"""Geometric multigrid preconditioner on stencil class grids (2D).

Counterpart of the reference's ``solver/multigrid.py``: a p-then-h
V-cycle for P2 scalar Dirichlet problems on structured rectangles (the
membrane class):

* p-coarsening: P2 -> P1 on the same mesh (vertex injection down, P1
  nodal interpolation up: a P2 coefficient at an edge node is the
  function's value at the midpoint);
* h-coarsening: P1 vertex grids halve per level with the
  triangulation-consistent linear interpolation (a diagonal midpoint
  averages the split diagonal's endpoints) and its adjoint as the
  restriction;
* damped-Jacobi smoothing at every level, a dense inverse on the coarsest
  interior (built on the host, applied as one product on the device).

The transfers are strided slices and multiply-adds on 2D grids, the
level products the stencil operators of
:mod:`~lsafw_tpu_torch.ops.stencil`.  It preconditions
:func:`~lsafw_tpu_torch.solver.power.lobpcg_smallest_pc`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.ops.stencil import StencilOperator, build_stencil_operator


def prolong_vertex(c: torch.Tensor, fine_shape: tuple[int, int]) -> torch.Tensor:
    """Linear interpolation coarse -> fine on the triangulated grid (quads
    split along the (i, j)-(i+1, j+1) diagonal)."""
    f = torch.zeros(fine_shape, dtype=c.dtype, device=c.device)
    f[0::2, 0::2] = c
    f[1::2, 0::2] = 0.5 * (c[:-1, :] + c[1:, :])
    f[0::2, 1::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    f[1::2, 1::2] = 0.5 * (c[:-1, :-1] + c[1:, 1:])
    return f


def restrict_vertex(f: torch.Tensor, coarse_shape: tuple[int, int]) -> torch.Tensor:
    """The adjoint of :func:`prolong_vertex`."""
    c = f[0::2, 0::2].clone()
    e = 0.5 * f[1::2, 0::2]
    c[:-1, :] += e
    c[1:, :] += e
    e = 0.5 * f[0::2, 1::2]
    c[:, :-1] += e
    c[:, 1:] += e
    e = 0.5 * f[1::2, 1::2]
    c[:-1, :-1] += e
    c[1:, 1:] += e
    return c


def _zero_boundary(g: torch.Tensor) -> torch.Tensor:
    """Homogeneous Dirichlet on every face of a vertex grid (any dimension)."""
    g = g.clone()
    for axis in range(g.dim()):
        g.select(axis, 0).zero_()
        g.select(axis, -1).zero_()
    return g


# P2 scalar classes on a split rectangle (ops.stencil's signature order):
#   class 0: (0,0) vertices          class 1: (0,1) vertical edges
#   class 2: (1,0) horizontal edges  class 3: (1,1) diagonal edges


def p1_to_p2(op2: StencilOperator, v: torch.Tensor) -> torch.Tensor:
    """P1 vertex grid -> packed P2 coefficients (nodal interpolation)."""
    return op2.join_grids((v, 0.5 * (v[:, :-1] + v[:, 1:]), 0.5 * (v[:-1, :] + v[1:, :]),
                           0.5 * (v[:-1, :-1] + v[1:, 1:])))


def p2_to_p1(op2: StencilOperator, xp: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`p1_to_p2`: packed P2 -> vertex grid."""
    gv, ge_v, ge_h, ge_d = op2.split_grids(xp)
    out = gv.clone()
    out[:, :-1] += 0.5 * ge_v
    out[:, 1:] += 0.5 * ge_v
    out[:-1, :] += 0.5 * ge_h
    out[1:, :] += 0.5 * ge_h
    out[:-1, :-1] += 0.5 * ge_d
    out[1:, 1:] += 0.5 * ge_d
    return out


def _inv_diag(d: torch.Tensor) -> torch.Tensor:
    """1 / d, with 1 where d is 0."""
    return torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.ones_like(d))


@dataclass(eq=False)
class MultigridPC:
    """V-cycle preconditioner for P2 Dirichlet scalar problems."""

    op2: StencilOperator  # the P2 operator (packed)
    inv_diag2: torch.Tensor  # packed Jacobi diagonal of op2
    ops1: tuple  # P1 hierarchy, fine -> coarse
    inv_diags1: tuple  # vertex-grid Jacobi (grid shape)
    coarse_inv: torch.Tensor  # dense inverse on the coarsest interior
    omega: float = 0.7
    smooth_steps: int = 2

    def _smooth2(self, x, b):
        for _ in range(self.smooth_steps):
            x = x + self.omega * self.inv_diag2 * (b - self.op2.matvec(x))
        return x

    def _apply1(self, level: int, g: torch.Tensor) -> torch.Tensor:
        (y,) = self.ops1[level].matvec_grids((g,))
        return _zero_boundary(y)

    def _smooth1(self, level, x, b):
        for _ in range(self.smooth_steps):
            x = x + self.omega * self.inv_diags1[level] * (b - self._apply1(level, x))
        return _zero_boundary(x)

    def _coarse(self, b: torch.Tensor) -> torch.Tensor:
        interior = tuple(slice(1, -1) for _ in range(b.dim()))
        x = torch.zeros_like(b)
        x[interior] = (self.coarse_inv @ b[interior].reshape(-1)).view(x[interior].shape)
        return x

    def _restrict(self, level: int, r: torch.Tensor) -> torch.Tensor:
        return restrict_vertex(r, self.ops1[level + 1].structure.class_shapes[0])

    def _prolong(self, ec: torch.Tensor, shape) -> torch.Tensor:
        return prolong_vertex(ec, shape)

    def _to_p1(self, res):
        return p2_to_p1(self.op2, res)

    def _to_p2(self, e1):
        return p1_to_p2(self.op2, e1)

    def _vcycle1(self, level: int, b: torch.Tensor) -> torch.Tensor:
        if level == len(self.ops1) - 1:
            return self._coarse(b)
        x = self._smooth1(level, torch.zeros_like(b), b)
        r = _zero_boundary(b - self._apply1(level, x))
        ec = self._vcycle1(level + 1, _zero_boundary(self._restrict(level, r)))
        x = x + _zero_boundary(self._prolong(ec, x.shape))
        return self._smooth1(level, x, b)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle: approximately op2^-1 r on the packed P2 layout."""
        x = self._smooth2(torch.zeros_like(r), r)
        r1 = _zero_boundary(self._to_p1(r - self.op2.matvec(x)))
        x = x + self._to_p2(_zero_boundary(self._vcycle1(0, r1)))
        if self.op2.bc_mask is not None:  # keep the Dirichlet rows exact (op2 is identity there)
            x = torch.where(self.op2.bc_mask, r, x)
        return self._smooth2(x, r)


def p1_level(mesh_l, device):
    """The P1 Dirichlet stiffness of a level mesh on ``device``: (K1 with
    identity Dirichlet rows, its space, the Dirichlet mask)."""
    from lsafw_tpu_torch.fem.assembly import SpaceContext, dirichlet_matrix_data, stiffness_scalar
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.ops.sparse import CSRMatrix

    space1 = make_scalar_space(mesh_l, "p1")
    ctx1 = SpaceContext.build(space1, device=device)
    bmask = np.zeros(space1.num_dofs, dtype=bool)
    bmask[space1.nodes_on_facets(mesh_l.boundary_facets)] = True
    data = dirichlet_matrix_data(ctx1.pattern, ctx1.scatter(stiffness_scalar(ctx1)).data,
                                 torch.as_tensor(bmask, device=ctx1.device), 1.0)
    return CSRMatrix(ctx1.pattern, data), space1, bmask


def coarse_interior_inverse(K1c, op1c, grid_shape) -> torch.Tensor:
    """The dense inverse of the coarsest level's interior block, in the
    grid's row-major interior order, built on the host."""
    Kc = K1c.to_scipy().toarray()
    grid_idx = np.arange(int(np.prod(grid_shape))).reshape(grid_shape)
    interior = grid_idx[tuple(slice(1, -1) for _ in grid_shape)].reshape(-1)
    gi = op1c.structure.perm[interior]
    return torch.as_tensor(np.linalg.inv(Kc[np.ix_(gi, gi)]), device=K1c.device)


def build_multigrid_pc(mesh, K2, bc_mask2: np.ndarray, *, levels: int | None = None,
                       omega: float = 0.7, smooth_steps: int = 3) -> MultigridPC:
    """The V-cycle preconditioner of a P2 Dirichlet operator on a
    structured rectangle: ``K2`` the assembled P2 CSRMatrix with identity
    Dirichlet rows (the hierarchy lives on its device), ``bc_mask2`` the
    Dirichlet mask over its DOFs."""
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh

    space2 = make_scalar_space(mesh, "p2")
    op2 = build_stencil_operator(K2.pattern, K2.data, [(space2, 1)], bc_mask=bc_mask2,
                                 bc_diag=1.0)
    perm2 = op2.structure.on(K2.device)["perm"].long()
    inv_diag2 = _inv_diag(K2.diagonal()[perm2])
    nxv, nyv = op2.structure.class_shapes[0]
    nx, ny = nxv - 1, nyv - 1
    x0, y0 = mesh.vertices.min(axis=0)
    x1, y1 = mesh.vertices.max(axis=0)
    if levels is None:
        levels = 1
        while (nx % (2 ** levels) == 0 and ny % (2 ** levels) == 0
               and min(nx, ny) // (2 ** levels) >= 4):
            levels += 1
    ops1, inv_diags1 = [], []
    for lev in range(levels):
        nxl, nyl = nx // (2 ** lev), ny // (2 ** lev)
        mesh_l = mesh if lev == 0 else rectangle_mesh((x0, y0), (x1, y1), nxl, nyl)
        K1, space1, _ = p1_level(mesh_l, K2.device)
        op1 = build_stencil_operator(K1.pattern, K1.data, [(space1, 1)])
        perm1 = op1.structure.on(K2.device)["perm"].long()
        ops1.append(op1)
        inv_diags1.append(1.0 / K1.diagonal()[perm1].view(nxl + 1, nyl + 1))
    return MultigridPC(op2=op2, inv_diag2=inv_diag2, ops1=tuple(ops1),
                       inv_diags1=tuple(inv_diags1),
                       coarse_inv=coarse_interior_inverse(K1, op1, (nxl + 1, nyl + 1)),
                       omega=omega, smooth_steps=smooth_steps)
