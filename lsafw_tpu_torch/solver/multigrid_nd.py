"""Dimension-generic geometric multigrid on structured N-D grids.

Counterpart of the reference's ``solver/multigrid_nd.py``: the V-cycle of
:mod:`~lsafw_tpu_torch.solver.multigrid` on the N-D stencil operator of
:mod:`~lsafw_tpu_torch.ops.stencil_nd`:

* p-coarsening: P2 -> P1 on the same box mesh.  Every non-vertex P2 class
  is an edge-midpoint family with a direction r in {0, 1}^d (its
  signature bits): the P2 coefficient at grid index v is the function's
  value at the midpoint of (v, v + r), so nodal interpolation down and up
  is two shifted grid reads per class;
* h-coarsening: vertex grids halve per level with separable d-linear
  interpolation (one 1D interleave per axis) and its adjoint.  On
  Kuhn-split meshes this is not the exact P1 interpolant but a spectrally
  equivalent transfer, as in the reference;
* damped-Jacobi smoothing per level, a dense inverse on the coarsest
  interior.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.ops.stencil_nd import StencilNDOperator, _classify_nd, build_stencil_nd
from lsafw_tpu_torch.solver.multigrid import (
    MultigridPC,
    _inv_diag,
    _zero_boundary,
    coarse_interior_inverse,
    p1_level,
)


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """Interleave midpoints along one axis: n -> 2(n - 1) + 1."""
    c = c.movedim(axis, 0)
    f = torch.zeros((2 * (c.shape[0] - 1) + 1,) + tuple(c.shape[1:]), dtype=c.dtype,
                    device=c.device)
    f[0::2] = c
    f[1::2] = 0.5 * (c[:-1] + c[1:])
    return f.movedim(0, axis)


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """The adjoint of :func:`_prolong_axis` along one axis."""
    f = f.movedim(axis, 0)
    c = f[0::2].clone()
    e = 0.5 * f[1::2]
    c[:-1] += e
    c[1:] += e
    return c.movedim(0, axis)


def prolong_vertex_nd(c: torch.Tensor) -> torch.Tensor:
    """d-linear interpolation coarse -> fine (each axis doubles)."""
    for axis in range(c.dim()):
        c = _prolong_axis(c, axis)
    return c


def restrict_vertex_nd(f: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`prolong_vertex_nd`."""
    for axis in range(f.dim()):
        f = _restrict_axis(f, axis)
    return f


def class_directions(op2: StencilNDOperator, node_coords: np.ndarray, h: np.ndarray,
                     origin: np.ndarray) -> tuple[tuple[int, ...], ...]:
    """Each class's edge direction r in {0, 1}^d, in the structure's class
    order (ascending signature; class 0 must be the vertex class)."""
    d = node_coords.shape[1]
    cls, _ = _classify_nd(node_coords, h, origin)
    dirs = tuple(tuple(int((int(sig) >> (d - 1 - a)) & 1) for a in range(d))
                 for sig in np.unique(cls))
    if any(dirs[0]):
        raise ValueError("class 0 is not the vertex class")
    return dirs


def _split(op: StencilNDOperator, xp: torch.Tensor) -> list[torch.Tensor]:
    st = op.structure
    return [xp[st.class_bases[k]:st.class_bases[k] + int(np.prod(shp))].view(shp)
            for k, shp in enumerate(st.class_shapes)]


def _ends(shape, r):
    """The slices of the lower and upper endpoints of direction r."""
    return (tuple(slice(0, s - rr) for s, rr in zip(shape, r)),
            tuple(slice(rr, None) for rr in r))


def p1_to_p2_nd(op2: StencilNDOperator, dirs, gv: torch.Tensor) -> torch.Tensor:
    """P1 vertex grid -> packed P2 coefficients (nodal interpolation)."""
    grids = []
    for r in dirs:
        if not any(r):
            grids.append(gv)
            continue
        lo, hi = _ends(gv.shape, r)
        grids.append(0.5 * (gv[lo] + gv[hi]))
    return torch.cat([g.reshape(-1) for g in grids])


def p2_to_p1_nd(op2: StencilNDOperator, dirs, xp: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`p1_to_p2_nd`: packed P2 -> vertex grid."""
    grids = _split(op2, xp)
    out = grids[0].clone()
    for r, g in zip(dirs[1:], grids[1:]):
        lo, hi = _ends(out.shape, r)
        out[lo] += 0.5 * g
        out[hi] += 0.5 * g
    return out


@dataclass(eq=False)
class MultigridNDPC(MultigridPC):
    """The V-cycle of :class:`~lsafw_tpu_torch.solver.multigrid.MultigridPC`
    for P2 Dirichlet scalar problems on structured d-dimensional boxes."""

    dirs: tuple = ()  # each class's edge direction

    def _apply1(self, level: int, g: torch.Tensor) -> torch.Tensor:
        return _zero_boundary(self.ops1[level].matvec(g.reshape(-1)).view(g.shape))

    def _restrict(self, level: int, r: torch.Tensor) -> torch.Tensor:
        return restrict_vertex_nd(r)

    def _prolong(self, ec: torch.Tensor, shape) -> torch.Tensor:
        return prolong_vertex_nd(ec)

    def _to_p1(self, res):
        return p2_to_p1_nd(self.op2, self.dirs, res)

    def _to_p2(self, e1):
        return p1_to_p2_nd(self.op2, self.dirs, e1)


def build_multigrid_nd_pc(mesh, K2, bc_mask2: np.ndarray, *, levels: int | None = None,
                          omega: float = 0.7, smooth_steps: int = 3) -> MultigridNDPC:
    """The N-D V-cycle preconditioner of a P2 Dirichlet operator on a
    structured box mesh (a 2D rectangle or a 3D box), on ``K2``'s device."""
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import box_mesh, rectangle_mesh

    d = mesh.gdim
    space2 = make_scalar_space(mesh, "p2")
    op2 = build_stencil_nd(K2.pattern, K2.data, [(space2, 1)], bc_mask=bc_mask2, bc_diag=1.0)
    st = op2.structure
    inv_diag2 = _inv_diag(K2.diagonal()[st.on(K2.device)["perm"].long()])
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    divs = tuple(s - 1 for s in st.class_shapes[0])
    h = (hi - lo) / np.asarray(divs, dtype=float)
    dirs = class_directions(op2, space2.node_coords[:, :d], h, lo)
    if levels is None:
        levels = 1
        while (all(n_ % (2 ** levels) == 0 for n_ in divs)
               and min(divs) // (2 ** levels) >= 4):
            levels += 1
    ops1, inv_diags1 = [], []
    for lev in range(levels):
        divs_l = tuple(n_ // (2 ** lev) for n_ in divs)
        if lev == 0:  # the finest P1 level lives on the P2 problem's own mesh
            mesh_l = mesh
        elif d == 2:
            mesh_l = rectangle_mesh(tuple(lo), tuple(hi), *divs_l)
        else:
            mesh_l = box_mesh(tuple(lo), tuple(hi), *divs_l)
        K1, space1, _ = p1_level(mesh_l, K2.device)
        op1 = build_stencil_nd(K1.pattern, K1.data, [(space1, 1)])
        gshape = op1.structure.class_shapes[0]
        ops1.append(op1)
        inv_diags1.append(1.0 / K1.diagonal()[op1.structure.on(K2.device)["perm"].long()]
                          .view(gshape))
    return MultigridNDPC(op2=op2, inv_diag2=inv_diag2, ops1=tuple(ops1),
                         inv_diags1=tuple(inv_diags1),
                         coarse_inv=coarse_interior_inverse(K1, op1, gshape), omega=omega,
                         smooth_steps=smooth_steps, dirs=dirs)
