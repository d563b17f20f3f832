"""Batched finite-element assembly on static sparsity.

Per-cell element matrices are computed for all cells at once with
``torch.einsum`` on the device, then scattered into the shared CSR
pattern with one f64 ``index_add_``.  On affine cells (simplices, and
parallelogram / parallelepiped quads and hexes) every bilinear term is a
contraction of a static reference tensor (basis tabulations
precontracted over quadrature) with a per-cell geometry factor, e.g. the
viscous matrix ``K0[t,s,i,j] . G[c,t,s]`` with ``G = detJ * Jinv Jinv^T``.
A :class:`SpaceContext` on quads and hexes takes the geometry of the
multilinear Q1 map per quadrature point instead (detJ (nc, nq), Jinv
(nc, nq, tdim, gdim)), and the scalar kernels contract it pointwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.elements import ElementFamily, make_element
from lsafw_tpu_torch.fem.quadrature import QuadratureRule, quadrature_rule
from lsafw_tpu_torch.fem.spaces import FunctionSpace, FunctionSpaces
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.ops.sparse import (
    CSRMatrix,
    SparsityPattern,
    assemble_csr_data,
    build_sparsity,
    spmv,
)

TENSOR_CELLS = (CellType.QUADRILATERAL, CellType.HEXAHEDRON)


def affine_geometry(mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """(|detJ|, Jinv) of the affine map of every cell.

    Simplices: J's columns are the edge vectors v_i - v_0.  Quads and
    hexes are affine exactly when they are parallelograms /
    parallelepipeds: J's columns are then the axis edges of the binary
    vertex order (quad (0,0),(1,0),(0,1),(1,1): v1, v2; hex (di, dj, dk)
    with k fastest: v4, v2, v1); callers check that property with
    :func:`is_parallelogram_cells` or take :func:`nonaffine_geometry`."""
    v = mesh.vertices[mesh.cells]  # (nc, nverts, gdim)
    if mesh.cell_type is CellType.QUADRILATERAL:
        J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    elif mesh.cell_type is CellType.HEXAHEDRON:
        J = np.stack([v[:, 4] - v[:, 0], v[:, 2] - v[:, 0], v[:, 1] - v[:, 0]], axis=2)
    else:
        J = np.transpose(v[:, 1:] - v[:, :1], (0, 2, 1))  # (nc, gdim, tdim)
    if mesh.tdim != mesh.gdim:
        raise NotImplementedError("Embedded manifolds not supported.")
    return np.abs(np.linalg.det(J)), np.linalg.inv(J)


def is_parallelogram_cells(mesh: Mesh, tol: float = 1e-12) -> bool:
    """Whether every tensor-product cell's multilinear map is affine
    (parallelogram quads, parallelepiped hexes); true for simplices."""
    v = mesh.vertices[mesh.cells]
    scale = max(float(np.abs(v).max()), 1.0)
    if mesh.cell_type is CellType.QUADRILATERAL:
        return bool(np.abs(v[:, 3] - v[:, 1] - v[:, 2] + v[:, 0]).max() <= tol * scale)
    if mesh.cell_type is CellType.HEXAHEDRON:
        a, b, c = v[:, 4] - v[:, 0], v[:, 2] - v[:, 0], v[:, 1] - v[:, 0]
        corners = [(di, dj, dk) for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
        return all(np.abs(v[:, m] - (v[:, 0] + di * a + dj * b + dk * c)).max() <= tol * scale
                   for m, (di, dj, dk) in enumerate(corners))
    return True


def nonaffine_geometry(mesh: Mesh, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-quadrature-point (|detJ| (nc, nq), Jinv (nc, nq, tdim, gdim))
    of the multilinear Q1 geometry map of quad / hex cells."""
    tab = make_element(ElementFamily.Q1, mesh.cell_type).tabulate(points)  # grad (nq, nv, tdim)
    J = np.einsum("cvg,qvt->cqgt", mesh.vertices[mesh.cells], tab.grad)
    return np.abs(np.linalg.det(J)), np.linalg.inv(J)


def _metric(detJ: torch.Tensor, Jinv: torch.Tensor) -> torch.Tensor:
    """G = detJ Jinv Jinv^T: (nc, t, s) per cell, or (nc, nq, t, s) per
    quadrature point."""
    return detJ[..., None, None] * torch.einsum("...td,...sd->...ts", Jinv, Jinv)


class _ContextBase:
    """What the contexts share: ``phi_u``/``dphi_u`` name the primary basis
    (velocity of a mixed space, or the one basis of a single space), so
    the scalar element kernels take either context."""

    @property
    def is_affine(self) -> bool:
        """One Jacobian per cell (simplices, parallelogram tensor cells),
        or one per quadrature point (quads, hexes of a SpaceContext)."""
        return self.detJ.ndim == 1

    def phys_grad_u(self) -> torch.Tensor:
        """(nc, nq, nu_el, gdim) physical gradients of the primary basis."""
        if not self.is_affine:
            return torch.einsum("qit,cqtd->cqid", self.dphi_u, self.Jinv)
        return torch.einsum("qit,ctd->cqid", self.dphi_u, self.Jinv)


@dataclass(eq=False)
class AssemblyContext(_ContextBase):
    """Static per-(mesh, spaces) assembly data of the mixed
    velocity-pressure space, as f64 tensors on one device: tabulations,
    geometry factors, precontracted reference tensors and the shared
    mixed sparsity pattern.  The mixed kernels take one Jacobian per
    cell: quads and hexes must be parallelograms / parallelepipeds (the
    Q2/Q1 Taylor-Hood pair on structured channel grids)."""

    rule: QuadratureRule
    spaces: FunctionSpaces
    pattern: SparsityPattern
    device: torch.device
    w: torch.Tensor  # (nq,)
    phi_u: torch.Tensor  # (nq, nu_el)
    dphi_u: torch.Tensor  # (nq, nu_el, tdim)
    phi_p: torch.Tensor  # (nq, np_el)
    detJ: torch.Tensor  # (nc,)
    Jinv: torch.Tensor  # (nc, tdim, gdim)
    cell_nodes_u: torch.Tensor  # (nc, nu_el) int64
    mixed_cell_dofs: torch.Tensor  # (nc, ndofs_el) int64
    M0: torch.Tensor  # (nu_el, nu_el)
    K0: torch.Tensor  # (tdim, tdim, nu_el, nu_el)
    B0: torch.Tensor  # (tdim, np_el, nu_el)
    metric: torch.Tensor  # (nc, tdim, tdim)

    @classmethod
    def build(
        cls, spaces: FunctionSpaces, *, device="cuda", quad_degree: int | None = None
    ) -> "AssemblyContext":
        device = resolve_device(device)
        mesh = spaces.velocity.mesh
        if mesh.cell_type in TENSOR_CELLS and not is_parallelogram_cells(mesh):
            raise NotImplementedError(
                "Mixed spaces on curvilinear quad/hex cells need per-quadrature-point "
                "geometry in the NS kernels; only parallelogram/parallelepiped tensor cells "
                "are supported (or use simplices).")
        rule = quadrature_rule(mesh.cell_type, quad_degree or spaces.quad_degree)
        tab_u = spaces.velocity.element.tabulate(rule.points)
        tab_p = spaces.pressure.element.tabulate(rule.points)
        detJ, Jinv = affine_geometry(mesh)
        pattern = build_sparsity(
            spaces.mixed_cell_dofs, shape=(spaces.num_dofs, spaces.num_dofs)
        )

        def f64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

        def i64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        w, phi_u, dphi_u, phi_p = f64(rule.weights), f64(tab_u.phi), f64(tab_u.grad), f64(tab_p.phi)
        detJ_t, Jinv_t = f64(detJ), f64(Jinv)
        return cls(
            rule=rule, spaces=spaces, pattern=pattern, device=device,
            w=w, phi_u=phi_u, dphi_u=dphi_u, phi_p=phi_p,
            detJ=detJ_t, Jinv=Jinv_t,
            cell_nodes_u=i64(spaces.velocity.cell_nodes),
            mixed_cell_dofs=i64(spaces.mixed_cell_dofs),
            M0=torch.einsum("q,qi,qj->ij", w, phi_u, phi_u),
            K0=torch.einsum("q,qit,qjs->tsij", w, dphi_u, dphi_u),
            B0=torch.einsum("q,qk,qjt->tkj", w, phi_p, dphi_u),
            metric=_metric(detJ_t, Jinv_t),
        )

    @property
    def nu_el(self) -> int:
        return int(self.phi_u.shape[1])

    @property
    def np_el(self) -> int:
        return int(self.phi_p.shape[1])

    @property
    def gdim(self) -> int:
        return self.spaces.velocity.mesh.gdim

    @property
    def ndofs_el(self) -> int:
        return self.nu_el * self.gdim + self.np_el


@dataclass(eq=False)
class SpaceContext(_ContextBase):
    """Assembly context of a single scalar or blocked-vector space (e.g.
    the P1 pressure space of an L2 projection, the membrane's P2 or Q2
    space, the elasticity displacement): the ``phi_u``/``M0``/``K0``/
    ``metric`` names of :class:`AssemblyContext` hold this space's basis
    and geometry, so the scalar element kernels take either context.  On
    quads and hexes the geometry is per quadrature point, always (the
    multilinear map is not affine in general)."""

    rule: QuadratureRule
    space: FunctionSpace
    pattern: SparsityPattern
    device: torch.device
    w: torch.Tensor  # (nq,)
    phi_u: torch.Tensor  # (nq, ndofs_el)
    dphi_u: torch.Tensor  # (nq, ndofs_el, tdim)
    detJ: torch.Tensor  # (nc,), or (nc, nq) on quads / hexes
    Jinv: torch.Tensor  # (nc, tdim, gdim), or (nc, nq, tdim, gdim)
    cell_dofs: torch.Tensor  # (nc, ndofs_el * bs) int64
    M0: torch.Tensor  # (ndofs_el, ndofs_el)
    K0: torch.Tensor  # (tdim, tdim, ndofs_el, ndofs_el)
    metric: torch.Tensor  # (nc, tdim, tdim), or (nc, nq, tdim, tdim)

    @classmethod
    def build(cls, space: FunctionSpace, quad_degree: int | None = None, *,
              device="cuda") -> "SpaceContext":
        device = resolve_device(device)
        mesh = space.mesh
        rule = quadrature_rule(mesh.cell_type, quad_degree or 2 * space.element.degree)
        tab = space.element.tabulate(rule.points)
        detJ, Jinv = (nonaffine_geometry(mesh, rule.points) if mesh.cell_type in TENSOR_CELLS
                      else affine_geometry(mesh))
        pattern = build_sparsity(space.cell_dofs, shape=(space.num_dofs, space.num_dofs))

        def f64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

        w, phi, dphi = f64(rule.weights), f64(tab.phi), f64(tab.grad)
        detJ_t, Jinv_t = f64(detJ), f64(Jinv)
        return cls(
            rule=rule, space=space, pattern=pattern, device=device, w=w, phi_u=phi,
            dphi_u=dphi, detJ=detJ_t, Jinv=Jinv_t,
            cell_dofs=torch.as_tensor(np.asarray(space.cell_dofs, dtype=np.int64), device=device),
            M0=torch.einsum("q,qi,qj->ij", w, phi, phi),
            K0=torch.einsum("q,qit,qjs->tsij", w, dphi, dphi),
            metric=_metric(detJ_t, Jinv_t),
        )

    @property
    def gdim(self) -> int:
        return self.space.mesh.gdim

    def scatter(self, element_mats: torch.Tensor) -> CSRMatrix:
        """Per-cell element matrices -> the space's CSR matrix."""
        return CSRMatrix(self.pattern, assemble_csr_data(self.pattern, element_mats))

    def scatter_vec(self, element_vecs: torch.Tensor) -> torch.Tensor:
        """(nc, ndofs_el) element vectors -> (num_dofs,) global vector (f64
        ``index_add_``)."""
        out = torch.zeros(self.space.num_dofs, dtype=element_vecs.dtype, device=self.device)
        return out.index_add_(0, self.cell_dofs.reshape(-1), element_vecs.reshape(-1))


# ---------------------------------------------------------------------------
# Scalar element kernels
# ---------------------------------------------------------------------------


def mass_scalar(ctx: AssemblyContext | SpaceContext) -> torch.Tensor:
    """(nc, nu_el, nu_el) element mass matrices: detJ * M0, or on
    per-point geometry the pointwise |detJ| contraction."""
    if not ctx.is_affine:
        return torch.einsum("q,cq,qi,qj->cij", ctx.w, ctx.detJ, ctx.phi_u, ctx.phi_u)
    return ctx.detJ[:, None, None] * ctx.M0[None]


def stiffness_scalar(ctx: AssemblyContext | SpaceContext) -> torch.Tensor:
    """(nc, nu_el, nu_el) element Laplacian: metric . K0, or on per-point
    geometry the contraction at each quadrature point."""
    if not ctx.is_affine:
        return torch.einsum("q,qit,cqts,qjs->cij", ctx.w, ctx.dphi_u, ctx.metric, ctx.dphi_u)
    return torch.einsum("cts,tsij->cij", ctx.metric, ctx.K0)


def divergence_block(ctx: AssemblyContext) -> torch.Tensor:
    """(nc, np_el, nu_el, gdim): integral phi_p,k * d(phi_u,j)/dx_d."""
    dJinv = ctx.detJ[:, None, None] * ctx.Jinv
    return torch.einsum("tkj,ctd->ckjd", ctx.B0, dJinv)


def convection_scalar(ctx: AssemblyContext, ub_el: torch.Tensor) -> torch.Tensor:
    """(nc, nu_el, nu_el): integral phi_i * (u_b . grad phi_j);
    ``ub_el`` is the (nc, nu_el, gdim) nodal baseflow velocity."""
    gu = ctx.phys_grad_u()
    ubq = torch.einsum("qi,cid->cqd", ctx.phi_u, ub_el)
    wdet = ctx.w[None, :] * ctx.detJ[:, None]
    return torch.einsum("cq,qi,cqd,cqjd->cij", wdet, ctx.phi_u, ubq, gu)


def shear_tensor(ctx: AssemblyContext, ub_el: torch.Tensor) -> torch.Tensor:
    """(nc, nu_el, nu_el, gdim, gdim): integral phi_i phi_j * d(u_b,d)/dx_e."""
    gu = ctx.phys_grad_u()
    gub = torch.einsum("cid,cqie->cqde", ub_el, gu)
    wdet = ctx.w[None, :] * ctx.detJ[:, None]
    return torch.einsum("cq,qi,qj,cqde->cijde", wdet, ctx.phi_u, ctx.phi_u, gub)


# ---------------------------------------------------------------------------
# Mixed-block composition and scatter
# ---------------------------------------------------------------------------


def expand_vector_diag(scalar_el: torch.Tensor, gdim: int) -> torch.Tensor:
    """Lift (nc, i, j) scalar blocks to component-diagonal vector blocks
    (nc, i*gdim, j*gdim) in node-major/component-minor DOF order."""
    nc, a, b = scalar_el.shape
    eye = torch.eye(gdim, dtype=scalar_el.dtype, device=scalar_el.device)
    return torch.einsum("cij,de->cidje", scalar_el, eye).reshape(nc, a * gdim, b * gdim)


def compose_mixed(
    ctx: AssemblyContext,
    vv: torch.Tensor | None = None,
    vp: torch.Tensor | None = None,
    pv: torch.Tensor | None = None,
    pp: torch.Tensor | None = None,
) -> torch.Tensor:
    """Place blocks into full (nc, ndofs_el, ndofs_el) element matrices;
    missing blocks are zero."""
    nc = ctx.detJ.shape[0]
    nud = ctx.nu_el * ctx.gdim
    A = torch.zeros((nc, ctx.ndofs_el, ctx.ndofs_el), dtype=ctx.detJ.dtype, device=ctx.device)
    if vv is not None:
        A[:, :nud, :nud] += vv
    if vp is not None:
        A[:, :nud, nud:] += vp
    if pv is not None:
        A[:, nud:, :nud] += pv
    if pp is not None:
        A[:, nud:, nud:] += pp
    return A


def scatter_entries(ctx: AssemblyContext, element_mats: torch.Tensor) -> torch.Tensor:
    """Full-cell element matrices -> flat CSR data."""
    return assemble_csr_data(ctx.pattern, element_mats)


def scatter_matrix(ctx: AssemblyContext, element_mats: torch.Tensor) -> CSRMatrix:
    return CSRMatrix(ctx.pattern, scatter_entries(ctx, element_mats))


def scatter_vector(ctx: AssemblyContext, element_vecs: torch.Tensor) -> torch.Tensor:
    """(nc, ndofs_el) element vectors -> (num_dofs,) global vector."""
    out = torch.zeros(ctx.spaces.num_dofs, dtype=element_vecs.dtype, device=ctx.device)
    return out.index_add_(0, ctx.mixed_cell_dofs.reshape(-1), element_vecs.reshape(-1))


# ---------------------------------------------------------------------------
# Dirichlet BC application (dolfinx semantics)
# ---------------------------------------------------------------------------


def dirichlet_matrix_data(
    pattern: SparsityPattern,
    data: torch.Tensor,
    bc_mask: torch.Tensor,
    diag_value: float = 1.0,
) -> torch.Tensor:
    """Zero BC rows *and* columns, put ``diag_value`` on BC diagonals."""
    ix = pattern.on(data.device)
    kill = bc_mask[ix["row_ids"]] | bc_mask[ix["col"]]
    data = torch.where(kill, torch.zeros((), dtype=data.dtype, device=data.device), data)
    diag = ix["diag_slots"]
    data[diag] = torch.where(
        bc_mask, torch.full((), diag_value, dtype=data.dtype, device=data.device), data[diag]
    )
    return data


def dirichlet_lift(
    A_nobc: CSRMatrix, b: torch.Tensor, bc_mask: torch.Tensor, bc_values: torch.Tensor
) -> torch.Tensor:
    """b <- b - A g on free rows, b[bc] = g[bc] (lifting + set_bc)."""
    g = torch.where(bc_mask, bc_values, torch.zeros_like(bc_values))
    return torch.where(bc_mask, bc_values, b - spmv(A_nobc, g))
