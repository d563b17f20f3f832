"""Stokes, stationary Navier-Stokes and linearized Navier-Stokes operators.

The variational forms are compositions of the batched element kernels
of :mod:`lsafw_tpu_torch.fem.assembly`; the Newton Jacobian is the
analytic linearization (convection + shear around the current state),
assembled by the same kernels that build the eigensystem operator.

Sign conventions:
  residual form  F(w) = -(u.grad)u.v - (1/Re) grad u : grad v
                        + p div v + q div u + f.v  (+ boundary terms)
  eigen operator A = dF/dw at the baseflow; mass M = (u, v) on the
  velocity block; eigenproblem A x = sigma M x.
"""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch.fem.assembly import (
    AssemblyContext,
    compose_mixed,
    convection_scalar,
    dirichlet_lift,
    dirichlet_matrix_data,
    divergence_block,
    expand_vector_diag,
    mass_scalar,
    scatter_entries,
    scatter_matrix,
    scatter_vector,
    shear_tensor,
    stiffness_scalar,
)
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.fem.facets import (
    build_facet_context,
    neumann_pressure_load,
    neumann_velocity_load,
    robin_matrix_data,
    viscous_outlet_element_blocks,
    viscous_outlet_matrix_data,
)
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv


# ---------------------------------------------------------------------------
# Element-level composites
# ---------------------------------------------------------------------------


def _split_local(ctx: AssemblyContext, w: torch.Tensor):
    """Gather per-cell local mixed DOFs and split into (u_el, p_el)."""
    w_el = w[ctx.mixed_cell_dofs]  # (nc, ndofs_el)
    nud = ctx.nu_el * ctx.gdim
    return w_el[:, :nud].reshape(-1, ctx.nu_el, ctx.gdim), w_el[:, nud:]


def linearized_ns_elements(ctx: AssemblyContext, w_base: torch.Tensor, re) -> torch.Tensor:
    """Element matrices of the linearized NS operator around ``w_base``:
    shear + convection + viscous + pressure-gradient + divergence."""
    g = ctx.gdim
    ub_el, _ = _split_local(ctx, w_base)
    conv = convection_scalar(ctx, ub_el)
    sh = shear_tensor(ctx, ub_el)
    visc = stiffness_scalar(ctx)
    nc = visc.shape[0]
    nud = ctx.nu_el * g
    vv = expand_vector_diag(-conv - visc / re, g)
    vv = vv - sh.permute(0, 1, 3, 2, 4).reshape(nc, nud, nud)
    dvg = divergence_block(ctx)  # (nc, k, j, d)
    vp = dvg.permute(0, 2, 3, 1).reshape(nc, nud, ctx.np_el)
    pv = dvg.reshape(nc, ctx.np_el, nud)
    return compose_mixed(ctx, vv=vv, vp=vp, pv=pv)


def mass_elements(ctx: AssemblyContext) -> torch.Tensor:
    """Element mass matrices, velocity block only."""
    return compose_mixed(ctx, vv=expand_vector_diag(mass_scalar(ctx), ctx.gdim))


def stokes_elements(ctx: AssemblyContext, re) -> torch.Tensor:
    """Element matrices of (1/Re) grad u : grad v - p div v + q div u."""
    g = ctx.gdim
    visc = stiffness_scalar(ctx)
    nc = visc.shape[0]
    nud = ctx.nu_el * g
    dvg = divergence_block(ctx)
    vp = -dvg.permute(0, 2, 3, 1).reshape(nc, nud, ctx.np_el)
    pv = dvg.reshape(nc, ctx.np_el, nud)
    return compose_mixed(ctx, vv=expand_vector_diag(visc / re, g), vp=vp, pv=pv)


def ns_residual_elements(
    ctx: AssemblyContext, w: torch.Tensor, re, f: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-cell residual vectors of the stationary NS form F(w)."""
    u_el, p_el = _split_local(ctx, w)
    gu = ctx.phys_grad_u()  # (nc, q, i, d)
    uq = torch.einsum("qi,cid->cqd", ctx.phi_u, u_el)
    graduq = torch.einsum("cid,cqie->cqde", u_el, gu)  # du_d/dx_e
    pq = torch.einsum("qk,ck->cq", ctx.phi_p, p_el)
    divuq = torch.diagonal(graduq, dim1=-2, dim2=-1).sum(-1)
    convq = torch.einsum("cqe,cqde->cqd", uq, graduq)  # (u.grad u)_d
    wdet = ctx.w[None, :] * ctx.detJ[:, None]
    r_v = (
        -torch.einsum("cq,qi,cqd->cid", wdet, ctx.phi_u, convq)
        - (1.0 / re) * torch.einsum("cq,cqde,cqie->cid", wdet, graduq, gu)
        + torch.einsum("cq,cq,cqid->cid", wdet, pq, gu)
    )
    if f is not None:
        r_v = r_v + torch.einsum("cq,qi,d->cid", wdet, ctx.phi_u, f)
    r_p = torch.einsum("cq,qk,cq->ck", wdet, ctx.phi_p, divuq)
    return torch.cat([r_v.reshape(r_v.shape[0], -1), r_p], dim=1)


def convective_linearization_data(ctx: AssemblyContext, b: torch.Tensor) -> torch.Tensor:
    """CSR data of C(b): the convection-only part of the linearized NS
    operator about the mixed state ``b`` -- exactly
    ``linearized_ns_elements(ctx, b, re) - linearized_ns_elements(ctx, 0, re)``
    (convection is bilinear; viscous, pressure and divergence terms do not
    depend on b), assembled without any Dirichlet masking.

    C(b) v = -[(b . grad) v + (v . grad) b] tested against velocity test
    functions.  By the symmetry of the convection form this one matrix
    gives every coupling block of the coupled self-consistent
    (harmonic-balance) Jacobian: d/dU [A(U) q] = C(q) and
    d/dq {-1/2 [(q.grad)q]} = 1/2 C(q).  ``b`` is a real f64 vector."""
    g = ctx.gdim
    ub_el, _ = _split_local(ctx, torch.as_tensor(b, dtype=torch.float64, device=ctx.device))
    conv = convection_scalar(ctx, ub_el)
    sh = shear_tensor(ctx, ub_el)
    nc = conv.shape[0]
    vv = expand_vector_diag(-conv, g)
    vv = vv - sh.permute(0, 1, 3, 2, 4).reshape(nc, ctx.nu_el * g, ctx.nu_el * g)
    return scatter_entries(ctx, compose_mixed(ctx, vv=vv))


# ---------------------------------------------------------------------------
# Assemblers
# ---------------------------------------------------------------------------


def _check_homogeneous_natural(bcs: BoundaryConditions) -> None:
    """Reject non-homogeneous natural BCs for the eigenproblem."""
    flux = [v for _, v in bcs.velocity_neumann] + [(v,) for _, v in bcs.pressure_neumann]
    flux += [v for _, _, v in bcs.robin]
    if any(abs(x) > 0 for v in flux for x in v):
        raise ValueError(
            "Non-homogeneous natural (flux) boundary conditions are not yet stable."
        )


class _NSBase:
    def __init__(self, ctx: AssemblyContext, mesh: Mesh, bcs: BoundaryConditions) -> None:
        self.ctx = ctx
        self.mesh = mesh
        self.bcs = bcs
        self.bc_mask = torch.as_tensor(bcs.dirichlet_mask, device=ctx.device)
        self.bc_values = torch.as_tensor(
            np.asarray(bcs.dirichlet_values, dtype=np.float64), device=ctx.device
        )
        self._outlets = tuple(build_facet_context(ctx, mesh, m) for m in bcs.outlet_markers)
        self._outlet_units = None

    def _f(self, f):
        return None if f is None else torch.as_tensor(
            np.asarray(f, dtype=np.float64), device=self.ctx.device)

    def _state(self, w) -> torch.Tensor:
        return torch.as_tensor(w, dtype=torch.float64, device=self.ctx.device)

    def _outlet_unit_data(self) -> list[torch.Tensor]:
        """Each outlet's viscous term at Re = 1, assembled once (it does
        not depend on the state)."""
        if self._outlet_units is None:
            self._outlet_units = [viscous_outlet_matrix_data(fc, self.ctx, 1.0)
                                  for fc in self._outlets]
        return self._outlet_units

    def _outlet_data(self, re) -> torch.Tensor | int:
        return sum((1.0 / re) * data for data in self._outlet_unit_data())


class StokesAssembler(_NSBase):
    """Steady Stokes operator + RHS."""

    def __init__(self, ctx: AssemblyContext, mesh: Mesh, bcs: BoundaryConditions,
                 *, re: float, f=None) -> None:
        super().__init__(ctx, mesh, bcs)
        self.re = re
        self.f = self._f(f)
        self._neumann_v = [(build_facet_context(ctx, mesh, m), g)
                           for m, g in bcs.velocity_neumann]
        self._neumann_p = [(build_facet_context(ctx, mesh, m), h)
                           for m, h in bcs.pressure_neumann]

    def get_matrix_forms(self) -> tuple[CSRMatrix, torch.Tensor]:
        """Assemble (A_bc, b_lifted) ready for a linear solve."""
        ctx = self.ctx
        A0 = scatter_matrix(ctx, stokes_elements(ctx, self.re))
        b = torch.zeros(A0.shape[0], dtype=torch.float64, device=ctx.device)
        if self.f is not None:
            wdet = ctx.w[None, :] * ctx.detJ[:, None]
            r_v = torch.einsum("cq,qi,d->cid", wdet, ctx.phi_u, self.f)
            el = torch.zeros((r_v.shape[0], ctx.ndofs_el), dtype=torch.float64, device=ctx.device)
            el[:, : ctx.nu_el * ctx.gdim] = r_v.reshape(r_v.shape[0], -1)
            b = b + scatter_vector(ctx, el)
        for fc, g in self._neumann_v:
            b = b + neumann_velocity_load(fc, ctx, g)
        for fc, h in self._neumann_p:
            b = b + neumann_pressure_load(fc, ctx, h)
        b = dirichlet_lift(A0, b, self.bc_mask, self.bc_values)
        data = dirichlet_matrix_data(ctx.pattern, A0.data, self.bc_mask, 1.0)
        return CSRMatrix(ctx.pattern, data), b


class StationaryNavierStokesAssembler(_NSBase):
    """Residual + analytic Jacobian of stationary NS."""

    def __init__(self, ctx: AssemblyContext, mesh: Mesh, bcs: BoundaryConditions,
                 *, f=None) -> None:
        super().__init__(ctx, mesh, bcs)
        self.f = self._f(f)
        self._robin = [(build_facet_context(ctx, mesh, m), a, g) for m, a, g in bcs.robin]

    def residual(self, w, re) -> torch.Tensor:
        ctx = self.ctx
        w = self._state(w)
        r = scatter_vector(ctx, ns_residual_elements(ctx, w, re, self.f))
        for data in self._outlet_unit_data():
            r = r + (1.0 / re) * spmv(CSRMatrix(ctx.pattern, data), w)
        for fc, alpha, g in self._robin:
            data = robin_matrix_data(fc, ctx, alpha)
            r = r + spmv(CSRMatrix(ctx.pattern, data), w) + alpha * neumann_velocity_load(fc, ctx, g)
        return r

    def jacobian_data(self, w, re) -> torch.Tensor:
        ctx = self.ctx
        data = scatter_entries(ctx, linearized_ns_elements(ctx, self._state(w), re))
        data = data + self._outlet_data(re)
        for fc, alpha, _ in self._robin:
            data = data + robin_matrix_data(fc, ctx, alpha)
        return dirichlet_matrix_data(ctx.pattern, data, self.bc_mask, 1.0)

    def jacobian(self, w, re) -> CSRMatrix:
        """Assembled Jacobian with Dirichlet rows/cols eliminated."""
        return CSRMatrix(self.ctx.pattern, self.jacobian_data(w, re))


class LinearizedNavierStokesAssembler(_NSBase):
    """Eigensystem (A, M) around a baseflow.  A gets identity BC
    rows/cols; M gets *zero* BC rows/cols, which sends the spurious
    Dirichlet modes to infinity where shift-invert never sees them."""

    def __init__(self, base_flow, ctx: AssemblyContext, re: float,
                 bcs: BoundaryConditions, mesh: Mesh, *, mass_diag: float = 0.0) -> None:
        if tuple(np.shape(base_flow)) != (ctx.spaces.num_dofs,):
            raise ValueError("Baseflow must be defined on the mixed function space.")
        _check_homogeneous_natural(bcs)
        super().__init__(ctx, mesh, bcs)
        self.base_flow = self._state(base_flow)
        self.re = re
        self.mass_diag = mass_diag

    def assemble_linear_operator(self) -> CSRMatrix:
        ctx = self.ctx
        data = scatter_entries(ctx, linearized_ns_elements(ctx, self.base_flow, self.re))
        data = data + self._outlet_data(self.re)
        return CSRMatrix(ctx.pattern, dirichlet_matrix_data(ctx.pattern, data, self.bc_mask, 1.0))

    def assemble_mass_matrix(self) -> CSRMatrix:
        ctx = self.ctx
        data = scatter_entries(ctx, mass_elements(ctx))
        return CSRMatrix(
            ctx.pattern, dirichlet_matrix_data(ctx.pattern, data, self.bc_mask, self.mass_diag))

    def assemble_eigensystem(self) -> tuple[CSRMatrix, CSRMatrix]:
        """(A, M) on the shared pattern."""
        return self.assemble_linear_operator(), self.assemble_mass_matrix()

    def element_matrices(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(A_el, M_el, dofs): element matrices of the eigensystem (before
        the Dirichlet rows and columns) and their DOF maps, the
        matrix-free form of (A, M).  Viscous-outlet facet blocks are
        appended as extra elements with zero mass, so that the element
        operator matches the assembled one."""
        ctx = self.ctx
        A_el = linearized_ns_elements(ctx, self.base_flow, self.re)
        M_el = mass_elements(ctx)
        dofs = ctx.mixed_cell_dofs
        if self._outlets:
            nd, nud = ctx.ndofs_el, ctx.nu_el * ctx.gdim
            extra_A = []
            for fc in self._outlets:
                vv = viscous_outlet_element_blocks(fc, ctx, self.re)
                full = torch.zeros((vv.shape[0], nd, nd), dtype=vv.dtype, device=vv.device)
                full[:, :nud, :nud] = vv
                extra_A.append(full)
            A_el = torch.cat([A_el] + extra_A, dim=0)
            M_el = torch.cat([M_el, M_el.new_zeros((A_el.shape[0] - M_el.shape[0], nd, nd))])
            dofs = torch.cat([dofs] + [fc.cell_dofs for fc in self._outlets], dim=0)
        return A_el, M_el, dofs

    def pressure_nullspace_vector(self) -> np.ndarray:
        """Normalised constant-pressure vector (parity:
        ``attach_pressure_nullspace``, ``FEM/operators.py:534-545``)."""
        spaces = self.ctx.spaces
        v = np.zeros(spaces.num_dofs)
        v[spaces.dofs_p] = 1.0
        return v / np.linalg.norm(v)

    def extract_subblocks(self, mat: CSRMatrix) -> dict:
        """(vv, vp, pv, pp) scipy subblocks of an operator on the mixed
        space (parity: ``extract_subblocks``, ``FEM/operators.py:547-562``)."""
        s = mat.to_scipy()
        nu = self.ctx.spaces.num_velocity_dofs
        return {"vv": s[:nu, :nu], "vp": s[:nu, nu:], "pv": s[nu:, :nu], "pp": s[nu:, nu:]}
