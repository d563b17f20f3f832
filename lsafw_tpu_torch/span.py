"""Quasi-3D (spanwise-Fourier) linear stability of a steady 2D base flow.

Counterpart of the reference's ``span`` module, in the sense of Barkley
& Henderson (JFM 322, 1996): perturbations of a two-dimensional base
state carrying one spanwise Fourier mode,

    q'(x, y, z, t) = (u', v', w', p')(x, y, t) . e_beta(z),

on the SAME 2D mesh; the third dimension enters only through the
wavenumber ``beta``.  For a base flow with no spanwise component the
substitution (u', v', p') ~ (u, v, p) cos(beta z), w' ~ w sin(beta z)
closes the linearized Navier-Stokes system over real 2D fields:

    momentum (in-plane d):  A_2d(U) u_d  - (beta^2/Re) u_d
    momentum (spanwise):    -(U . grad2) w - (1/Re)(grad2^2 + beta^2) w
                            + beta p
    continuity:             div2 u + beta w = 0

so A(beta) and M are real matrices on the block layout ``[u, v, p (the
mixed space); w (one scalar velocity field)]`` and the eigensolver of
:mod:`lsafw_tpu_torch.solver.eigen` applies unchanged: on the card the
band factor of the quasi-3D pattern with the K1/K2 substitutions, G's
permutations and S's refinement matvecs.

The quasi-3D pattern and the outlet facets' slots are built once per
:class:`SpanwiseStability`; a wavenumber sweep assembles values only, on
that one pattern, so the band plan, the RCM ordering and the permuted-CSR
plan of the pattern are built once (``ops/sparse.py`` ``per_pattern``)
and every beta reuses them.  Element matrices are f64 einsums on the
device and the scatter one f64 ``index_add_`` (the reference's
``segment_sum_fast`` is a TPU workaround).

Dirichlet rule for the spanwise field: w is constrained at a node iff
ALL in-plane velocity components are constrained there (no-slip and
inflow walls pin w; symmetry planes leave it free).

:func:`spanwise_floquet` takes the same quasi-3D operator around the
snapshots of a periodic 2D orbit into the monodromy trip of
:mod:`lsafw_tpu_torch.floquet` (Barkley & Henderson's secondary
instability).
"""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import (
    AssemblyContext,
    convection_scalar,
    dirichlet_matrix_data,
    expand_vector_diag,
    mass_scalar,
    stiffness_scalar,
)
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.fem.facets import FacetContext, _pair_slots, build_facet_context
from lsafw_tpu_torch.models.navier_stokes import (
    _split_local,
    linearized_ns_elements,
    mass_elements,
)
from lsafw_tpu_torch.ops.sparse import CSRMatrix, SparsityPattern, assemble_csr_data, build_sparsity
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Element kernels
# ---------------------------------------------------------------------------


def quasi3d_elements(ctx: AssemblyContext, w_base: torch.Tensor, re, beta) -> torch.Tensor:
    """Element matrices of the quasi-3D linearized operator A(beta)
    around the 2D mixed state ``w_base``.

    Local DOF layout: ``[u,v (interleaved), p, w]`` -- (nc, nd + nu_el,
    nd + nu_el) with nd = ctx.ndofs_el."""
    nd, nu, g = ctx.ndofs_el, ctx.nu_el, ctx.gdim
    nud = nu * g
    A2 = linearized_ns_elements(ctx, w_base, re)
    ms = mass_scalar(ctx)
    ub_el, _ = _split_local(ctx, w_base)
    conv = convection_scalar(ctx, ub_el)
    stiff = stiffness_scalar(ctx)
    wdet = ctx.w[None, :] * ctx.detJ[:, None]
    mup = torch.einsum("cq,qi,qk->cik", wdet, ctx.phi_u, ctx.phi_p)  # (nc, nu, np)
    A = A2.new_zeros((A2.shape[0], nd + nu, nd + nu))
    A[:, :nd, :nd] = A2
    # spanwise viscous damping of the in-plane components
    A[:, :nud, :nud] += expand_vector_diag(-(beta * beta / re) * ms, g)
    # spanwise momentum: advection-diffusion + beta^2 damping
    A[:, nd:, nd:] = -conv - (stiff + (beta * beta) * ms) / re
    # z-momentum pressure gradient: + beta (p, w_test)
    A[:, nd:, nud:nd] = beta * mup
    # continuity: div2 u' + beta w'
    A[:, nud:nd, nd:] = beta * mup.transpose(1, 2)
    return A


def quasi3d_mass_elements(ctx: AssemblyContext) -> torch.Tensor:
    """Element mass: 2D velocity mass + the spanwise scalar mass."""
    nd, nu = ctx.ndofs_el, ctx.nu_el
    m2 = mass_elements(ctx)
    M = m2.new_zeros((m2.shape[0], nd + nu, nd + nu))
    M[:, :nd, :nd] = m2
    M[:, nd:, nd:] = mass_scalar(ctx)
    return M


def _q3_outlet_blocks(fc: FacetContext, ctx: AssemblyContext, re) -> torch.Tensor:
    """(nf, NE, NE) viscous-outlet facet blocks: the component-diagonal
    (u, v) term of the 2D operator (``fem.facets.viscous_outlet_*``) plus
    the same scalar block on the spanwise field (the w momentum equation
    integrates its in-plane Laplacian by parts over the same outflow
    boundary)."""
    nd, nu, g = ctx.ndofs_el, ctx.nu_el, ctx.gdim
    nud = nu * g
    gn = torch.einsum("fqjd,fd->fqj", fc.gphi_u, fc.normals)
    s = (1.0 / re) * torch.einsum("q,f,fqi,fqj->fij", fc.w, fc.detJf, fc.phi_u, gn)
    B = s.new_zeros((s.shape[0], nd + nu, nd + nu))
    B[:, :nud, :nud] = expand_vector_diag(s, g)
    B[:, nd:, nd:] = s
    return B


def quasi3d_operator_data(ctx: AssemblyContext, pattern: SparsityPattern, w: torch.Tensor, re,
                          beta, mask: torch.Tensor, outlets) -> torch.Tensor:
    """nnz data of A(beta) on the quasi-3D pattern: the cells' scatter,
    each outlet's facet blocks added at its slots, then identity
    Dirichlet rows and columns.  On the CPU the (u, v, p) block at
    beta = 0 is the 2D operator's data bit for bit."""
    data = assemble_csr_data(pattern, quasi3d_elements(ctx, w, re, beta))
    if outlets:  # summed and scaled in the order the 2D operator's outlet term is
        data = data + sum((1.0 / re) * torch.zeros_like(data).index_add_(
            0, slots, _q3_outlet_blocks(fc, ctx, 1.0).reshape(-1)) for fc, slots in outlets)
    return dirichlet_matrix_data(pattern, data, mask, 1.0)


def quasi3d_mass_data(ctx: AssemblyContext, pattern: SparsityPattern, mask: torch.Tensor,
                      diag: float) -> torch.Tensor:
    """nnz data of M on the quasi-3D pattern, ``diag`` on Dirichlet rows."""
    return dirichlet_matrix_data(
        pattern, assemble_csr_data(pattern, quasi3d_mass_elements(ctx)), mask, diag)


# ---------------------------------------------------------------------------
# Assembler
# ---------------------------------------------------------------------------


class SpanwiseStability:
    """Quasi-3D eigensystem builder: ``A(beta) x = sigma M x`` on the
    block space [2D mixed; spanwise velocity].

    ``device`` must be the assembly context's; the default ``"cuda"``
    raises without a usable GPU unless ``device="cpu"`` is passed.
    ``pattern`` (the quasi-3D sparsity), ``bc_mask`` and the outlets'
    slots are built here, once; :meth:`assemble_eigensystem` at any beta
    fills values on that pattern."""

    def __init__(self, ctx: AssemblyContext, base_flow, re: float,
                 bcs_pert: BoundaryConditions, mesh=None, mass_diag: float = 0.0, *,
                 device="cuda") -> None:
        device = resolve_device(device)
        if device.type != ctx.device.type:
            raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
        if ctx.gdim != 2:
            raise NotImplementedError("Spanwise-Fourier analysis is defined for 2D base flows.")
        self.ctx, self.re, self.bcs_pert, self.mesh = ctx, re, bcs_pert, mesh
        self.mass_diag = mass_diag
        spaces = ctx.spaces
        g = ctx.gdim
        self.n2 = spaces.num_dofs
        self.ns = spaces.num_velocity_dofs // g
        # super-element DOFs: the mixed cell DOFs + offset w nodes
        cell_u = np.asarray(spaces.velocity.cell_nodes, dtype=np.int64)
        super_dofs = np.concatenate([np.asarray(spaces.mixed_cell_dofs), cell_u + self.n2], axis=1)
        self.pattern: SparsityPattern = build_sparsity(
            super_dofs, shape=(self.n2 + self.ns, self.n2 + self.ns))
        mask2 = np.asarray(bcs_pert.dirichlet_mask, dtype=bool)
        mv = mask2[: spaces.num_velocity_dofs].reshape(-1, g)
        self.bc_mask = torch.as_tensor(np.concatenate([mask2, mv.all(axis=1)]), device=ctx.device)
        self.base_flow = torch.as_tensor(base_flow, dtype=torch.float64, device=ctx.device)
        outlets = tuple(getattr(bcs_pert, "outlet_markers", ()))
        if outlets and mesh is None:
            raise ValueError("Pressure-outlet perturbation BCs add a viscous-outlet facet term; "
                             "pass the mesh to build its facet contexts.")
        self._outlets = []
        for m in outlets:
            fc = build_facet_context(ctx, mesh, m)
            sup = np.concatenate([fc.cell_dofs.cpu().numpy(), cell_u[fc.parent_cells] + self.n2],
                                 axis=1)
            self._outlets.append((fc, torch.as_tensor(_pair_slots(self.pattern, sup),
                                                      device=ctx.device)))
        self._outlets = tuple(self._outlets)
        logger.info("SpanwiseStability: %d mixed + %d spanwise DOFs, %d nnz, %d outlet boundaries",
                    self.n2, self.ns, self.pattern.nnz, len(outlets))

    @property
    def num_dofs(self) -> int:
        return self.n2 + self.ns

    def operator_data(self, beta, state=None) -> torch.Tensor:
        """nnz data of A(beta) around the base flow (or ``state``)."""
        w = self.base_flow if state is None else torch.as_tensor(
            state, dtype=torch.float64, device=self.ctx.device)
        return quasi3d_operator_data(self.ctx, self.pattern, w, self.re, float(beta),
                                     self.bc_mask, self._outlets)

    def assemble_eigensystem(self, beta) -> tuple[CSRMatrix, CSRMatrix]:
        """(A(beta), M) on the shared quasi-3D pattern; Dirichlet rows get
        identity in A and ``mass_diag`` (default 0 = modes at infinity) in
        M, as in the 2D eigensystem."""
        A = CSRMatrix(self.pattern, self.operator_data(beta))
        M = CSRMatrix(self.pattern, quasi3d_mass_data(self.ctx, self.pattern, self.bc_mask,
                                                      self.mass_diag))
        return A, M

    def momentum_mask(self) -> np.ndarray:
        """All velocity rows (in-plane + spanwise) not under Dirichlet: the
        explicit-side restriction of a theta step."""
        mom = np.zeros(self.num_dofs, dtype=bool)
        mom[: self.ctx.spaces.num_velocity_dofs] = True
        mom[self.n2:] = True
        return mom & ~self.bc_mask.cpu().numpy()

    def embed(self, w2) -> np.ndarray:
        """Lift a 2D mixed vector into the quasi-3D space (w = 0)."""
        w2 = np.asarray(w2.cpu() if isinstance(w2, torch.Tensor) else w2)
        out = np.zeros(self.num_dofs, dtype=w2.dtype)
        out[: self.n2] = w2
        return out


def spanwise_floquet(span: SpanwiseStability, snapshots, dt: float, beta, *, theta: float = 0.5,
                     method: str = "banded", inexact: bool = True, device="cuda"):
    """Floquet solver for spanwise perturbations of a 2D periodic orbit,
    the secondary-instability calculation of Barkley & Henderson (JFM 322,
    1996): multipliers mu(beta) of the quasi-3D monodromy around the 2D
    cycle; |mu| > 1 at some beta marks the three-dimensional transition.

    ``snapshots``: (N, n2) 2D states over one period (those the 2D
    :class:`~lsafw_tpu_torch.floquet.FloquetSolver` takes); the returned
    solver acts on quasi-3D vectors ``[u, v, p; w]``.  The mass has zero
    Dirichlet rows.  ``inexact`` defaults to True (one cycle-mean factor),
    since the quasi-3D space is about 4/3 of the 2D one.  ``device`` must
    be ``span``'s; the default ``"cuda"`` raises without a usable GPU
    unless ``device="cpu"`` is passed."""
    from lsafw_tpu_torch.floquet import FloquetSolver

    device = resolve_device(device)
    if device.type != span.ctx.device.type:
        raise ValueError(f"device {device} is not the spanwise operator's {span.ctx.device}")
    Md = quasi3d_mass_data(span.ctx, span.pattern, span.bc_mask, 0.0)
    Jdata = [span.operator_data(beta, state=s) for s in snapshots]
    return FloquetSolver.from_operator_data(span.pattern, Md, Jdata, span.momentum_mask(), dt,
                                            theta=theta, method=method, inexact=inexact,
                                            device=device)
