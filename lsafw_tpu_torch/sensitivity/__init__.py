"""Adjoint-based eigenvalue sensitivity.

Counterpart of the reference's ``sensitivity`` module: the direct
eigenpair near a target, the adjoint (left) eigenpair of (A^T, M^T) near
conj(sigma), the baseflow sensitivity du/dRe from a steady-Jacobian
solve, the total derivative d sigma / d Re = explicit + implicit
(base-flow convection) terms, and the structural-sensitivity
"wavemaker" field Sw(x) = |u_adj(x)| |u(x)| / |<u_adj, u>| (Fabre et al.
AMR 2019).

A and M are real, so the Hermitian transpose is the plain transpose
(:func:`~lsafw_tpu_torch.ops.sparse.transpose_pair`: on a structurally
symmetric pattern both transposes stay on the original pattern object,
and the adjoint shares its RCM ordering, band plans and permuted-CSR
plan).  Vectors live on the device: the eigenvectors as complex128
tensors, du/dRe and the wavemaker as f64 tensors; every scalar form is
an f64 einsum there, returned as a Python scalar.

Two choices differ from the reference:

* ``si_method``: the default is ``"banded"``, the device shift-invert
  path (band factor and f64 refinement, through the CUDA kernels on the
  card).  The reference's default ``"lu"`` (a host SuperLU of the
  shifted operator, and a host ``SparseLU`` of J for du/dRe) runs when it
  is asked for.
* With ``"banded"`` the du/dRe solve ``J s = r`` runs on the device
  through the banded route of the Newton steps (``solver/newton.py``
  ``banded_solve``: J's cached real band plan, the real pivoted factor
  and ``_banded_mr`` GCR), to ``tol`` where given, else
  ``tol_baseflow``; the reference solves it with a host ``SparseLU`` and
  ignores ``tol``, as ``"lu"`` does here.  A banded solve that misses
  its tolerance raises.

A target on an exact eigenvalue (the usual call, target = sigma) makes
the band factor at the target singular to working precision; the
eigensolver then retries at the offset shift 1e-3 (1 + |target|), on the
card (``solver/eigen.py`` ``FactorUnusable``).  Without a target the
direct mode needs a spectral transform other than shift-invert, which
the port lacks (ROADMAP item 11): it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import AssemblyContext, SpaceContext, mass_scalar, scatter_vector
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
)
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv, transpose_pair
from lsafw_tpu_torch.solver.band import plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
from lsafw_tpu_torch.solver.linear import SolveResult, cg
from lsafw_tpu_torch.solver.newton import banded_solve, new_stats
from lsafw_tpu_torch.solver.precond import jacobi
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Real scalar forms (device): the building blocks of the sesquilinear forms
# ---------------------------------------------------------------------------


def _vec(ctx, w) -> torch.Tensor:
    return torch.as_tensor(w, device=ctx.device)


def _u_at_qp(ctx: AssemblyContext, w) -> torch.Tensor:
    """(nc, nq, gdim) velocity of a mixed vector at the quadrature points."""
    u = _vec(ctx, w)[: ctx.spaces.velocity.num_dofs].reshape(-1, ctx.gdim)
    return torch.einsum("qi,cid->cqd", ctx.phi_u.to(u.dtype), u[ctx.cell_nodes_u])


def _grad_u_at_qp(ctx: AssemblyContext, w) -> torch.Tensor:
    """(nc, nq, gdim, gdim) velocity gradient d u_d / d x_e at the
    quadrature points."""
    u = _vec(ctx, w)[: ctx.spaces.velocity.num_dofs].reshape(-1, ctx.gdim)
    return torch.einsum("cid,cqie->cqde", u[ctx.cell_nodes_u], ctx.phys_grad_u().to(u.dtype))


def _wdet(ctx: AssemblyContext) -> torch.Tensor:
    return ctx.w[None, :] * ctx.detJ[:, None]


def grad_inner_integral(ctx: AssemblyContext, w1, w2) -> float:
    """integral <grad u1, grad u2> dx for real mixed vectors."""
    return float(torch.einsum("cq,cqde,cqde->", _wdet(ctx), _grad_u_at_qp(ctx, w1),
                              _grad_u_at_qp(ctx, w2)))


def convection_integral(ctx: AssemblyContext, wm, w1, w2) -> float:
    """integral <(u_m . grad) u1, u2> dx for real mixed vectors."""
    return float(torch.einsum("cq,cqe,cqde,cqd->", _wdet(ctx), _u_at_qp(ctx, wm),
                              _grad_u_at_qp(ctx, w1), _u_at_qp(ctx, w2)))


def velocity_inner_integral(ctx: AssemblyContext, w1, w2) -> float:
    """integral <u1, u2> dx."""
    return float(torch.einsum("cq,cqd,cqd->", _wdet(ctx), _u_at_qp(ctx, w1), _u_at_qp(ctx, w2)))


def _sesquilinear(real_form, a, v, *args) -> complex:
    """I(conj(a), v) for a real-bilinear integrand: four real evaluations
    combined as [I(ar,vr)+I(ai,vi)] + i [I(ar,vi)-I(ai,vr)]."""
    a, v = torch.as_tensor(a, dtype=torch.complex128), torch.as_tensor(v, dtype=torch.complex128)
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    vr, vi = v.real.contiguous(), v.imag.contiguous()
    re = real_form(*args, ar, vr) + real_form(*args, ai, vi)
    im = real_form(*args, ar, vi) - real_form(*args, ai, vr)
    return complex(re, im)


# ---------------------------------------------------------------------------
# Sensitivity solver
# ---------------------------------------------------------------------------


class EigenSensitivitySolver:
    """Eigenvalue sensitivity d sigma / d Re via adjoint modes.

    ``device`` must be the assembly context's device; the default
    ``"cuda"`` raises without a usable GPU unless ``device="cpu"`` is
    passed.  After a run, ``sigma_adjoint`` holds the adjoint eigenvalue,
    ``operators`` the shift-invert factor's figures per stage
    (``"direct"``, ``"adjoint"``), ``stats`` the du/dRe solve's band
    counters (:func:`~lsafw_tpu_torch.solver.newton.new_stats`),
    ``baseflow_solve`` and ``wavemaker_cg`` the two linear solves'
    :class:`~lsafw_tpu_torch.solver.linear.SolveResult`."""

    def __init__(
        self,
        ctx: AssemblyContext,
        mesh: Mesh,
        bcs: BoundaryConditions,
        baseflow,
        re: float,
        *,
        A: CSRMatrix | None = None,
        M: CSRMatrix | None = None,
        perturbation_bcs: BoundaryConditions | None = None,
        target: complex | None = None,
        tol_direct: float = 1e-9,
        tol_adjoint: float = 1e-8,
        tol_baseflow: float = 1e-10,
        max_it: int = 200,
        max_modes: int = 5,
        si_method: str = "banded",
        device="cuda",
    ) -> None:
        device = resolve_device(device)
        if device.type != ctx.device.type:
            raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
        if si_method not in ("banded", "lu"):
            raise NotImplementedError(
                f"si_method={si_method!r}: the ported methods are 'banded' and 'lu'")
        self._ctx = ctx
        self._mesh = mesh
        self._bcs = bcs
        self._pert_bcs = perturbation_bcs or bcs.homogeneous()
        self._baseflow = torch.as_tensor(baseflow, dtype=torch.float64, device=ctx.device)
        self._re = re
        self._target = target
        self._tol_direct = tol_direct
        self._tol_adjoint = tol_adjoint
        self._tol_baseflow = tol_baseflow
        self._max_it = max_it
        self._max_modes = max_modes
        self._si_method = si_method
        if A is None or M is None:
            asm = LinearizedNavierStokesAssembler(self._baseflow, ctx, re, self._pert_bcs, mesh)
            A, M = asm.assemble_eigensystem()
        self._A, self._M = A, M
        self._sigma: complex | None = None
        self._v: torch.Tensor | None = None  # direct eigenvector (complex128)
        self._a: torch.Tensor | None = None  # adjoint eigenvector (complex128)
        self._baseflow_sens: torch.Tensor | None = None
        self.sigma_adjoint: complex | None = None
        self.operators: dict = {}
        self.stats = new_stats()
        self.baseflow_solve: SolveResult | None = None
        self.wavemaker_cg: SolveResult | None = None
        logger.info("Initialized eigenvalue sensitivity solver for Re = %.2f", re)

    def _eigensolve(self, A: CSRMatrix, M: CSRMatrix, atol: float, shift: complex,
                    stage: str) -> list:
        es = EigenSolver(A, M, EigensolverConfig(num_eig=self._max_modes, atol=atol,
                                                 max_it=self._max_it))
        es.set_st_type(STType.SINVERT)
        es.set_st_pc_type(self._si_method)
        es.set_target(shift)
        pairs = es.solve()
        if not pairs:
            raise RuntimeError(f"No eigenpairs returned by the {stage} eigensolver.")
        op = es.operator
        self.operators[stage] = op.figures()
        return pairs

    def _cvec(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.complex128, device=self._ctx.device)

    # --- direct mode ---
    def solve_direct_mode(self, target: complex | None = None) -> tuple[complex, torch.Tensor]:
        target = target if target is not None else self._target
        if target is None:
            raise NotImplementedError(
                "the direct mode without a target needs a spectral transform other than "
                "shift-invert, which is not ported (ROADMAP item 11): pass a target")
        pairs = self._eigensolve(self._A, self._M, self._tol_direct, target, "direct")
        sigma, v = min(pairs, key=lambda p: abs(p[0] - target))
        self._sigma, self._v = sigma, self._cvec(v)
        logger.info("Direct eigenpair: sigma = %.4e %+.4e j", sigma.real, sigma.imag)
        return sigma, self._v

    # --- adjoint mode ---
    def solve_adjoint_mode(self, sigma: complex | None = None, v=None) -> torch.Tensor:
        sigma = sigma if sigma is not None else self._sigma
        v = v if v is not None else self._v
        if sigma is None or v is None:
            raise RuntimeError("Direct eigenpair must be computed before adjoint solve.")
        A_T, M_T = transpose_pair(self._A, self._M)
        # conj(sigma) is an exact eigenvalue of A^T: a shift exactly there
        # makes the factor singular to working precision and pollutes the
        # eigenvector, so the shift is offset slightly
        offset = 1e-3 * (1.0 + abs(sigma))
        pairs = self._eigensolve(A_T, M_T, self._tol_adjoint, np.conj(sigma) + offset, "adjoint")
        sig_adj, a = min(pairs, key=lambda p: abs(p[0] - np.conj(sigma)))
        a, v = self._cvec(a), self._cvec(v)
        prod = complex(torch.vdot(a, spmv(self._M, v)))  # a^H M v, bi-orthonormal: = 1
        if prod == 0:
            raise RuntimeError("Bi-orthonormal normalization failed (a^H M v = 0).")
        a = a / np.conj(prod)
        self._a, self.sigma_adjoint = a, sig_adj
        logger.info("Adjoint eigenpair computed (sigma* = %.4e %+.4e j).", sig_adj.real,
                    sig_adj.imag)
        return a

    # --- baseflow sensitivity ---
    def baseflow_sensitivity_system(self) -> tuple[CSRMatrix, torch.Tensor]:
        """(J, r) of the du/dRe solve J s = r: the steady Jacobian at the
        baseflow, and r = -(1/Re^2) <grad u_base, grad v_test> with zero
        Dirichlet rows (the boundary values do not depend on Re)."""
        ctx = self._ctx
        J = StationaryNavierStokesAssembler(ctx, self._mesh, self._bcs).jacobian(
            self._baseflow, self._re)
        r_v = -(1.0 / self._re**2) * torch.einsum(
            "cq,cqde,cqie->cid", _wdet(ctx), _grad_u_at_qp(ctx, self._baseflow),
            ctx.phys_grad_u())
        nc = r_v.shape[0]
        el = torch.zeros((nc, ctx.ndofs_el), dtype=r_v.dtype, device=ctx.device)
        el[:, : ctx.nu_el * ctx.gdim] = r_v.reshape(nc, -1)
        rhs = scatter_vector(ctx, el)
        mask = torch.as_tensor(self._bcs.dirichlet_mask, device=ctx.device)
        return J, torch.where(mask, torch.zeros_like(rhs), rhs)

    def compute_baseflow_sensitivity(self, tol: float | None = None) -> torch.Tensor:
        J, rhs = self.baseflow_sensitivity_system()
        if self._si_method == "lu":
            logger.info("Solving baseflow sensitivity linear system (steady Jacobian, host LU).")
            x = torch.as_tensor(SparseLU(J).solve(rhs.cpu().numpy()), device=rhs.device)
            r = float(torch.linalg.vector_norm(spmv(J, x) - rhs) / torch.linalg.vector_norm(rhs))
            self.baseflow_solve = SolveResult(x, 1, r, True)
            self._baseflow_sens = x
            return x
        tol = tol if tol is not None else self._tol_baseflow
        logger.info("Solving baseflow sensitivity linear system (steady Jacobian, banded).")
        res = banded_solve(J, rhs, plan_for_csr(J, real=True), tol=tol, stats=self.stats)
        self.baseflow_solve = res
        if not (res.converged and bool(torch.isfinite(res.x).all())):
            raise RuntimeError(f"baseflow sensitivity solve stalled: relative residual "
                               f"{res.residual:.2e} after {res.iterations} iterations (tol "
                               f"{tol:.0e})")
        self._baseflow_sens = res.x
        return res.x

    # --- total sensitivity ---
    def evaluate_sensitivity(self, re: float | None = None, v=None, a=None,
                             baseflow_sens=None) -> complex:
        re_val = re if re is not None else self._re
        v = v if v is not None else self._v
        a = a if a is not None else self._a
        s = baseflow_sens if baseflow_sens is not None else self._baseflow_sens
        if v is None or a is None or s is None:
            raise RuntimeError(
                "Direct mode, adjoint mode, and baseflow sensitivity are required "
                "to evaluate d sigma/d Re.")
        ctx = self._ctx
        v, a = self._cvec(v), self._cvec(a)
        # with F-residual conventions (A = dF/dw, viscous term of F
        # -(1/Re) <grad u, grad v>):
        #   d sigma/dRe = a^H (dA/dRe) v + a^H (dA/dU . u_Re) v
        # explicit: dA/dRe = +(1/Re^2) K -> +(1/Re^2) <grad v, grad conj(a)>
        d_exp = (1.0 / re_val**2) * _sesquilinear(
            lambda x, y: grad_inner_integral(ctx, x, y), a, v)
        # implicit: dA/dU in the direction u_Re applied to v is
        # -[(u_Re . grad) v + (v . grad) u_Re]
        sr = torch.as_tensor(s, device=ctx.device).real

        def base_term(x, y):
            # x plays the conj(a) component, y the v component
            return convection_integral(ctx, sr, y, x) + convection_integral(ctx, y, sr, x)

        return d_exp - _sesquilinear(base_term, a, v)

    def evaluate(self, target: complex | None = None) -> complex:
        """Direct mode, adjoint mode, du/dRe, then d sigma / d Re."""
        self.solve_direct_mode(target=target)
        self.solve_adjoint_mode()
        self.compute_baseflow_sensitivity()
        d_sigma = self.evaluate_sensitivity()
        logger.info("Computed eigenvalue sensitivity: %.4e %+.4e j.", d_sigma.real, d_sigma.imag)
        return d_sigma

    # --- wavemaker ---
    def compute_wavemaker(self, *, v=None, a=None) -> torch.Tensor:
        """Sw on the pressure space (L2 projection of the quadrature-point
        field by Jacobi-preconditioned CG on the P1 mass matrix), packed
        into a mixed vector whose velocity slots are 0."""
        v = v if v is not None else self._v
        a = a if a is not None else self._a
        if v is None or a is None:
            raise RuntimeError("Compute direct and adjoint modes before Sw.")
        ctx = self._ctx
        v, a = self._cvec(v), self._cvec(a)
        denom_abs = abs(_sesquilinear(lambda x, y: velocity_inner_integral(ctx, x, y), a, v))
        if denom_abs == 0.0:
            raise RuntimeError("Denominator <u_adj, u> = 0; normalization issue.")
        a2 = _u_at_qp(ctx, a.real) ** 2 + _u_at_qp(ctx, a.imag) ** 2
        v2 = _u_at_qp(ctx, v.real) ** 2 + _u_at_qp(ctx, v.imag) ** 2
        sw_qp = torch.sqrt(a2.sum(-1)) * torch.sqrt(v2.sum(-1)) / denom_abs  # (nc, nq)
        pctx = SpaceContext.build(ctx.spaces.pressure, device=ctx.device)
        # the mixed rule samples Sw for the right-hand side
        rhs = pctx.scatter_vec(torch.einsum("cq,qk,cq->ck", _wdet(ctx), ctx.phi_p, sw_qp))
        Mp = pctx.scatter(mass_scalar(pctx))
        res = cg(lambda x: spmv(Mp, x), rhs, tol=1e-12, maxiter=2000, M=jacobi(Mp))
        self.wavemaker_cg = res
        if not res.converged:
            logger.warning("Wavemaker projection: CG stopped at relative residual %.2e.",
                           res.residual)
        out = torch.zeros(ctx.spaces.num_dofs, dtype=torch.float64, device=ctx.device)
        out[torch.as_tensor(ctx.spaces.dofs_p, device=ctx.device)] = res.x
        return out
