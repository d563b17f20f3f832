"""Weakly nonlinear (Stuart-Landau) expansion about the Hopf point.

Counterpart of the reference's ``wnl`` module (Sipp & Lebedev 2007):
from the critical fixed point alone -- the baseflow at Re_c, the
marginal eigenpair, its adjoint and two forced linear solves -- predict
the weakly supercritical branch

  dA/dt = lambda'(Re - Re_c) A - mu |A|^2 A,

so A(Re) = 2 sqrt(Re(lambda)/Re(mu)) (global-energy norm) and
omega(Re) = omega_c + Im(lambda) - Im(mu) |A_wnl|^2.  With the dynamics
``M dv/dt = A v + B(v, v)``, ``B(a, b) = -1/2[(a.grad)b + (b.grad)a]``:

  order e^2, mean:      q20 = -A^{-1} 2 B(q1, q1*)
  order e^2, harmonic:  q22 = -(A - 2 i omega M)^{-1} B(q1, q1)
  order e^3, resonance: mu  = -2 a^H [ B(q1, q20) + B(q1*, q22) ]

with q1 the direct mode at unit global energy and a the adjoint mode
normalized a^H M q1 = 1, both from
:class:`~lsafw_tpu_torch.sensitivity.EigenSensitivitySolver`, which also
gives the total slope lambda' = d sigma / d Re.

Two choices differ from the reference:

* The forced solves run on the card where the reference factors A and
  A - 2 i omega M with a host ``splu``: ``ShiftInvertOperator(...,
  method="banded").solve_raw`` -- at sigma = 0 the real right-hand side
  stays real through the real pivoted factor (K1/K2 f32, one column), at
  2 i omega a complex factor.  Each factor is freed after its solve, so
  that the sensitivity solver's factors and these two are never alive
  at once.  A refused factor raises
  :class:`~lsafw_tpu_torch.solver.eigen.FactorUnusable` (an offset shift
  would solve another system), and a refinement that misses its
  tolerance raises.  ``si_method="lu"`` (asked for only) solves both
  with the host SuperLU of the same operators.
* ``si_method`` and ``find_critical_re``'s ``linear_solver`` default to
  ``"banded"`` (the reference: ``"lu"``).

Vectors are device tensors: q1, q20 and q22 complex128 / f64 on the
assembly context's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import AssemblyContext, scatter_vector
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
)
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver, _grad_u_at_qp, _u_at_qp
from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
from lsafw_tpu_torch.solver.eigen import (
    EigenSolver,
    EigensolverConfig,
    ShiftInvertOperator,
    STType,
)
from lsafw_tpu_torch.solver.newton import NewtonSolver
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_TARGET = 0.0 + 0.75j  # the cylinder's Hopf band


def convective_bilinear_load(ctx: AssemblyContext, a, b) -> torch.Tensor:
    """B(a, b) = -1/2 [(a.grad)b + (b.grad)a] tested against velocity test
    functions, scattered to the mixed vector (zero pressure rows).

    Complex inputs are evaluated in complex128 directly (the form is
    bilinear, not sesquilinear: no conjugate).  ``B(q, q*)`` is real;
    ``B(v, v) = -(v.grad)v`` is the quadratic convection residual."""
    a, b = torch.as_tensor(a, device=ctx.device), torch.as_tensor(b, device=ctx.device)
    dtype = torch.complex128 if (a.is_complex() or b.is_complex()) else torch.float64
    a, b = a.to(dtype), b.to(dtype)
    uqa, gqa = _u_at_qp(ctx, a), _grad_u_at_qp(ctx, a)
    uqb, gqb = _u_at_qp(ctx, b), _grad_u_at_qp(ctx, b)
    convq = 0.5 * (torch.einsum("cqe,cqde->cqd", uqa, gqb)
                   + torch.einsum("cqe,cqde->cqd", uqb, gqa))
    wdet = (ctx.w[None, :] * ctx.detJ[:, None]).to(dtype)
    r_v = -torch.einsum("cq,qi,cqd->cid", wdet, ctx.phi_u.to(dtype), convq)
    el = torch.zeros((ctx.detJ.shape[0], ctx.ndofs_el), dtype=dtype, device=ctx.device)
    el[:, : ctx.nu_el * ctx.gdim] = r_v.reshape(r_v.shape[0], -1)
    return scatter_vector(ctx, el)


@dataclass
class WNLResult:
    """Stuart-Landau model coefficients and predictors."""

    re_c: float
    omega_c: float
    lambda_p: complex  # total d sigma / d Re at criticality
    mu: complex  # Landau coefficient (Re(mu) > 0: supercritical)
    q1: torch.Tensor  # marginal mode, unit global energy
    q20: torch.Tensor  # mean-flow correction field (per |A_wnl|^2)
    q22: torch.Tensor  # second-harmonic field (per A_wnl^2)
    baseflow: torch.Tensor = field(repr=False, default=None)

    def x_wnl(self, re: float) -> float:
        """|A_wnl|^2 of the expansion variable at ``re`` (0 below onset)."""
        lam_r = self.lambda_p.real * (re - self.re_c)
        return max(lam_r / self.mu.real, 0.0)

    def amplitude(self, re: float) -> float:
        """Saturated amplitude in the global-energy convention of the
        self-consistent model (A_scm = 2 A_wnl)."""
        return 2.0 * float(np.sqrt(self.x_wnl(re)))

    def frequency(self, re: float) -> float:
        """Saturated limit-cycle frequency at ``re``."""
        return (self.omega_c + self.lambda_p.imag * (re - self.re_c)
                - self.mu.imag * self.x_wnl(re))

    def mean_flow(self, re: float, baseflow_sens=None) -> torch.Tensor:
        """Predicted saturated mean flow at ``re``: critical base +
        amplitude-squared distortion (+ the Re drift when the baseflow
        sensitivity dU/dRe is supplied)."""
        U = self.baseflow + self.x_wnl(re) * self.q20
        if baseflow_sens is not None:
            U = U + (re - self.re_c) * torch.as_tensor(baseflow_sens, device=U.device)
        return U


def _forced_solve(A: CSRMatrix, M: CSRMatrix, shift: complex, b: torch.Tensor, *,
                  method: str, tol: float = 1e-10) -> torch.Tensor:
    """x = (A - shift M)^-1 b on one factor made for this solve and freed
    after it: the band factor (a real one at a real shift, where an f64 b
    stays f64) with GCR refinement, or the host SuperLU (``"lu"``).  A
    banded solve whose relative residual misses 100 ``tol`` raises."""
    op = ShiftInvertOperator(A, M, shift, method=method, inner_tol=tol)
    x = op.solve_raw(b)
    del op
    if method == "banded":
        r = spmv(A, x) - (shift.real if not x.is_complex() else shift) * spmv(M, x) - b
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b).clamp_min(1e-300))
        if not rel <= 100 * tol:
            raise RuntimeError(f"forced solve at shift {shift}: relative residual {rel:.2e} "
                               f"(tol {tol:.0e})")
    return x


def weakly_nonlinear(
    ctx: AssemblyContext,
    mesh,
    bcs,
    bcs_pert,
    re_c: float,
    baseflow,
    *,
    target: complex | None = None,
    si_method: str = "banded",
    device="cuda",
) -> WNLResult:
    """Compute the Stuart-Landau coefficients at the Hopf point.

    ``re_c``/``baseflow``: the critical Reynolds number and its fixed
    point (find them with :func:`find_critical_re`).  ``target``: shift
    for the marginal eigenpair (default 0 + 0.75j, the cylinder band).
    ``device`` must be the assembly context's; the default ``"cuda"``
    raises without a usable GPU unless ``device="cpu"`` is passed."""
    device = resolve_device(device)
    sens = EigenSensitivitySolver(
        ctx, mesh, bcs, baseflow, re_c, perturbation_bcs=bcs_pert,
        target=target if target is not None else DEFAULT_TARGET, si_method=si_method,
        device=device)
    sigma, v = sens.solve_direct_mode()
    if sigma.imag < 0:  # fix the +omega branch before the adjoint
        sigma, v = sigma.conjugate(), v.conj()
    A, M = sens._A, sens._M
    energy = float(torch.vdot(v, spmv(M, v)).real)
    q1 = v / np.sqrt(energy)
    a = sens.solve_adjoint_mode(sigma, q1)  # a^H M q1 = 1
    # (q1, a) passed explicitly: the +omega branch may be the conjugate of
    # what solve_direct_mode stored
    lambda_p = complex(sens.evaluate_sensitivity(
        v=q1, a=a, baseflow_sens=sens.compute_baseflow_sensitivity()))
    omega_c = float(sigma.imag)
    if abs(sigma.real) > 0.2 * abs(lambda_p.real):
        logger.warning("WNL expansion point is not marginal (sigma_r = %.3e vs lambda'_r = "
                       "%.3e): Re_c is off by ~%.2f.", sigma.real, lambda_p.real,
                       sigma.real / lambda_p.real)
    mask_p = torch.as_tensor(np.asarray(bcs_pert.dirichlet_mask, dtype=bool), device=ctx.device)

    # order e^2: mean distortion (a real solve on the marginal operator,
    # nonsingular: 0 is not an eigenvalue at a Hopf point)
    rhs20 = 2.0 * convective_bilinear_load(ctx, q1, q1.conj()).real
    rhs20 = torch.where(mask_p, torch.zeros_like(rhs20), rhs20)
    q20 = -_forced_solve(A, M, 0.0, rhs20, method=si_method)

    # order e^2: second harmonic (a complex solve at shift 2 i omega,
    # nonsingular unless 2 i omega is itself an eigenvalue: a 1:2
    # resonance, which generic Hopf points do not have)
    rhs22 = convective_bilinear_load(ctx, q1, q1)
    rhs22 = torch.where(mask_p, torch.zeros_like(rhs22), rhs22)
    q22 = -_forced_solve(A, M, 2j * omega_c, rhs22, method=si_method)

    # order e^3 resonance: project the slow forcing on the adjoint
    f31 = convective_bilinear_load(ctx, q1, q20) + convective_bilinear_load(ctx, q1.conj(), q22)
    mu = complex(-2.0 * torch.vdot(a, f31))
    logger.info("WNL at Re_c = %.3f: omega_c = %.5f, lambda' = %+.4e %+.4e j, mu = %+.4e %+.4e j "
                "(%s bifurcation)", re_c, omega_c, lambda_p.real, lambda_p.imag, mu.real,
                mu.imag, "supercritical" if mu.real > 0 else "SUBCRITICAL")
    return WNLResult(re_c, omega_c, lambda_p, mu, q1, q20, q22,
                     baseflow=torch.as_tensor(baseflow, dtype=torch.float64, device=ctx.device))


def find_critical_re(
    ctx: AssemblyContext,
    mesh,
    bcs,
    bcs_pert,
    re_lo: float,
    re_hi: float,
    *,
    target: complex | None = None,
    tol: float = 1e-3,
    max_it: int = 12,
    linear_solver: str = "banded",
    si_method: str = "banded",
    device="cuda",
) -> tuple[float, np.ndarray, complex]:
    """Locate the Hopf point by a secant on sigma_r(Re).

    ``[re_lo, re_hi]`` must bracket the onset (sigma_r changes sign).
    Returns (Re_c, baseflow at Re_c, marginal sigma).  Each iteration is
    one baseflow Newton (warm-started along the branch) plus one
    eigensolve started from the last marginal vector.  ``device`` as
    :func:`weakly_nonlinear`'s."""
    device = resolve_device(device)
    if device.type != ctx.device.type:
        raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
    tgt = target if target is not None else DEFAULT_TARGET
    w = None
    v0 = None

    def sigma_at(re: float):
        nonlocal w, v0
        if w is None:
            w = np.asarray(BaseFlowSolver(ctx, mesh, bcs, re=re).solve(
                ramp=True, steps=4, tol=1e-10, max_it=40, linear_solver=linear_solver))
        else:  # warm start along the branch
            res = NewtonSolver(StationaryNavierStokesAssembler(ctx, mesh, bcs),
                               linear_solver=linear_solver).solve(w, re, tol=1e-10, max_it=30)
            w = np.asarray(res.w)
        A, M = LinearizedNavierStokesAssembler(w, ctx, re, bcs_pert, mesh).assemble_eigensystem()
        es = EigenSolver(A, M, EigensolverConfig(num_eig=2, atol=1e-9))
        es.set_st_type(STType.SINVERT)
        es.set_target(tgt)
        es.set_st_pc_type(si_method)
        if v0 is not None:
            es.set_initial_vector(v0)
        pairs = es.solve()
        sigma, v = max(
            ((lam.conjugate(), np.conj(vv)) if lam.imag < 0 else (lam, vv) for lam, vv in pairs),
            key=lambda p: p[0].real)
        v0 = v
        return sigma

    r0, r1 = float(re_lo), float(re_hi)
    s0 = sigma_at(r0)
    s1 = sigma_at(r1)
    if s0.real * s1.real > 0:
        raise ValueError(f"[{re_lo}, {re_hi}] does not bracket the onset: "
                         f"sigma_r = {s0.real:.3e}, {s1.real:.3e}")
    for _ in range(max_it):
        r2 = r1 - s1.real * (r1 - r0) / (s1.real - s0.real)
        s2 = sigma_at(r2)
        logger.info("find_critical_re: Re = %.4f, sigma_r = %+.3e", r2, s2.real)
        r0, s0, r1, s1 = r1, s1, r2, s2
        if abs(s1.real) < tol * max(abs(s1.imag), 1e-3):
            break
    return r1, w, s1
