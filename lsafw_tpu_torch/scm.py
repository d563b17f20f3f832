"""Self-consistent mean-flow model (Mantic-Lugo, Arratia & Gallaire 2014).

Counterpart of the reference's ``scm`` module.  It predicts the
saturated limit cycle -- mean flow, oscillation frequency and amplitude
-- without time integration: the saturated mean is the flow whose
leading eigenvalue is marginal, and the Reynolds stress that drives it
comes from the marginal mode itself.

Unknowns (U, q_hat, A, omega), equations:

  1. mean:    R(U) + A^2 L(q_hat) = 0, with
     L_v = -1/2 [(u_r . grad) u_r + (u_i . grad) u_i] tested against
     velocity test functions (the phase-averaged Reynolds-stress
     divergence of the first harmonic);
  2. mode:    J(U) q_hat = sigma M q_hat, ||u_hat||_E = 1;
  3. closure: sigma_r = 0 selects the amplitude A.

:meth:`SelfConsistentModel.solve` alternates (mean Newton with the
frozen-mode load) and (eigensolve about the new mean, warm-started),
driving sigma_r(A) to zero by a guarded secant on A, with the
reference's robustness stack: the damping ladder and load continuation
of the mean Newton, the coupled relaxation past the fold of the
frozen-load branch, Re-continuation (:func:`scm_continuation`), the
wall acceptance and the Stuart-Landau amplitude ``amplitude_sl``.
:meth:`SelfConsistentModel.solve_coupled` is the monolithic Newton on
(U, q, omega) -- harmonic balance of order 1 (HB1) or 2 (HB2) -- whose
every coupling block is the one convective-linearization matrix C(b)
(:func:`~lsafw_tpu_torch.models.navier_stokes.convective_linearization_data`).

Choices that differ from the reference:

* ``linear_solver`` and ``si_method`` default to ``"banded"`` (the
  reference: ``"lu"``): the mean Newton's real band factors and the
  eigensolves' complex band factors on the card.  ``"lu"`` (asked for
  only) takes the host SuperLU, and then the coupled Newton's bordered
  system is solved by a host ``splu`` as well.
* A mean Newton trial whose banded step misses its refinement
  (:class:`~lsafw_tpu_torch.solver.newton.BandedStepMissed`) is a failed
  trial: the damping ladder goes on to its next rung, then to load
  continuation, and the mean solve returns None as for an unconverged
  Newton (the reference degrades that Newton solve to a host LU, which
  returns unconverged where Newton diverges).
* The coupled Newton runs on the card.  Its principal block K0 is
  assembled on the device from the block data on a pattern built once
  per model and harmonic order
  (:class:`~lsafw_tpu_torch.ops.sparse.BlockPattern`: every block of K0
  has the assembly pattern, so K0's pattern is fixed and its band plan
  and S's plan are made once, per pattern, and refilled every Newton
  iteration).  :func:`_bordered_gcr` runs GCR(16) on the full
  bordered system [[K0, c], [r^T, 0]], preconditioned by the real band
  factor of K0 (``factor_auto``; K1/K2 pivoted f32, one column), with
  K0's matvecs through S.  There is no device switch and no host
  fallback: a GCR that stalls above a relative residual of 1e-8 takes one
  more pass on its true residual, and where that misses too, raises
  :class:`~lsafw_tpu_torch.solver.eigen.FactorUnusable` (the reference's
  acceptance of an inexact solve under 1e-8 is kept).
* HB2's default q2 seed, (A - 2 i omega M) q2 = -1/2 B(q1, q1), is a
  forced solve on a complex band factor freed after it
  (:func:`~lsafw_tpu_torch.wnl._forced_solve`), where the reference
  factors it with a host ``splu``.

The alternation keeps its states on the host in numpy (as the
eigensolver's vectors are); the coupled Newton's residuals, Jacobian
blocks and solves are device tensors on the assembly context's device.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import AssemblyContext, scatter_vector
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
    convective_linearization_data,
)
from lsafw_tpu_torch.ops.bcsr import operator_for_budget
from lsafw_tpu_torch.ops.sparse import BlockPattern, CSRMatrix, rows_kept, spmv
from lsafw_tpu_torch.sensitivity import _grad_u_at_qp, _u_at_qp
from lsafw_tpu_torch.solver.band import factor_auto, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, FactorUnusable, STType
from lsafw_tpu_torch.solver.linear import SolveResult
from lsafw_tpu_torch.solver.newton import BandedStepMissed, NewtonSolver
from lsafw_tpu_torch.utils.logging import get_logger
from lsafw_tpu_torch.wnl import _forced_solve, convective_bilinear_load

logger = get_logger(__name__)

INEXACT_ACCEPT = 1e-8  # a bordered solve under this relative residual is accepted
# Ridge of K0's band factor, relative to each diagonal block's mean |diagonal|
# (``factor_auto``'s ``delta``): at the coupled root K0 is singular (the
# phase rotation of q is in its kernel), and an f32 factor's near-zero pivot
# there sends GCR's directions to a gain of up to 1/eps; the ridge bounds
# that gain, so that the bordered GCR converges in a few more iterations
# instead of stalling.
BORDER_RIDGE = 1e-4


@dataclass
class SCMResult:
    amplitude: float
    sigma: complex  # final mean-flow eigenvalue (sigma_r ~ 0)
    mean: np.ndarray
    mode: np.ndarray  # complex, unit energy
    converged: bool
    history: list = field(default_factory=list)  # (A, sigma_r, omega)
    # Stuart-Landau zero-crossing extrapolation of the amplitude when the
    # march is wall-limited below marginality; None when the root was
    # reached
    amplitude_sl: float | None = None
    # second-harmonic field (solve_coupled with harmonics=2 only)
    q2: np.ndarray | None = None


# ---------------------------------------------------------------------------
# The bordered GCR
# ---------------------------------------------------------------------------


def _bordered_gcr(K0: CSRMatrix, blu, c: torch.Tensor, r: torch.Tensor, f: torch.Tensor,
                  g: float, Jop=None, *, tol: float, max_its: int = 400,
                  m: int = 16, z0: torch.Tensor | None = None) -> SolveResult:
    """GCR(m) on the full bordered system [[K0, c], [r^T, 0]] with the band
    factor of K0 (the border passed through) as preconditioner.

    K0 is nearly singular at the converged marginal point (that is why
    the system is bordered), so Schur bordering through K0^-1 is
    ill-conditioned; iterating on the full system keeps the border's
    regularization in every step -- the factor's weak subspace (the
    marginal complex pair) costs GCR a couple of extra directions.  At the
    root the factor's gain in K0's null direction sets a floor under the
    relative residual; once under ``INEXACT_ACCEPT`` the iteration stops
    where 32 iterations have not halved it (the caller accepts such a solve
    as inexact, as it would after ``max_its``).  One band solve and one K0
    matvec (S, through ``Jop``) an iteration, and one host synchronisation
    for the stop test.  ``z0`` is a solution to continue from (the first
    step, the factor's solve of f and g, is then taken on z0's true
    residual)."""
    dev = f.device

    def kmv(x, y):
        Kx = (Jop.matvec(x) if Jop is not None else spmv(K0, x)) + c * y
        return Kx, torch.dot(r, x)

    y0 = torch.as_tensor(float(g), dtype=torch.float64, device=dev)
    bnorm = max(float(torch.sqrt(torch.dot(f, f) + y0 * y0)), 1e-300)
    x, y = blu.solve(f), y0.clone()
    if z0 is not None:  # the same first step, on z0's true residual
        Kx, kx = kmv(z0[:-1], z0[-1])
        x, y = z0[:-1] + blu.solve(f - Kx), z0[-1] + y0 - kx
    Kx, kx = kmv(x, y)
    rr, rs = f - Kx, y0 - kx
    n = f.shape[0]
    D = torch.zeros((m, n), dtype=torch.float64, device=dev)
    Ds = torch.zeros(m, dtype=torch.float64, device=dev)
    CD = torch.zeros_like(D)
    CDs = torch.zeros_like(Ds)
    k = 0
    rn = float(torch.sqrt(torch.dot(rr, rr) + rs * rs))
    hist = [rn]
    while np.isfinite(rn) and rn > tol * bnorm and k < max_its:
        if k >= 32 and rn < INEXACT_ACCEPT * bnorm and rn > 0.5 * hist[-33]:
            break  # stalled on the floor, under the acceptance level
        d, ds = blu.solve(rr), rs
        Cd, cds = kmv(d, ds)
        beta = CD @ Cd + CDs * cds
        Cd = Cd - CD.T @ beta
        cds = cds - CDs @ beta
        d = d - D.T @ beta
        ds = ds - Ds @ beta
        nrm = torch.sqrt(torch.dot(Cd, Cd) + cds * cds).clamp_min(1e-300)
        d, ds, Cd, cds = d / nrm, ds / nrm, Cd / nrm, cds / nrm
        alpha = torch.dot(Cd, rr) + cds * rs
        x = x + alpha * d
        y = y + alpha * ds
        rr = rr - alpha * Cd
        rs = rs - alpha * cds
        D[k % m], Ds[k % m], CD[k % m], CDs[k % m] = d, ds, Cd, cds
        k += 1
        rn = float(torch.sqrt(torch.dot(rr, rr) + rs * rs))
        hist.append(rn)
    res = rn / bnorm
    return SolveResult(torch.cat([x, y.reshape(1)]), k, res, res <= tol)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class _LoadedAssembler:
    """Stationary assembler + a constant momentum load (the Reynolds stress
    of the frozen harmonic); the Jacobian is untouched."""

    def __init__(self, base: StationaryNavierStokesAssembler, load: torch.Tensor) -> None:
        self._base = base
        self.load = load
        self.bc_mask = base.bc_mask
        self.bc_values = base.bc_values
        self.bcs = base.bcs
        self._state = base._state

    def residual(self, w, re):
        return self._base.residual(w, re) + self.load

    def jacobian(self, w, re):
        return self._base.jacobian(w, re)


class SelfConsistentModel:
    """The self-consistent model of one flow at one Reynolds number.

    ``linear_solver`` (mean Newton and the coupled Newton's bordered
    solves) and ``si_method`` (eigensolves, the HB2 seed) default to
    ``"banded"``; ``"lu"`` takes the host SuperLU.  The mass matrix is
    assembled once (``mass``: a CSRMatrix on the context's pattern from a
    previous model, as :func:`scm_continuation` passes it).  ``stats``
    counts the coupled Newton's bordered solves: their GCR iterations,
    factor seconds and the seconds of K0's value formation.  ``device``
    must be the assembly context's; the default ``"cuda"`` raises without
    a usable GPU unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        ctx: AssemblyContext,
        mesh,
        bcs,
        bcs_pert,
        re: float,
        *,
        linear_solver: str = "banded",
        si_method: str = "banded",
        target: complex | None = None,
        ncv: int = 30,
        atol: float = 1e-8,
        mass: CSRMatrix | None = None,
        device="cuda",
    ) -> None:
        device = resolve_device(device)
        if device.type != ctx.device.type:
            raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
        self.ctx = ctx
        self.mesh = mesh
        self.bcs = bcs
        self.bcs_pert = bcs_pert
        self.re = float(re)
        self.linear_solver = linear_solver
        self.si_method = si_method
        self.target = target
        self.ncv = ncv
        self.atol = atol
        self._base_asm = StationaryNavierStokesAssembler(ctx, mesh, bcs)
        # the mass matrix, assembled once: the energy norm and the M of
        # every eigensolve
        self._Mmat = mass if mass is not None else LinearizedNavierStokesAssembler(
            np.zeros(ctx.spaces.num_dofs), ctx, self.re, bcs_pert, mesh).assemble_mass_matrix()
        self._Ms = self._Mmat.to_scipy()
        self._MT = None  # M^T on the device, made on the first coupled Newton
        # block patterns of the bordered K0, one per harmonic order
        self._bord_cache: dict[int, BlockPattern] = {}
        self.stats = dict(bordered=0, gcr_its=[], factor_s=0.0, form_s=0.0, solve_s=0.0)

    # ------------------------------------------------------------------
    def _dev(self, v, dtype=torch.float64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=self.ctx.device).to(dtype)

    def unit_load(self, mode) -> torch.Tensor:
        """Reynolds-stress load of the unit-amplitude harmonic:
        L_v = -1/2 [(u_r.grad)u_r + (u_i.grad)u_i] tested, scattered to the
        mixed vector (zero pressure rows); an f64 device vector."""
        ctx = self.ctx
        mode = self._dev(mode, torch.complex128)
        el = torch.zeros((ctx.detJ.shape[0], ctx.ndofs_el), dtype=torch.float64,
                         device=ctx.device)
        wdet = ctx.w[None, :] * ctx.detJ[:, None]
        nud = ctx.nu_el * ctx.gdim
        for part in (mode.real.contiguous(), mode.imag.contiguous()):
            uq = _u_at_qp(ctx, part)
            gq = _grad_u_at_qp(ctx, part)
            convq = torch.einsum("cqe,cqde->cqd", uq, gq)
            r_v = -0.5 * torch.einsum("cq,qi,cqd->cid", wdet, ctx.phi_u, convq)
            el[:, :nud] += r_v.reshape(r_v.shape[0], -1)
        return scatter_vector(ctx, el)

    def _normalize(self, v: np.ndarray) -> np.ndarray:
        e = np.real(np.vdot(v, self._Ms @ v))
        return v / np.sqrt(e)

    def _eig_about(self, U: np.ndarray, target: complex, v0=None,
                   omega_ref: float | None = None):
        """Leading eigenpair near ``target``; with ``omega_ref``, follow the
        oscillatory branch: reject modes whose frequency left the +-40%
        band around it (heavily forced means can grow spurious steady
        modes).  Returns None if the branch is lost."""
        A = LinearizedNavierStokesAssembler(
            U, self.ctx, self.re, self.bcs_pert, self.mesh).assemble_linear_operator()
        es = EigenSolver(A, self._Mmat, EigensolverConfig(num_eig=3, atol=self.atol,
                                                          ncv=self.ncv))
        es.set_st_type(STType.SINVERT)
        es.set_target(target)
        es.set_st_pc_type(self.si_method)
        if v0 is not None:
            es.set_initial_vector(v0)
        pairs = es.solve()
        if omega_ref is not None:
            band = [p for p in pairs if abs(abs(p[0].imag) - omega_ref) < 0.4 * omega_ref]
            if not band:
                logger.info("Oscillatory branch not in returned set (omega_ref %.3f): "
                            "eigenvalues %s", omega_ref,
                            np.array2string(np.array([p[0] for p in pairs]), precision=4))
                return None
            # the branch member with positive frequency, largest growth
            return max(((lam.conjugate(), v.conj()) if lam.imag < 0 else (lam, v)
                        for lam, v in band), key=lambda p: p[0].real)
        return max(pairs, key=lambda p: p[0].real)

    def _trial(self, asm, U0, *, damping: float, tol: float, max_it: int):
        """One damped Newton trial of the mean, or None where a banded step
        missed its refinement: a failed trial, as the reference's Newton,
        which degrades that solve to a host LU, returns unconverged."""
        newton = NewtonSolver(asm, linear_solver=self.linear_solver, damping=damping)
        try:
            return newton.solve(U0, self.re, tol=tol, max_it=max_it)
        except BandedStepMissed as e:
            logger.info("SCM Newton trial (damping %.2f) failed: a banded step missed, relative "
                        "residual %.2e after %d refinement iterations.", damping, e.residual,
                        e.iterations)
            return None

    def _mean_solve(self, load, U0, tol=1e-9):
        """The mean state, or None when Newton fails.  Strongly forced means
        can defeat undamped Newton: retry down a damping ladder, then by
        load continuation (the Reynolds stress ramped in fractions,
        warm-starting each rung).  A banded step that misses fails its
        trial (:meth:`_trial`)."""
        asm = _LoadedAssembler(self._base_asm, load)
        res = None
        for damping in (1.0, 0.5, 0.25):
            res = self._trial(asm, U0, damping=damping, tol=tol,
                              max_it=40 if damping == 1.0 else 120)
            if res is not None and res.converged and np.isfinite(res.w).all():
                return res.w
        logger.info("SCM mean damping ladder failed (|F| = %s); trying load continuation.",
                    "a missed step" if res is None else f"{res.residual_norm:.2e}")
        w = U0
        for frac in (0.25, 0.5, 0.75, 1.0):
            asm_f = _LoadedAssembler(self._base_asm, frac * load)
            res = self._trial(asm_f, w, damping=0.5, tol=tol, max_it=120)
            if res is None or not (res.converged and np.isfinite(res.w).all()):
                logger.info("SCM load continuation failed at fraction %.2f (|F| = %s).", frac,
                            "a missed step" if res is None else f"{res.residual_norm:.2e}")
                return None
            w = res.w
        return w

    def _coupled_relax(self, x, Ut, modet, sigmat, omega, *, sweeps: int = 80,
                       tol: float = 1e-8):
        """Interleaved damped-Newton / mode-refresh relaxation for
        amplitudes past the fold of the frozen-mode forced-mean branch: a
        few damped Newton steps on the current load, (mode, sigma)
        refreshed about the new mean, the load rebuilt, repeated.
        Returns (U, mode, sigma) or None."""
        load = None
        scale = None
        res_hist = []
        for sweep in range(sweeps):
            new_load = x * self.unit_load(modet)
            # heavy load under-relaxation: the alternation's instability
            # near and above the root is load overcorrection
            load = new_load if load is None else 0.7 * load + 0.3 * new_load
            if scale is None:
                scale = max(float(torch.linalg.vector_norm(new_load)), 1e-30)
            res = self._trial(_LoadedAssembler(self._base_asm, load), Ut, damping=0.4, tol=tol,
                              max_it=2)
            if res is None or not np.isfinite(res.w).all():
                return None
            Ut = res.w
            pair = self._eig_about(Ut, sigmat.real + 1j * abs(sigmat.imag), v0=modet,
                                   omega_ref=omega)
            if pair is None:
                return None
            sigmat, modet = pair[0], self._normalize(pair[1])
            res_hist.append(float(res.residual_norm))
            # settled: the forced residual is small on the scale of the
            # load built from the current mode; the polish supplies the
            # final accuracy
            if res.converged or res_hist[-1] < 1e-4 * scale:
                return self._relax_polish(Ut, modet, sigmat, omega, new_load, sweep, res_hist)
            # diverging: residual grew far above its best, past the transient
            if sweep >= 5 and res_hist[-1] > 30.0 * min(res_hist):
                logger.info("SCM coupled relaxation diverged (|F| = %.2e).", res_hist[-1])
                return None
            # plateaued far from the target: stop burning sweeps
            if (sweep >= 20 and res_hist[-1] > 1e-3 * scale
                    and res_hist[-1] > 0.5 * res_hist[-10]):
                logger.info("SCM coupled relaxation plateaued (|F| = %.2e of scale %.2e).",
                            res_hist[-1], scale)
                return None
        if res_hist[-1] < 1e-2 * scale:
            # out of sweeps but close: let the polish try to finish
            return self._relax_polish(Ut, modet, sigmat, omega, x * self.unit_load(modet),
                                      sweeps - 1, res_hist)
        logger.info("SCM coupled relaxation did not settle in %d sweeps (|F| = %.2e of scale "
                    "%.2e).", sweeps, res_hist[-1], scale)
        return None

    def _relax_polish(self, Ut, modet, sigmat, omega, load, sweep, res_hist):
        """Final full Newton at the settled load + eigensolve refresh."""
        Um = self._mean_solve(load, Ut)
        if Um is not None:
            Ut = Um
            pair = self._eig_about(Ut, sigmat.real + 1j * abs(sigmat.imag), v0=modet,
                                   omega_ref=omega)
            if pair is None:
                return None
            sigmat, modet = pair[0], self._normalize(pair[1])
        logger.info("SCM coupled relaxation settled in %d sweeps (|F| = %.2e%s).", sweep + 1,
                    res_hist[-1], ", polished" if Um is not None else "")
        return Ut, modet, sigmat

    # ------------------------------------------------------------------
    # Fully coupled (harmonic-balance) Newton
    # ------------------------------------------------------------------
    def _convective_data(self, b) -> torch.Tensor:
        """C(b)'s data on the context's pattern (unmasked)."""
        return convective_linearization_data(self.ctx, self._dev(b))

    def _linearized(self, U) -> CSRMatrix:
        return LinearizedNavierStokesAssembler(
            U, self.ctx, self.re, self.bcs_pert, self.mesh).assemble_linear_operator()

    def _mass_T(self, x: torch.Tensor) -> torch.Tensor:
        """M^T x on the device (M^T made once)."""
        if self._MT is None:
            self._MT = self._Mmat.transpose()
        return spmv(self._MT, x)

    def _coupled_residual(self, U, qr, qi, om, Aop: CSRMatrix, avec, bvec, mask_m,
                          mask_p) -> torch.Tensor:
        """Residual of the coupled system F(U, q, omega):

          F1 = R(U) - 1/2 [(q_r.grad)q_r + (q_i.grad)q_i].v   (mean)
          F2 = (A(U) - i omega M) q                           (mode)
          F3 = Im <q_ref, q>_M                                (phase)

        with the BC-row masking convention of the Newton solver (rows
        zeroed; the Jacobian's identity rows keep the deltas zero
        there).  Device f64 vectors; ``avec``/``bvec`` = M^T q_ref."""
        U, qr, qi = self._dev(U), self._dev(qr), self._dev(qi)
        avec, bvec = self._dev(avec), self._dev(bvec)
        mask_m, mask_p = self._dev(mask_m, torch.bool), self._dev(mask_p, torch.bool)
        zero = torch.zeros((), dtype=torch.float64, device=U.device)
        load = self.unit_load(torch.complex(qr, qi))
        F1 = torch.where(mask_m, zero, self._base_asm.residual(U, self.re) + load)
        M = self._Mmat
        F2r = torch.where(mask_p, zero, spmv(Aop, qr) + om * spmv(M, qi))
        F2i = torch.where(mask_p, zero, spmv(Aop, qi) - om * spmv(M, qr))
        F3 = torch.dot(avec, qi) - torch.dot(bvec, qr)
        return torch.cat([F1, F2r, F2i, F3.reshape(1)])

    def _block(self, harmonics: int) -> BlockPattern:
        bp = self._bord_cache.get(harmonics)
        if bp is None:
            k = 3 if harmonics == 1 else 5
            bp = self._bord_cache[harmonics] = BlockPattern(self.ctx.pattern,
                                                            np.ones((k, k), dtype=bool))
        return bp

    def _coupled_matrix(self, U, qr, qi, om, Aop: CSRMatrix, avec, bvec, mask_m,
                        mask_p) -> tuple[CSRMatrix, torch.Tensor, torch.Tensor]:
        """The bordered Jacobian of :meth:`_coupled_residual` as (K0, c, r):

          [ J_mean(U)   1/2 Zm C(q_r)  1/2 Zm C(q_i)   0      ]
          [ Zp C(q_r)   A(U)           omega M         M q_i  ]
          [ Zp C(q_i)  -omega M        A(U)           -M q_r  ]
          [ 0          -(M^T q_ref_i)  (M^T q_ref_r)    0      ]

        K0 the 3N x 3N principal block on the model's block pattern, c the
        last column and r the last row (without the zero corner).  J_mean
        and A carry identity Dirichlet rows from their assemblers; the
        coupling blocks get their equation's rows zeroed (Zm/Zp)."""
        U, qr, qi = self._dev(U), self._dev(qr), self._dev(qi)
        mask_m, mask_p = self._dev(mask_m, torch.bool), self._dev(mask_p, torch.bool)
        pat, dev = self.ctx.pattern, self.ctx.device
        zm, zp = rows_kept(mask_m, pat, dev), rows_kept(mask_p, pat, dev)
        Jm = self._base_asm.jacobian(U, self.re).data
        Cr, Ci = self._convective_data(qr), self._convective_data(qi)
        Md, Ad = self._Mmat.data, Aop.data
        K0 = self._block(1).fill({
            (0, 0): Jm, (0, 1): 0.5 * zm * Cr, (0, 2): 0.5 * zm * Ci,
            (1, 0): zp * Cr, (1, 1): Ad, (1, 2): om * Md,
            (2, 0): zp * Ci, (2, 1): -om * Md, (2, 2): Ad,
        })
        n = U.shape[0]
        zero = torch.zeros(n, dtype=torch.float64, device=dev)
        c = torch.cat([zero, spmv(self._Mmat, qi), -spmv(self._Mmat, qr)])
        r = torch.cat([zero, -self._dev(bvec), self._dev(avec)])
        return K0, c, r

    # -- second-harmonic balance (HB2) ---------------------------------
    # Physical ansatz (same convention as HB1 / the alternation):
    #   v = Re(q1 e^{i w t}) + Re(q2 e^{2 i w t}),  U the true time-mean.
    # Collecting harmonics of M dv/dt = R(U) + C(U) v + B(v, v):
    #   F0 = R(U) + 1/2 B(q1,q1*) + 1/2 B(q2,q2*)          (mean)
    #   F1 = (A(U) - i w M) q1 + B(q1*, q2)                (E^1)
    #   F2 = (A(U) - 2 i w M) q2 + 1/2 B(q1, q1)           (E^2)
    #   F3 = Im <q_ref, q1>_M                              (phase)
    # where B(a,b) = -1/2[(a.grad)b + (b.grad)a] tested and every Jacobian
    # coupling block is 1/2 C(.) by d B(a,x)/dx = 1/2 C(a).

    def _hb2_residual(self, U, q1, q2, om, Aop: CSRMatrix, avec, bvec, mask_m,
                      mask_p) -> torch.Tensor:
        ctx, M = self.ctx, self._Mmat
        B = convective_bilinear_load
        U = self._dev(U)
        q1, q2 = self._dev(q1, torch.complex128), self._dev(q2, torch.complex128)
        avec, bvec = self._dev(avec), self._dev(bvec)
        mask_m, mask_p = self._dev(mask_m, torch.bool), self._dev(mask_p, torch.bool)
        zero = torch.zeros((), dtype=torch.float64, device=U.device)
        F0 = torch.where(mask_m, zero, self._base_asm.residual(U, self.re)
                         + 0.5 * B(ctx, q1, q1.conj()).real + 0.5 * B(ctx, q2, q2.conj()).real)
        F1 = spmv(Aop, q1) - 1j * om * spmv(M, q1) + B(ctx, q1.conj(), q2)
        F2 = spmv(Aop, q2) - 2j * om * spmv(M, q2) + 0.5 * B(ctx, q1, q1)
        czero = torch.zeros((), dtype=torch.complex128, device=U.device)
        F1 = torch.where(mask_p, czero, F1)
        F2 = torch.where(mask_p, czero, F2)
        F3 = torch.dot(avec, q1.imag.contiguous()) - torch.dot(bvec, q1.real.contiguous())
        return torch.cat([F0, F1.real, F1.imag, F2.real, F2.imag, F3.reshape(1)])

    def _hb2_matrix(self, U, q1, q2, om, Aop: CSRMatrix, avec, bvec, mask_m,
                    mask_p) -> tuple[CSRMatrix, torch.Tensor, torch.Tensor]:
        """The bordered HB2 Jacobian as (K0, c, r), block order
        (U, q1r, q1i, q2r, q2i, omega)."""
        U = self._dev(U)
        q1, q2 = self._dev(q1, torch.complex128), self._dev(q2, torch.complex128)
        mask_m, mask_p = self._dev(mask_m, torch.bool), self._dev(mask_p, torch.bool)
        pat, dev = self.ctx.pattern, self.ctx.device
        zm, zp = rows_kept(mask_m, pat, dev), rows_kept(mask_p, pat, dev)
        Jm = self._base_asm.jacobian(U, self.re).data
        C1r, C1i = self._convective_data(q1.real), self._convective_data(q1.imag)
        C2r, C2i = self._convective_data(q2.real), self._convective_data(q2.imag)
        Md, Ad = self._Mmat.data, Aop.data
        wM = om * Md
        h = 0.5
        K0 = self._block(2).fill({
            # F0: mean
            (0, 0): Jm, (0, 1): h * zm * C1r, (0, 2): h * zm * C1i,
            (0, 3): h * zm * C2r, (0, 4): h * zm * C2i,
            # F1r = A q1r + w M q1i + Re B(q1*, q2)
            (1, 0): zp * C1r, (1, 1): Ad + h * zp * C2r, (1, 2): wM + h * zp * C2i,
            (1, 3): h * zp * C1r, (1, 4): h * zp * C1i,
            # F1i = A q1i - w M q1r + Im B(q1*, q2)
            (2, 0): zp * C1i, (2, 1): -wM + h * zp * C2i, (2, 2): Ad - h * zp * C2r,
            (2, 3): -h * zp * C1i, (2, 4): h * zp * C1r,
            # F2r = A q2r + 2w M q2i + 1/2 Re B(q1, q1)
            (3, 0): zp * C2r, (3, 1): h * zp * C1r, (3, 2): -h * zp * C1i,
            (3, 3): Ad, (3, 4): 2.0 * wM,
            # F2i = A q2i - 2w M q2r + 1/2 Im B(q1, q1)
            (4, 0): zp * C2i, (4, 1): h * zp * C1i, (4, 2): h * zp * C1r,
            (4, 3): -2.0 * wM, (4, 4): Ad,
        })
        n = U.shape[0]
        M = self._Mmat
        zero = torch.zeros(n, dtype=torch.float64, device=dev)
        q1r, q1i = q1.real.contiguous(), q1.imag.contiguous()
        q2r, q2i = q2.real.contiguous(), q2.imag.contiguous()
        c = torch.cat([zero, spmv(M, q1i), -spmv(M, q1r), 2.0 * spmv(M, q2i),
                       -2.0 * spmv(M, q2r)])
        r = torch.cat([zero, -self._dev(bvec), self._dev(avec), zero, zero])
        return K0, c, r

    def _bordered_solve(self, K0: CSRMatrix, c: torch.Tensor, r: torch.Tensor,
                        F: torch.Tensor) -> torch.Tensor:
        """Solve the bordered coupled-Newton system [[K0, c], [r^T, 0]] dz = F.

        ``"banded"``: the real band factor of K0 (``factor_auto`` on K0's
        plan, made once for its pattern) preconditions
        :func:`_bordered_gcr` to 1e-11, with K0's matvecs through S
        (``operator_for_budget``, its plan made once per pattern); the
        factor is freed after the solve.  A solve that stalls above 1e-8
        takes one more GCR pass from where it stopped, on its true residual
        (the reference falls back to a host ``splu`` there).  A solve under 1e-8 is accepted as the reference
        accepts it; worse raises ``FactorUnusable``.
        ``"lu"`` (asked for only): the host ``splu`` of the bordered
        matrix."""
        self.stats["bordered"] += 1
        if self.linear_solver == "lu":
            K = sp.bmat([[K0.to_scipy(), sp.csr_matrix(c.cpu().numpy()[:, None])],
                         [sp.csr_matrix(r.cpu().numpy()[None, :]), None]], format="csc")
            dz = SparseLU(K).solve(F.cpu().numpy())
            return torch.as_tensor(dz, device=F.device)
        t0 = time.perf_counter()
        plan = plan_for_csr(K0, real=True)
        Jop = operator_for_budget(K0)
        blu, _ = factor_auto(plan, K0.data, diag_slots=K0.pattern.diag_slots, delta=BORDER_RIDGE)
        t1 = time.perf_counter()
        f, g = F[:-1].contiguous(), float(F[-1])
        res = _bordered_gcr(K0, blu, c, r, f, g, Jop, tol=1e-11)
        if not (res.converged or res.residual < INEXACT_ACCEPT) and torch.isfinite(res.x).all():
            # GCR(16)'s truncated memory can stall on the factor's weak
            # near-null direction at the root, a few times above the acceptance
            more = _bordered_gcr(K0, blu, c, r, f, g, Jop, tol=1e-11, z0=res.x)
            logger.info("Bordered GCR stalled at %.2e after %d iterations; a restart on the true "
                        "residual took %d more: %.2e.", res.residual, res.iterations,
                        more.iterations, more.residual)
            res = SolveResult(more.x, res.iterations + more.iterations, more.residual,
                              more.converged)
        del blu
        self.stats["factor_s"] += t1 - t0
        self.stats["solve_s"] += time.perf_counter() - t1
        self.stats["gcr_its"].append(res.iterations)
        finite = bool(torch.isfinite(res.x).all())
        if res.converged and finite:
            return res.x
        if res.residual < INEXACT_ACCEPT and finite:
            logger.info("Accepting inexact bordered solve (rel res %.1e).", res.residual)
            return res.x
        raise FactorUnusable(f"bordered GCR stalled: relative residual {res.residual:.2e} after "
                             f"{res.iterations} iterations (accepted below {INEXACT_ACCEPT:.0e})")

    def solve_coupled(
        self,
        U0,
        q0,
        omega0: float,
        *,
        tol: float = 1e-8,
        max_it: int = 25,
        harmonics: int = 1,
        q20=None,
    ) -> SCMResult:
        """Monolithic Newton on the coupled SCM system (harmonic balance of
        order ``harmonics``).

        ``harmonics=1``: unknowns (U, q_r, q_i, omega), 3N+1 equations:
        forced mean (N), marginal mode (A(U) - i omega M) q = 0 (2N), and
        the phase condition Im <q_ref, q>_M = 0 with q_ref = q0.  The
        amplitude is ||q||_E, so marginality is hardwired.
        ``harmonics=2``: adds the second-harmonic field q2 (5N+1 unknowns;
        see the HB2 block comment above).  ``q20`` optionally seeds q2;
        default is the forced solve (A - 2 i omega M) q2 = -1/2 B(q1, q1)
        on a band factor (``si_method``).  ``q0`` must carry the amplitude
        (A * unit mode).  Each iteration's K0 values are formed on the
        device (``stats["form_s"]``) and solved by
        :meth:`_bordered_solve`."""
        if harmonics not in (1, 2):
            raise ValueError("harmonics must be 1 or 2")
        dev = self.ctx.device
        n = self.ctx.spaces.num_dofs
        mask_m = self._base_asm.bc_mask
        mask_p = self._dev(np.asarray(self.bcs_pert.dirichlet_mask, dtype=bool), torch.bool)
        czero = torch.zeros((), dtype=torch.complex128, device=dev)
        U = torch.where(mask_m, self._base_asm.bc_values, self._dev(U0))
        q1 = torch.where(mask_p, czero, self._dev(q0, torch.complex128))
        om = float(omega0)
        # phase reference: the frozen initial mode (standard bordering)
        avec = self._mass_T(q1.real.contiguous())
        bvec = self._mass_T(q1.imag.contiguous())
        M = self._Mmat

        Aop = self._linearized(U)
        if harmonics == 2:
            if q20 is not None:
                q2 = torch.where(mask_p, czero, self._dev(q20, torch.complex128))
            else:
                rhs = 0.5 * convective_bilinear_load(self.ctx, q1, q1)
                rhs = torch.where(mask_p, czero, rhs)
                q2 = -_forced_solve(Aop, M, 2j * om, rhs, method=self.si_method)
        else:
            q2 = None

        def resid(Uv, q1v, q2v, omv, Av):
            if harmonics == 1:
                return self._coupled_residual(Uv, q1v.real.contiguous(), q1v.imag.contiguous(),
                                              omv, Av, avec, bvec, mask_m, mask_p)
            return self._hb2_residual(Uv, q1v, q2v, omv, Av, avec, bvec, mask_m, mask_p)

        def energy(q):
            return float(torch.sqrt(torch.vdot(q, spmv(M, q)).real))

        F = resid(U, q1, q2, om, Aop)
        normF = float(torch.linalg.vector_norm(F))
        history = []
        converged = False
        for it in range(1, max_it + 1):
            amp = energy(q1)
            history.append((amp, 0.0, om))
            if normF < tol:
                converged = True
                break
            t0 = time.perf_counter()
            if harmonics == 1:
                K0, c, r = self._coupled_matrix(U, q1.real.contiguous(), q1.imag.contiguous(), om,
                                                Aop, avec, bvec, mask_m, mask_p)
            else:
                K0, c, r = self._hb2_matrix(U, q1, q2, om, Aop, avec, bvec, mask_m, mask_p)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.stats["form_s"] += time.perf_counter() - t0
            dz = self._bordered_solve(K0, c, r, -F)
            del K0
            accepted = False
            for alpha in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
                Ut = U + alpha * dz[:n]
                q1t = q1 + alpha * torch.complex(dz[n:2 * n], dz[2 * n:3 * n])
                q2t = (q2 + alpha * torch.complex(dz[3 * n:4 * n], dz[4 * n:5 * n])
                       if harmonics == 2 else None)
                omt = om + alpha * float(dz[-1])
                At = self._linearized(Ut)
                Ft = resid(Ut, q1t, q2t, omt, At)
                normFt = float(torch.linalg.vector_norm(Ft))
                if np.isfinite(normFt) and normFt < (1 - 1e-4 * alpha) * normF:
                    U, q1, q2, om, Aop, F, normF = Ut, q1t, q2t, omt, At, Ft, normFt
                    accepted = True
                    break
            logger.info("SCM coupled Newton (HB%d) %d: |F| = %.3e, A = %.5f, omega = %.5f%s",
                        harmonics, it, normF, amp, om, "" if accepted else " (no descent)")
            if not accepted:
                logger.warning("SCM coupled Newton stalled at |F| = %.3e.", normF)
                break
        amp = energy(q1)
        mode = (q1 / max(amp, 1e-300)).cpu().numpy()
        return SCMResult(amp, complex(0.0, om), U.cpu().numpy(), mode, converged, history,
                         None, None if q2 is None else q2.cpu().numpy())

    # ------------------------------------------------------------------
    def solve(
        self,
        baseflow,
        *,
        A0: float = 0.1,
        tol_sigma: float = 1e-4,
        max_outer: int = 30,
        inner: int = 6,
        state0: tuple | None = None,
        x0: float | None = None,
    ) -> SCMResult:
        """Find (mean, mode, A, omega) with sigma_r = 0.

        ``baseflow``: the (unstable) fixed point to start from.  ``inner``:
        max mean <-> mode sweeps per amplitude (stops early once sigma_r
        settles; the load is under-relaxed across sweeps).
        ``state0``/``x0``: Re-continuation warm start -- the converged
        ``(mean, mode, sigma)`` of a nearby Re and the x = A^2 to open
        with."""
        U0 = np.asarray(baseflow, dtype=np.float64)
        sigma, mode = self._eig_about(U0, self.target if self.target is not None
                                      else 0.05 + 0.75j)
        mode = self._normalize(mode)
        g_hopf, omega = sigma.real, abs(sigma.imag)
        if g_hopf <= 0:
            logger.info("Baseflow already stable (sigma_r = %.3e); A = 0.", g_hopf)
            return SCMResult(0.0, sigma, U0, mode, True, [(0.0, sigma.real, sigma.imag)])
        history = [(0.0, sigma.real, sigma.imag)]

        # Stuart-Landau: g(x), x = A^2, decreases about linearly from
        # g_hopf.  Phase 1 marches x up (x *= 1.6, warm-started) until
        # g < 0 brackets the root; phase 2 bisects with a secant-
        # accelerated midpoint.  A failed trial counts as "x too large".
        if state0 is not None:
            Us0, ms0, ss0 = state0
            state = (np.asarray(Us0), self._normalize(np.asarray(ms0)), complex(ss0))
        else:
            state = (U0, mode, sigma)
        U = U0
        x_good = 0.0  # the x the held state was computed at
        x_lo, g_lo = 0.0, g_hopf
        x_hi = g_hi = None
        x = float(A0) ** 2 if x0 is None else float(x0)
        converged = False
        outer = 0
        x_fail_min = np.inf
        while outer < max_outer:
            outer += 1
            trial_ok = True
            Ut, modet, sigmat = state
            load = None
            g_seq = []
            for sweep in range(inner):
                # under-relaxed load: stabilizes the mean <-> mode ping-pong
                new_load = x * self.unit_load(modet)
                load = new_load if load is None else 0.3 * load + 0.7 * new_load
                Um = self._mean_solve(load, Ut)
                if Um is None:
                    # frozen-load fold: try the coupled relaxation
                    cr = self._coupled_relax(x, Ut, modet, sigmat, omega)
                    if cr is None:
                        trial_ok = False
                        break
                    Ut, modet, sigmat = cr
                    g_seq.append(sigmat.real)
                    break  # relaxation is already self-consistent
                Ut = Um
                pair = self._eig_about(Ut, sigmat.real + 1j * abs(sigmat.imag), v0=modet,
                                       omega_ref=omega)
                if pair is None:
                    trial_ok = False
                    break
                sigmat, modet = pair[0], self._normalize(pair[1])
                g_seq.append(sigmat.real)
                if sweep >= 1 and abs(g_seq[-1] - g_seq[-2]) < 0.2 * tol_sigma:
                    break  # self-consistent at this x
            if not trial_ok:
                x_fail_min = min(x_fail_min, x)
                x_new = 0.5 * (x + x_lo)
                # a trial failure within 1% of the last good x is a wall
                # probe: the coupled Newton resolves the root more cheaply
                if x - x_lo < 1e-2 * max(x, 1.0):
                    if abs(sigma.real) < 20 * tol_sigma:
                        logger.info("SCM wall at x = %.4f with near-marginal sigma_r = %+.2e: "
                                    "accepting.", x, sigma.real)
                        converged = True
                    else:
                        logger.warning("SCM stalled against a failing x; stopping at the last "
                                       "good state.")
                    break
                logger.info("SCM outer %d: trial failed at x = %.4f; retrying x = %.4f.",
                            outer, x, x_new)
                x = x_new
                continue
            state = (Ut, modet, sigmat)
            U, mode, sigma = state
            x_good = x
            if x >= x_fail_min:
                x_fail_min = np.inf  # a success above disproves the wall
            g, omega = sigma.real, abs(sigma.imag)
            history.append((float(np.sqrt(x)), sigma.real, sigma.imag))
            logger.info("SCM outer %d: A = %.5f, sigma = %+.5f %+.5f j", outer, np.sqrt(x),
                        sigma.real, sigma.imag)
            if abs(g) < tol_sigma:
                converged = True
                break
            if (g > 0 and np.isfinite(x_fail_min) and x_fail_min - x < 2e-3 * max(x, 1.0)
                    and abs(g) < 20 * tol_sigma):
                # pinned against the forced-mean Newton wall from the good
                # side, inside the alternation's noise floor
                logger.info("SCM wall-limited convergence at x = %.4f (sigma_r = %+.2e).", x, g)
                converged = True
                break
            if g > 0:
                x_lo, g_lo = x, g
            else:
                x_hi, g_hi = x, g
            if x_hi is not None and x_hi - x_lo < 1e-4 * x_hi and abs(g) < 20 * tol_sigma:
                # bracket collapsed onto the inner-sweep noise floor of g
                converged = True
                break
            if x_hi is None:
                # marching toward the bracket; never blindly overstep the
                # Stuart-Landau root estimate (g about linear in x)
                x_next = min(1.6 * x, 0.5 * (x + x_fail_min))
                if g < g_hopf:  # slope information available
                    x_star = x * g_hopf / max(g_hopf - g, 1e-14)
                    x_next = min(x_next, 1.15 * x_star)
                x = max(x_next, 1.02 * x)
            else:
                # secant-accelerated bisection inside [x_lo, x_hi]
                x_sec = x_lo - g_lo * (x_hi - x_lo) / (g_hi - g_lo)
                x_mid = 0.5 * (x_lo + x_hi)
                x = x_sec if x_lo < x_sec < x_hi else x_mid
        # report the amplitude of the state actually held
        if not converged and x_good > 0 and abs(sigma.real) < 20 * tol_sigma:
            logger.info("SCM outer budget exhausted near marginality (sigma_r = %+.2e): "
                        "accepting.", sigma.real)
            converged = True
        amplitude_sl = None
        if not converged and x_good > 0:
            # wall-limited below marginality: extrapolate the root of the
            # about linear g(x) through the reachable points
            pts = np.array([(a * a, g) for a, g, _ in history if a * a > 0.3 * x_good])
            if len(pts) >= 2 and np.ptp(pts[:, 0]) > 0:
                slope, icept = np.polyfit(pts[:, 0], pts[:, 1], 1)
                if slope < 0:
                    x_star = -icept / slope
                    if x_star > x_good:
                        amplitude_sl = float(np.sqrt(x_star))
                        logger.info("SCM Stuart-Landau extrapolated amplitude A* = %.4f "
                                    "(wall-limited at A = %.4f, sigma_r = %+.3e).",
                                    amplitude_sl, np.sqrt(x_good), sigma.real)
        return SCMResult(float(np.sqrt(x_good)), sigma, np.asarray(U), mode, converged, history,
                         amplitude_sl)


def scm_continuation(
    ctx: AssemblyContext,
    mesh,
    bcs,
    bcs_pert,
    res: list[float],
    baseflow_fn,
    **kw,
) -> list[tuple[float, SCMResult]]:
    """Re-continuation of the self-consistent model up the A(Re) curve.

    Solves the model at each Reynolds number of ``res`` (ascending, the
    first weakly supercritical), warm-starting every solve from the
    previous converged (mean, mode, sigma) at an x = A^2 extrapolated
    linearly along the curve.  ``baseflow_fn(re)``: the (unstable) fixed
    point at ``re``.  ``coupled`` (default True): a wall-limited point is
    finished by :meth:`SelfConsistentModel.solve_coupled`, and a point
    past the second is first tried by the coupled Newton directly from
    the previous state.  ``kw``: forwarded to :class:`SelfConsistentModel`
    (solver choices) and :meth:`SelfConsistentModel.solve` (tolerances),
    split on the constructor's signature."""
    coupled = kw.pop("coupled", True)
    ctor_keys = set(inspect.signature(SelfConsistentModel.__init__).parameters) - {
        "self", "ctx", "mesh", "bcs", "bcs_pert", "re", "mass"}
    ctor_kw = {k: v for k, v in kw.items() if k in ctor_keys}
    solve_kw = {k: v for k, v in kw.items() if k not in ctor_keys}
    out: list[tuple[float, SCMResult]] = []
    mass = None
    xs: list[tuple[float, float]] = []  # converged (re, x) points
    state = None
    for re in res:
        model = SelfConsistentModel(ctx, mesh, bcs, bcs_pert, re, mass=mass, **ctor_kw)
        mass = model._Mmat
        x0 = None
        if len(xs) >= 2:  # linear extrapolation of x(Re)
            (r1, x1), (r2, x2) = xs[-2], xs[-1]
            x0 = max(x2 + (x2 - x1) * (re - r2) / (r2 - r1), 0.25 * x2)
        elif xs:
            x0 = xs[-1][1]
        res_i = None
        if coupled and state is not None and x0 is not None:
            # continuation by the coupled Newton from the previous Re's
            # state at the extrapolated amplitude; the alternation where
            # the warm start is outside the Newton basin
            Us, ms, ss = state
            cres = model.solve_coupled(np.asarray(Us), float(np.sqrt(x0)) * np.asarray(ms),
                                       abs(complex(ss).imag), max_it=12)
            if cres.converged:
                logger.info("SCM continuation: coupled Newton solved Re = %g directly "
                            "(A = %.4f).", re, cres.amplitude)
                res_i = cres
        if res_i is None:
            res_i = model.solve(baseflow_fn(re), state0=state, x0=x0, **solve_kw)
        tol_sig = solve_kw.get("tol_sigma", 1e-4)
        if coupled and res_i.amplitude > 0 and (
                not res_i.converged or abs(res_i.sigma.real) > tol_sig):
            # wall-limited, or accepted only at the alternation's noise
            # floor: the coupled Newton resolves sigma_r = 0 exactly
            A0 = res_i.amplitude_sl or res_i.amplitude
            cres = model.solve_coupled(res_i.mean, A0 * res_i.mode, abs(res_i.sigma.imag))
            if cres.converged:
                logger.info("SCM continuation: coupled Newton closed Re = %g at A = %.4f (from "
                            "A = %.4f, sigma_r = %+.1e).", re, cres.amplitude, res_i.amplitude,
                            res_i.sigma.real)
                res_i = cres
        out.append((re, res_i))
        if res_i.amplitude > 0:
            # a wall-limited state is still the best warm start for the
            # next Re; the curve extrapolation uses the Stuart-Landau root
            # estimate when the march could not reach marginality
            state = (res_i.mean, res_i.mode, res_i.sigma)
            xs.append((re, (res_i.amplitude_sl or res_i.amplitude) ** 2))
        if not res_i.converged:
            logger.warning("SCM continuation: Re = %g wall-limited (A = %.3f, A_SL = %s).", re,
                           res_i.amplitude, res_i.amplitude_sl)
    return out
