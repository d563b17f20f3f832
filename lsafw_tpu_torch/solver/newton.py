"""Damped Newton for stationary Navier-Stokes.

The state ``w`` always satisfies the Dirichlet data exactly, so the
update solves J(w) dw = -F(w) with identity BC rows and F[bc] = 0.
Residual and Jacobian are assembled on the device.  Inner solves:

* ``linear_solver="banded"``: the device band LU of the real Jacobian
  (:func:`~lsafw_tpu_torch.solver.band.factor_auto` on one real
  :class:`~lsafw_tpu_torch.solver.band.BandPlan` built on the first
  step, refactored every step) with truncated GCR(8) refinement in f64
  (:func:`_banded_mr`), whose matvecs run through the S kernel on the
  permuted CSR (``ops/bcsr.py``, refilled from J's data every step).  A
  step the refinement brings under a relative residual of 1e-3 is
  accepted (inexact Newton).  A worse one on a bf16 band (a band over
  its memory budget) takes the reference's retry rung: the failed band
  is freed, the pattern marked :func:`~lsafw_tpu_torch.solver.band.mark_bf16_unstable`,
  and the step is solved again on a budget-clipped f32 plan; a failure
  there, or on an f32 band, raises :class:`BandedStepMissed` (a
  ``RuntimeError``: no banded solve returns past its tolerance).  A
  caller for which a missed step is a failed trial, as the
  self-consistent model's damping ladder, catches it.
* ``linear_solver="lu"``: host SuperLU.
* any other name: that Krylov type of :mod:`~lsafw_tpu_torch.solver.linear`
  (``"gmres"``, ``"bcgs"``, ...) on the device through
  :func:`~lsafw_tpu_torch.solver.linear.solve_csr`, preconditioned by
  block-Jacobi over 64 x 64 diagonal blocks, to ``linear_tol`` within
  5000 iterations; a stalled solve is logged and its iterate taken, as the
  reference does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
from lsafw_tpu_torch.ops.bcsr import operator_for_budget
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.solver.band import factor_auto, mark_bf16_unstable, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.linear import KSPType, SolveResult, solve_csr
from lsafw_tpu_torch.solver.precond import block_jacobi
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def new_stats() -> dict:
    """Counters of the banded inner solves: device seconds (synchronised)
    of the factors, band solves and matvecs, and their counts."""
    return dict(factor_s=0.0, solve_s=0.0, spmv_s=0.0, factors=0, solves=0, spmvs=0,
                gcr_its=0, pivoted=0)


def _timed(stats: dict | None, key: str, fn, *args):
    """fn(*args), adding its synchronised wall time to ``stats[key + '_s']``."""
    if stats is None:
        return fn(*args)
    dev = args[-1].device if isinstance(args[-1], torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats[key + "_s"] += time.perf_counter() - t0
    stats[key + "s"] += 1
    return out


def _banded_mr(J: CSRMatrix, blu, b: torch.Tensor, Jop=None, *, tol: float,
               max_its: int = 300, m: int = 8, stats: dict | None = None) -> SolveResult:
    """Truncated GCR(m) on the real Jacobian with the band factor as
    preconditioner: each step orthogonalizes the new direction's image
    against the last ``m`` kept images.  ``Jop``: the permuted-CSR
    operator for the matvecs (else the CSR matrix).  ``blu`` is any band
    factor (its ``solve`` takes and returns an f64 vector)."""
    jmv = Jop.matvec if Jop is not None else (lambda v: spmv(J, v))

    def bsolve(v):
        return _timed(stats, "solve", blu.solve, v)

    def apply(v):
        return _timed(stats, "spmv", jmv, v)

    bnorm = max(float(torch.linalg.vector_norm(b)), 1e-300)
    x = bsolve(b)
    r = b - apply(x)
    D = torch.zeros((m, b.shape[0]), dtype=b.dtype, device=b.device)
    CD = torch.zeros_like(D)
    k = 0
    while k < max_its:
        rn = float(torch.linalg.vector_norm(r))
        if not (np.isfinite(rn) and rn > tol * bnorm):
            break
        d = bsolve(r)
        Cd = apply(d)
        beta = CD @ Cd  # CGS against the kept images
        Cd = Cd - CD.T @ beta
        d = d - D.T @ beta
        nrm = torch.linalg.vector_norm(Cd).clamp_min(1e-300)
        d, Cd = d / nrm, Cd / nrm
        alpha = torch.dot(Cd, r)
        x = x + alpha * d
        r = r - alpha * Cd
        D[k % m] = d
        CD[k % m] = Cd
        k += 1
    if stats is not None:
        stats["gcr_its"] += k
    res = float(torch.linalg.vector_norm(r)) / bnorm
    return SolveResult(x, k, res, bool(res <= tol))


def banded_solve(A: CSRMatrix, b: torch.Tensor, plan, *, tol: float,
                 stats: dict | None = None) -> SolveResult:
    """One banded solve of the real operator ``A``: factor on ``plan``
    (:func:`factor_auto`), refill the matvec operator from A's data, run
    :func:`_banded_mr`."""
    dev = A.data.device
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    blu, pivoted = factor_auto(plan, A.data, diag_slots=A.pattern.diag_slots)
    if stats is not None:
        stats["factor_s"] += time.perf_counter() - t0
        stats["factors"] += 1
        stats["pivoted"] += int(pivoted)
    return _banded_mr(A, blu, b, operator_for_budget(A), tol=tol, stats=stats)


def _accepted(res: SolveResult) -> torch.Tensor | None:
    """A banded step's solution if it is finite and converged, or under a
    relative residual of 1e-3 (inexact Newton: the outer |F| criterion
    alone decides convergence); else None."""
    if not bool(torch.isfinite(res.x).all()):
        return None
    if res.converged:
        return res.x
    if res.residual < 1e-3:
        logger.info("Accepting inexact banded Newton step (rel res %.1e).", res.residual)
        return res.x
    return None


@dataclass
class NewtonResult:
    w: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool
    history: list[float]


class BandedStepMissed(RuntimeError):
    """A banded Newton step whose refinement missed the inexact-Newton
    acceptance (relative residual 1e-3), with its ``residual`` and
    refinement ``iterations``."""

    def __init__(self, residual: float, iterations: int) -> None:
        super().__init__(f"banded Newton step failed: relative residual {residual:.2e} after "
                         f"{iterations} refinement iterations")
        self.residual, self.iterations = residual, iterations


class NewtonSolver:
    """Newton with adjustable damping; inner solves ``"banded"`` (device),
    ``"lu"`` (host) or a Krylov type (device, block-Jacobi)."""

    def __init__(
        self,
        assembler: StationaryNavierStokesAssembler,
        *,
        damping: float = 1.0,
        linear_solver: str = "lu",
        linear_tol: float = 1e-10,
        stats: dict | None = None,
    ) -> None:
        if linear_solver not in ("lu", "banded"):
            KSPType.from_string(linear_solver)  # an unknown name raises here
        self._asm = assembler
        self._damping = damping
        self._linear_solver = linear_solver
        self._linear_tol = linear_tol
        self._band_plan = None  # built on the first Jacobian's pattern
        self.stats = new_stats() if stats is None else stats

    def _masked_residual(self, w: torch.Tensor, re: float) -> torch.Tensor:
        F = self._asm.residual(w, re)
        return torch.where(self._asm.bc_mask, torch.zeros_like(F), F)

    def _banded_solve(self, J: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
        """Device band LU (f32, or bf16 at rest) of the real Jacobian + f64
        GCR refinement, with the bf16 -> f32 retry rung."""
        if self._band_plan is None:
            self._band_plan = plan_for_csr(J, real=True)
        res = banded_solve(J, b, self._band_plan, tol=self._linear_tol, stats=self.stats)
        x = _accepted(res)
        if x is None and self._band_plan.band_dtype == "bf16":
            logger.warning("bf16 full-width band failed (rel res %.2e); retrying with a "
                           "budget-clipped f32 band", res.residual)
            mark_bf16_unstable(J.pattern)
            self._band_plan = plan_for_csr(J, real=True, force_f32=True)
            res = banded_solve(J, b, self._band_plan, tol=self._linear_tol, stats=self.stats)
            x = _accepted(res)
        if x is None:
            raise BandedStepMissed(res.residual, res.iterations)
        return x

    def _krylov_solve(self, J: CSRMatrix, b: torch.Tensor, it: int) -> torch.Tensor:
        """The Krylov inner solve: block-Jacobi(64) and ``solve_csr``."""
        res = solve_csr(J, b, M=block_jacobi(J, 64), ksp_type=self._linear_solver,
                        tol=self._linear_tol, maxiter=5000)
        self.stats["krylov_its"] = self.stats.get("krylov_its", 0) + res.iterations
        if not res.converged:
            logger.warning("Inner %s solve stalled (res=%.2e) at Newton it %d",
                           self._linear_solver, res.residual, it)
        return res.x

    def solve(self, w0, re: float, *, max_it: int = 50, tol: float = 1e-6) -> NewtonResult:
        """Iterate to the steady state (divergence -> warning + partial
        result instead of raising)."""
        asm = self._asm
        w = torch.where(asm.bc_mask, asm.bc_values, asm._state(w0))
        history: list[float] = []
        converged = False
        it = 0
        for it in range(1, max_it + 1):
            F = self._masked_residual(w, re)
            rnorm = float(torch.linalg.norm(F))
            history.append(rnorm)
            if not np.isfinite(rnorm):
                logger.warning("Newton residual is not finite; aborting at it %d", it)
                break
            if rnorm < tol:
                converged = True
                break
            J = asm.jacobian(w, re)
            if self._linear_solver == "banded":
                dw = self._banded_solve(J, -F)
            elif self._linear_solver == "lu":
                dw = torch.as_tensor(SparseLU(J).solve(-F.cpu().numpy()), device=w.device)
            else:
                dw = self._krylov_solve(J, -F, it)
            if not bool(torch.isfinite(dw).all()):
                logger.warning("Newton update is not finite; aborting at it %d", it)
                break
            w = w + self._damping * dw
            logger.debug("Newton it %d: |F| = %.3e", it, rnorm)
        else:
            it = max_it
        rfinal = float(torch.linalg.norm(self._masked_residual(w, re)))
        if rfinal < tol:
            converged = True
        if not converged:
            logger.warning(
                "Newton did not converge in %d iterations (|F| = %.3e); "
                "returning partial result", it, rfinal,
            )
        return NewtonResult(w=w.cpu().numpy(), iterations=it, residual_norm=rfinal,
                            converged=converged, history=history)
