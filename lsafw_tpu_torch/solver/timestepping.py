"""Unsteady incompressible Navier-Stokes: nonlinear time integration.

Counterpart of the reference's ``solver/timestepping`` module: a
theta-scheme (Crank-Nicolson by default) marching of

    M dq/dt = R(q),

with R the stationary-NS residual (momentum + continuity + Dirichlet
rows; the Jacobian dR/dq is the eigensystem operator A, so sigma_r > 0
means unstable and perturbations evolve as M dq'/dt = +J q') and M the
velocity mass with zero pressure and Dirichlet rows, on the stationary
Jacobian's pattern.

Per step, chord Newton on

    G(q1) = M (q1 - q0) - dt [theta R(q1) + (1 - theta) R_mom(q0)] = 0,

where the explicit part R_mom is masked to the momentum rows, so the
continuity row enforces div q1 = 0 implicitly, and G is zero on the
Dirichlet rows: the Newton matrix M - dt theta J(q1) carries -dt theta on
their diagonal, so an update leaves the boundary values where the
initial state put them.  The Newton matrix is factored once and frozen
across iterations and, with ``refactor_every``, across steps; a change
of dt, or a Newton that stalls, refactors.

``method="banded"`` (the default; the reference defaults to its host
``"lu"``, which runs here only when asked for): the Newton matrix's
real band factor (:func:`~lsafw_tpu_torch.solver.band.factor_auto`: on
the card the panel-pivoted f32 factor, K1/K2's pivoted f32 one-column
substitution) with f64 GCR refinement through S on the Newton matrix's
own values (:class:`~lsafw_tpu_torch.solver.eigen.BandedSIOp` with
M = None at sigma = 0; GCR to tol 1e-11 in at most 40 iterations, a
miss raising :class:`~lsafw_tpu_torch.solver.eigen.FactorUnusable`).
The reference fuses a step into one program; here a step
is a Python loop of device calls whose only host synchronisations are
the Newton stop test and the refinement's own.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
)
from lsafw_tpu_torch.ops.bcsr import operator_for_budget
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.solver.band import factor_auto, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.eigen import BandedSIOp, refine_checked
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SOLVE_TOL, SOLVE_MAX_ITS = 1e-11, 40  # the reference's banded Newton solves


@dataclass
class StepStats:
    t: float
    newton_iters: int  # Newton corrections taken
    residual: float
    refactored: bool


@dataclass
class UnsteadyResult:
    t: np.ndarray  # (n_saved,)
    probes: np.ndarray  # (n_saved, n_probes)
    q: torch.Tensor  # final state, on the solver's device
    stats: list = field(default_factory=list)


def momentum_mask(spaces, bc_mask: np.ndarray) -> np.ndarray:
    """Velocity rows not under Dirichlet: the explicit side's rows."""
    mom = np.zeros(spaces.num_dofs, dtype=bool)
    mom[:spaces.num_velocity_dofs] = True
    return mom & ~np.asarray(bc_mask, dtype=bool)


class UnsteadySolver:
    """theta-scheme marching with chord-Newton steps.

    Args:
        ctx, mesh, bcs: as for the baseflow solver (inhomogeneous BCs
            belong in ``bcs``; the state carries the lift).
        re: Reynolds number.
        theta: 0.5 = Crank-Nicolson (default), 1.0 = backward Euler.
        method: ``"banded"`` (the device band factor, default) or ``"lu"``
            (host SuperLU, asked for only).
        refactor_every: steps between Newton-matrix factorizations.
        device: must be the assembly context's; the default ``"cuda"``
            raises without a usable GPU unless ``device="cpu"`` is passed.

    ``stats`` counts factors, their seconds and the refinement's GCR
    iterations.
    """

    def __init__(self, ctx: AssemblyContext, mesh, bcs, re: float, *, theta: float = 0.5,
                 method: str = "banded", newton_tol: float = 1e-9, newton_maxit: int = 12,
                 refactor_every: int = 1, device="cuda") -> None:
        device = resolve_device(device)
        if device.type != ctx.device.type:
            raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
        if method not in ("banded", "lu"):
            raise NotImplementedError(f"method {method!r}: only 'banded' and 'lu' are ported")
        self.ctx = ctx
        self.re = float(re)
        self.theta = float(theta)
        self.method = method
        self.newton_tol = float(newton_tol)
        self.newton_maxit = int(newton_maxit)
        self.refactor_every = max(1, int(refactor_every))
        self._asm = StationaryNavierStokesAssembler(ctx, mesh, bcs)
        self._bc_mask = self._asm.bc_mask
        self._mom_mask = torch.as_tensor(momentum_mask(ctx.spaces, bcs.dirichlet_mask),
                                         device=ctx.device)
        n = ctx.spaces.num_dofs
        lin = LinearizedNavierStokesAssembler(np.zeros(n), ctx, self.re, bcs, mesh)
        self._M = lin.assemble_mass_matrix()
        self._Mop = operator_for_budget(self._M)
        self._factor = None
        self._factor_dt = None
        self._steps_since_factor = 0
        self._factor_bdf2 = None
        self._bdf2_dt = None
        self._bdf2_steps_since = 0
        self.stats = dict(factors=0, factor_s=0.0, gcr_its=0)

    # ------------------------------------------------------------------
    def _state(self, q) -> torch.Tensor:
        return torch.as_tensor(q, dtype=torch.float64, device=self.ctx.device)

    def _mass(self, x: torch.Tensor) -> torch.Tensor:
        return self._Mop.matvec(x) if self._Mop is not None else spmv(self._M, x)

    def _newton_matrix_data(self, q, dt: float) -> torch.Tensor:
        Jd = self._asm.jacobian_data(q, self.re)
        return self._M.data - (dt * self.theta) * Jd

    def _build_factor(self, data: torch.Tensor):
        """Factor of a Newton-matrix data array on the shared pattern:
        ``("banded", BandedSIOp)`` (the band factor and S's operator on
        the same values) or ``("lu", SparseLU)``."""
        A = CSRMatrix(self.ctx.pattern, data)
        t0 = time.perf_counter()
        if self.method == "banded":
            blu, _ = factor_auto(plan_for_csr(A, real=True), data,
                                 diag_slots=self.ctx.pattern.diag_slots)
            out = ("banded", BandedSIOp(A, None, blu, 0.0, operator_for_budget(A)))
        else:
            out = ("lu", SparseLU(A))
        self.stats["factors"] += 1
        self.stats["factor_s"] += time.perf_counter() - t0
        return out

    def _refactor(self, q, dt: float) -> None:
        self._factor = None  # free the old factor before the new one is made
        self._factor = self._build_factor(self._newton_matrix_data(q, dt))
        self._factor_dt = float(dt)
        self._steps_since_factor = 0

    def _solve_with(self, factor, b: torch.Tensor) -> torch.Tensor:
        kind, fac = factor
        if kind == "banded":
            x, its = refine_checked(fac, b, tol=SOLVE_TOL, max_its=SOLVE_MAX_ITS,
                                    what="unsteady Newton solve")
            self.stats["gcr_its"] += its
            return x
        return torch.as_tensor(fac.solve(b.cpu().numpy()), device=b.device)

    def _residual(self, q: torch.Tensor, load) -> torch.Tensor:
        """R(q), plus the body-force vector ``load`` where there is one."""
        R = self._asm.residual(q, self.re)
        return R if load is None else R + self._state(load)

    def _newton(self, q, G_of, factor, scale_vec: torch.Tensor):
        """Chord Newton from ``q``: (q, residual, corrections, scale).  It
        stops at ||G|| <= newton_tol * max(||scale_vec||, 1)
        (the f64 rounding floor of G) or ||G|| <= 1e-6 ||G(q)|| (the step's
        initial defect), or after newton_maxit corrections; one host
        synchronisation per test."""
        G = G_of(q)
        res0, scale = torch.stack([torch.linalg.vector_norm(G),
                                   torch.linalg.vector_norm(scale_vec)]).tolist()
        scale = max(scale, 1.0)
        res, it = res0, 0
        while res > self.newton_tol * scale and res > 1e-6 * res0 and it < self.newton_maxit:
            q = q + self._solve_with(factor, -G)
            G = G_of(q)
            res = float(torch.linalg.vector_norm(G))
            it += 1
        return q, res, it, scale

    def step(self, q0, dt: float, t: float = 0.0, load0=None,
             load1=None) -> tuple[torch.Tensor, StepStats]:
        """One theta step from ``q0`` (which must satisfy the Dirichlet
        BCs).  ``load0``/``load1``: optional assembled body-force vectors
        at t and t + dt, added to R."""
        q0 = self._state(q0)
        refactored = False
        if (self._factor is None or self._steps_since_factor >= self.refactor_every
                or self._factor_dt != float(dt)):
            self._refactor(q0, dt)
            refactored = True
        theta = self.theta
        expl = (dt * (1.0 - theta)) * torch.where(self._mom_mask, self._residual(q0, load0), 0.0)
        Mq0 = self._mass(q0)

        def G_of(q1):
            F = torch.where(self._bc_mask, 0.0, self._residual(q1, load1))
            return self._mass(q1) - Mq0 - (dt * theta) * F - expl

        q1, res, it, scale = self._newton(q0, G_of, self._factor, Mq0)
        if it >= self.newton_maxit and res > 1e3 * self.newton_tol * scale:
            logger.warning("Unsteady Newton slow at t=%.3f (res %.2e); refactoring.", t, res)
            self._refactor(q1, dt)
            refactored = True
        self._steps_since_factor += 1
        return q1, StepStats(t + dt, it, res, refactored)

    def step_bdf2(self, q1, q0, dt: float, t: float = 0.0,
                  load2=None) -> tuple[torch.Tensor, StepStats]:
        """One BDF2 step (L-stable; for long stiff marches),

            G(q2) = M (1.5 q2 - 2 q1 + 0.5 q0) - dt (R(q2) + load2) = 0,

        Newton matrix 1.5 M - dt J(q2); fully implicit, so continuity and
        BC rows need no explicit-side masking.  Bootstrap the first step
        with :meth:`step` (CN).  Its own chord factor goes through the same
        backend as the theta step's."""
        q1, q0 = self._state(q1), self._state(q0)
        refactored = False
        if (self._factor_bdf2 is None or self._bdf2_steps_since >= self.refactor_every
                or self._bdf2_dt != float(dt)):
            self._factor_bdf2 = None
            Jd = self._asm.jacobian_data(q1, self.re)
            self._factor_bdf2 = self._build_factor(1.5 * self._M.data - dt * Jd)
            self._bdf2_dt = float(dt)
            self._bdf2_steps_since = 0
            refactored = True
        rhs = self._mass(2.0 * q1 - 0.5 * q0)

        def G_of(q2):
            F = torch.where(self._bc_mask, 0.0, self._residual(q2, load2))
            return 1.5 * self._mass(q2) - rhs - dt * F

        q2, res, it, _ = self._newton(q1, G_of, self._factor_bdf2, rhs)
        self._bdf2_steps_since += 1
        return q2, StepStats(t + dt, it, res, refactored)

    # ------------------------------------------------------------------
    def run(self, q0, dt: float, n_steps: int, *, probe_dofs=None, save_every: int = 1,
            t0: float = 0.0, load_fn=None, scheme: str = "theta", checkpoint_path=None,
            checkpoint_every: int = 200) -> UnsteadyResult:
        """March ``n_steps``, recording ``q[probe_dofs]`` every
        ``save_every`` steps.  ``load_fn(t)``: optional assembled
        body-force vector at time t.  ``scheme``: ``"theta"`` or ``"bdf2"``
        (CN-bootstrapped).  ``checkpoint_path``: an .npz written atomically
        every ``checkpoint_every`` steps; a rerun with the same path
        resumes from it (state, BDF2 history, probe series).  Probe values
        stay on the device until the march ends or a checkpoint is
        written."""
        probe = torch.as_tensor(np.asarray(probe_dofs if probe_dofs is not None else [0]),
                                dtype=torch.long, device=self.ctx.device)
        q = self._state(q0)
        q_prev = None
        ts: list = []
        probes: list = []
        stats: list = []
        t = t0
        k0 = 0
        cp = None
        if checkpoint_path is not None:
            cp = Path(checkpoint_path)  # np.savez appends .npz: normalise so resume finds it
            if cp.suffix != ".npz":
                cp = cp.with_suffix(cp.suffix + ".npz")
            if cp.exists():
                with np.load(cp, allow_pickle=False) as d:
                    k0, t = int(d["k"]), float(d["t"])
                    q = self._state(d["q"])
                    q_prev = self._state(d["q_prev"]) if d["has_prev"] else None
                    ts = list(d["ts"])
                    probes = [self._state(p) for p in d["probes"]]
                logger.info("Resuming unsteady march from checkpoint %s (step %d, t=%.3f).",
                            cp, k0, t)

        def save(k: int) -> None:
            # atomic: an interrupted write must not corrupt the only copy
            tmp = cp.with_suffix(".tmp.npz")
            np.savez(tmp, k=k, t=t, q=q.cpu().numpy(),
                     q_prev=(q_prev if q_prev is not None else q).cpu().numpy(),
                     has_prev=q_prev is not None, ts=np.asarray(ts),
                     probes=(torch.stack(probes).cpu().numpy() if probes
                             else np.zeros((0, probe.numel()))))
            os.replace(tmp, cp)

        for k in range(k0, n_steps):
            if scheme == "bdf2" and q_prev is not None:
                q_new, st = self.step_bdf2(q, q_prev, dt, t,
                                           load2=None if load_fn is None else load_fn(t + dt))
                q_prev, q = q, q_new
            else:
                q_prev = q
                q, st = self.step(q, dt, t, load0=None if load_fn is None else load_fn(t),
                                  load1=None if load_fn is None else load_fn(t + dt))
            t = st.t
            stats.append(st)
            if (k + 1) % save_every == 0:
                ts.append(t)
                probes.append(q[probe])
            if not np.isfinite(st.residual):
                # never persist a poisoned state: a NaN checkpoint would brick every resume
                logger.error("Unsteady solve diverged at t=%.3f.", t)
                break
            if cp is not None and (k + 1) % checkpoint_every == 0:
                save(k + 1)
        P = torch.stack(probes).cpu().numpy() if probes else np.zeros((0, probe.numel()))
        return UnsteadyResult(np.asarray(ts), P, q, stats)


def dominant_frequency(t: np.ndarray, signal: np.ndarray) -> float:
    """Peak frequency (rad/time) of a uniformly-sampled scalar signal,
    refined by parabolic interpolation of the FFT magnitude peak."""
    s = np.asarray(signal, dtype=np.float64)
    s = s - s.mean()
    n = s.size
    if n < 8:
        raise ValueError("signal too short")
    dt = float(t[1] - t[0])
    win = np.hanning(n)
    spec = np.abs(np.fft.rfft(s * win))
    freqs = np.fft.rfftfreq(n, dt)
    k = int(np.argmax(spec[1:])) + 1
    # parabolic refinement around the peak bin
    if 1 <= k < spec.size - 1:
        a, b, c = spec[k - 1], spec[k], spec[k + 1]
        denom = a - 2 * b + c
        shift = 0.5 * (a - c) / denom if denom != 0 else 0.0
        shift = float(np.clip(shift, -0.5, 0.5))
    else:
        shift = 0.0
    return 2.0 * np.pi * (freqs[k] + shift * (freqs[1] - freqs[0]))
