"""Floquet stability of periodic orbits (the shedding limit cycle).

Counterpart of the reference's ``floquet`` module: the eigenvalues of
the monodromy operator Phi_T, the linearization of the period-T flow map
around a periodic orbit.  Multipliers |mu| > 1 mean the cycle is
unstable; a limit cycle of an autonomous system carries the trivial
multiplier mu = 1 (the phase mode), a built-in check.

Discretization: the exact linearization of the nonlinear theta-stepper
(:mod:`lsafw_tpu_torch.solver.timestepping`) around stored snapshots
q_0 .. q_{N-1} (q_N = q_0):

    (M - dt theta J(q_{k+1})) v_{k+1} = (M + dt (1 - theta) J_mom(q_k)) v_k,

J the stationary Jacobian (identity Dirichlet rows) and J_mom its
momentum rows, the stepper's masks.  Multipliers come from ARPACK on
the host over the matrix-free Phi_T action.

On the card a trip is a loop over the N snapshots on complex128
vectors that stay on the device (one copy in and one out per apply).
Each step's right-hand side is one S launch in its shifted mode at
sigma = 0 with M x (``BCSRShiftedOp`` on J(q_k)'s and M's values: J v
and M v from one pass); its implicit solve is a band solve of the real
factor, whose K1/K2 take the complex vector as two f32 columns in one
pass, refined by GCR on the step's implicit values through S
(:class:`~lsafw_tpu_torch.solver.eigen.BandedSIOp` with M = None at
sigma = 0).  Every snapshot's values sit in S's slot order on one
permuted-CSR plan of the pattern (a G refill each, once).

Each step refines to 1e-12 (``TOL``).  Prestored (``inexact=False``): N
implicit factors, one per step, at most 40 GCR iterations.
``inexact=True``: one factor of the cycle-mean implicit matrix
M - dt theta J(q_mean) preconditions every step's GCR (at most 120
iterations): the implicit matrices differ from the mean by
dt theta (J(q_k) - J(q_mean)), so the refinement contracts fast at a dt
that resolves the cycle, and factor storage drops N-fold.  A refinement
that misses its tolerance raises.  ``method="lu"`` (asked for only)
takes host SuperLU factors instead, and the host refinement in inexact
mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
)
from lsafw_tpu_torch.ops.bcsr import BCSROperator, BCSRShiftedOp, plan_for_pattern
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.solver.band import BandPlan, factor_auto, pivoted_extra_bytes, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.eigen import BandedSIOp, bcsr_budget, refine_checked
from lsafw_tpu_torch.solver.timestepping import momentum_mask
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# GCR tolerance of a step, and its iterations prestored / inexact.  The
# reference's device trip stops at 1e-11 and its host refinement at 1e-12;
# at 1e-11 the prestored trip of the 43k shedding cycle ended 2e-8 from the
# inexact one on an H100 (one prestored step was 2.5e-10 from a host LU).
TOL = 1e-12
MAX_ITS = {False: 40, True: 120}


@dataclass
class FloquetResult:
    period: float
    multipliers: np.ndarray  # (k,) complex, descending |mu|
    modes: np.ndarray  # (k, n) complex
    trivial_error: float  # min_j |mu_j - 1| (phase-mode check)


def factor_bytes(plan: BandPlan, pivoted: bool) -> int:
    """Device bytes of one real factor on ``plan``: its band
    (:meth:`BandPlan.band_bytes`) and the pivoted factor's extras, or the
    pivot-free factor's inverse diagonal blocks."""
    bf16 = plan.band_dtype == "bf16" and not pivoted
    band = BandPlan.band_bytes(plan.n, plan.B, nb=plan.nb, chunk=plan.chunk,
                               per_entry=2 if bf16 else 4)
    return band + (pivoted_extra_bytes(plan) if pivoted else plan.nblk_pad * plan.nb ** 2 * 4)


class FloquetSolver:
    """Monodromy eigenanalysis around the snapshots of one period.

    Args:
        ctx, mesh, bcs: the nonlinear problem's definition (those the
            :class:`~lsafw_tpu_torch.solver.timestepping.UnsteadySolver`
            marched with).
        re: Reynolds number.
        snapshots: (N, n) states over one period (q_N = q_0 implied,
            uniformly spaced in time).
        dt: snapshot spacing (period = N dt).
        theta: must match the stepper that made the orbit.
        method: ``"banded"`` (default) or ``"lu"`` (host SuperLU, asked for
            only).
        inexact: one cycle-mean factor as the preconditioner of every
            step, instead of N prestored factors.
        device: must be the assembly context's; the default ``"cuda"``
            raises without a usable GPU unless ``device="cpu"`` is passed.

    ``stats`` counts factors, their seconds, trip steps, the GCR
    iterations of the band solves and monodromy applies.
    """

    def __init__(self, ctx: AssemblyContext, mesh, bcs, re: float, snapshots, dt: float, *,
                 theta: float = 0.5, method: str = "banded", inexact: bool = False,
                 device="cuda") -> None:
        device = resolve_device(device)
        if device.type != ctx.device.type:
            raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
        self.ctx = ctx
        self.re = float(re)
        asm = StationaryNavierStokesAssembler(ctx, mesh, bcs)
        n = ctx.spaces.num_dofs
        Md = LinearizedNavierStokesAssembler(np.zeros(n), ctx, self.re, bcs,
                                             mesh).assemble_mass_matrix().data
        # each snapshot's Jacobian once; step k's implicit matrix takes q_{k+1}'s
        Jdata = [asm.jacobian_data(s, self.re) for s in snapshots]
        self._setup(ctx.pattern, Md, Jdata, momentum_mask(ctx.spaces, bcs.dirichlet_mask), dt,
                    theta=theta, method=method, inexact=inexact)

    @classmethod
    def from_operator_data(cls, pattern, Md: torch.Tensor, Jdata: list, mom, dt: float, *,
                           theta: float = 0.5, method: str = "banded", inexact: bool = False,
                           device="cuda") -> "FloquetSolver":
        """Monodromy analysis of any linear(ized) system on one sparsity
        pattern: ``Md`` the mass data, ``Jdata`` one Jacobian data array
        per snapshot (identity Dirichlet rows), ``mom`` the explicit side's
        row mask; the data's device must be ``device``.  The quasi-3D
        spanwise Floquet (:func:`lsafw_tpu_torch.span.spanwise_floquet`)
        builds on it."""
        device = resolve_device(device)
        if device.type != Md.device.type:
            raise ValueError(f"device {device} is not the data's {Md.device}")
        self = cls.__new__(cls)
        self.ctx = None
        self.re = None
        self._setup(pattern, Md, Jdata, np.asarray(mom), dt, theta=theta, method=method,
                    inexact=inexact)
        return self

    def _setup(self, pattern, Md, Jdata, mom, dt, *, theta, method, inexact) -> None:
        if method not in ("banded", "lu"):
            raise NotImplementedError(f"method {method!r}: only 'banded' and 'lu' are ported")
        self._pattern = pattern
        self.dt = float(dt)
        self.theta = float(theta)
        self.method = method
        self.inexact = bool(inexact)
        self.N = len(Jdata)
        self.period = self.N * self.dt
        self._dev = Md.device
        self._mom = torch.as_tensor(np.asarray(mom, dtype=bool), device=self._dev)
        self._M = CSRMatrix(pattern, Md)
        self._Md = Md
        self._expl = [CSRMatrix(pattern, Jk) for Jk in Jdata]
        self._ew = self.dt * (1.0 - self.theta)
        self._dth = self.dt * self.theta
        self.stats = dict(factors=0, factor_s=0.0, steps=0, gcr_its=0, applies=0)
        logger.info("Floquet: %s %d implicit steps (%s) over period %.3f",
                    "mean-PC refining" if self.inexact else "factoring", self.N, method,
                    self.period)
        self._fac_mean = None
        self._facs = None
        if self.inexact:
            self._init_inexact(Jdata, Md)
        else:
            self._facs = [self._factor(self._imp_data(k)) for k in range(self.N)]
            self._log_storage(self._facs, "across %d snapshots" % self.N)
        self._init_operands()

    def _factor(self, data: torch.Tensor):
        """One implicit factor: ``(blu, pivoted)`` on the device, or a host
        SparseLU."""
        t0 = time.perf_counter()
        A = CSRMatrix(self._pattern, data)
        if self.method == "banded":
            out = factor_auto(plan_for_csr(A, real=True), data,
                              diag_slots=self._pattern.diag_slots)
        else:
            out = SparseLU(A)
        self.stats["factors"] += 1
        self.stats["factor_s"] += time.perf_counter() - t0
        return out

    def _log_storage(self, facs: list, where: str) -> None:
        if self.method == "banded":
            plan = plan_for_csr(self._M, real=True)
            fac_bytes = sum(factor_bytes(plan, pivoted) for _, pivoted in facs)
        else:  # SuperLU's nnz counts L and U without copying them out
            fac_bytes = sum(f._lu.nnz for f in facs) * 12
        self.factor_bytes = fac_bytes
        logger.info("Floquet factor storage: %.2f GB %s%s.", fac_bytes / 1e9, where,
                    "" if self.inexact else " (pass inexact=True for one mean-matrix factor "
                                            "instead)")

    def _init_inexact(self, Jdata, Md) -> None:
        """One factor of the cycle-mean implicit matrix, the shared
        preconditioner; each step's implicit values are an axpy on the
        stored Jacobians."""
        mean_J = Jdata[0]
        for Jk in Jdata[1:]:
            mean_J = mean_J + Jk
        self._fac_mean = self._factor(Md - self._dth * (mean_J / self.N))
        self._log_storage([self._fac_mean], "in one mean-matrix factor shared across %d "
                                            "snapshots" % self.N)

    def _init_operands(self) -> None:
        """S's operands: M's and every snapshot's Jacobian values in the
        permuted-CSR slot order of the pattern's one plan (and, prestored,
        each step's implicit values), or None where they do not fit beside
        the factors (then the CSR matrices apply them, and the log says
        so): the budget is :func:`~lsafw_tpu_torch.solver.eigen.bcsr_budget`,
        whose free memory already excludes the factors."""
        self._plan = self._vM = self._vE = self._vimp = None
        if self.method != "banded":
            return
        plan = plan_for_pattern(self._M)
        arrays = 1 + self.N + (1 if self.inexact else self.N)
        need = arrays * plan.bytes_per_matrix + plan.index_bytes
        budget = bcsr_budget(self._dev)
        if need > budget:
            logger.info("Floquet S operands (%.2f GB) over budget %.1f GB; applying the CSR "
                        "matrices.", need / 1e9, budget / 1e9)
            return
        csr = plan.on(self._dev)
        self._plan = plan
        self._vM = csr.values(self._Md)
        self._vE = [csr.values(E.data) for E in self._expl]
        if self.inexact:  # each step's implicit values, written in place (S's padded storage)
            self._vimp = [csr.values(self._Md)]
        else:
            self._vimp = [csr.values(self._imp_data(k)) for k in range(self.N)]
        logger.info("Floquet S operands: %d value arrays, %.3f GB", arrays, need / 1e9)

    # ------------------------------------------------------------------
    def _imp_data(self, k: int) -> torch.Tensor:
        """CSR data of step k's implicit matrix M - dt theta J(q_{k+1})."""
        return torch.add(self._Md, self._expl[(k + 1) % self.N].data, alpha=-self._dth)

    def _imp_op(self, k: int) -> BandedSIOp:
        """Step k's implicit operator: its band factor (prestored, or the
        mean one) and S on its own values, at sigma = 0 with M = None."""
        blu = self._fac_mean[0] if self.inexact else self._facs[k][0]
        A = CSRMatrix(self._pattern, self._imp_data(k))
        if self._plan is None:
            return BandedSIOp(A, None, blu, 0.0)
        if self.inexact:
            vals = torch.add(self._vM, self._vE[(k + 1) % self.N], alpha=-self._dth,
                             out=self._vimp[0])
        else:
            vals = self._vimp[k]
        return BandedSIOp(A, None, blu, 0.0, BCSROperator(vals, self._plan))

    def _rhs(self, k: int, v: torch.Tensor) -> torch.Tensor:
        """(M + dt (1 - theta) J_mom(q_k)) v: J v and M v from one S pass."""
        if self._plan is None:
            Jv, Mv = spmv(self._expl[k], v), spmv(self._M, v)
        else:
            Jv, Mv = BCSRShiftedOp(self._vE[k], self._vM, 0.0, self._plan).matvec_pair(
                v, mass=True)
        return Mv + self._ew * torch.where(self._mom, Jv, 0.0)

    def _refine_host(self, A, b: np.ndarray, *, tol: float = 1e-12,
                     max_its: int = 200) -> np.ndarray:
        """Host minimal-residual refinement: the mean-matrix LU as the
        preconditioner, residual matvecs on the true implicit matrix ``A``
        (the host twin of the device GCR)."""
        x = self._fac_mean.solve(b)
        r = b - A @ x
        bnorm = max(float(np.linalg.norm(b)), 1e-300)
        for _ in range(max_its):
            if np.linalg.norm(r) <= tol * bnorm:
                break
            d = self._fac_mean.solve(r)
            Ad = A @ d
            alpha = float(Ad @ r) / max(float(Ad @ Ad), 1e-300)
            x += alpha * d
            r -= alpha * Ad
        else:
            logger.warning("Floquet inexact refinement hit max_its (rel res %.2e).",
                           np.linalg.norm(r) / bnorm)
        return x

    def _step(self, k: int, v: torch.Tensor) -> torch.Tensor:
        """One linearized theta step k -> k+1 of a complex128 device vector."""
        b = self._rhs(k, v)
        self.stats["steps"] += 1
        if self.method == "banded":
            x, its = refine_checked(self._imp_op(k), b, tol=TOL, max_its=MAX_ITS[self.inexact],
                                    what=f"Floquet step {k}")
            self.stats["gcr_its"] += its
            return x
        bh = b.cpu().numpy()
        if self.inexact:
            A = CSRMatrix(self._pattern, self._imp_data(k)).to_scipy()
            x = (self._refine_host(A, np.ascontiguousarray(bh.real))
                 + 1j * self._refine_host(A, np.ascontiguousarray(bh.imag)))
        else:  # a real factor: the two parts as two columns
            xs = self._facs[k].solve(np.stack([bh.real, bh.imag], axis=1))
            x = xs[:, 0] + 1j * xs[:, 1]
        return torch.as_tensor(x, device=self._dev)

    def _step_lin(self, k: int, v: np.ndarray) -> np.ndarray:
        """One linearized theta step k -> k+1 on a complex host vector."""
        return self._step(k, torch.as_tensor(np.asarray(v, dtype=np.complex128),
                                              device=self._dev)).cpu().numpy()

    def monodromy_apply(self, v: np.ndarray) -> np.ndarray:
        """Phi_T v: one trip around the orbit, on the device."""
        x = torch.as_tensor(np.asarray(v, dtype=np.complex128), device=self._dev)
        for k in range(self.N):
            x = self._step(k, x)
        self.stats["applies"] += 1
        return x.cpu().numpy()

    # ------------------------------------------------------------------
    def solve(self, k: int = 5, *, tol: float = 1e-8) -> FloquetResult:
        """The ``k`` leading Floquet multipliers by |mu| (ARPACK on the host
        over the matrix-free monodromy action)."""
        n = self._pattern.shape[0]
        P = spla.LinearOperator((n, n), matvec=self.monodromy_apply, dtype=np.complex128)
        mu, V = spla.eigs(P, k=k, which="LM", tol=tol, ncv=max(2 * k + 4, 20))
        order = np.argsort(-np.abs(mu))
        mu, V = mu[order], V[:, order]
        triv = float(np.min(np.abs(mu - 1.0)))
        logger.info("Floquet multipliers |mu| = %s (trivial-mode error %.2e)",
                    np.array2string(np.abs(mu), precision=4), triv)
        return FloquetResult(self.period, mu, V.T.copy(), triv)
