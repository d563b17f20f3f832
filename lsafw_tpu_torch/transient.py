"""Transient (non-modal) growth: the optimal initial-perturbation gain G(T).

Counterpart of the reference's ``transient`` module: the largest
kinetic-energy amplification any initial condition reaches by time T
under the linearized dynamics M dq/dt = A q,

    G(T) = max_{q0}  ||q(T)||_E^2 / ||q0||_E^2,

with ||q||_E^2 = q^T M q and q0 on the free velocity DOFs.  Time runs
by Crank-Nicolson, whose step is minus the Cayley apply at a real shift,

    q_{n+1} = (M - dt/2 A)^-1 (M + dt/2 A) q_n = -(A - s M)^-1 (A + s M) q_n,
    s = 2/dt,

on one real factor per propagator
(:class:`~lsafw_tpu_torch.solver.eigen.ShiftInvertOperator` with
``antishift=s``).  The adjoint step is the product in the reversed
order, S^T = -(A^T + s M^T)(A^T - s M^T)^-1: a raw solve on the
transposed pair's factor, then one fused product (A^T - (-s) M^T) y,
and not a Cayley apply on the transpose (the two orders agree only if A
and M commute).  The gain operator T = P^T (S^T)^N M S^N P is real
symmetric PSD; its leading W-generalized eigenpairs come from the
W-weighted Lanczos of :func:`~lsafw_tpu_torch.resolvent.w_weighted_gains`.

The marches are real f64 throughout: on the card every band solve is the
real factor's one-column substitution and every product S on an f64 x.
The reference jits one loop per march; here Python loops over device
calls.  Factor pairs are cached per dt, as the reference caches them,
so a horizon sweep at fixed ``n_steps`` holds two factors per horizon.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.resolvent import _EnergyPair, w_weighted_gains
from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class GrowthResult:
    """``gains`` are G(T) (energy ratios); ``initials``/``finals`` the
    optimal perturbations and their evolved states, unit initial energy."""

    horizon: float
    n_steps: int
    gains: np.ndarray  # (k,) descending energy gains
    initials: np.ndarray  # (k, n) real
    finals: np.ndarray  # (k, n) real


class TransientGrowthSolver(_EnergyPair):
    """Optimal-growth solver over the (A, M) eigensystem pair.

    Arguments as :class:`~lsafw_tpu_torch.resolvent.ResolventSolver`'s
    (``method`` defaults to ``"banded"``, ``device`` to ``"cuda"``); the
    propagators are built per (horizon, n_steps) in :meth:`solve`.  After
    a solve, ``operators`` holds the figures of the horizon's two
    factors and ``applies`` its T applies.
    """

    def __init__(self, A: CSRMatrix, M: CSRMatrix, num_velocity_dofs: int, dirichlet_mask, *,
                 method: str = "banded", elements=None, device="cuda") -> None:
        super().__init__(A, M, num_velocity_dofs, dirichlet_mask, method, device)
        self._prop_cache: dict = {}

    def _propagators(self, dt: float):
        """(forward, adjoint, s): the forward CN step is minus the Cayley
        apply at sigma = nu = s; the adjoint factors A^T - s M^T."""
        s = 2.0 / float(dt)
        key = round(s, 12)
        if key not in self._prop_cache:
            fw = ShiftInvertOperator(self.A, self.M, s, method=self.method, antishift=s)
            ad = ShiftInvertOperator(self._At, self._Mt, s, method=self.method)
            self._prop_cache[key] = (fw, ad)
        fw, ad = self._prop_cache[key]
        return fw, ad, s

    def _march(self, op, x: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Forward: q_{n+1} = -Cayley(q_n)."""
        for _ in range(n_steps):
            x = -op.apply(x)
        return x

    def _adjoint_product(self, ad, s: float, y: torch.Tensor) -> torch.Tensor:
        """(A^T + s M^T) y: one fused product at sigma = -s where the
        adjoint operator has one, else the CSR pair."""
        Cop = ad.device_op.Cop if ad.device_op is not None else None
        if Cop is not None:
            return replace(Cop, sigma=complex(-s)).matvec_pair(y)
        return spmv(self._At, y) + s * spmv(self._Mt, y)

    def _march_adjoint(self, ad, s: float, x: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Adjoint: z_{n+1} = -(A^T + s M^T)(A^T - s M^T)^-1 z_n."""
        for _ in range(n_steps):
            x = -self._adjoint_product(ad, s, ad.solve_raw(x))
        return x

    def solve(self, horizon: float, n_steps: int, k: int = 1, *,
              tol: float = 1e-8) -> GrowthResult:
        """The leading ``k`` optimal gains over [0, horizon] with
        ``n_steps`` CN steps (dt = horizon / n_steps); ``k`` is clamped to
        the forcing-subspace size."""
        k = min(int(k), self._fdofs.size)
        fw, ad, s = self._propagators(float(horizon) / int(n_steps))
        dev = self.A.device

        def lift(fc) -> torch.Tensor:
            x = torch.zeros(self._n, dtype=torch.float64, device=dev)
            x[self._fd] = torch.as_tensor(np.real(fc), dtype=torch.float64, device=dev)
            return x

        def apply_T(fc: np.ndarray) -> np.ndarray:
            q = self._march(fw, lift(fc), n_steps)
            z = self._march_adjoint(ad, s, self._mass(q), n_steps)
            self.applies += 1
            return z[self._fd].cpu().numpy()

        self.applies = 0
        gam, F = w_weighted_gains(apply_T, self._W, k, tol=tol, dtype=np.float64)
        gains = np.maximum(gam, 0.0)
        initials = np.zeros((k, self._n))
        finals = np.zeros((k, self._n))
        for j in range(k):
            q0 = lift(F[:, j])
            q0 = q0 / torch.sqrt(torch.dot(q0, self._mass(q0)))
            initials[j] = q0.cpu().numpy()
            finals[j] = self._march(fw, q0, n_steps).cpu().numpy()
        self.operators = {"forward": fw.figures(), "adjoint": ad.figures()}
        logger.info("Transient growth T=%.3f (%d CN steps): G = %s", horizon, n_steps,
                    np.array2string(gains, precision=4))
        return GrowthResult(float(horizon), int(n_steps), gains, initials, finals)

    def growth_curve(self, horizons, n_steps: int, k: int = 1, *,
                     tol: float = 1e-8) -> list[GrowthResult]:
        """G(T) over several horizons; factor pairs are cached per
        dt = T / n_steps, so repeated dt values reuse theirs."""
        return [self.solve(float(T), n_steps, k=k, tol=tol) for T in horizons]
