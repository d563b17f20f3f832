"""Baseflow (steady Navier-Stokes) solve: Stokes solve as the Newton
initial guess, optional Reynolds ramp 1.0 -> Re, damped Newton per
step, and the recirculation-length diagnostic.

``linear_solver="banded"`` runs the Stokes solve and every Newton step
on the device band LU with f64 GCR refinement (one real band plan,
shared by the Stokes operator and the Jacobians of the same pattern).
A stalled banded Stokes solve on a bf16 band is retried once on a
budget-clipped f32 plan (the pattern marked bf16-unstable, as Newton's
rung does); a stalled f32 solve raises.  ``"lu"`` solves on the host."""

from __future__ import annotations

import numpy as np

from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.models.navier_stokes import (
    StationaryNavierStokesAssembler,
    StokesAssembler,
)
from lsafw_tpu_torch.solver.direct import direct_solve
from lsafw_tpu_torch.solver.band import mark_bf16_unstable, plan_for_csr
from lsafw_tpu_torch.solver.newton import NewtonResult, NewtonSolver, banded_solve, new_stats
from lsafw_tpu_torch.utils.logging import get_logger, timed

logger = get_logger(__name__)


class BaseFlowSolver:
    """Solves for the base (stationary) flow."""

    def __init__(self, ctx: AssemblyContext, mesh: Mesh, bcs: BoundaryConditions,
                 *, re: float) -> None:
        self._ctx = ctx
        self._mesh = mesh
        self._bcs = bcs
        self._re = re
        self._initial_guess: np.ndarray | None = None  # Newton's start; None: a Stokes solve
        self.stats = new_stats()  # banded inner solves: device seconds and counts
        self.newton_results: list[NewtonResult] = []

    def _solve_stokes_flow(self, linear_solver: str = "lu") -> np.ndarray:
        logger.info("Solving Stokes flow as Newton initial guess.")
        A, b = StokesAssembler(self._ctx, self._mesh, self._bcs, re=self._re).get_matrix_forms()
        if linear_solver == "banded":
            plan = plan_for_csr(A, real=True)
            res = banded_solve(A, b, plan, tol=1e-10, stats=self.stats)
            if not res.converged and plan.band_dtype == "bf16":
                logger.warning("bf16 Stokes band stalled (rel res %.2e); retrying with a "
                               "budget-clipped f32 band", res.residual)
                mark_bf16_unstable(A.pattern)
                res = banded_solve(A, b, plan_for_csr(A, real=True, force_f32=True), tol=1e-10,
                                   stats=self.stats)
            if not res.converged:
                raise RuntimeError(f"banded Stokes solve stalled (relative residual "
                                   f"{res.residual:.2e})")
            return res.x.cpu().numpy()
        return direct_solve(A, b.cpu().numpy())

    def solve(
        self,
        *,
        ramp: bool = False,
        steps: int = 3,
        max_it: int = 50,
        tol: float = 1e-6,
        damping_factor: float = 1.0,
        linear_solver: str = "lu",
    ) -> np.ndarray:
        """Steady NS solve with optional Reynolds ramp."""
        re_ramp = (
            np.linspace(1.0, self._re, steps).tolist() if (ramp and steps > 1) else [self._re]
        )
        newton = NewtonSolver(
            StationaryNavierStokesAssembler(self._ctx, self._mesh, self._bcs),
            damping=damping_factor, linear_solver=linear_solver, stats=self.stats,
        )
        if self._initial_guess is None:
            self._initial_guess = self._solve_stokes_flow(linear_solver)
        sol = self._initial_guess
        result: NewtonResult | None = None
        for re in re_ramp:
            logger.info("Solving stationary Navier-Stokes at Re=%.2f", re)
            with timed(logger, f"Newton at Re={re:.1f}"):
                result = newton.solve(sol, re, max_it=max_it, tol=tol)
            self.newton_results.append(result)
            sol = result.w
        if result is not None and not result.converged:
            logger.warning("Final Newton residual %.3e > tol %.1e", result.residual_norm, tol)
        return sol


def compute_recirculation_length(ctx: AssemblyContext, baseflow: np.ndarray) -> float:
    """Max x with u_x < 0."""
    u, _ = ctx.spaces.split(np.asarray(baseflow))
    mask = u[:, 0] < 0.0
    if not mask.any():
        raise RuntimeError("No negative u_x found; no recirculation detected.")
    return float(ctx.spaces.velocity.node_coords[mask, 0].max())
