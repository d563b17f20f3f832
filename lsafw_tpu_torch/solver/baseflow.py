"""Baseflow (steady Navier-Stokes) solve: Stokes solve as the Newton
initial guess, optional Reynolds ramp 1.0 -> Re, damped Newton per
step, and the diagnostics (recirculation length, drag) and the
interpolation of a state between meshes.

``linear_solver="banded"`` runs the Stokes solve and every Newton step
on the device band LU with f64 GCR refinement (one real band plan,
shared by the Stokes operator and the Jacobians of the same pattern).
A stalled banded Stokes solve on a bf16 band is retried once on a
budget-clipped f32 plan (the pattern marked bf16-unstable, as Newton's
rung does); a stalled f32 solve raises.  ``"lu"`` solves on the host.
A Krylov name (``"gmres"``, ``"bcgs"``, ...) runs every Newton step, and
the Stokes guess too, through that Krylov type with block-Jacobi(64) on
the device (the reference's Stokes guess takes its host LU there; here a
host LU runs only for ``"lu"``)."""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.fem.facets import build_facet_context, traction_force
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.models.navier_stokes import (
    StationaryNavierStokesAssembler,
    StokesAssembler,
)
from lsafw_tpu_torch.solver.direct import direct_solve
from lsafw_tpu_torch.solver.band import mark_bf16_unstable, plan_for_csr
from lsafw_tpu_torch.solver.linear import solve_csr
from lsafw_tpu_torch.solver.precond import block_jacobi
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
        if linear_solver != "lu":
            res = solve_csr(A, b, M=block_jacobi(A, 64), ksp_type=linear_solver, tol=1e-10,
                            maxiter=5000)
            if not res.converged:
                logger.warning("Krylov %s Stokes solve stalled (rel res %.2e); Newton starts "
                               "from its iterate", linear_solver, res.residual)
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


def _host(w) -> np.ndarray:
    """A state as a host f64 array, from numpy or from a tensor on any device."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float64).numpy()
    return np.asarray(w, dtype=np.float64)


def interpolate_state(w_coarse, spaces_coarse, spaces_fine) -> np.ndarray:
    """Mixed Taylor-Hood state on one mesh -> the same fields sampled on
    another mesh's spaces: a mesh-sequenced continuation initial guess
    (solve the ramp once on a coarse mesh, Newton-polish on the fine one).
    Linear interpolation through the coarse node clouds (component-wise
    for velocity), nearest neighbour outside the hull.  Host scipy."""
    import scipy.interpolate as si
    from scipy.spatial import cKDTree

    u_c, p_c = spaces_coarse.split(_host(w_coarse))

    def _interp(pts_c, vals_c, pts_f):
        out = np.atleast_2d(np.asarray(si.LinearNDInterpolator(pts_c, vals_c)(pts_f)))
        if out.shape[0] == 1 and pts_f.shape[0] != 1:
            out = out.T
        bad = ~np.isfinite(out).all(axis=1)
        if bad.any():
            _, idx = cKDTree(pts_c).query(pts_f[bad])
            out[bad] = np.atleast_2d(vals_c)[idx] if vals_c.ndim > 1 else vals_c[idx][:, None]
        return out

    u_f = _interp(spaces_coarse.velocity.node_coords, u_c, spaces_fine.velocity.node_coords)
    p_f = _interp(spaces_coarse.pressure.node_coords, p_c[:, None],
                  spaces_fine.pressure.node_coords)[:, 0]
    return spaces_fine.combine(u_f, p_f)


def point_interpolation_matrix(pts_c: np.ndarray, pts_f: np.ndarray):
    """Sparse P1 barycentric interpolation matrix (scipy CSR) from one
    point cloud to another (nearest source point outside the hull)."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay, cKDTree

    tri = Delaunay(pts_c)
    simp = tri.find_simplex(pts_f)
    inside = simp >= 0
    rows, cols, vals = [], [], []
    if inside.any():
        s = simp[inside]
        X = tri.transform[s]  # (m, tdim + 1, tdim)
        bary = np.einsum("mij,mj->mi", X[:, :-1], pts_f[inside] - X[:, -1])
        w = np.concatenate([bary, 1.0 - bary.sum(axis=1, keepdims=True)], axis=1)
        verts = tri.simplices[s]
        rows.append(np.repeat(np.flatnonzero(inside), verts.shape[1]))
        cols.append(verts.ravel())
        vals.append(w.ravel())
    if (~inside).any():
        _, nn = cKDTree(pts_c).query(pts_f[~inside])
        rows.append(np.flatnonzero(~inside))
        cols.append(nn)
        vals.append(np.ones(nn.shape[0]))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(pts_f.shape[0], pts_c.shape[0]))


def interpolation_matrix(spaces_coarse, spaces_fine):
    """Sparse mixed-state prolongation P (fine DOFs x coarse DOFs), the
    matrix form of :func:`interpolate_state`: ``P @ w_coarse`` equals
    ``interpolate_state(w_coarse, ...)`` to rounding.  scipy CSR."""
    import scipy.sparse as sp

    Pu = point_interpolation_matrix(spaces_coarse.velocity.node_coords,
                                    spaces_fine.velocity.node_coords)
    Pp = point_interpolation_matrix(spaces_coarse.pressure.node_coords,
                                    spaces_fine.pressure.node_coords)
    bs = spaces_fine.velocity.bs
    return sp.block_diag([sp.kron(Pu, sp.identity(bs, format="csr"), format="csr"), Pp],
                         format="csr")


def compute_recirculation_length(ctx: AssemblyContext, baseflow, *,
                                 restrict_to_centreline: bool = False,
                                 centreline_tol: float = 1e-6) -> float:
    """Max x with u_x < 0, over every velocity node (2D or 3D), or over
    the nodes with |y| <= ``centreline_tol``."""
    u, _ = ctx.spaces.split(_host(baseflow))
    coords = ctx.spaces.velocity.node_coords
    mask = u[:, 0] < 0.0
    if restrict_to_centreline:
        mask &= np.abs(coords[:, 1]) <= centreline_tol
    if not mask.any():
        raise RuntimeError("No negative u_x found; no recirculation detected.")
    return float(coords[mask, 0].max())


def compute_drag(ctx: AssemblyContext, mesh: Mesh, baseflow, *, re: float,
                 cylinder_marker: int) -> float:
    """Nondimensional drag |Fx| over the tagged boundary: the traction
    integral on the context's device."""
    fc = build_facet_context(ctx, mesh, cylinder_marker)
    return abs(float(traction_force(fc, ctx, baseflow, re, direction=0)))
