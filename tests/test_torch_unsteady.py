"""The port's nonlinear time stepping and Floquet analysis against the JAX
package and dense linear algebra.

The small cases of ``tests/unit/test_timestepping.py`` (6x6 rectangle,
P2/P1, inflow at x = 0, pressure outlet at x = 1, no-slip walls, Re =
20; 387 DOFs) and ``tests/unit/test_span.py`` (the 6x4 channel around
Poiseuille flow, Re = 50), each built by both packages.  The steady
state comes from the port's host-LU baseflow and feeds both packages.
The JAX package runs its host ``"lu"`` method, as its own tests do; the
port runs its default ``"banded"`` method (band factor with f64 GCR
refinement at 1e-11) and, where a test says so, its host ``"lu"``.

Tolerances: one step and a short forced march rel 1e-10 (Newton to
1e-12 on both sides); the linear regime against the dense
Crank-Nicolson / BDF2 recurrences 3e-3 (the reference's: O(eps)
nonlinear feedback); the monodromy against the dense N-th power rel
1e-9, against the JAX package rel 1e-8 (the spanwise trip 1e-9);
multipliers 1e-8; ``dominant_frequency`` exact (the same numpy).

Band plans are unpadded (``chunk=1``), as in ``test_torch_slice.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu import floquet as jfloquet
from lsafw_tpu import span as jspan
from lsafw_tpu.config import BoundaryConditionsConfig as JBC
from lsafw_tpu.fem.assembly import AssemblyContext as JContext
from lsafw_tpu.fem.bcs import define_bcs as jdefine_bcs
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.meshing.mesh import rectangle_mesh as jrectangle_mesh
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.solver import timestepping as jts
from lsafw_tpu_torch import span as tspan
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import define_bcs
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.floquet import FloquetSolver
from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    StationaryNavierStokesAssembler,
)
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator
from lsafw_tpu_torch.solver.timestepping import UnsteadySolver, dominant_frequency
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

RE, RE_CHANNEL = 20.0, 50.0
DT, N = 0.25, 5
BETA = 1.7
BCS = [(1, "dirichlet_velocity", (1.0, 0.0)), (3, "dirichlet_velocity", (0.0, 0.0)),
       (2, "dirichlet_pressure", 0.0)]


@pytest.fixture(scope="module", autouse=True)
def small_plans():
    """Band plans of the small systems unpadded (chunk 1)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
    yield
    mp.undo()


def _marker(x):
    out = np.full(x.shape[0], 3, np.int32)
    out[np.isclose(x[:, 0], 0.0)] = 1
    out[np.isclose(x[:, 0], x[:, 0].max())] = 2
    return out


def _both(corner, nx, ny, bcs):
    """(mesh, spaces, bcs, ctx) of the JAX package and of the port."""
    jm = jrectangle_mesh((0.0, 0.0), corner, nx, ny)
    jmark(jm, _marker)
    js = jdefine_spaces(jm)
    jb = jdefine_bcs(jm, js, [JBC(marker=m, type=t, value=v) for m, t, v in bcs])
    pm = rectangle_mesh((0.0, 0.0), corner, nx, ny)
    mark_boundary_facets(pm, _marker)
    ps = define_spaces(pm)
    pb = define_bcs(pm, ps, [BoundaryConditionsConfig(marker=m, type=t, value=v)
                             for m, t, v in bcs])
    return (jm, js, jb, JContext.build(js)), (pm, ps, pb, AssemblyContext.build(ps, device="cpu"))


@pytest.fixture(scope="module")
def case():
    """Both packages' rectangle, its steady state (the port's host-LU
    baseflow), a perturbed state, a varying orbit of N snapshots and a
    complex vector, all from numpy seeds."""
    jax_side, port = _both((1.0, 1.0), 6, 6, BCS)
    pm, ps, pb, pctx = port
    w = BaseFlowSolver(pctx, pm, pb, re=RE).solve(ramp=True, steps=2, tol=1e-11, max_it=40)
    rng = np.random.default_rng(5)
    pert = rng.standard_normal(w.size) * 1e-3
    pert[pb.dirichlet_mask] = 0.0
    snaps = np.tile(w, (N, 1)) + 0.05 * np.abs(w).max() * rng.standard_normal((N, w.size))
    v = rng.standard_normal(w.size) + 1j * rng.standard_normal(w.size)
    return dict(jax=jax_side, port=port, w=w, q0=w + pert, snaps=snaps, v=v)


def _solver(case, **kw) -> UnsteadySolver:
    pm, ps, pb, pctx = case["port"]
    return UnsteadySolver(pctx, pm, pb, RE, device="cpu", **kw)


def _dense(case):
    """Dense (J, M, mom, v): the stationary Jacobian at the steady state,
    the stepper's mass, its momentum mask, and a div-free, BC-homogeneous
    perturbation (a real eigenvector of the linearized pair)."""
    pm, ps, pb, pctx = case["port"]
    w = case["w"]
    A, M = LinearizedNavierStokesAssembler(w, pctx, RE, pb.homogeneous(),
                                           pm).assemble_eigensystem()
    _, V = spla.eigs(A.to_scipy().astype(complex), k=1, M=M.to_scipy().astype(complex),
                     sigma=-0.5 + 0.0j, which="LM")
    v = np.real(V[:, 0])
    Jd = StationaryNavierStokesAssembler(pctx, pm, pb).jacobian(w, RE).to_scipy().toarray()
    mom = np.zeros(w.size, dtype=bool)
    mom[:ps.num_velocity_dofs] = True
    mom &= ~pb.dirichlet_mask
    return Jd, M.to_scipy().toarray(), mom, v / np.linalg.norm(v)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# UnsteadySolver
# ---------------------------------------------------------------------------


def test_steady_state_is_fixed_point(case):
    us = _solver(case, newton_tol=1e-12)
    q = case["w"]
    for _ in range(3):
        q, st = us.step(q, dt=0.2)
        assert st.newton_iters <= 3
    assert np.linalg.norm(q.numpy() - case["w"]) < 1e-7 * (1.0 + np.linalg.norm(case["w"]))


def test_linear_regime_matches_dense_cn(case):
    """The nonlinear step in the eps regime against the dense CN of the
    stepper's own linearization, (M - dt/2 J) q1 = (M + dt/2 J) q0."""
    Jd, Md, _, v = _dense(case)
    dt, nsteps, eps = 0.1, 6, 1e-6
    S = np.linalg.solve(Md - 0.5 * dt * Jd, Md + 0.5 * dt * Jd)
    us = _solver(case, newton_tol=1e-13)
    q = case["w"] + eps * v
    for _ in range(nsteps):
        q, _ = us.step(q, dt)
    err = _rel((q.numpy() - case["w"]) / eps, np.linalg.matrix_power(S, nsteps) @ v)
    assert err < 3e-3, err


@pytest.fixture(scope="module")
def jax_step(case):
    """The JAX package's host-LU theta step from the perturbed state."""
    jm, js, jb, jctx = case["jax"]
    q, _ = jts.UnsteadySolver(jctx, jm, jb, RE, method="lu", newton_tol=1e-12).step(
        jnp.asarray(case["q0"]), 0.15)
    return np.asarray(q)


@pytest.mark.parametrize("method", ["banded", "lu"])
def test_step_matches_jax(case, jax_step, method):
    """One theta step from a perturbed state: the port's banded and host-LU
    steps against the JAX package's host-LU step."""
    us = _solver(case, method=method, newton_tol=1e-12)
    q, st = us.step(case["q0"], 0.15)
    assert _rel(q.numpy(), jax_step) < 1e-10
    assert st.refactored and np.isfinite(st.residual) and us.stats["factors"] == 1


def test_bdf2_linear_regime_matches_dense(case):
    """BDF2 steps (CN bootstrap) against the dense recurrence
    v2 = (1.5 M - dt J)^-1 M (2 v1 - 0.5 v0)."""
    Jd, Md, _, v = _dense(case)
    dt, nsteps, eps = 0.1, 6, 1e-6
    S_cn = np.linalg.solve(Md - 0.5 * dt * Jd, Md + 0.5 * dt * Jd)
    Nb = np.linalg.solve(1.5 * Md - dt * Jd, Md)
    v0, v1 = v, S_cn @ v
    for _ in range(nsteps - 1):
        v0, v1 = v1, Nb @ (2.0 * v1 - 0.5 * v0)
    res = _solver(case, newton_tol=1e-13).run(case["w"] + eps * v, dt, nsteps, scheme="bdf2")
    err = _rel((res.q.numpy() - case["w"]) / eps, v1)
    assert err < 3e-3, err


def test_forced_run_matches_jax(case):
    """``run`` with a harmonic ``load_fn`` and probes, theta then BDF2,
    against the JAX package's."""
    jm, js, jb, jctx = case["jax"]
    rng = np.random.default_rng(8)
    a = rng.standard_normal(case["w"].size) * 1e-3
    a[~(np.arange(a.size) < js.num_velocity_dofs) | jb.dirichlet_mask] = 0.0

    def load_fn(t):
        return a * np.cos(0.8 * t)

    kw = dict(probe_dofs=np.flatnonzero(~jb.dirichlet_mask)[[0, 40]], load_fn=load_fn)
    for scheme in ("theta", "bdf2"):
        ref = jts.UnsteadySolver(jctx, jm, jb, RE, method="lu", newton_tol=1e-12).run(
            jnp.asarray(case["q0"]), 0.2, 3, scheme=scheme, **kw)
        res = _solver(case, newton_tol=1e-12).run(case["q0"], 0.2, 3, scheme=scheme, **kw)
        assert _rel(res.q.numpy(), ref.q) < 1e-10
        assert np.allclose(res.t, ref.t) and _rel(res.probes, ref.probes) < 1e-10


def test_checkpoint_resume(case, tmp_path):
    """An interrupted march and its resume equal the uninterrupted march
    (state, BDF2 history and probe series)."""
    kw = dict(probe_dofs=[3, 7], scheme="bdf2")
    ref = _solver(case).run(case["q0"], 0.2, 10, **kw)
    cp = tmp_path / "march.ckpt"  # np.savez appends .npz; resume must still find it
    _solver(case).run(case["q0"], 0.2, 6, checkpoint_path=cp, checkpoint_every=3, **kw)
    res = _solver(case).run(case["q0"], 0.2, 10, checkpoint_path=cp, checkpoint_every=3, **kw)
    assert np.allclose(res.q.numpy(), ref.q.numpy(), atol=1e-12)
    assert np.allclose(res.t, ref.t)
    assert np.allclose(res.probes, ref.probes, atol=1e-12)


def test_dt_change_refactors(case):
    """The chord factor is dt-specific: a new dt refactors."""
    us = _solver(case, refactor_every=100)
    q, st1 = us.step(case["w"], 0.2)
    q, st2 = us.step(q, 0.2)
    assert st1.refactored and not st2.refactored
    q, st3 = us.step(q, 0.1)
    assert st3.refactored and us.stats["factors"] == 2


def test_dominant_frequency_matches_jax():
    t = np.linspace(0.0, 60.0, 1200)
    sig = 0.7 * np.sin(0.83 * t + 0.3) + 0.05 * np.sin(2.9 * t)
    w = dominant_frequency(t, sig)
    assert w == jts.dominant_frequency(t, sig)
    assert abs(w - 0.83) < 0.01


# ---------------------------------------------------------------------------
# FloquetSolver
# ---------------------------------------------------------------------------


def _floquet(case, snaps, **kw) -> FloquetSolver:
    pm, ps, pb, pctx = case["port"]
    return FloquetSolver(pctx, pm, pb, RE, snaps, DT, device="cpu", **kw)


def test_constant_orbit_monodromy_matches_dense(case):
    """On a steady state, a periodic orbit of any period, Phi_T is the N-th
    power of the linearized one-step map."""
    Jd, Md, mom, _ = _dense(case)
    S = np.linalg.solve(Md - 0.5 * DT * Jd, Md + 0.5 * DT * np.where(mom[:, None], Jd, 0.0))
    fs = _floquet(case, np.tile(case["w"], (N, 1)))
    got = fs.monodromy_apply(case["v"])
    assert _rel(got, np.linalg.matrix_power(S, N) @ case["v"]) < 1e-9


@pytest.fixture(scope="module")
def jax_monodromy(case):
    jm, js, jb, jctx = case["jax"]
    fs = jfloquet.FloquetSolver(jctx, jm, jb, RE, case["snaps"], DT, method="lu")
    return fs.monodromy_apply(case["v"])


@pytest.mark.parametrize("method,inexact", [("banded", False), ("banded", True), ("lu", False),
                                            ("lu", True)])
def test_monodromy_matches_jax(case, jax_monodromy, method, inexact):
    """A varying orbit (distinct Jacobians): the port's trip in each
    backend against the JAX package's prestored host-LU trip."""
    fs = _floquet(case, case["snaps"], method=method, inexact=inexact)
    assert _rel(fs.monodromy_apply(case["v"]), jax_monodromy) < 1e-8
    assert fs.stats["factors"] == (1 if inexact else N) and fs.stats["steps"] == N


def test_multipliers_match_jax(case):
    """``solve(k=4)`` on a constant orbit (N = 3, dt = 0.2) against the JAX
    package's multipliers (conjugates may trade places).  Backward Euler
    (theta = 1): its multipliers 1 / (1 - dt lambda)^N are well separated,
    where Crank-Nicolson's lead with a cluster at |mu| = 1 (the pencil's
    infinite eigenvalues, each step multiplying them by -1)."""
    jm, js, jb, jctx = case["jax"]
    snaps = np.tile(case["w"], (3, 1))
    ref = jfloquet.FloquetSolver(jctx, jm, jb, RE, snaps, 0.2, theta=1.0, method="lu").solve(
        k=4, tol=1e-10)
    pm, ps, pb, pctx = case["port"]
    res = FloquetSolver(pctx, pm, pb, RE, snaps, 0.2, theta=1.0, device="cpu").solve(
        k=4, tol=1e-10)

    def key(mu):
        return np.sort_complex(mu.real + 1j * np.abs(mu.imag))

    assert np.abs(key(res.multipliers) - key(ref.multipliers)).max() < 1e-8
    assert res.period == pytest.approx(ref.period) and res.modes.shape == (4, case["w"].size)
    assert abs(res.trivial_error - ref.trivial_error) < 1e-8


def test_spanwise_monodromy_matches_jax():
    """The quasi-3D trip of ``spanwise_floquet`` (its default: banded, one
    cycle-mean factor) at beta = 1.7 on a varying orbit of the channel
    against the JAX package's (host LU, one cycle-mean factor)."""
    bcs = [(1, "dirichlet_velocity", (0.0, 0.0)), (3, "dirichlet_velocity", (0.0, 0.0)),
           (2, "dirichlet_pressure", 0.0)]
    (jm, js, jb, jctx), (pm, ps, pb, pctx) = _both((2.0, 1.0), 6, 4, bcs)
    w = np.zeros(ps.num_dofs)
    nu = ps.num_velocity_dofs
    y = ps.velocity.dof_coords[:, 1]
    w[:nu] = np.where(np.arange(nu) % 2 == 0, 4.0 * y * (1.0 - y), 0.0)  # Poiseuille
    rng = np.random.default_rng(2)
    snaps = np.tile(w, (3, 1)) + 0.03 * np.abs(w).max() * rng.standard_normal((3, w.size))
    jfs = jspan.spanwise_floquet(jspan.SpanwiseStability(jctx, w, RE_CHANNEL, jb, jm), snaps,
                                 0.2, BETA)
    span = tspan.SpanwiseStability(pctx, w, RE_CHANNEL, pb, pm, device="cpu")
    fs = tspan.spanwise_floquet(span, snaps, 0.2, BETA, device="cpu")
    v = rng.standard_normal(span.num_dofs) + 1j * rng.standard_normal(span.num_dofs)
    assert fs.inexact and fs.method == "banded"
    assert _rel(fs.monodromy_apply(v), jfs.monodromy_apply(v)) < 1e-9


# ---------------------------------------------------------------------------
# Shift-invert with M = None
# ---------------------------------------------------------------------------


def test_shift_invert_without_mass_matches_lu(case):
    """C = A - sigma I at a real shift: the banded method (real factor, S
    on A's values; a complex vector as two columns) against the host LU."""
    Jd = StationaryNavierStokesAssembler(*[case["port"][i] for i in (3, 0, 2)]).jacobian(
        case["w"], RE)
    v = torch.as_tensor(case["v"])
    sol = {m: ShiftInvertOperator(Jd, None, 0.3, method=m) for m in ("banded", "lu")}
    for x in (v, v.real.contiguous()):
        got, ref = (sol[m].solve_raw(x) for m in ("banded", "lu"))
        assert got.dtype == x.dtype and _rel(got.numpy(), ref.numpy()) < 1e-9
        assert _rel(sol["banded"].apply(x).numpy(), sol["lu"].apply(x).numpy()) < 1e-9
    assert sol["banded"].device_op.Cop is not None
