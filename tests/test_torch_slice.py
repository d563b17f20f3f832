"""The port's main path end to end against the JAX package on a small
cylinder: ramped Newton baseflow, eigensystem, and the shift-invert
Krylov-Schur eigenpair nearest 0.74j with f64 refinement.

Two routes through the port: host SuperLU Newton with the pivot-free
band factor (``LSAFW_PIVOT_MEM_GB=0`` on both sides), and the
reference's device route, banded Newton then the default pivoted
factor with the fused (A, M) refinement matvecs, where a spy shows that
no host LU runs.  The baseflows are f64 on both sides (rel 1e-9 for the
same host LU; rel 1e-7 for the banded Newton, which stops at |F| < 1e-8
with another last step); the eigenvalue is held to the eigensolver's
own gate (1e-8).

Adjoint sensitivity: the JAX package's ``EigenSensitivitySolver`` runs
once on the JAX baseflow with its default host-LU shift-invert; the
port's runs ``evaluate()`` once on the same baseflow, on the banded
device route with host LU forbidden, and its adjoint vector is held to
the JAX package's through the phase between the two direct vectors.
The JAX package's direct pair, adjoint vector and du/dRe, carried into
the port, drive ``evaluate_sensitivity`` and ``compute_wavemaker``.
The bf16 retry rung (Newton and Stokes) is held to the JAX package's
plan of the marked pattern (exact) and its result to SuperLU (1e-9, GCR
at 1e-10); the TOML loaders to the JAX package's (exact).

Tolerances: the transposes exact; the scalar forms rel 1e-12 (f64
einsums in another order); sigma_adj 1e-8 and the adjoint vector rel
1e-6 (the adjoint eigensolve's ``atol`` is 1e-8); du/dRe rel 1e-7 (GCR
to a relative residual of 1e-10 against SuperLU); d sigma/dRe on
identical inputs rel 1e-10 and end to end rel 1e-6; the wavemaker rel
1e-8 (CG to 1e-12 on both sides).

The port's band plans on its device route (banded baseflow, pivoted
eigenpair, sensitivity) keep the small cylinder's 23 block rows
unpadded (``chunk=1``) instead of padding them to 128 with identity
rows: the same factors at a fraction of the CPU time.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu import sensitivity as jsens
from lsafw_tpu.fem import assembly as jassembly
from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.ops import sparse as jsparse
from lsafw_tpu.solver import band as jband
from lsafw_tpu.solver import baseflow as jbaseflow
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu.solver import linear as jlinear
from lsafw_tpu.solver import precond as jprecond
from lsafw_tpu_torch import interop
from lsafw_tpu_torch import sensitivity as tsens
from lsafw_tpu_torch.fem import assembly as tassembly
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.ops import sparse as tsparse
from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import baseflow as tbaseflow
from lsafw_tpu_torch.solver import direct as tdirect
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver import linear as tlinear
from lsafw_tpu_torch.solver import newton as tnewton
from lsafw_tpu_torch.solver import precond as tprecond
from lsafw_tpu_torch.solver.band import PivotedBandedLU
from tests.test_torch_fem import RE, cylinder_case, one_blas_thread  # noqa: F401

torch.set_num_threads(1)

TARGET = 0.74j


@pytest.fixture(scope="module")
def cases():
    return cylinder_case("lsafw_tpu"), cylinder_case("lsafw_tpu_torch", device="cpu")


@pytest.fixture(scope="module")
def baseflows(cases):
    jc, tc = cases
    kw = dict(ramp=True, steps=3, tol=1e-8, max_it=40)
    jw = jbaseflow.BaseFlowSolver(jc["ctx"], jc["mesh"], jc["bcs_base"], re=RE).solve(
        linear_solver="lu", **kw)
    tw = tbaseflow.BaseFlowSolver(tc["ctx"], tc["mesh"], tc["bcs_base"], re=RE).solve(**kw)
    return np.asarray(jw), np.asarray(tw)


def _leading(es_mod, A, M):
    es = es_mod.EigenSolver(A, M, es_mod.EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(es_mod.STType.SINVERT)
    es.set_target(TARGET)
    es.set_st_pc_type("banded")
    pairs = es.solve()
    return pairs, es


def _no_host_lu(*args, **kw):
    raise AssertionError("host LU called on the device path")


@pytest.fixture(scope="module")
def jax_system(cases, baseflows):
    """The JAX package's (A, M) around the JAX baseflow."""
    jc, _ = cases
    jw, _ = baseflows
    return JLinearized(jw, jc["ctx"], RE, jc["bcs_pert"], jc["mesh"]).assemble_eigensystem()


@pytest.fixture(scope="module")
def jax_leading(jax_system):
    """The JAX package's leading pair on its pivot-free branch, and the
    pivoted flags its ``factor_auto`` returned."""
    pivoted = []
    factor_auto = jband.factor_auto

    def spy(*args, **kw):
        lu, piv = factor_auto(*args, **kw)
        pivoted.append(piv)
        return lu, piv

    mp = pytest.MonkeyPatch()
    mp.setenv("LSAFW_PIVOT_MEM_GB", "0")
    mp.setattr(jband, "factor_auto", spy)
    mp.setattr(jeigen, "SparseLU", _no_host_lu)
    mp.setitem(jband.plan_for_csr.__kwdefaults__, "chunk", 1)  # unpadded, as _small_plans
    try:
        jpairs, _ = _leading(jeigen, *jax_system)
    finally:
        mp.undo()
    return jpairs, pivoted


def _forbid_host_lu(mp: pytest.MonkeyPatch) -> None:
    """Every host LU of the port raises."""
    for mod, name in ((tdirect, "SparseLU"), (tdirect, "direct_solve"), (tnewton, "SparseLU"),
                      (tbaseflow, "direct_solve")):
        mp.setattr(mod, name, _no_host_lu)


def _small_plans(mp: pytest.MonkeyPatch) -> None:
    """Band plans of the small cylinder's 23 block rows, unpadded (chunk 1)
    rather than padded with identity rows to 128: the same factors and
    solves at a fifth of the CPU time (padded plans: the JAX comparisons
    above and ``test_torch_pivoted.py``; the card runs the default)."""
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)


@pytest.fixture(scope="module")
def banded_baseflow(cases):
    """The port's baseflow on the banded Newton, host LU forbidden."""
    _, tc = cases
    mp = pytest.MonkeyPatch()
    mp.setattr(tnewton, "SparseLU", _no_host_lu)
    mp.setattr(tbaseflow, "direct_solve", _no_host_lu)
    _small_plans(mp)
    try:
        solver = tbaseflow.BaseFlowSolver(tc["ctx"], tc["mesh"], tc["bcs_base"], re=RE)
        w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
    finally:
        mp.undo()
    return np.asarray(w), solver


def test_baseflow_matches(cases, baseflows):
    jw, tw = baseflows
    assert np.isfinite(tw).all()
    assert np.abs(tw - jw).max() / np.abs(jw).max() <= 1e-9
    jc, tc = cases
    assert tbaseflow.compute_recirculation_length(tc["ctx"], tw) == pytest.approx(
        jbaseflow.compute_recirculation_length(jc["ctx"], jw), rel=1e-12)


def test_leading_eigenvalue_matches(cases, baseflows, jax_leading, monkeypatch):
    jc, tc = cases
    jw, tw = baseflows
    jpairs, pivoted = jax_leading
    assert pivoted and not any(pivoted)
    monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", "0")
    A, M = LinearizedNavierStokesAssembler(tw, tc["ctx"], RE, tc["bcs_pert"],
                                           tc["mesh"]).assemble_eigensystem()
    pairs, es = _leading(teigen, A, M)
    sigma = pairs[0][0]
    assert abs(sigma - jpairs[0][0]) <= 1e-8
    assert teigen.eigen_residuals(A, M, pairs)[0] <= 1e-8
    assert not es.operator.pivoted
    print(f"pivot-free factor: contraction {es.operator.rho:.2e}")
    assert es.operator.rho < 1e-2  # the pivot-free factor preconditions well


def test_banded_baseflow_matches(cases, baseflows, banded_baseflow):
    jw, _ = baseflows
    w, solver = banded_baseflow
    rel = np.abs(w - jw).max() / np.abs(jw).max()
    print(f"banded baseflow vs the JAX host-LU baseflow: rel {rel:.2e}")
    assert np.isfinite(w).all() and rel <= 1e-7
    jc, tc = cases
    assert tbaseflow.compute_recirculation_length(tc["ctx"], w) == pytest.approx(
        jbaseflow.compute_recirculation_length(jc["ctx"], jw), rel=1e-6)
    st = solver.stats
    assert st["factors"] == st["pivoted"] > 0  # one real pivoted factor per solve
    assert st["spmvs"] > 0 and all(r.converged for r in solver.newton_results)


def test_pivoted_eigenvalue_matches(cases, banded_baseflow, jax_leading, monkeypatch):
    """The default branch: pivoted factor, (A, M) refinement matvecs on
    the permuted CSR, no host LU."""
    _, tc = cases
    w, _ = banded_baseflow
    jpairs, _ = jax_leading
    monkeypatch.delenv("LSAFW_PIVOT_MEM_GB", raising=False)
    monkeypatch.setattr(tnewton, "SparseLU", _no_host_lu)
    monkeypatch.setattr(tbaseflow, "direct_solve", _no_host_lu)
    _small_plans(monkeypatch)
    A, M = LinearizedNavierStokesAssembler(w, tc["ctx"], RE, tc["bcs_pert"],
                                           tc["mesh"]).assemble_eigensystem()
    pairs, es = _leading(teigen, A, M)
    op = es.operator
    assert op.pivoted and isinstance(op.device_op.blu, PivotedBandedLU)
    assert isinstance(op.device_op.Cop, BCSRShiftedOp)
    assert abs(pairs[0][0] - jpairs[0][0]) <= 1e-8
    assert teigen.eigen_residuals(A, M, pairs)[0] <= 1e-8
    print(f"pivoted factor: contraction {op.rho:.2e}")
    assert op.rho < 1e-4  # no saddle regularization: an f32 LU's contraction


# ---------------------------------------------------------------------------
# Adjoint sensitivity
# ---------------------------------------------------------------------------


def _rel(got, ref) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_sensitivity(cases, baseflows, jax_system):
    """The JAX package's sensitivity pipeline, once, with its default
    ``si_method="lu"``; the adjoint eigenvalue is read off the pairs of
    its eigensolver."""
    jc, _ = cases
    jw, _ = baseflows
    JA, JM = jax_system
    solved = []

    class Recording(jeigen.EigenSolver):
        def solve(self):
            solved.append(super().solve())
            return solved[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(jsens, "EigenSolver", Recording)
    try:
        sens = jsens.EigenSensitivitySolver(jc["ctx"], jc["mesh"], jc["bcs_base"], jw, RE, A=JA,
                                            M=JM, perturbation_bcs=jc["bcs_pert"], target=TARGET)
        sigma, v = sens.solve_direct_mode()
        a = sens.solve_adjoint_mode()
        s = sens.compute_baseflow_sensitivity()
        d = sens.evaluate_sensitivity()
        sw = sens.compute_wavemaker()
    finally:
        mp.undo()
    sigma_adj = min(solved[-1], key=lambda p: abs(p[0] - np.conj(sigma)))[0]
    return dict(sigma=sigma, v=np.asarray(v), a=np.asarray(a), sigma_adj=sigma_adj,
                s=np.asarray(s), d=d, sw=np.asarray(sw))


@pytest.fixture(scope="module")
def port_system(cases, baseflows):
    """The port's (A, M) around the same (JAX) baseflow."""
    _, tc = cases
    jw, _ = baseflows
    return LinearizedNavierStokesAssembler(jw, tc["ctx"], RE, tc["bcs_pert"],
                                           tc["mesh"]).assemble_eigensystem()


def _port_solver(cases, baseflows, port_system):
    _, tc = cases
    jw, _ = baseflows
    A, M = port_system
    return tsens.EigenSensitivitySolver(tc["ctx"], tc["mesh"], tc["bcs_base"], jw, RE, A=A, M=M,
                                        perturbation_bcs=tc["bcs_pert"], target=TARGET,
                                        device="cpu")


@pytest.fixture(scope="module")
def port_evaluated(cases, baseflows, port_system):
    """The port's own pipeline, once: ``evaluate(TARGET)`` (direct mode,
    adjoint mode at that pair, du/dRe) with host LU forbidden."""
    mp = pytest.MonkeyPatch()
    _forbid_host_lu(mp)
    _small_plans(mp)
    try:
        solver = _port_solver(cases, baseflows, port_system)
        d = solver.evaluate(TARGET)
    finally:
        mp.undo()
    return solver, d


def test_homogeneous_bcs_match_jax(cases):
    jc, tc = cases
    jh, th = jc["bcs_base"].homogeneous(), tc["bcs_base"].homogeneous()
    assert np.array_equal(th.dirichlet_mask, jh.dirichlet_mask)
    assert np.array_equal(th.dirichlet_values, jh.dirichlet_values)
    assert not th.dirichlet_values.any() and tc["bcs_base"].dirichlet_values.any()
    assert (th.velocity_neumann, th.pressure_neumann, th.robin, th.outlet_markers) == (
        jh.velocity_neumann, jh.pressure_neumann, jh.robin, jh.outlet_markers)


def test_adjoint_mode_matches_jax(port_evaluated, jax_sensitivity):
    """The adjoint pair of ``evaluate()``'s ``solve_adjoint_mode(sigma, v)``
    call, against the JAX package's: both vectors are scaled by a^H M v = 1
    on their own direct vector, which differ by a phase c (v_port = c v),
    so a_port conj(c) is held to the JAX package's a."""
    solver, _ = port_evaluated
    ref = jax_sensitivity
    assert abs(solver.sigma_adjoint - ref["sigma_adj"]) <= 1e-8
    assert abs(solver.sigma_adjoint - np.conj(ref["sigma"])) <= 1e-8
    c = complex(np.vdot(ref["v"], solver._v.numpy()) / np.vdot(ref["v"], ref["v"]))
    assert abs(abs(c) - 1) <= 1e-8
    assert _rel(solver._a * np.conj(c), ref["a"]) <= 1e-6
    op = solver.operators["adjoint"]
    assert op["pivoted"] and op["fused"]


def test_baseflow_sensitivity_matches_jax(port_evaluated, jax_sensitivity):
    solver, _ = port_evaluated
    assert _rel(solver._baseflow_sens, jax_sensitivity["s"]) <= 1e-7
    res = solver.baseflow_solve
    assert res.converged and res.residual <= 1e-10
    assert solver.stats["factors"] == solver.stats["pivoted"] == 1


def test_evaluate_sensitivity_and_wavemaker_match_jax(cases, baseflows, port_system,
                                                      jax_sensitivity):
    """d sigma/dRe and the wavemaker on the JAX package's (v, a, s)."""
    ref = jax_sensitivity
    solver = _port_solver(cases, baseflows, port_system)
    v, a = (interop.complex_state_from_numpy(ref[k], device="cpu") for k in ("v", "a"))
    s = interop.state_from_numpy(ref["s"], device="cpu")
    d = solver.evaluate_sensitivity(v=v, a=a, baseflow_sens=s)
    assert abs(d - ref["d"]) <= 1e-10 * abs(ref["d"])
    sw = solver.compute_wavemaker(v=v, a=a)
    assert _rel(sw, ref["sw"]) <= 1e-8
    assert not sw[cases[1]["spaces"].dofs_u].any()
    assert solver.wavemaker_cg.converged


def test_evaluate_end_to_end_matches_jax(port_evaluated, jax_sensitivity):
    solver, d = port_evaluated
    ref = jax_sensitivity
    print(f"d sigma/dRe: port {d:.10e}, JAX package {ref['d']:.10e}")
    assert abs(d - ref["d"]) <= 1e-6 * abs(ref["d"])
    assert abs(solver._sigma - ref["sigma"]) <= 1e-8
    assert all(op["pivoted"] and op["fused"] for op in solver.operators.values())


@pytest.mark.parametrize("structure", ["taylor_hood", "unsymmetric"])
def test_transpose_pair_matches_jax(jax_system, structure):
    """Both transposes on one pattern, equal to the JAX package's and to
    scipy's ``.T`` exactly; a structurally symmetric pair keeps its
    pattern object."""
    if structure == "taylor_hood":
        JA, JM = jax_system
        sA, sM = JA.to_scipy(), JM.to_scipy()
    else:
        rng = np.random.default_rng(5)
        sA = sp.random(60, 60, density=0.1, random_state=rng, format="csr") + sp.eye(60)
        sA.sort_indices()
        sM = sp.csr_matrix((rng.standard_normal(sA.nnz), sA.indices, sA.indptr), shape=sA.shape)
        JA = jsparse.CSRMatrix.from_scipy(sA)
        JM = jsparse.CSRMatrix(JA.pattern, jnp.asarray(sM.data))
    pat = interop.csr_from_numpy(sA.indptr, sA.indices, sA.data, sA.shape, device="cpu").pattern
    A = tsparse.CSRMatrix(pat, torch.as_tensor(sA.data))
    M = tsparse.CSRMatrix(pat, torch.as_tensor(sM.data))
    At, Mt = tsparse.transpose_pair(A, M)
    JAt, JMt = jsparse.transpose_pair(JA, JM)
    assert At.pattern is Mt.pattern
    assert (At.pattern is pat) == (structure == "taylor_hood")
    for t, j, ref in ((At, JAt, sA), (Mt, JMt, sM)):
        st = ref.T.tocsr()
        st.sort_indices()
        for got in (j.pattern, st):
            assert np.array_equal(t.pattern.indptr, got.indptr)
            assert np.array_equal(t.pattern.indices, got.indices)
        assert np.array_equal(t.data.numpy(), np.asarray(j.data))
        assert np.array_equal(t.data.numpy(), st.data)


FORMS = ("grad_inner", "convection", "velocity_inner", "sesquilinear")


@pytest.mark.parametrize("form", FORMS)
def test_scalar_forms_match_jax(cases, baseflows, form):
    jc, tc = cases
    jw, _ = baseflows
    rng = np.random.default_rng(FORMS.index(form))
    n = jw.size
    w1, w2 = rng.standard_normal(n), rng.standard_normal(n)
    a = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    calls = {
        "grad_inner": lambda m, c: m.grad_inner_integral(c, w1, w2),
        "convection": lambda m, c: m.convection_integral(c, jw, w1, w2),
        "velocity_inner": lambda m, c: m.velocity_inner_integral(c, w1, w2),
        "sesquilinear": lambda m, c: m._sesquilinear(
            lambda x, y: m.convection_integral(c, jw, x, y), a, v),
    }
    got, ref = calls[form](tsens, tc["ctx"]), calls[form](jsens, jc["ctx"])
    assert abs(got - ref) <= 1e-12 * abs(ref)


def test_cg_jacobi_match_jax(cases):
    """The P1 pressure mass matrix of ``SpaceContext`` and Jacobi CG on it,
    against the JAX package's, on a right-hand side from a seed."""
    jc, tc = cases
    jp = jassembly.SpaceContext.build(jc["spaces"].pressure)
    tp = tassembly.SpaceContext.build(tc["spaces"].pressure, device="cpu")
    JMp = jp.scatter(jassembly.mass_scalar(jp))
    Mp = tp.scatter(tassembly.mass_scalar(tp))
    assert np.array_equal(Mp.pattern.indptr, JMp.pattern.indptr)
    assert _rel(Mp.data, JMp.data) <= 1e-12
    el = np.random.default_rng(9).standard_normal(tuple(tp.cell_dofs.shape))
    b = tp.scatter_vec(torch.as_tensor(el))
    jb = jp.scatter_vec(jnp.asarray(el))
    assert _rel(b, jb) <= 1e-12
    kw = dict(tol=1e-12, maxiter=2000)
    jres = jlinear.cg(lambda x: jsparse.spmv(JMp, x), jb, M=jprecond.jacobi(JMp), **kw)
    res = tlinear.cg(lambda x: tsparse.spmv(Mp, x), b, M=tprecond.jacobi(Mp), **kw)
    assert res.converged and bool(jres.converged)
    assert abs(res.iterations - int(jres.iterations)) <= 1
    assert _rel(res.x, jres.x) <= 1e-10


def test_shift_on_an_exact_eigenvalue_retries_offset(monkeypatch):
    """A shift exactly on an eigenvalue makes C singular: the band factor's
    calibration refuses it, and the eigensolver retries once at the offset
    shift 1e-3 (1 + |target|), as the direct mode at sigma does."""
    A, M, _ = _block_pair()
    target = complex(-0.3, 3.0)  # the third block's eigenvalue a + ib
    _small_plans(monkeypatch)
    es = teigen.EigenSolver(A, M, teigen.EigensolverConfig(num_eig=1, atol=1e-10, ncv=10))
    es.set_st_type(teigen.STType.SINVERT)
    es.set_target(target)
    es.set_st_pc_type("banded")
    with pytest.raises(teigen.FactorUnusable):
        teigen.ShiftInvertOperator(A, M, target)
    lam, x = es.solve()[0]
    assert es.operator.sigma == target + 1e-3 * (1 + abs(target))
    assert abs(lam - target) <= 1e-10
    assert teigen.eigen_residuals(A, M, [(lam, x)])[0] <= 1e-10


# ---------------------------------------------------------------------------
# The bf16 -> f32 retry rung, and the TOML loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solve", ["newton", "stokes"])
def test_bf16_retry_rung_matches_jax(cases, solve, monkeypatch):
    """A banded solve that fails on a bf16 band (forced here: the first one
    reports a stall) marks the pattern bf16-unstable and is solved again
    on an f32 plan that the budget clips: the plan the JAX package makes
    for the marked pattern under the same budget, and a result SuperLU's
    f64 solve agrees with to 1e-9 (GCR's tolerance is 1e-10)."""
    _, tc = cases
    _small_plans(monkeypatch)
    monkeypatch.setenv("LSAFW_BAND_NB", "32")  # B = 8: a clipped band still preconditions
    A, b = tc["ns"].StokesAssembler(tc["ctx"], tc["mesh"], tc["bcs_base"], re=RE).get_matrix_forms()
    if solve == "newton":
        w = tdirect.direct_solve(A, b.numpy())
        asm = tc["ns"].StationaryNavierStokesAssembler(tc["ctx"], tc["mesh"], tc["bcs_base"])
        A = asm.jacobian(w, RE)
        b = -asm.residual(w, RE)
    full = tband.plan_for_csr(A, real=True)
    monkeypatch.setenv("LSAFW_BAND_MEM_GB",  # bf16 at full width; f32 clipped to B - 1
                       repr(0.95 * full.rows_total * full.R * full.nb * full.nb * 4 / 1e9))
    monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", "0")  # the pivot-free factors, which keep bf16
    plans = []
    banded_solve = tnewton.banded_solve

    def first_fails(A_, b_, plan, **kw):
        plans.append(plan)
        res = banded_solve(A_, b_, plan, **kw)
        return res if len(plans) > 1 else replace(res, residual=1.0, converged=False)

    mod = tnewton if solve == "newton" else tbaseflow
    monkeypatch.setattr(mod, "banded_solve", first_fails)
    JA = jsparse.CSRMatrix.from_scipy(A.to_scipy())
    try:
        if solve == "newton":
            x = tnewton.NewtonSolver(asm, linear_solver="banded")._banded_solve(A, b).numpy()
        else:
            x = tbaseflow.BaseFlowSolver(tc["ctx"], tc["mesh"], tc["bcs_base"],
                                         re=RE)._solve_stokes_flow("banded")
        marked = tband.bf16_unstable(A.pattern)
        jband.mark_bf16_unstable(JA.pattern)
        ref_plan = jband.plan_for_csr(JA, real=True, chunk=1)
    finally:
        tband._BF16_UNSTABLE.discard(A.pattern)
        jband._BF16_UNSTABLE.discard(id(JA.pattern))
    assert marked and [p.band_dtype for p in plans] == ["bf16", "f32"]
    assert plans[0].B == full.B == plans[1].B + 1
    assert (plans[1].B, plans[1].nblk_pad, plans[1].band_dtype) == (
        ref_plan.B, ref_plan.nblk_pad, ref_plan.band_dtype)
    ref = spla.spsolve(A.to_scipy().tocsc(), b.numpy())
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) <= 1e-9


def test_config_loaders_match_jax():
    """The production configuration's four TOML files through both
    packages' loaders: the same geometry, boundary conditions and facet
    markers; and one coordinate expression compiled alike."""
    from dataclasses import asdict
    from pathlib import Path

    from lsafw_tpu import config as jconfig
    from lsafw_tpu_torch import config as tconfig

    root = Path(__file__).resolve().parents[1] / "config_files" / "2D" / "cylinder"
    geo = tconfig.load_cylinder_flow_config(root / "geometry.toml")
    assert asdict(geo) == asdict(jconfig.load_cylinder_flow_config(root / "geometry.toml"))
    assert (geo.x_range, geo.y_range, geo.resolution) == ((-40.0, 120.0), (-40.0, 40.0), 1.25)
    for name in ("bcs.toml", "bcs_perturbation.toml"):
        got, ref = tconfig.load_bc_config(root / name), jconfig.load_bc_config(root / name)
        assert [(c.marker, c.type, c.value, c.robin_alpha) for c in got] == [
            (c.marker, c.type, c.value, c.robin_alpha) for c in ref]
    pts = np.array([[-40.0, 3.0], [120.0, -7.0], [10.0, -40.0], [5.0, 40.0], [0.5, 0.0],
                    [0.0, -0.5], [-40.0, -40.0]])
    got = tconfig.load_facet_config(root / "facets.toml")(pts)
    assert np.array_equal(got, jconfig.load_facet_config(root / "facets.toml")(pts))
    assert got.tolist() == [1, 2, 3, 4, 5, 5, 1]
    xy = np.random.default_rng(3).standard_normal((20, 2))
    expr = ["4*y*(1 - y)", "sin(pi*x)"]
    assert np.array_equal(tconfig._compile_bc_expr(expr, scalar=False)(xy),
                          jconfig._compile_bc_expr(expr, scalar=False)(xy))


def _block_pair(k: int = 20):
    """(A, M) of 2x2 blocks [[a, -b], [b, a]] (eigenvalues a +- ib) and M = I,
    on one pattern."""
    a, b = -np.arange(1, k + 1) / 10, np.arange(1, k + 1, dtype=np.float64)
    sA = sp.block_diag([[[x, -y], [y, x]] for x, y in zip(a, b)], format="csr")
    sA.sort_indices()
    pat = interop.csr_from_numpy(sA.indptr, sA.indices, sA.data, sA.shape, device="cpu").pattern
    A = tsparse.CSRMatrix(pat, torch.as_tensor(sA.data))
    return A, tsparse.CSRMatrix(pat, torch.as_tensor((sA.indices == pat.row_ids) * 1.0)), sA


@pytest.mark.parametrize("scale", [3.0, 0.0])
def test_weak_factor_kept_only_if_gcr_converges(scale, monkeypatch):
    """A pivot-free factor whose inverse diagonal blocks are scaled by 3
    contracts by 2 in one step (the reference's bound refuses it), but a
    trial GCR solve reaches the tolerance at once: it is kept, with a cap
    of four times the trial's iterations, and its applies are exact to the
    tolerance.  Scaled by 0 it carries nothing: the trial fails and the
    factor is refused."""
    A, M, sA = _block_pair()
    monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", "0")
    _small_plans(monkeypatch)
    factor_auto = teigen.factor_auto

    def scaled(*args, **kw):
        lu, pivoted = factor_auto(*args, **kw)
        return replace(lu, dinv=scale * lu.dinv), pivoted

    monkeypatch.setattr(teigen, "factor_auto", scaled)
    if scale == 0.0:
        with pytest.raises(teigen.FactorUnusable, match="trial GCR solve"):
            teigen.ShiftInvertOperator(A, M, TARGET)
        return
    op = teigen.ShiftInvertOperator(A, M, TARGET)
    assert op.rho == pytest.approx(2.0, rel=1e-6) and op.trial_its is not None
    assert 1 <= op.trial_its <= op._TRIAL_CAP and op.refine_its == 4 * op.trial_its
    v = np.random.default_rng(12).standard_normal(A.shape[0]) + 0j
    y = op.apply(torch.as_tensor(v)).numpy()
    ref = spla.spsolve((sA - TARGET * sp.identity(A.shape[0])).tocsc(), v)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) <= 1e-9


def test_sensitivity_lu_matches_jax_and_banded(cases, baseflows, port_system, port_evaluated,
                                               jax_sensitivity):
    """``si_method="lu"``, asked for: the host SuperLU shift-invert (the
    eigensolves run ``EigenSolver`` with ``set_st_pc_type("lu")``) and a
    host LU of J for du/dRe, against the JAX package's host-LU pipeline and
    the port's banded one."""
    _, tc = cases
    jw, _ = baseflows
    A, M = port_system
    solver = tsens.EigenSensitivitySolver(tc["ctx"], tc["mesh"], tc["bcs_base"], jw, RE, A=A,
                                          M=M, perturbation_bcs=tc["bcs_pert"], target=TARGET,
                                          si_method="lu", device="cpu")
    d = solver.evaluate(TARGET)
    ref = jax_sensitivity
    assert abs(solver._sigma - ref["sigma"]) <= 1e-8
    assert abs(solver.sigma_adjoint - ref["sigma_adj"]) <= 1e-8
    assert _rel(solver._baseflow_sens, ref["s"]) <= 1e-9
    assert abs(d - ref["d"]) <= 1e-6 * abs(ref["d"])
    assert abs(d - port_evaluated[1]) <= 1e-6 * abs(ref["d"])
    assert not any(op["pivoted"] or op["fused"] for op in solver.operators.values())
