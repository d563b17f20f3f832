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
"""

import numpy as np
import pytest
import torch

from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.solver import band as jband
from lsafw_tpu.solver import baseflow as jbaseflow
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
from lsafw_tpu_torch.solver import baseflow as tbaseflow
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver import newton as tnewton
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
def jax_leading(cases, baseflows):
    """The JAX package's leading pair on its pivot-free branch, and the
    pivoted flags its ``factor_auto`` returned."""
    jc, _ = cases
    jw, _ = baseflows
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
    try:
        JA, JM = JLinearized(jw, jc["ctx"], RE, jc["bcs_pert"], jc["mesh"]).assemble_eigensystem()
        jpairs, _ = _leading(jeigen, JA, JM)
    finally:
        mp.undo()
    return jpairs, pivoted


@pytest.fixture(scope="module")
def banded_baseflow(cases):
    """The port's baseflow on the banded Newton, host LU forbidden."""
    _, tc = cases
    mp = pytest.MonkeyPatch()
    mp.setattr(tnewton, "SparseLU", _no_host_lu)
    mp.setattr(tbaseflow, "direct_solve", _no_host_lu)
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
