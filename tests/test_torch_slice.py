"""The port's first slice end to end against the JAX package on a small
cylinder: ramped Newton baseflow (host SuperLU), eigensystem, and the
shift-invert Krylov-Schur eigenpair nearest 0.74j on the pivot-free
band factor with f64 refinement.

The JAX side takes the same pivot-free branch of ``factor_auto``
(``LSAFW_PIVOT_MEM_GB=0``).  The baseflow is f64 on both sides (rel
1e-9: Newton stops at tol 1e-8, so the last step's summation order
shows); the eigenvalue is held to the eigensolver's own gate (1e-8).
"""

import numpy as np
import pytest
import torch

from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.solver import band as jband
from lsafw_tpu.solver import baseflow as jbaseflow
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.solver import baseflow as tbaseflow
from lsafw_tpu_torch.solver import eigen as teigen
from tests.test_torch_fem import RE, cylinder_case

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


def test_baseflow_matches(cases, baseflows):
    jw, tw = baseflows
    assert np.isfinite(tw).all()
    assert np.abs(tw - jw).max() / np.abs(jw).max() <= 1e-9
    jc, tc = cases
    assert tbaseflow.compute_recirculation_length(tc["ctx"], tw) == pytest.approx(
        jbaseflow.compute_recirculation_length(jc["ctx"], jw), rel=1e-12)


def test_leading_eigenvalue_matches(cases, baseflows, monkeypatch):
    jc, tc = cases
    jw, tw = baseflows
    monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", "0")
    pivoted = []

    def spy(*args, **kw):
        lu, piv = factor_auto(*args, **kw)
        pivoted.append(piv)
        return lu, piv

    def no_host_lu(*args, **kw):
        raise AssertionError("the JAX side left the band factor for host LU")

    factor_auto = jband.factor_auto
    monkeypatch.setattr(jband, "factor_auto", spy)
    monkeypatch.setattr(jeigen, "SparseLU", no_host_lu)
    JA, JM = JLinearized(jw, jc["ctx"], RE, jc["bcs_pert"], jc["mesh"]).assemble_eigensystem()
    jpairs, _ = _leading(jeigen, JA, JM)
    assert pivoted and not any(pivoted)

    A, M = LinearizedNavierStokesAssembler(tw, tc["ctx"], RE, tc["bcs_pert"],
                                           tc["mesh"]).assemble_eigensystem()
    pairs, es = _leading(teigen, A, M)
    sigma = pairs[0][0]
    assert abs(sigma - jpairs[0][0]) <= 1e-8
    assert teigen.eigen_residuals(A, M, pairs)[0] <= 1e-8
    assert es.operator.rho < 1e-2  # the pivot-free factor preconditions well
