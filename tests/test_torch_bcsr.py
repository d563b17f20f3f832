"""The port's refinement matvecs (permuted CSR, ``ops/bcsr.py``) and the
plain versions of its G and S kernels, against scipy, numpy and the JAX
package's BCSR operators (the cases of ``tests/unit/test_bcsr.py`` that
are about values).

Tolerances: the matvecs are f64 on every side and differ only in
summation order (rel 1e-13 against scipy, 1e-12 against the JAX
package's hi/lo-split apply); a gather moves values, so it is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lsafw_tpu.ops.bcsr import BCSRShiftedOp as JBCSRShiftedOp
from lsafw_tpu.ops.sparse import CSRMatrix as JCSRMatrix
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.ops import bcsr, spmv_cuda
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.solver.band import plan_for_csr, rcm_permutation
from lsafw_tpu_torch.solver.eigen import BandedSIOp, _si_apply_M
from tests.test_torch_fem import one_blas_thread  # noqa: F401
from tests.unit.test_bcsr import fem_like_matrix

torch.set_num_threads(1)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _csr(S, data=None):
    return interop.csr_from_numpy(S.indptr, S.indices, S.data if data is None else data, S.shape,
                                  device="cpu")


def _pair(n=400, seed=8):
    """(A, M) of one FEM-like pattern: the port's CSRMatrix pair and scipy."""
    A = fem_like_matrix(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    Md = sp.csr_matrix((rng.random(A.nnz) + 0.5, A.indices, A.indptr), shape=A.shape)
    Am = _csr(A)
    return A, Md, Am, CSRMatrix(Am.pattern, torch.as_tensor(Md.data)), rng


def _cvec(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("dtype", ["real", "complex"])
def test_bcsr_matvec_matches_scipy(dtype):
    A = fem_like_matrix(900)
    before = dict(spmv_cuda.LAUNCHES)
    op = bcsr.BCSROperator.from_csr(_csr(A))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0]) if dtype == "real" else _cvec(rng, A.shape[0])
    y = op.matvec(torch.as_tensor(x))
    assert y.dtype == (torch.float64 if dtype == "real" else torch.complex128)
    assert _rel(y.numpy(), A @ x) <= 1e-13
    if dtype == "complex":
        assert _rel(op.matvec_pair(torch.as_tensor(x)).numpy(), A @ x) <= 1e-13
    assert spmv_cuda.LAUNCHES == before  # CPU tensors run the plain versions


def test_bcsr_permuted_space_roundtrip():
    A = fem_like_matrix(400, seed=2)
    Am = _csr(A)
    plan = bcsr.plan_for_pattern(Am)
    assert bcsr.plan_for_pattern(Am) is plan  # cached per pattern
    op = bcsr.BCSROperator.from_csr(Am, plan)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    yp = op.matvec_permuted(torch.as_tensor(x[plan.perm]))
    assert _rel(yp.numpy(), (A @ x)[plan.perm]) <= 1e-13
    P = A[plan.perm][:, plan.perm].tocsr()
    P.sort_indices()
    np.testing.assert_array_equal(plan.indptr, P.indptr)
    np.testing.assert_array_equal(plan.indices, P.indices)
    np.testing.assert_array_equal(op.vals.numpy(), P.data)


def test_bcsr_shares_band_rcm():
    """One RCM pass per pattern serves the band plans and the CSR plan."""
    A = fem_like_matrix(400, seed=6)
    Am = _csr(A)
    plan = bcsr.plan_for_pattern(Am)
    np.testing.assert_array_equal(plan.perm, rcm_permutation(A))
    assert plan_for_csr(Am, chunk=16).perm is plan.perm
    assert plan_for_csr(Am, chunk=16, real=True).perm is plan.perm


def test_bcsr_shifted_op():
    """C apply, fused C + M apply and mass apply against scipy; a new
    sigma reuses the stored values."""
    A, Md, Am, Mm, rng = _pair()
    sigma = 1.7 - 0.4j
    op = bcsr.BCSRShiftedOp.from_csr(Am, Mm, sigma)
    z = _cvec(rng, A.shape[0])
    zt = torch.as_tensor(z)
    assert _rel(op.matvec_pair(zt).numpy(), (A - sigma * Md) @ z) <= 1e-13
    y, m = op.matvec_pair(zt, mass=True)
    assert _rel(y.numpy(), (A - sigma * Md) @ z) <= 1e-13
    assert _rel(m.numpy(), Md @ z) <= 1e-13
    assert _rel(op.mass_pair(zt).numpy(), Md @ z) <= 1e-13
    op2 = dataclasses.replace(op, sigma=3.1 + 0.2j)
    assert op2.vA is op.vA and op2.vM is op.vM
    assert _rel(op2.matvec_pair(zt).numpy(), (A - (3.1 + 0.2j) * Md) @ z) <= 1e-13


def test_shifted_apply_matches_jax():
    A, Md, Am, Mm, rng = _pair(seed=10)
    sigma = 0.2 + 0.74j
    z = _cvec(rng, A.shape[0])
    jA = JCSRMatrix.from_scipy(A)
    jop = JBCSRShiftedOp.from_csr(jA, JCSRMatrix(jA.pattern, jnp.asarray(Md.data)), sigma,
                                  br=8, bc=32)
    yr, yi = jop.matvec_pair(jnp.asarray(z.real), jnp.asarray(z.imag))
    got = bcsr.BCSRShiftedOp.from_csr(Am, Mm, sigma).matvec_pair(torch.as_tensor(z))
    assert _rel(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi)) <= 1e-12


def test_si_apply_m_dispatch():
    """With a Cop, M x comes from Cop's storage (M is deliberately 2x wrong
    in the op, so the assertion proves the route); without one, from M."""
    A, Md, Am, Mm, rng = _pair(seed=12)
    sigma = 0.3 + 0.9j
    cop = bcsr.BCSRShiftedOp.from_csr(Am, Mm, sigma)
    z = torch.as_tensor(_cvec(rng, A.shape[0]))
    M2 = CSRMatrix(Am.pattern, 2.0 * Mm.data)
    ref = Md @ z.numpy()
    assert _rel(_si_apply_M(BandedSIOp(Am, M2, None, sigma, cop), z).numpy(), ref) <= 1e-13
    assert _rel(_si_apply_M(BandedSIOp(Am, Mm, None, sigma), z).numpy(), ref) <= 1e-13


def test_operator_for_budget(monkeypatch):
    Am = _csr(fem_like_matrix(400, seed=14))
    assert isinstance(bcsr.operator_for_budget(Am), bcsr.BCSROperator)
    monkeypatch.setenv("LSAFW_BCSR_MEM_GB", "1e-6")
    assert bcsr.operator_for_budget(Am) is None


def _probe_inputs(N: int, rng):
    x = rng.standard_normal(N).astype(np.float32)
    return x, torch.from_numpy(x)


def test_gather_flat_forms_match_numpy():
    """``run_a``, ``run_b`` and ``run_c`` of ``scripts/dev_pallas_gather.py``
    at reduced sizes, their indices built as the probes build them."""
    rng = np.random.default_rng(0)
    N, R, W = 1 << 12, 64, 16
    x, xt = _probe_inputs(N, rng)
    idx = rng.integers(0, N, (R, W)).astype(np.int32)
    ref = x[idx]
    got_a = spmv_cuda.gather(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got_a.numpy(), ref)
    flat_b = (idx // 128) * 128 + idx % 128  # run_b's (row, lane) as one index
    np.testing.assert_array_equal(spmv_cuda.gather(xt, torch.from_numpy(flat_b)).numpy(), ref)
    lane_idx = rng.integers(0, 128, (N // 128, 128)).astype(np.int32)
    ref_c = np.take_along_axis(x.reshape(N // 128, 128), lane_idx, 1)
    flat_c = (np.arange(N // 128, dtype=np.int32)[:, None] * 128 + lane_idx).astype(np.int32)
    np.testing.assert_array_equal(spmv_cuda.gather(xt, torch.from_numpy(flat_c)).numpy(), ref_c)


def test_gather_two_pass_matches_numpy():
    """``pallas_two_pass`` of ``scripts/dev_pallas_gather2.py`` at a reduced
    size, lane-unique indices built as the probe builds them."""
    rng = np.random.default_rng(0)
    N, M = 1 << 12, 256
    x, xt = _probe_inputs(N, rng)
    rows = rng.integers(0, N // 128, (M, 128)).astype(np.int32)
    perm = np.argsort(rng.random((M, 128)), axis=1).astype(np.int32)
    lanes = np.take_along_axis(np.tile(np.arange(128, dtype=np.int32), (M, 1)), perm, axis=1)
    rowsel = np.take_along_axis(rows, np.argsort(perm, axis=1).astype(np.int32), axis=1)
    got = spmv_cuda.gather_two_pass(xt.reshape(N // 128, 128), torch.from_numpy(rowsel),
                                    torch.from_numpy(lanes))
    np.testing.assert_array_equal(got.numpy(), x[rows * 128 + lanes])


def test_spmv_plain_matches_scipy_and_checks():
    A, Md, Am, Mm, rng = _pair(seed=16)
    plan = bcsr.plan_for_pattern(Am)
    ix = plan.on("cpu")
    vA = spmv_cuda.gather(Am.data, ix["src"])
    vM = spmv_cuda.gather(Mm.data, ix["src"])
    P = lambda S: S[plan.perm][:, plan.perm]  # noqa: E731
    z = _cvec(rng, A.shape[0])
    y, m = spmv_cuda.csr_shifted_spmv(ix["crow"], ix["col"], ix["rows"], vA, vM,
                                      torch.as_tensor(z), 0.5j, mass=True)
    assert _rel(y.numpy(), P(A - 0.5j * Md) @ z) <= 1e-13
    assert _rel(m.numpy(), P(Md) @ z) <= 1e-13
    with pytest.raises(TypeError):
        spmv_cuda._check_spmv(ix["crow"], ix["col"].long(), vA, None, torch.as_tensor(z))
    with pytest.raises(ValueError):
        spmv_cuda._check_spmv(ix["crow"], ix["col"], vA, None, torch.as_tensor(z[:-1]))
    with pytest.raises(TypeError):
        spmv_cuda._check_gather(vA, ix["src"].long())
    with pytest.raises(ValueError):
        spmv_cuda._check_gather(torch.zeros((4, 2), dtype=torch.float64)[:, 0], ix["src"][:4])
