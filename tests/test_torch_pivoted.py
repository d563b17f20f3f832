"""Parity of the port's panel-pivoted band factors and their substitutions
with the JAX package, on the small cylinder's Stokes operator (real) and
shift-invert operator C = A - sigma M (complex).

Tolerances: the real factor is f32 on both sides and pivots by the same
|x| rule (rel 1e-4 in max-norm, pivots exact, as the pivot-free factor
test); a substitution of one factor in f32 (rel 1e-5); the complex
factor pivots by another rule than the reference (LAPACK's |re| + |im|
against |z|^2), so it is held at the level of its solves: its f32
solve's residual within 10x of the reference factor's, and its refined
solve to SuperLU at 1e-10.  Plans are built with chunk 16 on both sides.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.solver import band as jband
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import band_cuda
from lsafw_tpu_torch.solver.direct import direct_solve
from lsafw_tpu_torch.solver.eigen import BandedSIOp, banded_solve_raw
from tests.test_torch_band import plain_solve
from tests.test_torch_fem import RE, cylinder_case, one_blas_thread  # noqa: F401

torch.set_num_threads(1)

SIGMA = 0.74j
CHUNK = 16


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def system():
    """The port's Stokes operator, (A, M) around its Stokes flow, and
    the real and complex plans of their shared pattern on both sides
    (the port's under the JAX RCM ordering)."""
    c = cylinder_case("lsafw_tpu_torch", device="cpu")
    S, b0 = c["ns"].StokesAssembler(c["ctx"], c["mesh"], c["bcs_base"], re=RE).get_matrix_forms()
    A, M = c["ns"].LinearizedNavierStokesAssembler(
        direct_solve(S, b0.numpy()), c["ctx"], RE, c["bcs_pert"], c["mesh"]).assemble_eigensystem()
    pat = A.pattern
    csr = sp.csr_matrix((np.ones(pat.nnz, np.int8), pat.indices.copy(), pat.indptr.copy()),
                        shape=pat.shape)
    plans = {}
    for real in (True, False):
        jp = jband.BandPlan.build(csr, nb=128, chunk=CHUNK, real=real)
        tp = tband.BandPlan.build(csr, nb=128, chunk=CHUNK, perm=jp.perm, real=real)
        assert (tp.B, tp.nblk_pad, tp.real) == (jp.B, jp.nblk_pad, real)
        plans[real] = (jp, tp)
    return dict(S=S, A=A, M=M, plans=plans, dre=A.data - SIGMA.real * M.data,
                dim=-SIGMA.imag * M.data)


@pytest.fixture(scope="module")
def real_factors(system):
    jp, tp = system["plans"][True]
    S = system["S"]
    return (jband.RealPivotedBandedLU.factor(jp, jnp.asarray(S.data.numpy())),
            tband.RealPivotedBandedLU.factor(tp, S.data))


@pytest.fixture(scope="module")
def complex_factors(system):
    jp, tp = system["plans"][False]
    s = system
    return (jband.PivotedBandedLU.factor(jp, jnp.asarray(s["dre"].numpy()),
                                         jnp.asarray(s["dim"].numpy())),
            tband.PivotedBandedLU.factor(tp, s["dre"], s["dim"]))


def test_real_pivoted_factor_matches(real_factors):
    """The port's factor against the JAX factor in the port's stored
    layout (U blocks folded by Uinv, L2 by L1inv)."""
    jlu, tlu = real_factors
    np.testing.assert_array_equal(tlu.perms.numpy(), np.asarray(jlu.perms))
    ref = {name: torch.from_numpy(np.array(getattr(jlu, name))) for name in
           ("band", "L2", "L1inv", "Uinv")}
    ref["band"], ref["L2"] = tband.fold_pivoted(ref["band"], ref["L2"], ref["L1inv"], ref["Uinv"])
    for name in ("band", "L2", "L1inv", "Uinv"):
        got = getattr(tlu, name)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_pivoted_substitutions_match_jax_scans(request, real):
    """The port's substitutions (K1/K2 pivoted, whose plain versions CPU
    tensors take) on the JAX factors carried across into the port's
    folded layout, against ``_solve_pivoted_real`` / ``_solve_pivoted``."""
    rng = np.random.default_rng(5)
    if real:
        jr = request.getfixturevalue("real_factors")[0]
        lu = interop.real_pivoted_lu_from_numpy(jr.band, jr.L2, jr.L1inv, jr.Uinv, jr.perms,
                                                jr.perm, jr.iperm, jr.n, jr.nb, jr.B, device="cpu")
        b = rng.standard_normal((lu.L1inv.shape[0], lu.nb, 2)).astype(np.float32)
        ref = jband._solve_pivoted_real(jr.band, jr.L2, jr.L1inv, jr.Uinv, jr.perms,
                                        jnp.asarray(b), B=jr.B, nb=jr.nb)
        got = band_cuda.solve_pivoted(lu.band, lu.L2, lu.L1inv, lu.Uinv, lu.perms,
                                      torch.from_numpy(b))
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5
        return
    jc = request.getfixturevalue("complex_factors")[0]
    lu = interop.pivoted_lu_from_numpy(jc.band_re, jc.band_im, jc.L2r, jc.L2i, jc.L1inv_r,
                                       jc.L1inv_i, jc.Uinv_r, jc.Uinv_i, jc.perms, jc.perm,
                                       jc.iperm, jc.n, jc.nb, jc.B, device="cpu")
    br, bi = rng.standard_normal((2, lu.L1inv.shape[0], lu.nb)).astype(np.float32)
    xr, xi = jband._solve_pivoted(jc.band_re, jc.band_im, jc.L2r, jc.L2i, jc.L1inv_r, jc.L1inv_i,
                                  jc.Uinv_r, jc.Uinv_i, jc.perms, jnp.asarray(br), jnp.asarray(bi),
                                  B=jc.B, nb=jc.nb)
    got = band_cuda.solve_pivoted(lu.band, lu.L2, lu.L1inv, lu.Uinv, lu.perms,
                                  torch.from_numpy((br + 1j * bi).astype(np.complex64)))
    assert _rel(got.numpy(), np.asarray(xr) + 1j * np.asarray(xi)) <= 1e-5


def test_complex_pivoted_factor_solves_like_jax(system, complex_factors):
    s = system
    jlu, tlu = complex_factors
    assert tlu.band.dtype == torch.complex64 and tlu.perms.shape == (tlu.L1inv.shape[0],
                                                                      (tlu.B + 1) * tlu.nb)
    C = (s["A"].to_scipy() - SIGMA * s["M"].to_scipy()).tocsr()
    rng = np.random.default_rng(9)
    b = rng.standard_normal(C.shape[0]) + 1j * rng.standard_normal(C.shape[0])

    def resid(x):
        return np.linalg.norm(C @ x - b) / np.linalg.norm(b)

    r_ref = resid(jlu.solve(b))
    r_got = resid(tlu.solve(torch.as_tensor(b)).numpy())
    print(f"f32 pivoted solve residual: port {r_got:.2e}, reference {r_ref:.2e}")
    assert r_got <= 10 * r_ref
    op = BandedSIOp(s["A"], s["M"], tlu, SIGMA)
    x = banded_solve_raw(op, torch.as_tensor(b), tol=1e-13, max_its=40).numpy()
    ref = spla.spsolve(C.tocsc(), b)
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) <= 1e-10


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_factor_auto_branches_match_jax(system, monkeypatch, real):
    """Under one LSAFW_PIVOT_MEM_GB, both packages pick the same factor:
    pivoted at the default and just above the band plus its extra memory,
    pivot-free just below and at 0.  The factors themselves are stubbed:
    only the choice is compared."""
    jp, tp = system["plans"][real]
    assert tband.pivoted_extra_bytes(tp) == jband.pivoted_extra_bytes(jp)
    for mod in (jband, tband):
        for cls in ("PivotedBandedLU", "RealPivotedBandedLU", "BandedLU", "RealBandedLU"):
            monkeypatch.setattr(getattr(mod, cls), "factor", classmethod(
                lambda c, *a, **k: c.__name__))
    s = system
    need = tp.rows_total * tp.R * tp.nb * tp.nb * (4 if real else 8) + tband.pivoted_extra_bytes(tp)
    for gb in (None, (need + 1e6) / 1e9, (need - 1e6) / 1e9, 0.0):
        if gb is None:
            monkeypatch.delenv("LSAFW_PIVOT_MEM_GB", raising=False)
        else:
            monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", repr(gb))
        dim_t = None if real else s["dim"]
        dim_j = None if real else jnp.asarray(s["dim"].numpy())
        got = tband.factor_auto(tp, s["dre"], dim_t, diag_slots=s["A"].pattern.diag_slots)
        ref = jband.factor_auto(jp, jnp.asarray(s["dre"].numpy()), dim_j,
                                diag_slots=s["A"].pattern.diag_slots)
        assert got == ref, gb
        assert got[1] == (gb is None or gb * 1e9 >= need)


@pytest.mark.parametrize("real,b_complex", [(True, False), (True, True), (False, True),
                                             (False, False)],
                         ids=["real-f64", "real-c128", "complex-c128", "complex-f64"])
def test_permutes_match_jax(request, real, b_complex):
    """G's permute-in and permute-out (plain versions, as CPU tensors take
    them) against the reference's: ``_permute_in`` (zero pad, gather, cast
    to float32; a complex b as its two parts, stacked as columns) and the
    ``[iperm]`` gathers of the widened band-order result, exactly."""
    jlu, tlu = request.getfixturevalue("real_factors" if real else "complex_factors")
    # the complex classes inline _permute_in in solve_pair; the real one is it
    ref_in = SimpleNamespace(L1inv=jlu.L1inv if real else jlu.L1inv_r, nb=jlu.nb, n=jlu.n,
                             perm=jlu.perm)
    rng = np.random.default_rng(12)
    b = rng.standard_normal(tlu.n) + (1j * rng.standard_normal(tlu.n) if b_complex else 0)
    got = spmv_cuda.permute_in(torch.as_tensor(b), tlu.perm, tlu.nb, tlu.band.dtype)
    parts = [jband.RealPivotedBandedLU._permute_in(ref_in, jnp.asarray(c))
             for c in ((b.real, b.imag) if b_complex else (b,))]
    ref = np.stack([np.asarray(p) for p in parts], axis=2)
    if real:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(got.numpy().real, ref[:, :, 0])
        np.testing.assert_array_equal(got.numpy().imag, ref[:, :, 1] if b_complex else 0)
    assert not got.flatten(0, 1)[tlu.n:].any()  # the padding slots
    x = rng.standard_normal((got.shape[0], tlu.nb, 2)).astype(np.float32)
    cols = [jnp.asarray(x[:, :, j]).reshape(-1).astype(jnp.float64)[jlu.iperm] for j in (0, 1)]
    if real:
        xt = torch.from_numpy(x if b_complex else x[:, :, :1].copy())
    else:
        xt = torch.from_numpy(x[:, :, 0] + 1j * x[:, :, 1])
    out = spmv_cuda.permute_out(xt, tlu.iperm, torch.complex128 if b_complex else torch.float64)
    want = np.asarray(cols[0]) + (1j * np.asarray(cols[1]) if b_complex else 0)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.fixture(scope="module")
def real_pivot_free(system):
    """Both packages' pivot-free real factors of the Stokes operator
    (``factor_auto`` under a zero pivot budget, saddle-regularized)."""
    jp, tp = system["plans"][True]
    S = system["S"]
    mp = pytest.MonkeyPatch()
    mp.setenv("LSAFW_PIVOT_MEM_GB", "0")
    try:
        diag = S.pattern.diag_slots
        jlu, jpiv = jband.factor_auto(jp, jnp.asarray(S.data.numpy()), diag_slots=diag)
        tlu, tpiv = tband.factor_auto(tp, S.data, diag_slots=diag)
    finally:
        mp.undo()
    assert (jpiv, tpiv) == (False, False)
    return jlu, tlu


def test_real_pivot_free_factor_matches(real_pivot_free):
    """``factor_auto``'s over-budget real branch: the regularized pivot-free
    real factor against the JAX ``RealBandedLU``, and the port's real
    substitution (K1/K2 pivot-free, plain on CPU tensors) on the JAX factor
    against ``_solve_banded_real``."""
    jlu, tlu = real_pivot_free
    assert isinstance(tlu, tband.RealBandedLU)
    dinv = torch.tensor(np.asarray(jlu.dinv))
    band = tband.fold_pivot_free(torch.tensor(np.asarray(jlu.band)), dinv)  # the port's layout
    assert _rel(tlu.band.numpy(), band.numpy()) <= 1e-4
    assert _rel(tlu.dinv.numpy(), dinv.numpy()) <= 1e-4
    b = np.random.default_rng(7).standard_normal((tlu.dinv.shape[0], tlu.nb, 2)).astype(np.float32)
    ref = jband._solve_banded_real(jlu.band, jlu.dinv, jnp.asarray(b), B=jlu.B, nb=jlu.nb)
    got = band_cuda.solve_banded(band, dinv, torch.from_numpy(b))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5  # the JAX factor carried across


def test_real_shift_takes_the_real_factor(system):
    """A real shift factors one real band; a complex vector rides it as two
    columns, and the refined apply matches SuperLU."""
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    s = system
    op = ShiftInvertOperator(s["A"], s["M"], 0.5)
    assert op.pivoted and isinstance(op.device_op.blu, tband.RealPivotedBandedLU)
    n = s["A"].shape[0]
    rng = np.random.default_rng(3)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    C = (s["A"].to_scipy() - 0.5 * s["M"].to_scipy()).tocsc()
    ref = spla.spsolve(C, s["M"].to_scipy() @ v)
    got = op.apply(torch.as_tensor(v)).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-8


def test_plan_cache_keeps_real_and_complex_plans(system):
    """The Newton (real) and shift-invert (complex) plans of one pattern
    stay cached side by side."""
    A = system["A"]
    real = tband.plan_for_csr(A, real=True)
    cplx = tband.plan_for_csr(A)
    assert real.real and not cplx.real
    assert tband.plan_for_csr(A, real=True) is real and tband.plan_for_csr(A) is cplx


@pytest.mark.parametrize("which", ["real_pivoted", "complex_pivoted", "real_pivot_free"])
def test_factor_solve_takes_the_plain_path_on_cpu(request, which):
    """Each factor's ``solve`` on CPU tensors is the plain substitutions'
    result, bit for bit, with no kernel launch: a complex vector (two real
    columns on a real factor) and, on a real factor, a real one."""
    fixture = {"real_pivoted": "real_factors", "complex_pivoted": "complex_factors",
               "real_pivot_free": "real_pivot_free"}[which]
    lu = request.getfixturevalue(fixture)[1]
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.standard_normal(lu.n) + 1j * rng.standard_normal(lu.n))
    before = dict(band_cuda.LAUNCHES)
    for v in (b,) if lu.band.is_complex() else (b, b.real.contiguous()):
        torch.testing.assert_close(lu.solve(v), plain_solve(lu, v), rtol=0, atol=0)
    assert band_cuda.LAUNCHES == before
