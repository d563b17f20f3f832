"""Parity of the port's band plan, pivot-free band factor and band
substitution with the JAX package, on the shift-invert operator
C = A - sigma M of a small cylinder.

Tolerances: the plan is integer geometry (exact); the factor is f32 on
both sides with a different inversion route (native complex inverse vs
the 2nb real embedding) and summation order (rel 1e-4 in max-norm); the
substitution of one factor in f32 (rel 1e-5); the refined solve is f64
(1e-10 against SuperLU).  The bf16 at-rest factors round each entry
once, at other places on the two sides (rel 2e-2 for the band, 1e-2 for
an unrefined solve); carrying a bf16 factor across is exact; the plan
switches resolve to the same integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.ops import sparse as jsparse
from lsafw_tpu.solver import band as jband
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.ops import sparse as tsparse
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import band_cuda
from lsafw_tpu_torch.solver import newton as tnewton
from lsafw_tpu_torch.solver.direct import direct_solve
from lsafw_tpu_torch.solver.eigen import BandedSIOp, banded_solve_raw
from tests.test_torch_fem import RE, cylinder_case, one_blas_thread  # noqa: F401

torch.set_num_threads(1)

SIGMA = 0.74j


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def system():
    """(A, M) of the port around its Stokes flow, C's data split as the
    shift-invert factor sees it, and both packages' plans."""
    c = cylinder_case("lsafw_tpu_torch", device="cpu")
    A0, b0 = c["ns"].StokesAssembler(c["ctx"], c["mesh"], c["bcs_base"], re=RE).get_matrix_forms()
    w = direct_solve(A0, b0.numpy())
    A, M = c["ns"].LinearizedNavierStokesAssembler(
        w, c["ctx"], RE, c["bcs_pert"], c["mesh"]).assemble_eigensystem()
    pat = A.pattern
    csr = sp.csr_matrix((np.ones(pat.nnz, np.int8), pat.indices.copy(), pat.indptr.copy()),
                        shape=pat.shape)
    jplan = jband.BandPlan.build(csr, nb=128, chunk=128)
    dre = A.data - SIGMA.real * M.data
    dim = -SIGMA.imag * M.data
    return dict(A=A, M=M, csr=csr, jplan=jplan, dre=dre, dim=dim, diag=pat.diag_slots)


@pytest.fixture(scope="module")
def factors(system):
    """Both packages' pivot-free factors of the same regularized data,
    through each ``factor_auto`` under a zero pivot budget."""
    s = system
    plan = interop.band_plan_from_numpy(
        s["csr"], s["jplan"].perm, s["jplan"].n, 128, s["jplan"].B, s["jplan"].nblk_pad, 128)
    mp = pytest.MonkeyPatch()
    mp.setenv("LSAFW_PIVOT_MEM_GB", "0")
    try:
        jlu, jpiv = jband.factor_auto(
            s["jplan"], jnp.asarray(s["dre"].numpy()), jnp.asarray(s["dim"].numpy()),
            diag_slots=s["diag"])
        tlu, tpiv = tband.factor_auto(plan, s["dre"], s["dim"], diag_slots=s["diag"])
    finally:
        mp.undo()
    assert (jpiv, tpiv) == (False, False)
    return jlu, tlu, plan


def test_plan_geometry_matches(system):
    s = system
    jp = s["jplan"]
    own = tband.BandPlan.build(s["csr"], nb=128, chunk=128)  # the port's own native RCM
    np.testing.assert_array_equal(own.perm, jp.perm)
    plan = interop.band_plan_from_numpy(s["csr"], jp.perm, jp.n, 128, jp.B, jp.nblk_pad, 128)
    assert (plan.B, plan.nblk_pad, plan.rows_total, plan.R) == (jp.B, jp.nblk_pad, jp.rows_total, jp.R)
    for name in ("pos_row", "pos_off", "pad_row", "pad_off"):
        np.testing.assert_array_equal(getattr(plan, name), np.asarray(getattr(jp, name)), err_msg=name)
    np.testing.assert_array_equal(plan.perm_pad, np.asarray(jp.perm_pad_d))
    np.testing.assert_array_equal(plan.iperm, np.asarray(jp.iperm_d))


def test_saddle_regularization_matches(system):
    s = system
    ref = jband.regularize_saddle_data(jnp.asarray(s["dre"].numpy()), jnp.asarray(s["dim"].numpy()),
                                       s["diag"])
    got = tband.regularize_saddle_data(s["dre"], s["dim"], s["diag"])
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-15
    assert not torch.equal(got, s["dre"])  # the pressure diagonal was shifted


def test_pivot_free_factor_matches(factors):
    """The port's factor against the JAX factor in the port's stored
    layout (U blocks folded by Dinv)."""
    jlu, tlu, _ = factors
    band_ref = np.asarray(jlu.band_re) + 1j * np.asarray(jlu.band_im)
    dinv_ref = np.asarray(jlu.dinv_r) + 1j * np.asarray(jlu.dinv_i)
    band_ref = tband.fold_pivot_free(torch.from_numpy(band_ref), torch.from_numpy(dinv_ref))
    assert tlu.band.dtype == torch.complex64 and tlu.dinv.dtype == torch.complex64
    assert _rel(tlu.band.numpy(), band_ref.numpy()) <= 1e-4
    assert _rel(tlu.dinv.numpy(), dinv_ref) <= 1e-4


def test_plain_substitution_matches_jax_scan(factors):
    """K1 + K2 (plain versions, as the wrappers run them on a CPU tensor)
    on the JAX factor carried across, against ``_solve_banded``."""
    jlu, _, _ = factors
    lu = interop.banded_lu_from_numpy(
        jlu.band_re, jlu.band_im, jlu.dinv_r, jlu.dinv_i, jlu.perm, jlu.iperm,
        jlu.n, jlu.nb, jlu.B, device="cpu")
    nblk = lu.dinv.shape[0]
    rng = np.random.default_rng(5)
    br = rng.standard_normal((nblk, lu.nb)).astype(np.float32)
    bi = rng.standard_normal((nblk, lu.nb)).astype(np.float32)
    xr, xi = jband._solve_banded(jlu.band_re, jlu.band_im, jlu.dinv_r, jlu.dinv_i,
                                 jnp.asarray(br), jnp.asarray(bi), B=jlu.B, nb=jlu.nb)
    ref = np.asarray(xr) + 1j * np.asarray(xi)
    b = torch.from_numpy((br + 1j * bi).astype(np.complex64))
    before = dict(band_cuda.LAUNCHES)
    y = band_cuda.fwd_substitute(lu.band, b)
    x = band_cuda.bwd_substitute(lu.band, lu.dinv, y)
    assert band_cuda.LAUNCHES == before  # CPU tensors run the plain versions
    assert y.shape == (lu.band.shape[0], lu.nb) and x.shape == (nblk, lu.nb)
    assert _rel(x.numpy(), ref) <= 1e-5
    assert _rel(band_cuda.solve_banded(lu.band, lu.dinv, b).numpy(), ref) <= 1e-5


def test_refined_solve_matches_superlu(system, factors):
    s = system
    _, tlu, _ = factors
    op = BandedSIOp(s["A"], s["M"], tlu, SIGMA)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(s["A"].shape[0]) + 1j * rng.standard_normal(s["A"].shape[0])
    x = banded_solve_raw(op, torch.as_tensor(b), tol=1e-13, max_its=40).numpy()
    C = (s["A"].to_scipy() - SIGMA * s["M"].to_scipy()).tocsc()
    ref = spla.spsolve(C, b)
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) <= 1e-10


def plain_solve(lu, b: torch.Tensor) -> torch.Tensor:
    """``lu.solve(b)`` spelled out: b into the band's order (two real
    columns for a complex b on a real factor), the plain substitutions of
    ``band_cuda``, and back."""
    nblk = lu.perm.numel() // lu.nb
    cplx = lu.band.is_complex()
    cols = [b] if cplx or not b.is_complex() else [b.real, b.imag]

    def into(c):
        v = torch.zeros(nblk * lu.nb, dtype=c.dtype)
        v[:lu.n] = c
        return v[lu.perm.long()].to(lu.band.dtype).reshape(nblk, lu.nb)

    bp = into(cols[0]) if cplx else torch.stack([into(c) for c in cols], dim=2)
    if isinstance(lu, (tband.PivotedBandedLU, tband.RealPivotedBandedLU)):
        y = band_cuda.fwd_substitute_pivoted_plain(lu.L2, lu.L1inv, lu.perms, bp)
        x = band_cuda.bwd_substitute_pivoted_plain(lu.band, lu.Uinv, y)
    else:
        x = band_cuda.bwd_substitute_plain(lu.band, lu.dinv, band_cuda.fwd_substitute_plain(lu.band, bp))
    x = x.reshape(nblk * lu.nb, -1)[lu.iperm.long()]
    if cplx:
        return x[:, 0].to(torch.complex128)
    x = x.to(torch.float64)
    return torch.complex(x[:, 0], x[:, 1]) if b.is_complex() else x[:, 0]


def test_factor_solve_takes_the_plain_path_on_cpu(factors):
    """The pivot-free complex factor's ``solve`` on CPU tensors is the plain
    substitutions' result, bit for bit, with no kernel launch."""
    _, tlu, _ = factors
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.standard_normal(tlu.n) + 1j * rng.standard_normal(tlu.n))
    before = dict(band_cuda.LAUNCHES)
    torch.testing.assert_close(tlu.solve(b), plain_solve(tlu, b), rtol=0, atol=0)
    assert band_cuda.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take(factors):
    _, tlu, _ = factors
    b = torch.zeros((tlu.dinv.shape[0], tlu.nb), dtype=torch.complex128)
    with pytest.raises(TypeError):
        band_cuda.fwd_substitute(tlu.band, b)
    with pytest.raises(ValueError):
        band_cuda.fwd_substitute(tlu.band, b[:, :-1].to(torch.complex64))
    with pytest.raises(ValueError):
        band_cuda.bwd_substitute(tlu.band, tlu.dinv[:-1], b.to(torch.complex64))
    # the real and pivoted modes, on small factor-shaped tensors
    nblk, B, nb = 3, 2, 8
    rband = torch.zeros((nblk + B, 2 * B + 1, nb, nb))
    L2, L1inv = torch.zeros((nblk, B, nb, nb)), torch.zeros((nblk, nb, nb))
    perms = torch.arange((B + 1) * nb).repeat(nblk, 1)
    rb = torch.zeros((nblk, nb, 1))
    band_cuda.solve_pivoted(rband, L2, L1inv, L1inv, perms, rb)  # accepted as it is
    with pytest.raises(TypeError):  # a complex right-hand side on a real factor
        band_cuda.fwd_substitute(rband, rb[:, :, 0].to(torch.complex64))
    with pytest.raises(TypeError):  # f64 factors
        band_cuda.fwd_substitute_pivoted(L2.double(), L1inv.double(), perms, rb.double())
    with pytest.raises(ValueError):  # m > 2 columns
        band_cuda.fwd_substitute(rband, torch.zeros((nblk, nb, 3)))
    with pytest.raises(ValueError):
        band_cuda.solve_pivoted(rband, L2, L1inv, L1inv, perms, torch.zeros((nblk, nb, 3)))
    with pytest.raises(ValueError):  # perms of the wrong shape
        band_cuda.fwd_substitute_pivoted(L2, L1inv, perms[:, :-1], rb)
    with pytest.raises(TypeError):  # int32 perms
        band_cuda.fwd_substitute_pivoted(L2, L1inv, perms.int(), rb)
    with pytest.raises(ValueError):  # y of a pivoted solve has nblk rows
        band_cuda.bwd_substitute_pivoted(rband, L1inv, torch.zeros((nblk + B, nb, 1)))
    with pytest.raises(TypeError):  # a complex Uinv beside a real band
        band_cuda.bwd_substitute_pivoted(rband, L1inv.to(torch.complex64), rb)


# ---------------------------------------------------------------------------
# The band plan's switches, the bf16 at-rest band, nb = 256
# ---------------------------------------------------------------------------

# budget: a fraction of the complex f32 band's bytes at nb = 128
SWITCHES = {
    "nb128": dict(env={"LSAFW_BAND_NB": "128"}, want=("f32", "full")),
    "nb256": dict(env={"LSAFW_BAND_NB": "256"}, want=("f32", "full")),
    "dtype_f32": dict(env={"LSAFW_BAND_DTYPE": "f32"}, budget=0.75, want=("f32", "clipped")),
    "bf16_full": dict(budget=0.75, want=("bf16", "full")),
    "bf16_clipped": dict(budget=0.3, want=("bf16", "clipped")),
    "f32_clipped": dict(budget=0.3, force_f32=True, want=("f32", "clipped")),
    "marked": dict(budget=0.75, mark=True, want=("f32", "clipped")),
}


@pytest.fixture(scope="module")
def jax_A(system):
    """The JAX package's CSRMatrix of the port's A (one pattern object, so
    that its plan cache and bf16 marks see one pattern)."""
    return jsparse.CSRMatrix.from_scipy(system["A"].to_scipy())


@pytest.mark.parametrize("case", SWITCHES)
def test_plan_switches_match_jax(system, jax_A, case, monkeypatch):
    """``plan_for_csr`` resolves ``LSAFW_BAND_NB``, ``LSAFW_BAND_DTYPE``,
    the memory budget, ``force_f32`` and the bf16-unstable mark as the JAX
    package does: the same (nb, B, nblk_pad, band_dtype), exactly."""
    c = SWITCHES[case]
    A, jp = system["A"], system["jplan"]
    for k, v in c.get("env", {}).items():
        monkeypatch.setenv(k, v)
    kw = dict(force_f32=c.get("force_f32", False))
    if "budget" in c:
        kw["max_bytes"] = int(c["budget"] * jp.rows_total * jp.R * jp.nb * jp.nb * 8)
    if c.get("mark"):
        tband.mark_bf16_unstable(A.pattern)
        jband.mark_bf16_unstable(jax_A.pattern)
    try:
        got, ref = tband.plan_for_csr(A, **kw), jband.plan_for_csr(jax_A, **kw)
        unmarked = tband.plan_for_csr(A, **kw) if not c.get("mark") else None
    finally:
        tband._BF16_UNSTABLE.discard(A.pattern)
        jband._BF16_UNSTABLE.discard(id(jax_A.pattern))
    assert (got.nb, got.B, got.nblk_pad, got.band_dtype) == (ref.nb, ref.B, ref.nblk_pad,
                                                             ref.band_dtype)
    assert got.band_dtype == c["want"][0]
    full_B = jp.B if got.nb == 128 else tband.plan_for_csr(A, nb=got.nb).B
    assert (got.B == full_B) == (c["want"][1] == "full")
    if c.get("mark"):  # the mark forces f32; unmarked, the same budget keeps bf16
        assert tband.plan_for_csr(A, **kw).band_dtype == "bf16"
    else:
        assert unmarked is got  # cached per resolved (nb, budget, force_f32)
    if case == "nb256":
        assert got.nb == 256 and tband.plan_for_csr(A, nb=128) is not got


def test_unsupported_nb_raises_before_a_cuda_factor(system):
    """On the CPU the plain versions take any nb; on the card a plan of an
    nb the kernels were not built for raises before its band is made."""
    s = system
    plan = tband.BandPlan.build(s["csr"], nb=64, chunk=1)
    lu, pivoted = tband.factor_auto(plan, s["dre"], s["dim"], diag_slots=s["diag"])
    assert pivoted and lu.band.shape[2] == 64

    class OnTheCard:
        is_cuda = True

    with pytest.raises(ValueError, match=r"nb in \(128, 256\)"):
        tband.fill_band(plan, OnTheCard())


@pytest.fixture(scope="module", params=["complex", "real"])
def bf16_factors(request, system):
    """Both packages' pivot-free factors on a bf16 plan at full width (a
    budget between the bf16 and the f32 band), unpadded (chunk 1), of the
    same data: the shift-invert operator's, or its real part's."""
    s = system
    real = request.param == "real"
    per = 4 if real else 8
    full = jband.BandPlan.build(s["csr"], nb=128, chunk=1, real=real)
    budget = int(0.75 * full.rows_total * full.R * 128 * 128 * per)
    jplan = jband.BandPlan.build(s["csr"], nb=128, chunk=1, max_bytes=budget, real=real)
    plan = interop.band_plan_from_numpy(s["csr"], jplan.perm, jplan.n, 128, jplan.B,
                                        jplan.nblk_pad, 1, band_dtype="bf16", max_bytes=budget,
                                        real=real)
    assert jplan.band_dtype == "bf16" and jplan.B == full.B
    mp = pytest.MonkeyPatch()
    mp.setenv("LSAFW_PIVOT_MEM_GB", "0")
    try:
        data = (s["dre"],) if real else (s["dre"], s["dim"])
        jlu, jpiv = jband.factor_auto(jplan, *(jnp.asarray(d.numpy()) for d in data),
                                      diag_slots=s["diag"])
        tlu, tpiv = tband.factor_auto(plan, *data, diag_slots=s["diag"])
    finally:
        mp.undo()
    assert (jpiv, tpiv) == (False, False)
    return dict(real=real, jlu=jlu, tlu=tlu)


def _jax_bf16_band(f):
    """The JAX factor's bf16 band, as the port lays it out (complex: (..., 2)
    pairs), and its Dinv."""
    jlu = f["jlu"]
    if f["real"]:
        return interop._bf16(jlu.band, "cpu"), torch.from_numpy(np.array(jlu.dinv))
    band = torch.stack([interop._bf16(jlu.band_re, "cpu"), interop._bf16(jlu.band_im, "cpu")], -1)
    dinv = np.asarray(jlu.dinv_r) + 1j * np.asarray(jlu.dinv_i)
    return band, torch.from_numpy(dinv.astype(np.complex64))


def test_bf16_factor_matches_jax(bf16_factors):
    """The port's bf16 band, widened, against the JAX package's bf16 band
    folded in f32 (U blocks premultiplied by Dinv): rel 2e-2 in max-norm,
    as is Dinv (f32 on both sides, from f32 windows); the two round once
    per entry, but at other places (the port rounds folded blocks)."""
    f = bf16_factors
    tlu = f["tlu"]
    cplx = not f["real"]
    assert tlu.band.dtype == torch.bfloat16 and band_cuda.band_is_complex(tlu.band) == cplx
    assert tlu.dinv.dtype == (torch.complex64 if cplx else torch.float32)
    jband_, jdinv = _jax_bf16_band(f)
    B = (jband_.shape[1] - 1) // 2
    ref = band_cuda.widen(jband_, cplx).clone()
    ref[:jdinv.shape[0], B + 1:] = jdinv[:, None] @ ref[:jdinv.shape[0], B + 1:]
    assert _rel(band_cuda.widen(tlu.band, cplx).numpy(), ref.numpy()) <= 2e-2
    assert _rel(tlu.dinv.numpy(), jdinv.numpy()) <= 2e-2


def test_bf16_substitution_matches_jax(system, bf16_factors):
    """One unrefined solve of the port's bf16 factor against one of the
    JAX package's bf16 factor carried across (``interop``; both through
    the plain substitutions on the CPU): rel 1e-2 (two bf16 factors)."""
    f = bf16_factors
    jlu = f["jlu"]
    if f["real"]:
        ref_lu = interop.real_banded_lu_from_numpy(jlu.band, jlu.dinv, jlu.perm, jlu.iperm, jlu.n,
                                                   jlu.nb, jlu.B, device="cpu")
    else:
        ref_lu = interop.banded_lu_from_numpy(jlu.band_re, jlu.band_im, jlu.dinv_r, jlu.dinv_i,
                                              jlu.perm, jlu.iperm, jlu.n, jlu.nb, jlu.B,
                                              device="cpu")
    rng = np.random.default_rng(6)
    n = system["A"].shape[0]
    b = rng.standard_normal(n) if f["real"] else rng.standard_normal(n) + 1j * rng.standard_normal(n)
    before = dict(band_cuda.LAUNCHES)
    got = f["tlu"].solve(torch.as_tensor(b)).numpy()
    assert band_cuda.LAUNCHES == before
    assert _rel(got, ref_lu.solve(torch.as_tensor(b)).numpy()) <= 1e-2


def test_bf16_refined_solve_matches_superlu(system, bf16_factors):
    """GCR refinement preconditioned by the bf16 factor reaches SuperLU's
    f64 solve: 1e-10."""
    s, f = system, bf16_factors
    rng = np.random.default_rng(10)
    n = s["A"].shape[0]
    if f["real"]:
        J = tsparse.CSRMatrix(s["A"].pattern, s["dre"])
        b = rng.standard_normal(n)
        res = tnewton._banded_mr(J, f["tlu"], torch.as_tensor(b), tol=1e-13, max_its=60)
        x, C = res.x.numpy(), J.to_scipy()
    else:
        op = BandedSIOp(s["A"], s["M"], f["tlu"], SIGMA)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x = banded_solve_raw(op, torch.as_tensor(b), tol=1e-13, max_its=60).numpy()
        C = s["A"].to_scipy() - SIGMA * s["M"].to_scipy()
    ref = spla.spsolve(C.tocsc(), b)
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) <= 1e-10


def test_bf16_interop_round_trip_is_exact(bf16_factors):
    """A JAX bf16 factor carried into the port keeps its bits: the L and
    diagonal slots and the lookahead rows as they were, the U blocks as
    the bf16 rounding of Dinv times the widened JAX blocks, Dinv exact;
    and the port's band read back as numpy bfloat16 equals it."""
    f = bf16_factors
    jlu = f["jlu"]
    if f["real"]:
        lu = interop.real_banded_lu_from_numpy(jlu.band, jlu.dinv, jlu.perm, jlu.iperm, jlu.n,
                                               jlu.nb, jlu.B, device="cpu")
    else:
        lu = interop.banded_lu_from_numpy(jlu.band_re, jlu.band_im, jlu.dinv_r, jlu.dinv_i,
                                          jlu.perm, jlu.iperm, jlu.n, jlu.nb, jlu.B, device="cpu")
    band, dinv = _jax_bf16_band(f)
    cplx = not f["real"]
    B, nblk = jlu.B, dinv.shape[0]
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    assert torch.equal(lu.dinv, dinv)
    assert torch.equal(bits(lu.band[:, :B + 1]), bits(band[:, :B + 1]))
    assert torch.equal(bits(lu.band[nblk:]), bits(band[nblk:]))
    folded = band_cuda.narrow(dinv[:, None] @ band_cuda.widen(band[:nblk, B + 1:], cplx))
    assert torch.equal(bits(lu.band[:nblk, B + 1:]), bits(folded))
    back = interop.band_to_numpy(lu.band)
    assert back.dtype.name == "bfloat16" and back.shape == tuple(lu.band.shape)
    assert np.array_equal(back.view(np.int16), bits(lu.band).numpy())


@pytest.mark.parametrize("mode", ["pivot_free", "pivoted"])
def test_nb256_matches_jax(mode):
    """K1 + K2 at nb = 256 (plain versions on the CPU) on a real factor of
    the JAX package's layout carried across by ``interop``, against the
    JAX package's scan (``_solve_banded_real`` / ``_solve_pivoted_real``):
    rel 1e-5 (one f32 factor, sums in another order).  The factor is
    random and well conditioned (identity plus 2e-3 noise; the pivoted
    one with random panel permutations)."""
    rng = np.random.default_rng(256)
    nb, B, nblk = 256, 2, 5
    m = (B + 1) * nb

    def noise(*shape):
        return (2e-3 * rng.standard_normal(shape)).astype(np.float32)

    eye = np.eye(nb, dtype=np.float32)
    n = nblk * nb - 37
    perm = np.concatenate([rng.permutation(n), np.arange(n, nblk * nb)]).astype(np.int32)
    iperm = np.argsort(perm)[:n].astype(np.int32)
    b = rng.standard_normal((nblk, nb, 1)).astype(np.float32)
    if mode == "pivot_free":
        band, dinv = noise(nblk + B, 2 * B + 1, nb, nb), noise(nblk, nb, nb) + eye
        ref = jband._solve_banded_real(jnp.asarray(band), jnp.asarray(dinv), jnp.asarray(b), B=B,
                                       nb=nb)
        lu = interop.real_banded_lu_from_numpy(band, dinv, perm, iperm, n, nb, B, device="cpu")
        x = band_cuda.solve_banded(lu.band, lu.dinv, torch.from_numpy(b))
    else:
        band, L2 = noise(nblk + B, 2 * B + 1, nb, nb), noise(nblk, B, nb, nb)
        L1inv, Uinv = noise(nblk, nb, nb) + eye, noise(nblk, nb, nb) + eye
        perms = np.stack([rng.permutation(m) for _ in range(nblk)])
        ref = jband._solve_pivoted_real(*(jnp.asarray(a) for a in (band, L2, L1inv, Uinv, perms, b)),
                                        B=B, nb=nb)
        lu = interop.real_pivoted_lu_from_numpy(band, L2, L1inv, Uinv, perms, perm, iperm, n, nb,
                                                B, device="cpu")
        x = band_cuda.solve_pivoted(lu.band, lu.L2, lu.L1inv, lu.Uinv, lu.perms, torch.from_numpy(b))
    assert lu.nb == 256 and x.shape == (nblk, nb, 1)
    assert _rel(x.numpy(), np.asarray(ref)) <= 1e-5
