"""Parity of the port's band plan, pivot-free band factor and band
substitution with the JAX package, on the shift-invert operator
C = A - sigma M of a small cylinder.

Tolerances: the plan is integer geometry (exact); the factor is f32 on
both sides with a different inversion route (native complex inverse vs
the 2nb real embedding) and summation order (rel 1e-4 in max-norm); the
substitution of one factor in f32 (rel 1e-5); the refined solve is f64
(1e-10 against SuperLU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.solver import band as jband
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import band_cuda
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
