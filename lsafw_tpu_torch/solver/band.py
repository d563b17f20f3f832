"""Blocked band LU on the device: pivoted and pivot-free, complex and real.

Design:
  * RCM-permute the operator (host, once per sparsity pattern, through
    the native ordering) so it is banded with half bandwidth ``b``; view
    it as block-banded with ``nb x nb`` blocks and block half-bandwidth
    ``B = ceil(b / nb)``.
  * The band is filled on the device by scattering CSR data through a
    precomputed :class:`BandPlan`, into a (rows_total, 2B+1, nb, nb)
    tensor (complex64, or float32 for a real operator); slot r of block
    row K holds block (K, K + r - B).  The plan's switches
    (:func:`plan_for_csr`): block size ``LSAFW_BAND_NB`` (default 128;
    the card's kernels take 128 and 256), the band's memory budget
    ``LSAFW_BAND_MEM_GB`` (default 12), over which the band is stored in
    bf16 and then clipped, and ``LSAFW_BAND_DTYPE=f32`` (or a pattern
    marked :func:`mark_bf16_unstable`), which clips it in f32 instead.
  * :class:`PivotedBandedLU` / :class:`RealPivotedBandedLU` (the default
    of :func:`factor_auto` whenever their memory fits): per block row,
    an LU with partial pivoting of the (B+1)·nb x nb panel of block
    column K, then the composed row permutation applied to the trailing
    2B block columns and their Schur update.  U widens to 2B upper
    blocks inside the same band; L2 panels, the L1 and U diagonal-block
    inverses and the permutations are stored beside it.
  * :class:`BandedLU` / :class:`RealBandedLU` (over the pivot budget):
    pivot-free elimination in place in the band, with saddle
    regularization of the zero pressure diagonals.  LU of a banded
    matrix without cross-block pivoting fills only inside the band.  On
    a bf16 plan the band is stored in bf16 ((..., 2) (re, im) pairs for
    a complex band): the elimination runs in an f32 window of the B + 1
    live block rows, and each row is rounded to bf16 once, when it
    retires (the reference's ``_factor_chunk``); Dinv stays f32.  The
    pivoted factors are always stored in f32, as the reference's.
  * Stored folded (:func:`fold_pivoted`, :func:`fold_pivot_free`): each
    off-diagonal U block is kept premultiplied by its row's diagonal
    inverse (U^-1 U_j, D^-1 U_j) and each L2 panel postmultiplied by
    L1^-1, so that a substitution step is one product per block on the
    solution's critical path (``band_cuda``'s head comment).
  * Every factor computes in f32/complex64 (a bf16 band only stores
    its result): it preconditions an f64 iterative refinement
    (mixed-precision direct-iterative solve).  Every factor's
    substitution runs through the CUDA kernels K1/K2 of
    :mod:`lsafw_tpu_torch.solver.band_cuda` (pivot-free or pivoted mode,
    complex64 or float32) on the card, and through their plain torch
    loops on the CPU.  Vectors enter and leave the band's order through
    G's permute-in and permute-out (:mod:`lsafw_tpu_torch.ops.spmv_cuda`),
    one launch each way.

Pivot rule: the panel LU is ``torch.linalg.lu_factor_ex`` (LAPACK on the
host, cuSOLVER on the card).  For complex panels LAPACK and cuSOLVER
pick the pivot of largest |re| + |im| (icamax); the reference picks
largest |z|^2.  So complex pivots, and with them the complex factor's
arrays, may differ from the reference's; the factor is held to the
reference at the level of its solves.  For real panels both pick
largest |x|.
"""

from __future__ import annotations

import os
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.ops.native import rcm_native
from lsafw_tpu_torch.ops.sparse import CSRMatrix, SparsityPattern, pattern_csr, per_pattern
from lsafw_tpu_torch.solver import band_cuda
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def rcm_permutation(pattern_csr: sp.spmatrix) -> np.ndarray:
    """Symmetric reverse-Cuthill-McKee ordering (native C++ sweep)."""
    g = pattern_csr.tocsr()
    return rcm_native(g.indptr, g.indices, g.shape[0])


@dataclass(eq=False)
class BandPlan:
    """Host-built static geometry of the band for one sparsity pattern.

    ``pos_row``/``pos_off`` place each CSR entry (in the CSR's own
    order) at block row ``pos_row`` and flat offset ``pos_off`` inside
    the (R, nb, nb) row; entries outside a budget-clipped band carry
    ``pos_row = rows_total`` and are dropped at fill time.  ``real``: the
    plan was sized for one real band (no imaginary channel)."""

    n: int
    nb: int
    B: int
    nblk_pad: int
    chunk: int
    band_dtype: str  # "f32" | "bf16": the pivot-free factors' at-rest storage
    real: bool
    perm: np.ndarray  # (n,) permuted index -> original
    pos_row: np.ndarray  # (nnz,) band block row of each CSR entry
    pos_off: np.ndarray  # (nnz,) offset within the block row
    pad_row: np.ndarray  # identity-padding positions
    pad_off: np.ndarray
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def R(self) -> int:
        return 2 * self.B + 1

    @property
    def rows_total(self) -> int:
        return self.nblk_pad + self.B

    @property
    def perm_pad(self) -> np.ndarray:
        """(nblk_pad * nb,) padded permuted index -> original (padding maps
        to itself)."""
        return np.concatenate([self.perm, np.arange(self.n, self.nblk_pad * self.nb)])

    @property
    def iperm(self) -> np.ndarray:
        iperm = np.empty(self.n, dtype=np.int64)
        iperm[self.perm] = np.arange(self.n)
        return iperm

    def on(self, device) -> dict[str, torch.Tensor]:
        """Device index tensors of the plan (cached per device): flat band
        positions of the kept CSR entries and of the identity padding, and
        the int32 permutations G's permute-in and permute-out take."""
        key = str(torch.device(device))
        hit = self._device.get(key)
        if hit is None:
            row_len = self.R * self.nb * self.nb
            keep = np.flatnonzero(self.pos_row < self.rows_total)

            def t(a, dtype=np.int64):
                return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

            hit = dict(
                keep=t(keep),
                flat=t(self.pos_row[keep].astype(np.int64) * row_len + self.pos_off[keep]),
                pad=t(self.pad_row.astype(np.int64) * row_len + self.pad_off),
                perm_pad=t(self.perm_pad, np.int32), iperm=t(self.iperm, np.int32),
            )
            self._device[key] = hit
        return hit

    @classmethod
    def build(
        cls,
        csr: sp.spmatrix,
        *,
        nb: int = 128,
        chunk: int = 128,
        perm: np.ndarray | None = None,
        max_bytes: int | None = None,
        real: bool = False,
        force_f32: bool = False,
    ) -> "BandPlan":
        """Plan the band of the (pattern of) ``csr``; data values are
        ignored.  ``max_bytes`` is the budget of the band (4 bytes per
        entry for a real plan, 8 for a complex one).  Over it the plan
        first asks for bf16 storage (2 or 4 bytes), and where even that
        does not fit, clips B; ``force_f32`` clips B at f32 storage
        instead.  Entries outside a clipped band are dropped: the factor
        then preconditions the band-truncated operator."""
        t0 = time.time()
        csr = csr.tocsr()
        n = csr.shape[0]
        if perm is None:
            pat = sp.csr_matrix(
                (np.ones(csr.nnz, np.int8), csr.indices, csr.indptr), shape=csr.shape
            )
            perm = rcm_permutation(pat + pat.T)
        perm = np.asarray(perm, dtype=np.int64)
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)

        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
        pi = iperm[rows]
        pj = iperm[csr.indices.astype(np.int64)]
        bw = int(np.abs(pi - pj).max()) if len(pi) else 0
        B = max(1, -(-bw // nb))
        nblk = -(-n // nb)
        nblk_pad = -(-nblk // chunk) * chunk
        band_dtype = "f32"
        if max_bytes is not None:
            f32_b, bf16_b = (4, 2) if real else (8, 4)

            def _bytes(B_, per_entry):
                return (nblk_pad + B_) * (2 * B_ + 1) * nb * nb * per_entry

            if force_f32:
                while B > 1 and _bytes(B, f32_b) > max_bytes:
                    B -= 1
            elif _bytes(B, f32_b) > max_bytes:
                band_dtype = "bf16"
                while B > 1 and _bytes(B, bf16_b) > max_bytes:
                    B -= 1
        I = pi // nb
        d_blk = pj // nb - I
        off = (d_blk + B) * (nb * nb) + (pi % nb) * nb + (pj % nb)
        out = np.abs(d_blk) > B
        dropped = int(out.sum())
        if dropped:
            I = np.where(out, nblk_pad + B, I)
            off = np.where(out, 0, off)
        pad = np.arange(n, (nblk_pad + B) * nb, dtype=np.int64)
        logger.info(
            "BandPlan: n=%d bandwidth=%d B=%d nblk=%d (%sband %.2f GB %s, %.1fs plan%s)",
            n, bw, B, nblk, "real " if real else "",
            (nblk_pad + B) * (2 * B + 1) * nb * nb * (4 if real else 8)
            / (2 if band_dtype == "bf16" else 1) / 1e9, band_dtype, time.time() - t0,
            f"; {dropped} entries outside the band dropped" if dropped else "",
        )
        return cls(
            n=n, nb=nb, B=B, nblk_pad=nblk_pad, chunk=chunk, band_dtype=band_dtype, real=real,
            perm=perm, pos_row=I, pos_off=off,
            pad_row=pad // nb, pad_off=B * nb * nb + (pad % nb) * nb + (pad % nb),
        )


def pattern_permutation(pattern: SparsityPattern) -> np.ndarray:
    """RCM ordering of a pattern (symmetrized), computed once per pattern:
    the band plans and the permuted CSR of :mod:`lsafw_tpu_torch.ops.bcsr`
    share it."""
    def build():
        pat = pattern_csr(pattern)
        return rcm_permutation(pat + pat.T)

    return per_pattern(pattern, ("rcm",), build)


def band_mem_budget() -> int:
    """Device-memory budget of the band (bytes): env ``LSAFW_BAND_MEM_GB``,
    default 12."""
    return int(float(os.environ.get("LSAFW_BAND_MEM_GB", "12")) * 1e9)


# Patterns whose bf16 full-width factor failed (a stalled or non-finite
# refinement) in this process: their later plans take the f32 rung at
# once instead of paying for a failed bf16 factor per Newton step.
_BF16_UNSTABLE: weakref.WeakSet = weakref.WeakSet()


def mark_bf16_unstable(pattern: SparsityPattern) -> None:
    _BF16_UNSTABLE.add(pattern)


def bf16_unstable(pattern: SparsityPattern) -> bool:
    return pattern in _BF16_UNSTABLE


def plan_for_csr(A: CSRMatrix, *, nb: int | None = None, chunk: int = 128,
                 max_bytes: int | None = None, real: bool = False,
                 force_f32: bool = False) -> BandPlan:
    """:class:`BandPlan` of a CSRMatrix's pattern, cached per (pattern,
    nb, chunk, budget, real, force_f32) as resolved from the switches:
    ``nb`` defaults to ``LSAFW_BAND_NB`` (128; a larger nb takes fewer,
    larger substitution steps), ``max_bytes`` to :func:`band_mem_budget`,
    and ``LSAFW_BAND_DTYPE=f32`` or a pattern marked
    :func:`mark_bf16_unstable` force ``force_f32`` (the budget clips B at
    f32 storage instead of asking for bf16)."""
    if nb is None:
        nb = int(os.environ.get("LSAFW_BAND_NB", "128"))
    if os.environ.get("LSAFW_BAND_DTYPE", "").lower() == "f32" or bf16_unstable(A.pattern):
        force_f32 = True
    if max_bytes is None:
        max_bytes = band_mem_budget()
    pat = A.pattern
    return per_pattern(pat, ("band", nb, chunk, max_bytes, real, force_f32), lambda: BandPlan.build(
        pattern_csr(pat), nb=nb, chunk=chunk, perm=pattern_permutation(pat), max_bytes=max_bytes,
        real=real, force_f32=force_f32))


def regularize_saddle_data(dre: torch.Tensor, dim_: torch.Tensor | None, diag_slots,
                           *, gamma: float = 1e-3) -> torch.Tensor:
    """Add ``-gamma * diag_scale`` to numerically-zero diagonal entries
    (the pressure block of saddle-point operators) before a pivot-free
    factorization; returns the adjusted real data."""
    diag_slots = torch.as_tensor(diag_slots, device=dre.device)
    dmag = dre[diag_slots].abs()
    if dim_ is not None:
        dmag = dmag + dim_[diag_slots].abs()
    scale = dmag.mean()
    shift = torch.where(dmag < 1e-10 * scale, -gamma * scale, torch.zeros_like(dmag))
    return dre.index_add(0, diag_slots, shift)


def fill_band(plan: BandPlan, data: torch.Tensor, *, bf16: bool | None = None) -> torch.Tensor:
    """Scatter CSR data into a fresh band on the data's device, with
    identity on the padding diagonal: complex64 for complex data, float32
    for real data, or (``bf16``, default: the plan's storage) bf16, the
    complex band as (..., 2) (re, im) pairs, each value rounded once from
    the data.  On the card the plan's nb must be one the kernels take."""
    if data.is_cuda:
        band_cuda.check_nb(plan.nb)
    if bf16 is None:
        bf16 = plan.band_dtype == "bf16"
    ix = plan.on(data.device)
    cplx = data.is_complex()
    shape = (plan.rows_total, plan.R, plan.nb, plan.nb)
    vals = data[ix["keep"]]
    if bf16:
        band = torch.zeros(shape + ((2,) if cplx else ()), dtype=torch.bfloat16,
                           device=data.device)
        flat = band.view(-1, 2) if cplx else band.view(-1, 1)
        flat[ix["flat"], 0] = vals.real.to(torch.bfloat16)
        if cplx:
            flat[ix["flat"], 1] = vals.imag.to(torch.bfloat16)
        flat[ix["pad"], 0] = 1.0
        return band
    dtype = torch.complex64 if cplx else torch.float32
    band = torch.zeros(shape, dtype=dtype, device=data.device)
    flat = band.view(-1)
    flat[ix["flat"]] = vals.to(dtype)
    flat[ix["pad"]] = 1.0
    return band


def _complex_data(data_re: torch.Tensor, data_im: torch.Tensor | None) -> torch.Tensor:
    if data_im is None:
        return data_re.to(torch.complex128)
    return torch.complex(data_re.to(torch.float64), data_im.to(torch.float64))


def _ridge_scale(D: torch.Tensor) -> torch.Tensor:
    """Mean |Re| of a diagonal block's diagonal: the unit of ``delta``."""
    return D.diagonal().real.abs().mean() + 1e-30


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# The calling contract of every factor
# ---------------------------------------------------------------------------


class _PermutedSolve:
    """The calling contract every factor shares (``banded_solve_raw`` and
    ``_banded_mr`` take any of them): ``solve(b)``, alias ``solve_vec``,
    returns x ~= C^-1 b in the original order for an f64 or complex128
    vector.  G's permute-in carries b into the band's order in the
    factor's dtype ((nblk, nb) complex64, or (nblk, nb, m) float32: a
    complex b on a real factor as two real columns in one band pass, a
    real b on a complex factor with a zero imaginary part),
    ``_substitute`` runs on its blocks, and G's permute-out carries the
    result back in b's dtype: one launch each way."""

    def _substitute(self, bp: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        bp = spmv_cuda.permute_in(b, self.perm, self.nb, band_cuda.compute_dtype(self.band))
        return spmv_cuda.permute_out(self._substitute(bp), self.iperm, b.dtype)

    def solve_vec(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)


# ---------------------------------------------------------------------------
# Pivot-free factor (complex BandedLU with K1/K2, and RealBandedLU)
# ---------------------------------------------------------------------------


def factor_band(band: torch.Tensor, nblk_pad: int, *, delta: float = 0.0) -> torch.Tensor:
    """Pivot-free blocked LU of a filled band (complex or real), in place,
    its U blocks stored folded (:func:`fold_pivot_free`); returns the
    (nblk_pad, nb, nb) inverse diagonal blocks.  ``delta`` is a ridge
    relative to the mean |Re| of each diagonal block's diagonal.

    A bf16 band is eliminated in ``work``, an f32 window of the B + 1
    block rows K..K+B that step K reads and updates (row J in slot
    J mod (B+1)): row K + B + 1 is widened into it as row K retires,
    rounded to bf16 once.  An f32 band is its own window."""
    rows_total, R, nb = band.shape[:3]
    B = (R - 1) // 2
    dev = band.device
    cplx = band_cuda.band_is_complex(band)
    dtype = band_cuda.compute_dtype(band)
    ring = B + 1 if band.dtype == torch.bfloat16 else None
    if ring:
        work = torch.zeros((ring, R, nb, nb), dtype=dtype, device=dev)
        for J in range(min(ring, rows_total)):
            work[J] = band_cuda.widen(band[J], cplx)
    else:
        work = band
    dinv = torch.empty((nblk_pad, nb, nb), dtype=dtype, device=dev)
    i = torch.arange(1, B + 1, device=dev)
    rows = i[:, None].expand(B, B)  # block (K+i, K+j) sits at row K+i,
    slots = B + i[None, :] - i[:, None]  # slot B + j - i
    eye = torch.eye(nb, dtype=dtype, device=dev)
    for K in range(nblk_pad):
        k, ki = (K % ring, (K + i) % ring) if ring else (K, K + i)
        D = work[k, B]
        if delta:
            D = D + (delta * _ridge_scale(D)) * eye
        X, _ = torch.linalg.inv_ex(D)
        dinv[K] = X
        L = work[ki, B - i] @ X  # (B, nb, nb): L_i = E_i D^-1
        U = work[k, B + 1:]  # (B, nb, nb)
        r = (rows + K) % ring if ring else rows + K
        work[r, slots] = work[r, slots] - L[:, None] @ U[None, :]
        work[ki, B - i] = L
        work[k, B + 1:] = X @ U  # folded: D^-1 U
        if ring:  # row K retires; row K + B + 1 takes its slot
            band[K] = band_cuda.narrow(work[k])
            if K + ring < rows_total:
                work[k] = band_cuda.widen(band[K + ring], cplx)
    if ring:
        for J in range(nblk_pad, rows_total):
            band[J] = band_cuda.narrow(work[J % ring])
    return dinv


def fold_pivot_free(band: torch.Tensor, dinv: torch.Tensor) -> torch.Tensor:
    """A pivot-free factor's band in the stored (folded) layout: the U
    blocks of each row K < nblk premultiplied by Dinv_K, so that
    x_K = Dinv_K y_K - sum_t (Dinv_K U_Kt) x_{K+1+t}.  ``factor_band``
    folds as it goes; this carries an unfolded band across (a copy; a
    bf16 band's products are widened, then rounded once)."""
    B, nblk = (band.shape[1] - 1) // 2, dinv.shape[0]
    out = band.clone()
    U = dinv[:, None] @ band_cuda.widen(band[:nblk, B + 1:], band_cuda.band_is_complex(band))
    out[:nblk, B + 1:] = band_cuda.narrow(U) if band.dtype == torch.bfloat16 else U
    return out


def fold_pivoted(band: torch.Tensor, L2: torch.Tensor, L1inv: torch.Tensor,
                 Uinv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A pivoted factor's (band, L2) in the stored (folded) layout: the 2B
    U blocks of each row K < nblk premultiplied by Uinv_K, and L2_K
    postmultiplied by L1inv_K, so that the forward window update is
    f[nb:] - (L2 L1^-1) f[:nb] and x_K = Uinv_K y_K - sum_j (Uinv_K U_Kj)
    x_{K+j}.  ``_pfactor`` folds as it goes; this carries unfolded
    factors across (copies)."""
    nblk = L2.shape[0]
    out = band.clone()
    out[:nblk, 1:] = Uinv[:, None] @ band[:nblk, 1:]
    return out, L2 @ L1inv[:, None]


@dataclass(eq=False)
class BandedLU(_PermutedSolve):
    """Factored pivot-free complex band on a device; :meth:`solve`
    applies C^-1 through the K1/K2 substitution kernels."""

    band: torch.Tensor  # (nblk_pad + B, 2B+1, nb, nb) complex64, or bf16 (..., 2); factored, U folded
    dinv: torch.Tensor  # (nblk_pad, nb, nb) complex64
    perm: torch.Tensor  # (nblk_pad * nb,) int32: padded permuted index -> original
    iperm: torch.Tensor  # (n,) int32: original -> permuted position
    n: int
    nb: int
    B: int

    @classmethod
    def factor(cls, plan: BandPlan, data_re: torch.Tensor, data_im: torch.Tensor | None = None,
               *, delta: float = 0.0) -> "BandedLU":
        """Fill the band from CSR data (the plan's CSR order) and factor it."""
        t0 = time.time()
        band = fill_band(plan, _complex_data(data_re, data_im))
        dinv = factor_band(band, plan.nblk_pad, delta=delta)
        _sync(band)
        logger.info("BandedLU: factored n=%d B=%d nb=%d (%s band) in %.2f s", plan.n, plan.B,
                    plan.nb, plan.band_dtype, time.time() - t0)
        ix = plan.on(band.device)
        return cls(band, dinv, ix["perm_pad"], ix["iperm"], plan.n, plan.nb, plan.B)

    def _substitute(self, bp: torch.Tensor) -> torch.Tensor:
        return band_cuda.solve_banded(self.band, self.dinv, bp)


@dataclass(eq=False)
class RealBandedLU(_PermutedSolve):
    """Pivot-free factor of a real operator: one f32 band (half the memory
    of the complex band); its substitution runs K1/K2 in float32."""

    band: torch.Tensor  # (nblk_pad + B, 2B+1, nb, nb) float32 or bf16, factored (U folded)
    dinv: torch.Tensor  # (nblk_pad, nb, nb) float32
    perm: torch.Tensor  # (nblk_pad * nb,) int32
    iperm: torch.Tensor  # (n,) int32
    n: int
    nb: int
    B: int

    @classmethod
    def factor(cls, plan: BandPlan, data_re: torch.Tensor, *, delta: float = 0.0) -> "RealBandedLU":
        t0 = time.time()
        band = fill_band(plan, data_re.to(torch.float64))
        dinv = factor_band(band, plan.nblk_pad, delta=delta)
        _sync(band)
        logger.info("RealBandedLU: factored n=%d B=%d nb=%d (%s band) in %.2f s", plan.n,
                    plan.B, plan.nb, plan.band_dtype, time.time() - t0)
        ix = plan.on(band.device)
        return cls(band, dinv, ix["perm_pad"], ix["iperm"], plan.n, plan.nb, plan.B)

    def _substitute(self, bp: torch.Tensor) -> torch.Tensor:
        return band_cuda.solve_banded(self.band, self.dinv, bp)


# ---------------------------------------------------------------------------
# Panel-pivoted factor (PivotedBandedLU, RealPivotedBandedLU)
# ---------------------------------------------------------------------------


def _wide(rows: torch.Tensor) -> torch.Tensor:
    """(c, nb, nb) blocks of one block row -> the (nb, c * nb) matrix."""
    return rows.permute(1, 0, 2).reshape(rows.shape[1], -1)


@contextmanager
def _panel_lu_library(device: torch.device):
    """Run the panel LUs on cuSOLVER on a card.  For one (B+1)·nb x nb
    panel PyTorch's default choice launches a batched column-by-column
    kernel chain, about ten times slower than cuSOLVER's getrf
    (``chip_smoke.py`` phase 4 times both); the setting is restored
    afterwards."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _pfactor(band: torch.Tensor, nblk_pad: int, delta: float):
    """Panel-pivoted blocked LU of a filled band (complex or real), in
    place: band row K becomes the U row of block row K over block columns
    K..K+2B.  Returns (L2, L1inv, Uinv, perms), stored folded: L2 L1^-1
    and, in band slots 1..2B, U^-1 U_j (:func:`fold_pivoted`).

    The window ``W`` holds block rows K..K+B over block columns K..K+2B
    as one ((B+1)·nb, (2B+1)·nb) matrix.  Step K takes the fresh band row
    K+B into its last block row, factors the panel W[:, :nb] with partial
    pivoting (P^T panel = L U, so row i of L U is panel row perm[i]),
    forms U's off-diagonal blocks T0 = L1^-1 T[:nb] and the Schur update
    T[nb:] - L2 T0 of the row-permuted trailing columns T, and shifts the
    updated rows up as the next window."""
    rows_total, R, nb, _ = band.shape
    B = (R - 1) // 2
    m = (B + 1) * nb
    dev, dt = band.device, band.dtype
    W = torch.zeros((m, R * nb), dtype=dt, device=dev)
    for i in range(min(B, nblk_pad)):  # rows 0..B-1 anchored at K = 0
        W[i * nb:(i + 1) * nb, :(B + i + 1) * nb] = _wide(band[i, B - i:])
    L2 = torch.empty((nblk_pad, B, nb, nb), dtype=dt, device=dev)
    L1inv = torch.empty((nblk_pad, nb, nb), dtype=dt, device=dev)
    Uinv = torch.empty_like(L1inv)
    perms = torch.empty((nblk_pad, m), dtype=torch.int64, device=dev)
    eye = torch.eye(nb, dtype=dt, device=dev)
    shape_only = torch.empty((m, nb), dtype=torch.float32, device=dev)  # P in a real dtype
    with _panel_lu_library(dev):
        for K in range(nblk_pad):
            W[B * nb:] = _wide(band[K + B])
            LU, piv, _ = torch.linalg.lu_factor_ex(W[:, :nb])
            P, _, _ = torch.lu_unpack(shape_only, piv, unpack_data=False)
            perm = P.argmax(0)
            perms[K] = perm
            Up = torch.triu(LU[:nb])
            L1inv[K] = torch.linalg.solve_triangular(LU[:nb], eye, upper=False, unitriangular=True)
            D = Up + (delta * _ridge_scale(Up)) * eye if delta else Up
            Uinv[K] = torch.linalg.solve_triangular(D, eye, upper=True)
            T = W[:, nb:].index_select(0, perm)
            T0 = L1inv[K] @ T[:nb]
            Tl = torch.addmm(T[nb:], LU[nb:], T0, alpha=-1)
            L2[K] = (LU[nb:] @ L1inv[K]).view(B, nb, nb)  # folded: L2 L1^-1
            band[K, 0] = Up
            band[K, 1:] = Uinv[K] @ T0.view(nb, 2 * B, nb).transpose(0, 1)  # folded: U^-1 U_j
            W[:B * nb, :2 * B * nb] = Tl
            W[:B * nb, 2 * B * nb:] = 0
    return L2, L1inv, Uinv, perms


@dataclass(eq=False)
class PivotedBandedLU(_PermutedSolve):
    """Panel-pivoted complex band factor (the robust device direct
    solver, :func:`factor_auto`'s default): no saddle regularization, so
    its contraction is that of an f32 LU."""

    band: torch.Tensor  # (nblk_pad + B, 2B+1, nb, nb) complex64: U_KK, then U^-1 U_Kj
    L2: torch.Tensor  # (nblk_pad, B, nb, nb) complex64: L2 L1^-1
    L1inv: torch.Tensor  # (nblk_pad, nb, nb) complex64
    Uinv: torch.Tensor  # (nblk_pad, nb, nb) complex64
    perms: torch.Tensor  # (nblk_pad, (B+1)*nb) int64
    perm: torch.Tensor  # (nblk_pad * nb,) int32
    iperm: torch.Tensor  # (n,) int32
    n: int
    nb: int
    B: int

    @classmethod
    def factor(cls, plan: BandPlan, data_re: torch.Tensor, data_im: torch.Tensor | None = None,
               *, delta: float = 0.0) -> "PivotedBandedLU":
        """Fill the band from CSR data and factor it with panel pivoting."""
        t0 = time.time()
        band = fill_band(plan, _complex_data(data_re, data_im), bf16=False)
        L2, L1inv, Uinv, perms = _pfactor(band, plan.nblk_pad, delta)
        _sync(band)
        logger.info("PivotedBandedLU: factored n=%d B=%d in %.2f s", plan.n, plan.B,
                    time.time() - t0)
        ix = plan.on(band.device)
        return cls(band, L2, L1inv, Uinv, perms, ix["perm_pad"], ix["iperm"],
                   plan.n, plan.nb, plan.B)

    def _substitute(self, bp: torch.Tensor) -> torch.Tensor:
        return band_cuda.solve_pivoted(self.band, self.L2, self.L1inv, self.Uinv, self.perms, bp)


@dataclass(eq=False)
class RealPivotedBandedLU(_PermutedSolve):
    """Real panel-pivoted factor (Newton Jacobians, Stokes): f32 band,
    half the memory of the complex one."""

    band: torch.Tensor  # (nblk_pad + B, 2B+1, nb, nb) float32: U_KK, then U^-1 U_Kj
    L2: torch.Tensor  # (nblk_pad, B, nb, nb) float32: L2 L1^-1
    L1inv: torch.Tensor  # (nblk_pad, nb, nb) float32
    Uinv: torch.Tensor  # (nblk_pad, nb, nb) float32
    perms: torch.Tensor  # (nblk_pad, (B+1)*nb) int64
    perm: torch.Tensor  # (nblk_pad * nb,) int32
    iperm: torch.Tensor  # (n,) int32
    n: int
    nb: int
    B: int

    @classmethod
    def factor(cls, plan: BandPlan, data_re: torch.Tensor, *,
               delta: float = 0.0) -> "RealPivotedBandedLU":
        t0 = time.time()
        band = fill_band(plan, data_re.to(torch.float64), bf16=False)
        L2, L1inv, Uinv, perms = _pfactor(band, plan.nblk_pad, delta)
        _sync(band)
        logger.info("RealPivotedBandedLU: factored n=%d B=%d in %.2f s", plan.n, plan.B,
                    time.time() - t0)
        ix = plan.on(band.device)
        return cls(band, L2, L1inv, Uinv, perms, ix["perm_pad"], ix["iperm"],
                   plan.n, plan.nb, plan.B)

    def _substitute(self, bp: torch.Tensor) -> torch.Tensor:
        return band_cuda.solve_pivoted(self.band, self.L2, self.L1inv, self.Uinv, self.perms, bp)


def pivoted_extra_bytes(plan: BandPlan) -> int:
    """Device bytes the pivoted factor needs beyond the band: the L2
    panels, the two block inverses and the permutations, counted as the
    reference counts them (one channel for a real plan, two otherwise)."""
    nb, B = plan.nb, plan.B
    chan = 1 if plan.real else 2
    per_row = (B * nb * nb + 2 * nb * nb) * chan * 4 + (B + 1) * nb * 4
    return plan.nblk_pad * per_row


def factor_auto(plan: BandPlan, data_re: torch.Tensor, data_im: torch.Tensor | None = None,
                *, diag_slots=None, delta: float = 0.0):
    """Factor with the pivoted elimination when the band plus its extra
    memory fits ``LSAFW_PIVOT_MEM_GB`` (default 8), else pivot-free with
    saddle regularization of the zero diagonals.  Returns ``(lu,
    pivoted)``.  A ``real`` plan takes the real factors and refuses
    complex data."""
    budget = float(os.environ.get("LSAFW_PIVOT_MEM_GB", "8")) * 1e9
    if plan.real:
        if data_im is not None:
            raise ValueError("real band plan cannot factor complex data")
        band_bytes = plan.rows_total * plan.R * plan.nb * plan.nb * 4
        if band_bytes + pivoted_extra_bytes(plan) <= budget:
            return RealPivotedBandedLU.factor(plan, data_re, delta=delta), True
        if diag_slots is not None:
            data_re = regularize_saddle_data(data_re, None, diag_slots)
        return RealBandedLU.factor(plan, data_re, delta=delta), False
    band_bytes = plan.rows_total * plan.R * plan.nb * plan.nb * 8
    if band_bytes + pivoted_extra_bytes(plan) <= budget:
        return PivotedBandedLU.factor(plan, data_re, data_im, delta=delta), True
    if diag_slots is not None:
        data_re = regularize_saddle_data(data_re, data_im, diag_slots)
    return BandedLU.factor(plan, data_re, data_im, delta=delta), False
