"""Blocked band LU of a complex operator on the device, pivot-free.

Design:
  * RCM-permute the operator (host, once per sparsity pattern, through
    the native ordering) so it is banded with half bandwidth ``b``; view
    it as block-banded with ``nb x nb`` blocks and block half-bandwidth
    ``B = ceil(b / nb)``.
  * The band is filled on the device by scattering CSR data through a
    precomputed :class:`BandPlan`, into a (rows_total, 2B+1, nb, nb)
    complex64 tensor; slot r of block row K holds block (K, K + r - B).
  * Right-looking blocked LU without cross-block pivoting, in place in
    the band: a Python loop over block rows, each step one nb x nb
    complex inverse of the diagonal block, the L = E D^-1 panel and the
    B x B Schur update as one batched matmul.  LU of a banded matrix
    without cross-block pivoting fills only inside the band.
  * The factor is complex64: it preconditions f64 iterative refinement
    (mixed-precision direct-iterative solve).  Its substitution runs
    through the CUDA kernels of :mod:`lsafw_tpu_torch.solver.band_cuda`.

The pivoted factor of the reference package is not ported yet, so
:func:`factor_auto` always takes the pivot-free branch (with saddle
regularization), the branch the reference takes when the pivoted
factor's extra memory is over budget.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.ops.native import rcm_native
from lsafw_tpu_torch.ops.sparse import CSRMatrix
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
    ``pos_row = rows_total`` and are dropped at fill time."""

    n: int
    nb: int
    B: int
    nblk_pad: int
    chunk: int
    band_dtype: str  # "f32" | "bf16" (bf16 at-rest storage is not ported)
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
        positions of the kept CSR entries and of the identity padding."""
        key = str(torch.device(device))
        hit = self._device.get(key)
        if hit is None:
            row_len = self.R * self.nb * self.nb
            keep = np.flatnonzero(self.pos_row < self.rows_total)

            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

            hit = dict(
                keep=t(keep),
                flat=t(self.pos_row[keep].astype(np.int64) * row_len + self.pos_off[keep]),
                pad=t(self.pad_row.astype(np.int64) * row_len + self.pad_off),
                perm_pad=t(self.perm_pad), iperm=t(self.iperm),
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
    ) -> "BandPlan":
        """Plan the band of the (pattern of) ``csr``; data values are
        ignored.  ``max_bytes`` is the budget of the complex band: over
        it the plan first asks for bf16 storage, then clips B (entries
        outside the clipped band are dropped; the factor is then a
        preconditioner of the band-truncated operator)."""
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
            def _bytes(B_, per_entry):
                return (nblk_pad + B_) * (2 * B_ + 1) * nb * nb * per_entry

            if _bytes(B, 8) > max_bytes:
                band_dtype = "bf16"
                while B > 1 and _bytes(B, 4) > max_bytes:
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
            "BandPlan: n=%d bandwidth=%d B=%d nblk=%d (band %.2f GB %s, %.1fs plan%s)",
            n, bw, B, nblk, (nblk_pad + B) * (2 * B + 1) * nb * nb * 8 / 1e9, band_dtype,
            time.time() - t0, f"; {dropped} entries outside the band dropped" if dropped else "",
        )
        return cls(
            n=n, nb=nb, B=B, nblk_pad=nblk_pad, chunk=chunk, band_dtype=band_dtype,
            perm=perm, pos_row=I, pos_off=off,
            pad_row=pad // nb, pad_off=B * nb * nb + (pad % nb) * nb + (pad % nb),
        )


_PLAN_CACHE: dict = {}


def band_mem_budget() -> int:
    """Device-memory budget of the band (bytes): env ``LSAFW_BAND_MEM_GB``,
    default 12."""
    return int(float(os.environ.get("LSAFW_BAND_MEM_GB", "12")) * 1e9)


def plan_for_csr(A: CSRMatrix, *, nb: int = 128, chunk: int = 128,
                 max_bytes: int | None = None) -> BandPlan:
    """:class:`BandPlan` of a CSRMatrix's pattern, cached per pattern."""
    if max_bytes is None:
        max_bytes = band_mem_budget()
    key = (id(A.pattern), nb, chunk, max_bytes)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0] is A.pattern:
        return hit[1]
    pat = A.pattern
    csr = sp.csr_matrix(
        (np.ones(pat.nnz, np.int8), pat.indices.copy(), pat.indptr.copy()), shape=pat.shape
    )
    plan = BandPlan.build(csr, nb=nb, chunk=chunk, max_bytes=max_bytes)
    _PLAN_CACHE.clear()
    _PLAN_CACHE[key] = (A.pattern, plan)
    return plan


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


def fill_band(plan: BandPlan, data: torch.Tensor) -> torch.Tensor:
    """Scatter complex CSR data into a fresh complex64 band on the
    data's device, with identity on the padding diagonal."""
    if plan.band_dtype != "f32":
        raise NotImplementedError(
            "bf16 at-rest band storage (band over the memory budget) is not ported")
    ix = plan.on(data.device)
    band = torch.zeros((plan.rows_total, plan.R, plan.nb, plan.nb),
                       dtype=torch.complex64, device=data.device)
    flat = band.view(-1)
    flat[ix["flat"]] = data[ix["keep"]].to(torch.complex64)
    flat[ix["pad"]] = 1.0
    return band


def factor_band(band: torch.Tensor, nblk_pad: int, *, delta: float = 0.0) -> torch.Tensor:
    """Pivot-free blocked LU of a filled band, in place; returns the
    (nblk_pad, nb, nb) inverse diagonal blocks.  ``delta`` is a ridge
    relative to the mean |Re| of each diagonal block's diagonal."""
    B = (band.shape[1] - 1) // 2
    nb = band.shape[2]
    dev = band.device
    dinv = torch.empty((nblk_pad, nb, nb), dtype=band.dtype, device=dev)
    i = torch.arange(1, B + 1, device=dev)
    rows = i[:, None].expand(B, B)  # block (K+i, K+j) sits at row K+i,
    slots = B + i[None, :] - i[:, None]  # slot B + j - i
    eye = torch.eye(nb, dtype=band.dtype, device=dev)
    for K in range(nblk_pad):
        D = band[K, B]
        if delta:
            s = D.diagonal().real.abs().mean() + 1e-30
            D = D + (delta * s) * eye
        X, _ = torch.linalg.inv_ex(D)
        dinv[K] = X
        L = band[K + i, B - i] @ X  # (B, nb, nb): L_i = E_i D^-1
        U = band[K, B + 1:]  # (B, nb, nb)
        r = rows + K
        band[r, slots] = band[r, slots] - L[:, None] @ U[None, :]
        band[K + i, B - i] = L
    return dinv


@dataclass(eq=False)
class BandedLU:
    """Factored complex band on a device; :meth:`solve` applies C^-1."""

    band: torch.Tensor  # (nblk_pad + B, 2B+1, nb, nb) complex64, factored
    dinv: torch.Tensor  # (nblk_pad, nb, nb) complex64
    perm: torch.Tensor  # (nblk_pad * nb,) int64: padded permuted index -> original
    iperm: torch.Tensor  # (n,) int64: original -> permuted position
    n: int
    nb: int
    B: int

    @classmethod
    def factor(cls, plan: BandPlan, data_re: torch.Tensor, data_im: torch.Tensor | None = None,
               *, delta: float = 0.0) -> "BandedLU":
        """Fill the band from CSR data (the plan's CSR order) and factor it."""
        t0 = time.time()
        data = data_re.to(torch.complex128)
        if data_im is not None:
            data = torch.complex(data_re, data_im)
        band = fill_band(plan, data)
        dinv = factor_band(band, plan.nblk_pad, delta=delta)
        if band.is_cuda:
            torch.cuda.synchronize(band.device)
        logger.info("BandedLU: factored n=%d B=%d in %.2f s", plan.n, plan.B, time.time() - t0)
        ix = plan.on(band.device)
        return cls(band, dinv, ix["perm_pad"], ix["iperm"], plan.n, plan.nb, plan.B)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x ~= C^-1 b for a complex128 vector (unpermuted), through the
        complex64 band substitution."""
        nblk_pad = self.dinv.shape[0]
        bp = torch.zeros(nblk_pad * self.nb, dtype=torch.complex128, device=b.device)
        bp[: self.n] = b
        bp = bp[self.perm].to(torch.complex64).reshape(nblk_pad, self.nb)
        x = band_cuda.solve_banded(self.band, self.dinv, bp)
        return x.reshape(-1).to(torch.complex128)[self.iperm]


def factor_auto(plan: BandPlan, data_re: torch.Tensor, data_im: torch.Tensor | None = None,
                *, diag_slots=None, delta: float = 0.0):
    """Factor C = data_re + i data_im on the plan; returns ``(lu, pivoted)``.

    The pivoted factor is not ported yet, so this always takes the
    pivot-free branch with saddle regularization of the zero diagonals
    (the reference's branch for a pivoted factor over budget)."""
    logger.info("factor_auto: pivot-free BandedLU with saddle regularization "
                "(the pivoted factor is not ported)")
    if diag_slots is not None:
        data_re = regularize_saddle_data(data_re, data_im, diag_slots)
    return BandedLU.factor(plan, data_re, data_im, delta=delta), False
