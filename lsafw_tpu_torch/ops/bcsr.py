"""Refinement matvecs on the RCM-permuted CSR of one sparsity pattern.

Counterpart of the reference's ``ops/bcsr.py`` (``BCSRPlan``,
``BCSROperator``, ``BCSRShiftedOp``, ``operator_for_budget``), under
the same names.  The reference packs the matrix into 128-lane column
blocks on an ``(S, C)`` scan grid and splits every f64 value into hi/lo
f32 channels: answers to the TPU's per-index gather cost (about 7 ns)
and its lack of f64.  Neither holds on an H100, which has native f64
and gathers from L2 for no more per index than a streamed load.  On
the 43k cylinder Jacobian (``scripts/data/J43k_re47.npz``) the
reference's default blocks (br = 16, bc = 32) hold 20 blocks per row
group, 27.96 M slots for 1.28 M nonzeros (4.6% fill): 224 MB per
matrix in f64, against 10.3 MB of CSR values and 5.1 MB of columns.
So the port stores plain CSR, in f64, in the band's RCM order
(``band.rcm_permutation``: neighbouring rows touch neighbouring x), with
the A and M values of a shifted operator on one set of row pointers and
column indices.  The block shape, its ``LSAFW_BCSR_BR/BC`` knobs and the
hi/lo channels are gone.

Applies run through the S kernel of :mod:`lsafw_tpu_torch.ops.spmv_cuda`,
which cuts the rows into tiles of whole rows at plan time.  The public
``matvec*``/``mass_pair`` take and return vectors in the original order
in one S launch each: the plan's operands hold the columns in original
ids, and S writes row r's result to y[perm[r]].  The ``*_permuted``
applies work in permuted coordinates, on operands made on their first
use.  Where the
reference passes a complex vector as an (re, im) pair, the ``*_pair``
methods take one complex128 tensor.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.ops.sparse import pattern_csr, per_pattern, shared_pattern, spmv
from lsafw_tpu_torch.solver.band import pattern_permutation, rcm_permutation
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(eq=False)
class BCSRPlan:
    """Host-built permuted CSR structure of one sparsity pattern.

    Row r of the permuted matrix is original row ``perm[r]``; its entries
    sit at ``indptr[r]:indptr[r+1]`` with permuted column ids ``indices``
    (ascending), and ``src`` maps each permuted slot to the original CSR
    slot its value comes from.  ``tile_row``/``tile_ptr`` are S's tiles
    (:func:`~lsafw_tpu_torch.ops.spmv_cuda.plan_tiles`)."""

    perm: np.ndarray  # (n,) permuted index -> original
    iperm: np.ndarray  # (n,) original -> permuted
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    src: np.ndarray  # (nnz,) int64
    tile_row: np.ndarray  # (ntiles+1,) int32
    tile_ptr: np.ndarray  # (ntiles+1,) int64
    n: int
    nnz: int
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def bytes_per_matrix(self) -> int:
        """Device bytes of one matrix's f64 values."""
        return self.nnz * 8

    @property
    def index_bytes(self) -> int:
        """Device bytes of the main path's structure: row pointers, the
        columns in original ids, the refill's slot map, the permutation,
        S's tiles (the permuted-order operands, for the ``*_permuted``
        applies alone, are made on their first use and not counted)."""
        return (self.n + 1) * 8 + 2 * self.nnz * 4 + self.n * 4 + self.tile_row.size * 12

    def on(self, device, order: str = "original") -> spmv_cuda.TiledCSR:
        """S's operands on ``device`` (cached per device and order): in
        ``"original"`` order (original column ids, y[perm[r]]) or in
        ``"permuted"`` order."""
        key = (str(torch.device(device)), order)
        hit = self._device.get(key)
        if hit is None:
            if order == "original":
                cols, out = self.perm[self.indices.astype(np.int64)], self.perm
            elif order == "permuted":
                cols, out = self.indices, None
            else:
                raise ValueError(f"S's orders are 'original' and 'permuted', not {order!r}")
            hit = spmv_cuda.TiledCSR.build(self.indptr, cols, self.src,
                                           (self.tile_row, self.tile_ptr), device, out=out)
            self._device[key] = hit
        return hit

    @classmethod
    def build(cls, A: sp.spmatrix, *, perm: np.ndarray | None = None) -> "BCSRPlan":
        """Plan the (pattern of) scipy ``A``; ``perm`` defaults to the native
        RCM ordering the band planner uses."""
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if perm is None:
            perm = rcm_permutation(A)
        perm = np.asarray(perm, dtype=np.int64)
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        pi = iperm[rows]
        pj = iperm[A.indices.astype(np.int64)]
        src = np.lexsort((pj, pi))
        indptr = np.concatenate([[0], np.cumsum(np.bincount(pi, minlength=n))]).astype(np.int64)
        tile_row, tile_ptr = spmv_cuda.plan_tiles(indptr)
        logger.info("BCSRPlan: n=%d nnz=%d permuted CSR (%.1f MB per f64 matrix), %d tiles",
                    n, A.nnz, A.nnz * 8 / 1e6, tile_row.size - 1)
        return cls(perm=perm, iperm=iperm, indptr=indptr, indices=pj[src].astype(np.int32),
                   src=src, tile_row=tile_row, tile_ptr=tile_ptr, n=n, nnz=int(A.nnz))


def plan_for_pattern(A) -> BCSRPlan:
    """The plan of ``A``'s pattern in the band's RCM ordering, cached per
    pattern beside the band plans: Newton refills and sigma sweeps share
    one plan."""
    pat = A.pattern
    return per_pattern(pat, ("csr",), lambda: BCSRPlan.build(
        pattern_csr(pat), perm=pattern_permutation(pat)))


def _values(plan: BCSRPlan, data: torch.Tensor) -> torch.Tensor:
    """CSR data in the plan's permuted slot order (one G gather)."""
    return plan.on(data.device).values(data)


@dataclass(eq=False)
class BCSROperator:
    """One real matrix on the permuted CSR."""

    vals: torch.Tensor  # (nnz,) f64, permuted slot order
    plan: BCSRPlan

    @classmethod
    def from_csr(cls, A, plan: BCSRPlan | None = None) -> "BCSROperator":
        plan = plan or plan_for_pattern(A)
        return cls(_values(plan, A.data), plan)

    def matvec_permuted(self, xp: torch.Tensor) -> torch.Tensor:
        """y = P^T A P xp for an f64 or complex128 xp in permuted order."""
        return spmv_cuda.csr_spmv(self.plan.on(self.vals.device, "permuted"), self.vals, xp)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in the original order (one S launch)."""
        return spmv_cuda.csr_spmv(self.plan.on(self.vals.device), self.vals, x)

    def matvec_pair(self, x: torch.Tensor) -> torch.Tensor:
        """The real matrix on a complex128 x: one read of the values serves
        both parts."""
        return self.matvec(x)


@dataclass(eq=False)
class BCSRShiftedOp:
    """C = A - sigma M with A's and M's values on one permuted CSR and
    sigma a runtime scalar: ``dataclasses.replace(op, sigma=s)`` serves a
    new shift without a refill.  ``mass_pair`` applies M from the same
    storage."""

    vA: torch.Tensor  # (nnz,) f64
    vM: torch.Tensor  # (nnz,) f64
    sigma: complex
    plan: BCSRPlan

    @classmethod
    def from_csr(cls, A, M, sigma: complex, plan: BCSRPlan | None = None) -> "BCSRShiftedOp":
        """The fused operator of (A, M); a pair on two patterns is first put
        on one (:func:`~lsafw_tpu_torch.ops.sparse.shared_pattern`), so a
        given ``plan`` must be of a pattern the pair shares."""
        if M.pattern is not A.pattern:
            if plan is not None:
                raise ValueError("a plan was given for a pair on two patterns")
            A, M = shared_pattern(A, M)
        plan = plan or plan_for_pattern(A)
        return cls(_values(plan, A.data), _values(plan, M.data), complex(sigma), plan)

    def _apply(self, order: str, x: torch.Tensor, mass: bool):
        if x.is_complex() or self.sigma.imag != 0.0:  # an f64 x stays f64 at a real sigma
            x = x.to(torch.complex128)
        return spmv_cuda.csr_shifted_spmv(self.plan.on(self.vA.device, order), self.vA, self.vM,
                                          x, self.sigma, mass=mass)

    def _mass(self, order: str, x: torch.Tensor) -> torch.Tensor:
        return spmv_cuda.csr_spmv(self.plan.on(self.vM.device, order), self.vM, x)

    def matvec_pair_permuted(self, xp: torch.Tensor, *, mass: bool = False):
        """(A - sigma M) xp in permuted coordinates; with ``mass`` also M xp
        from the same pass, as a tuple."""
        return self._apply("permuted", xp, mass)

    def mass_pair_permuted(self, xp: torch.Tensor) -> torch.Tensor:
        """M xp alone: reads only the M values."""
        return self._mass("permuted", xp)

    def matvec_pair(self, x: torch.Tensor, *, mass: bool = False):
        """(A - sigma M) x in the original order (and M x when ``mass``), in
        one S launch; an f64 x at a real sigma stays f64."""
        return self._apply("original", x, mass)

    def mass_pair(self, x: torch.Tensor) -> torch.Tensor:
        """M x in the original order (one S launch)."""
        return self._mass("original", x)


def operator_for_budget(A) -> BCSROperator | None:
    """The permuted-CSR operator of ``A`` for refinement matvecs, or None
    (the caller applies the CSR matrix itself) when its values and
    structure exceed ``LSAFW_BCSR_MEM_GB`` (default 6)."""
    plan = plan_for_pattern(A)
    budget = float(os.environ.get("LSAFW_BCSR_MEM_GB", "6")) * 1e9
    need = plan.bytes_per_matrix + plan.index_bytes
    if need > budget:
        logger.info("CSR matvec operator (%.1f GB) over budget; applying the CSR matrix.",
                    need / 1e9)
        return None
    return BCSROperator.from_csr(A, plan)


def matvec_of(A):
    """x -> A x for a square CSR ``A``: one S launch in the original order
    on :func:`operator_for_budget`'s operator, or the CSR product where
    that is over budget."""
    op = operator_for_budget(A)
    return op.matvec if op is not None else (lambda x: spmv(A, x))
