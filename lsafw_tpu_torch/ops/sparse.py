"""Sparse matrix containers on a static FEM sparsity pattern.

The pattern (CSR structure plus the COO-entry -> nnz-slot scatter map)
is built once on the host per (mesh, spaces) and shared by A, M and
every Jacobian, so sums like ``A - sigma*M`` are element-wise ops on
the data.  The data lives on the device as an f64 tensor; assembly is
one ``index_add_`` over the slots, and the matvec goes through
``torch.sparse_csr_tensor``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.ops import spmv_cuda


@dataclass(frozen=True, eq=False)
class SparsityPattern:
    """CSR structure + COO-entry -> nnz-slot scatter map (host numpy).

    Device copies of the index arrays are cached per device by
    :meth:`on`.  Equality is identity: operators built on one pattern
    share it."""

    shape: tuple[int, int]
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    slots: np.ndarray  # (num_coo_entries,) int32
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @cached_property
    def row_ids(self) -> np.ndarray:
        """(nnz,) row index of every stored entry."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )

    @cached_property
    def diag_slots(self) -> np.ndarray:
        """(n,) nnz slot of each diagonal entry ((row, col) pairs form
        one globally sorted key, so one binary search finds them all)."""
        n = self.shape[0]
        rows = np.arange(n, dtype=np.int64)
        key = self.row_ids.astype(np.int64) * (self.shape[1] + 1) + self.indices
        want = rows * (self.shape[1] + 1) + rows
        out = np.searchsorted(key, want)
        if not ((out < self.nnz) & (key[np.minimum(out, self.nnz - 1)] == want)).all():
            raise ValueError("Sparsity pattern is missing diagonal entries.")
        return out

    def on(self, device) -> dict[str, torch.Tensor]:
        """int64 index tensors of the pattern on ``device`` (cached)."""
        key = str(torch.device(device))
        hit = self._device.get(key)
        if hit is None:
            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

            hit = dict(
                crow=t(self.indptr), col=t(self.indices), row_ids=t(self.row_ids),
                slots=t(self.slots), diag_slots=t(self.diag_slots),
            )
            self._device[key] = hit
        return hit


_PER_PATTERN: dict = {}
_PER_PATTERN_MAX = 8
PLAN_BUILDS: dict = {}  # builds (cache misses) of per_pattern, by the key's first item


def per_pattern(pattern: SparsityPattern, key: tuple, build):
    """``build()`` for one pattern, cached in a small LRU by the pattern's
    identity and ``key``.  Each entry holds the pattern, so its id is not
    reused while the entry lives.  The RCM ordering, the real (Newton) and
    complex (shift-invert) band plans and the permuted-CSR plan of a
    pattern stay cached side by side.  ``PLAN_BUILDS`` counts the misses:
    an evicted plan is rebuilt silently, so a caller that must not re-plan
    reads the count."""
    full = (id(pattern),) + key
    hit = _PER_PATTERN.get(full)
    if hit is not None and hit[0] is pattern:
        _PER_PATTERN[full] = _PER_PATTERN.pop(full)
        return hit[1]
    PLAN_BUILDS[key[0]] = PLAN_BUILDS.get(key[0], 0) + 1
    value = build()
    while len(_PER_PATTERN) >= _PER_PATTERN_MAX:
        _PER_PATTERN.pop(next(iter(_PER_PATTERN)))
    _PER_PATTERN[full] = (pattern, value)
    return value


def pattern_csr(pattern: SparsityPattern) -> sp.csr_matrix:
    """The pattern as a scipy CSR matrix of ones (int8)."""
    return sp.csr_matrix((np.ones(pattern.nnz, np.int8), pattern.indices.copy(),
                          pattern.indptr.copy()), shape=pattern.shape)


def build_sparsity(
    rows_per_cell: np.ndarray,
    cols_per_cell: np.ndarray | None = None,
    shape: tuple[int, int] | None = None,
) -> SparsityPattern:
    """CSR pattern of a cell-local scatter (native C++ routine).

    Args:
        rows_per_cell: (num_cells, a) int row DOFs per cell.
        cols_per_cell: (num_cells, b) int col DOFs (defaults to rows).
        shape: matrix shape (defaults to square over max DOF + 1).
    """
    from lsafw_tpu_torch.ops.native import build_pattern_native

    rows_per_cell = np.asarray(rows_per_cell, dtype=np.int64)
    cols_per_cell = (
        rows_per_cell if cols_per_cell is None else np.asarray(cols_per_cell, dtype=np.int64)
    )
    if shape is None:
        shape = (int(rows_per_cell.max()) + 1, int(cols_per_cell.max()) + 1)
    indptr, indices, slots = build_pattern_native(rows_per_cell, cols_per_cell, shape[0])
    return SparsityPattern(shape=shape, indptr=indptr, indices=indices, slots=slots)


@dataclass(eq=False)
class CSRMatrix:
    """A sparse matrix: host pattern + f64 data tensor on a device."""

    pattern: SparsityPattern
    data: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return self.pattern.shape

    @property
    def device(self) -> torch.device:
        return self.data.device

    def idx(self) -> dict[str, torch.Tensor]:
        return self.pattern.on(self.data.device)

    def torch_csr(self) -> torch.Tensor:
        ix = self.idx()
        return torch.sparse_csr_tensor(ix["crow"], ix["col"], self.data, size=self.shape,
                                       check_invariants=False)

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (self.data.detach().cpu().numpy(), self.pattern.indices, self.pattern.indptr),
            shape=self.shape,
        )

    def diagonal(self) -> torch.Tensor:
        """The stored diagonal (raises where the pattern lacks one)."""
        return self.data[self.idx()["diag_slots"]]

    def transpose(self) -> "CSRMatrix":
        """A^T on a new pattern of its own (host transpose)."""
        t = self.to_scipy().T.tocsr()
        t.sort_indices()
        pattern = SparsityPattern(shape=t.shape, indptr=t.indptr.astype(np.int64),
                                  indices=t.indices.astype(np.int32),
                                  slots=np.arange(t.nnz, dtype=np.int32))
        return CSRMatrix(pattern, torch.as_tensor(t.data, device=self.device))


def transpose_pair(A: CSRMatrix, M: CSRMatrix) -> tuple[CSRMatrix, CSRMatrix]:
    """(A^T, M^T) of a pair that shares a pattern, on one shared pattern.

    The slot map of the structural transpose is computed once on the host
    and both data arrays are permuted by it (G's flat f64 gather on the
    card), so explicit zeros stay.  Where the transposed structure equals
    the original (a structurally symmetric pattern, as every Taylor-Hood
    pattern is), both matrices come back on the *original* pattern object:
    the RCM ordering depends only on the structure, so the adjoint shares
    every plan cached for the pattern.  Otherwise they get a new pattern.
    A pair on two patterns is transposed matrix by matrix."""
    if M.pattern is not A.pattern:
        return A.transpose(), M.transpose()
    pat = A.pattern
    ids = sp.csr_matrix((np.arange(1, pat.nnz + 1, dtype=np.int64), pat.indices, pat.indptr),
                        shape=pat.shape).T.tocsr()  # 1-based slot ids: no 0 to prune
    ids.sort_indices()
    if np.array_equal(ids.indptr, pat.indptr) and np.array_equal(ids.indices, pat.indices):
        pattern_t = pat
    else:
        pattern_t = SparsityPattern(shape=ids.shape, indptr=ids.indptr.astype(np.int64),
                                    indices=ids.indices.astype(np.int32),
                                    slots=np.arange(pat.nnz, dtype=np.int32))
    src = torch.as_tensor((ids.data - 1).astype(np.int32), device=A.device)
    return (CSRMatrix(pattern_t, spmv_cuda.gather(A.data.contiguous(), src)),
            CSRMatrix(pattern_t, spmv_cuda.gather(M.data.contiguous(), src)))


def assemble_csr_data(pattern: SparsityPattern, element_values: torch.Tensor) -> torch.Tensor:
    """Scatter flattened per-cell element matrices into nnz data (f64
    ``index_add_``; the sum order of duplicate slots is the device's)."""
    flat = element_values.reshape(-1)
    slots = pattern.on(flat.device)["slots"]
    out = torch.zeros(pattern.nnz, dtype=flat.dtype, device=flat.device)
    return out.index_add_(0, slots, flat)


def spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a real or complex vector (complex as two real products)."""
    S = A.torch_csr()
    if x.is_complex():
        y = S @ torch.stack([x.real, x.imag], dim=1)
        return torch.complex(y[:, 0], y[:, 1])
    return S @ x
