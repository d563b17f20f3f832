"""Direct sparse factorization on the host (scipy SuperLU), real or
complex: one factorization, many solves."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from lsafw_tpu_torch.ops.sparse import CSRMatrix


class SparseLU:
    """LU factorization of a sparse matrix (real or complex)."""

    def __init__(self, A: CSRMatrix | sp.spmatrix) -> None:
        mat = A.to_scipy() if isinstance(A, CSRMatrix) else sp.csc_matrix(A)
        self.shape = mat.shape
        self.dtype = mat.dtype
        self._lu = spla.splu(sp.csc_matrix(mat))

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (host arrays; accepts (n,) or (n, k))."""
        return self._lu.solve(np.asarray(b, dtype=self.dtype))

    def solve_t(self, b: np.ndarray) -> np.ndarray:
        """Solve A^T x = b."""
        return self._lu.solve(np.asarray(b, dtype=self.dtype), trans="T")


def direct_solve(A: CSRMatrix | sp.spmatrix, b) -> np.ndarray:
    """One-shot direct LU solve."""
    return SparseLU(A).solve(np.asarray(b))
