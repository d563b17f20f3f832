"""ctypes bindings for the repository's native sparsity library.

``native/sparsity.cpp`` builds the CSR pattern of a cell-local scatter
and the reverse Cuthill-McKee ordering of a pattern.  The library is
built on first use with ``make -C native``, without OpenMP (toolchains
without libgomp refuse ``-fopenmp``; the source guards its pragmas and
the results do not depend on threading).  There is no numpy stand-in:
the RCM ordering fixes the band width of every band factor (scipy's
ordering gives a band 3.7x wider on the 43k cylinder), so a missing
library raises instead of quietly changing the ordering.
"""

from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsparsity.so"
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        proc = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), "CXXFLAGS=-O3 -march=native -fPIC -std=c++17"],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0 and not _LIB_PATH.exists():
            raise RuntimeError(
                f"building {_LIB_PATH} with `make -C native` failed:\n{proc.stderr}"
            )
    # another process may be writing the same library (concurrent first
    # use); a half-written file fails to load, so wait for the writer
    last: OSError | None = None
    for _ in range(30):
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            break
        except OSError as exc:
            last = exc
            time.sleep(1.0)
    else:
        raise RuntimeError(f"cannot load {_LIB_PATH}: {last}")
    lib.lsafw_rcm.restype = ctypes.c_int64
    lib.lsafw_rcm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.lsafw_build_pattern.restype = ctypes.c_int64
    lib.lsafw_build_pattern.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def build_pattern_native(
    cell_rows: np.ndarray, cell_cols: np.ndarray, n_rows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, slots) of the scatter pattern of per-cell DOF maps."""
    lib = _load()
    cell_rows = np.ascontiguousarray(cell_rows, dtype=np.int32)
    cell_cols = np.ascontiguousarray(cell_cols, dtype=np.int32)
    nc, a = cell_rows.shape
    b = cell_cols.shape[1]
    n_entries = nc * a * b
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indices = np.empty(n_entries, dtype=np.int32)
    slots = np.empty(n_entries, dtype=np.int32)
    nnz = lib.lsafw_build_pattern(
        cell_rows.ctypes.data, cell_cols.ctypes.data,
        nc, a, b, n_rows,
        indptr.ctypes.data, indices.ctypes.data, slots.ctypes.data,
    )
    if nnz < 0:
        raise ValueError("native sparsity pattern: DOF index out of range")
    return indptr, indices[:nnz].copy(), slots


def rcm_native(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a structurally symmetric pattern."""
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    rc = lib.lsafw_rcm(indptr.ctypes.data, indices.ctypes.data, n, perm.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"native RCM failed (code {rc})")
    return perm.astype(np.int64)
