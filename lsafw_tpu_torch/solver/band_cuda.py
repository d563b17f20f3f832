"""Banded block substitution through a pivot-free complex band factor:
forward (K1) and backward + Dinv (K2), as hand-written CUDA kernels.

``csrc/band_subst.cu`` holds the kernels (their design and bound are
in its head comment).  It is compiled with ``nvcc`` for ``sm_90a`` on
first use into ``build/kernels/`` and loaded with ctypes.  Each wrapper
takes a CUDA tensor to its kernel and a CPU tensor to the plain
step-by-step recursion beside it (``*_plain``); a CUDA launch that fails
raises.  ``LAUNCHES`` counts kernel launches.

Layout: ``band`` is the factored (rows_total, 2B+1, nb, nb) complex64
band (L in slots 0..B-1, U in slots B+1..2B), ``dinv`` the
(nblk, nb, nb) complex64 inverse diagonal blocks, right-hand sides are
(nblk, nb) complex64 blocks with nblk <= rows_total.  The B lookahead
rows past nblk take a zero right-hand side and Dinv = I.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from lsafw_tpu_torch.utils.cuda_build import CSRC, compile_library, raise_on, stream

LAUNCHES = {"fwd": 0, "bwd": 0}

_SRC = CSRC / "band_subst.cu"
_SMEM_MAX = 232_448  # bytes of shared memory one H100 block may use
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``band_subst.cu`` for sm_90a (once per source version) and
    return the shared library's path."""
    return compile_library(_SRC)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.band_fwd.argtypes = [p, p, p, i64, i64, i32, i32, p]
        lib.band_bwd.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
        lib.band_fwd.restype = lib.band_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(band: torch.Tensor, rhs: torch.Tensor, dinv: torch.Tensor | None = None) -> tuple[int, int]:
    """Validate shapes/dtypes/devices; return (B, nb)."""
    if band.dim() != 4 or band.shape[2] != band.shape[3] or band.shape[1] % 2 != 1:
        raise ValueError(f"band must be (rows_total, 2B+1, nb, nb), got {tuple(band.shape)}")
    B, nb = (band.shape[1] - 1) // 2, band.shape[2]
    rows_total = band.shape[0]
    if rhs.dim() != 2 or rhs.shape[1] != nb or rhs.shape[0] > rows_total:
        raise ValueError(f"right-hand side must be (nblk <= {rows_total}, {nb}), got {tuple(rhs.shape)}")
    tensors = [band, rhs] + ([dinv] if dinv is not None else [])
    if dinv is not None and tuple(dinv.shape) != (rhs.shape[0], nb, nb):
        raise ValueError(f"dinv must be ({rhs.shape[0]}, {nb}, {nb}), got {tuple(dinv.shape)}")
    for t in tensors:
        if t.dtype != torch.complex64:
            raise TypeError(f"band substitution takes complex64 tensors, got {t.dtype}")
        if t.device != band.device:
            raise ValueError("band substitution tensors must share one device")
    if band.is_cuda:
        for t in tensors:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("band substitution tensors must be contiguous and 16-byte aligned")
        if nb % 2:
            raise ValueError(f"the CUDA kernels take an even block size, got nb={nb}")
        if (B + 2) * nb * 8 > _SMEM_MAX:
            raise ValueError(f"carry window of B={B}, nb={nb} exceeds shared memory")
    return B, nb


def _check_bwd(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor) -> tuple[int, int]:
    """Validate K2's inputs: y is K1's full (rows_total, nb) output."""
    if tuple(y.shape) != (band.shape[0], band.shape[-1]):
        raise ValueError(f"y must be (rows_total, nb) = {(band.shape[0], band.shape[-1])}, "
                         f"got {tuple(y.shape)}")
    if band.is_cuda and not y.is_contiguous():
        raise ValueError("y must be contiguous")
    return _check(band, y[: dinv.shape[0]], dinv)


# ---------------------------------------------------------------------------
# Plain versions: the step-by-step recursion in torch
# ---------------------------------------------------------------------------


def fwd_substitute_plain(band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y_K = b_K - sum_{t<B} L[K,t] y_{K-B+t}, K ascending; (rows_total, nb)."""
    B, nb = _check(band, b)
    rows_total, nblk = band.shape[0], b.shape[0]
    y = torch.zeros((rows_total, nb), dtype=b.dtype, device=b.device)
    y[:nblk] = b
    Y = torch.zeros((B, nb), dtype=b.dtype, device=b.device)  # Y[t] = y_{K-B+t}
    for k in range(rows_total):
        y[k] -= torch.einsum("tij,tj->i", band[k, :B], Y)
        Y = torch.cat([Y[1:], y[k][None]])
    return y


def bwd_substitute_plain(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x_K = Dinv_K (y_K - sum_{t<B} U[K,B+1+t] x_{K+1+t}), K descending;
    returns the first nblk = dinv.shape[0] blocks."""
    nblk = dinv.shape[0]
    B, nb = _check_bwd(band, dinv, y)
    X = torch.zeros((B, nb), dtype=y.dtype, device=y.device)  # X[t] = x_{K+1+t}
    x = torch.empty((nblk, nb), dtype=y.dtype, device=y.device)
    for k in range(band.shape[0] - 1, -1, -1):
        z = y[k] - torch.einsum("tij,tj->i", band[k, B + 1:], X)
        if k < nblk:
            z = dinv[k] @ z
            x[k] = z
        X = torch.cat([z[None], X[:-1]])
    return x


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def fwd_substitute(band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: forward substitution through L; (rows_total, nb) out."""
    if not band.is_cuda:
        return fwd_substitute_plain(band, b)
    B, nb = _check(band, b)
    y = torch.empty((band.shape[0], nb), dtype=torch.complex64, device=band.device)
    err = _load().band_fwd(band.data_ptr(), b.data_ptr(), y.data_ptr(),
                           band.shape[0], b.shape[0], B, nb, stream())
    raise_on(err, "band_fwd")
    LAUNCHES["fwd"] += 1
    return y


def bwd_substitute(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2: backward substitution through U with the Dinv product;
    (nblk, nb) out."""
    if not band.is_cuda:
        return bwd_substitute_plain(band, dinv, y)
    nblk = dinv.shape[0]
    B, nb = _check_bwd(band, dinv, y)
    x = torch.empty((nblk, nb), dtype=torch.complex64, device=band.device)
    err = _load().band_bwd(band.data_ptr(), dinv.data_ptr(), y.data_ptr(), x.data_ptr(),
                           band.shape[0], nblk, B, nb, stream())
    raise_on(err, "band_bwd")
    LAUNCHES["bwd"] += 1
    return x


def solve_banded(band: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full banded solve: K1 then K2.  (nblk, nb) complex64 in and out."""
    return bwd_substitute(band, dinv, fwd_substitute(band, b))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "LAUNCHES", "build", "bwd_substitute", "bwd_substitute_plain", "fwd_substitute",
    "fwd_substitute_plain", "reset_launches", "solve_banded",
]
