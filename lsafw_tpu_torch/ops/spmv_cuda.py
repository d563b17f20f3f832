"""Gather (G) and fused shifted CSR SpMV (S) as hand-written CUDA kernels.

``csrc/spmv_gather.cu`` holds both kernels (their design and bound are
in its head comment).  It is compiled with ``nvcc`` for ``sm_90a`` on
first use into ``build/kernels/`` and loaded with ctypes.  Each wrapper
takes CUDA tensors to its kernel and CPU tensors to the plain PyTorch
version beside it (``*_plain``); a CUDA launch that fails raises, and
nothing falls back.  ``LAUNCHES`` counts kernel launches:

* ``gather_f32``, ``gather_f64``, ``gather_c128``: G's flat form by
  element type (f64: the CSR value refill and the real permutation
  gathers; complex128: the complex permutation gathers; f32 is only the
  probes' type);
* ``gather_two_pass``: G's two-pass form (the probe's layout only);
* ``spmv_real``: S on an f64 x, one matrix (Newton's J x);
* ``spmv_complex``: S on a complex128 x, one matrix (the shift-invert
  right-hand side M x);
* ``spmv_shifted``: S's fused (A - sigma M) x, with M x in the same pass
  where asked.

CSR operands: ``crow`` (n+1,) int64 row pointers, ``col`` (nnz,) int32
column ids, ``rows`` (nnz,) int64 row id of each entry (read by the
plain version only), values (nnz,) f64.  Indices must be in range: the
kernels do not check them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from lsafw_tpu_torch.utils.cuda_build import CSRC, compile_library, raise_on, stream

LAUNCHES = {"gather_f32": 0, "gather_f64": 0, "gather_c128": 0, "gather_two_pass": 0,
            "spmv_real": 0, "spmv_complex": 0, "spmv_shifted": 0}

_SRC = CSRC / "spmv_gather.cu"
_lib: ctypes.CDLL | None = None
_GATHER_FN = {torch.float32: "gather_f32", torch.float64: "gather_f64",
              torch.complex128: "gather_c128"}
_SPMV_FN = {torch.float64: "csr_spmv_f64", torch.complex128: "csr_spmv_c128"}


def build() -> Path:
    """Compile ``spmv_gather.cu`` for sm_90a (once per source version) and
    return the shared library's path."""
    return compile_library(_SRC)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
        for name in _GATHER_FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, i64, i32, p]
            fn.restype = ctypes.c_int
        for name in _SPMV_FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, p, p, i64, f64, f64, p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_card(tensors, what: str) -> None:
    """Every tensor contiguous, aligned to its element size (16 bytes for
    complex128) and on the first one's card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors must share one device")
        if not t.is_contiguous() or t.data_ptr() % t.element_size():
            raise ValueError(f"{what}: tensors must be contiguous and aligned")


# ---------------------------------------------------------------------------
# G: gather
# ---------------------------------------------------------------------------


def gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y = x[idx] for a 1-D x."""
    return x[idx]


def gather_two_pass_plain(x2d: torch.Tensor, rowsel: torch.Tensor,
                          lanesel: torch.Tensor) -> torch.Tensor:
    """y[m, l] = x2d[rowsel[m, lanesel[m, l]], lanesel[m, l]]."""
    lane = lanesel.long()
    return x2d[torch.gather(rowsel.long(), 1, lane), lane]


def _check_gather(x: torch.Tensor, *idx: torch.Tensor) -> None:
    if x.dtype not in _GATHER_FN:
        raise TypeError(f"gather takes f32, f64 or complex128 values, got {x.dtype}")
    for i in idx:
        if i.dtype != torch.int32:
            raise TypeError(f"gather takes int32 indices, got {i.dtype}")
    _on_card((x,) + idx, "gather")


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G, flat form: y = x[idx] (any idx shape, 1-D x)."""
    if not x.is_cuda:
        return gather_plain(x, idx)
    if x.dim() != 1:
        raise ValueError(f"the flat gather takes a 1-D x, got {tuple(x.shape)}")
    _check_gather(x, idx)
    y = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    err = getattr(_load(), _GATHER_FN[x.dtype])(
        x.data_ptr(), idx.data_ptr(), None, y.data_ptr(), idx.numel(), 0, stream())
    raise_on(err, "gather")
    LAUNCHES[_GATHER_FN[x.dtype]] += 1
    return y


def gather_two_pass(x2d: torch.Tensor, rowsel: torch.Tensor, lanesel: torch.Tensor) -> torch.Tensor:
    """G, two-pass form: y[m, l] = x2d[rowsel[m, lanesel[m, l]], lanesel[m, l]],
    with rowsel and lanesel (M, W) and x2d (rows, W)."""
    if not x2d.is_cuda:
        return gather_two_pass_plain(x2d, rowsel, lanesel)
    W = x2d.shape[-1]
    if x2d.dim() != 2 or rowsel.shape != lanesel.shape or rowsel.dim() != 2 or rowsel.shape[1] != W:
        raise ValueError(f"two-pass gather needs x2d (rows, W) and (M, W) selectors, got "
                         f"{tuple(x2d.shape)}, {tuple(rowsel.shape)}, {tuple(lanesel.shape)}")
    _check_gather(x2d, rowsel, lanesel)
    y = torch.empty(rowsel.shape, dtype=x2d.dtype, device=x2d.device)
    err = getattr(_load(), _GATHER_FN[x2d.dtype])(
        x2d.data_ptr(), rowsel.data_ptr(), lanesel.data_ptr(), y.data_ptr(), rowsel.numel(), W,
        stream())
    raise_on(err, "gather")
    LAUNCHES["gather_two_pass"] += 1
    return y


# ---------------------------------------------------------------------------
# S: CSR SpMV, one matrix or the fused shifted pair
# ---------------------------------------------------------------------------


def csr_spmv_plain(crow, col, rows, va, x, vm=None, sigma: complex = 0.0, mass: bool = False):
    """``index_add_`` of ``vals * x[col]`` by row: A x, or (A - sigma M) x
    (and M x when ``mass``)."""
    n = crow.numel() - 1
    xg = x[col]

    def prod(v):
        return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, rows, v * xg)

    a = prod(va)
    if vm is None:
        return a
    m = prod(vm)
    y = a - sigma * m
    return (y, m) if mass else y


def _check_spmv(crow, col, va, vm, x) -> None:
    n = crow.numel() - 1
    if crow.dtype != torch.int64 or col.dtype != torch.int32:
        raise TypeError(f"S takes int64 row pointers and int32 columns, got {crow.dtype}, "
                        f"{col.dtype}")
    for v in (va, vm):
        if v is not None and (v.dtype != torch.float64 or v.shape != col.shape):
            raise ValueError("S takes f64 values, one per column index")
    if x.dtype not in _SPMV_FN or x.shape != (n,):
        raise ValueError(f"S takes an f64 or complex128 x of shape ({n},), got {x.dtype} "
                         f"{tuple(x.shape)}")
    _on_card([t for t in (crow, col, va, vm, x) if t is not None], "csr_spmv")


def _launch(crow, col, va, vm, x, sigma: complex, mass: bool):
    n = crow.numel() - 1
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    ym = torch.empty_like(y) if mass else None
    err = getattr(_load(), _SPMV_FN[x.dtype])(
        crow.data_ptr(), col.data_ptr(), va.data_ptr(), _ptr(vm), x.data_ptr(), y.data_ptr(),
        _ptr(ym), n, float(sigma.real), float(sigma.imag), stream())
    raise_on(err, "csr_shifted_spmv")
    return y, ym


def csr_spmv(crow, col, rows, vals, x):
    """S, one matrix: y = A x for an f64 or complex128 x."""
    if not x.is_cuda:
        return csr_spmv_plain(crow, col, rows, vals, x)
    _check_spmv(crow, col, vals, None, x)
    y, _ = _launch(crow, col, vals, None, x, 0.0, False)
    LAUNCHES["spmv_complex" if x.is_complex() else "spmv_real"] += 1
    return y


def csr_shifted_spmv(crow, col, rows, va, vm, x, sigma: complex, *, mass: bool = False):
    """S, fused pair: (A - sigma M) x for a complex128 x, and M x from the
    same pass when ``mass`` (then a tuple)."""
    sigma = complex(sigma)
    if not x.is_cuda:
        return csr_spmv_plain(crow, col, rows, va, x, vm, sigma, mass)
    if not x.is_complex():
        raise TypeError("the shifted apply takes a complex128 x")
    _check_spmv(crow, col, va, vm, x)
    y, ym = _launch(crow, col, va, vm, x, sigma, mass)
    LAUNCHES["spmv_shifted"] += 1
    return (y, ym) if mass else y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "LAUNCHES", "build", "csr_shifted_spmv", "csr_spmv", "csr_spmv_plain", "gather",
    "gather_plain", "gather_two_pass", "gather_two_pass_plain", "reset_launches",
]
