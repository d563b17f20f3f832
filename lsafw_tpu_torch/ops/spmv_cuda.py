"""Gather (G), its permutation forms, and the tiled CSR SpMV (S) as
hand-written CUDA kernels.

``csrc/spmv_gather.cu`` holds the kernels (their design and bound are in
its head comment).  It is compiled with ``nvcc`` for ``sm_90a`` on first
use into ``build/kernels/`` and loaded with ctypes.  Each wrapper takes
CUDA tensors to its kernel and CPU tensors to the plain PyTorch version
beside it (``*_plain``); a CUDA launch that fails, or CUDA tensors the
kernel does not take, raise, and nothing falls back.  ``LAUNCHES`` counts
kernel launches:

* ``gather_f32``, ``gather_f64``, ``gather_c128``: G's flat form by
  element type (f64: the CSR value refill; f32 and complex128 are the
  probes' and the tests' types, not the main path's);
* ``gather_two_pass``: G's two-pass form (the probe's layout only);
* ``permute_in.<from>.<kind>``, ``permute_out.<kind>.<to>``: G's
  permutation forms, into and out of a band factor's order, by the
  vector's type (``f64``, ``c128``) and the band-order type (``c64``;
  ``f32x1``, ``f32x2``: one or two real columns, the kinds of
  :mod:`~lsafw_tpu_torch.solver.band_cuda`), as listed in ``PERMUTES``;
* ``spmv_real``, ``spmv_complex``, ``spmv_shifted``,
  ``spmv_shifted_real``: S on an f64 x (one matrix, Newton's J x), on a
  complex128 x (one matrix: the shift-invert right-hand side M x), fused
  (A - sigma M) x on a complex128 x, and fused (A - sigma M) x on an f64
  x with a real sigma (the real-shift solves of the Crank-Nicolson
  propagators), each with M x in the same pass where asked, in permuted
  coordinates; the same keys with ``.original`` count the original-order
  applies, which take x and return y in the original order in the same
  one launch.

S's operands are a :class:`TiledCSR` (row pointers, columns, the tile
plan of :func:`plan_tiles`, the output permutation, the value refill's
slot map), made by :meth:`TiledCSR.build`, and f64 values made by
:meth:`TiledCSR.values`.  The kernel copies the 16-byte-aligned superset
of each tile's ranges, so both store every array it copies padded to a
multiple of 4 entries; the wrapper checks the storage (a ``.clone()`` of
the values does not keep it).  Indices must be in range: the kernels do
not check them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lsafw_tpu_torch.utils.cuda_build import CSRC, compile_library, raise_on, stream

PERMUTES = {"in": ("c128.c64", "f64.c64", "f64.f32x1", "c128.f32x2"),
            "out": ("c64.c128", "c64.f64", "f32x1.f64", "f32x2.c128")}
SPMV_KEYS = ("spmv_real", "spmv_complex", "spmv_shifted", "spmv_shifted_real")
LAUNCHES = {"gather_f32": 0, "gather_f64": 0, "gather_c128": 0, "gather_two_pass": 0,
            **{f"permute_{d}.{t}": 0 for d, types in PERMUTES.items() for t in types},
            **{m + o: 0 for m in SPMV_KEYS for o in ("", ".original")}}

TILE_NNZ = 2048  # most nonzeros of a tile of S (the kernel's kCap bounds it)
TILE_ROWS = 256  # most rows of a tile (the kernel's kRowCap)

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
            getattr(lib, name).argtypes = [p, p, p, p, i64, i32, p]
        lib.permute_in.argtypes = [p, p, p, i64, i64, i32, i32, p]
        lib.permute_out.argtypes = [p, p, p, i64, i32, i32, p]
        for name in _SPMV_FN.values():
            getattr(lib, name).argtypes = [p, p, i64, p, p, p, p, p, p, p, p, f64, f64, p]
        for name in (*_GATHER_FN.values(), "permute_in", "permute_out", *_SPMV_FN.values()):
            getattr(lib, name).restype = ctypes.c_int
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
# G: permutation into and out of a band factor's order
# ---------------------------------------------------------------------------


def band_kind(dtype: torch.dtype, b_complex: bool) -> str:
    """The band-order type a vector takes on a factor of ``dtype``: one
    complex64 column, or one or two float32 columns (a complex vector on a
    real factor)."""
    if dtype == torch.complex64:
        return "c64"
    if dtype == torch.float32:
        return "f32x2" if b_complex else "f32x1"
    raise TypeError(f"band factors are complex64 or float32, got {dtype}")


def permute_in_plain(b: torch.Tensor, perm: torch.Tensor, nb: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """b in the band's order: slot i holds b[perm[i]] (0 where perm[i] >= n),
    cast to ``dtype``; (nblk, nb) complex64, or (nblk, nb, m) float32 with
    a complex b as m = 2 columns (re, im)."""
    npad = perm.numel()
    bp = torch.zeros(npad, dtype=b.dtype, device=b.device)
    bp[:b.numel()] = b
    v = bp[perm.long()]
    if dtype == torch.complex64:
        return v.to(torch.complex128).to(dtype).reshape(npad // nb, nb)
    cols = [v.real, v.imag] if v.is_complex() else [v]
    return torch.stack([c.to(dtype) for c in cols], dim=1).reshape(npad // nb, nb, len(cols))


def permute_out_plain(x: torch.Tensor, iperm: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The band-order x back in the original order: out[i] = x[iperm[i]]
    as ``dtype`` (f64 or complex128); two real columns merge into one
    complex vector, and a complex64 x to f64 keeps its real part."""
    idx = iperm.long()
    if x.is_complex():
        v = x.reshape(-1)[idx].to(torch.complex128)
        return v if dtype == torch.complex128 else v.real.contiguous()
    v = x.reshape(-1, x.shape[-1])[idx].to(torch.float64)
    return torch.complex(v[:, 0], v[:, 1]) if v.shape[1] == 2 else v[:, 0].contiguous()


def _check_permute_in(b: torch.Tensor, perm: torch.Tensor, nb: int, dtype: torch.dtype) -> str:
    if b.dtype not in (torch.float64, torch.complex128):
        raise TypeError(f"permute_in takes an f64 or complex128 b, got {b.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"permute_in takes an int32 permutation, got {perm.dtype}")
    if b.dim() != 1 or perm.dim() != 1 or perm.numel() % nb or perm.numel() < b.numel():
        raise ValueError(f"permute_in takes a 1-D b and a padded permutation of whole blocks of "
                         f"{nb}, got {tuple(b.shape)}, {tuple(perm.shape)}")
    return band_kind(dtype, b.is_complex())


def permute_in(b: torch.Tensor, perm: torch.Tensor, nb: int, dtype: torch.dtype) -> torch.Tensor:
    """G, permute-in: :func:`permute_in_plain` in one launch."""
    kind = _check_permute_in(b, perm, nb, dtype)
    if not b.is_cuda:
        return permute_in_plain(b, perm, nb, dtype)
    _on_card((b, perm), "permute_in")
    npad = perm.numel()
    shape = (npad // nb, nb) if kind == "c64" else (npad // nb, nb, 2 if kind == "f32x2" else 1)
    out = torch.empty(shape, dtype=dtype, device=b.device)
    wo = 1 if kind == "f32x1" else 2
    err = _load().permute_in(b.data_ptr(), perm.data_ptr(), out.data_ptr(), npad, b.numel(),
                             2 if b.is_complex() else 1, wo, stream())
    raise_on(err, "permute_in")
    LAUNCHES[f"permute_in.{'c128' if b.is_complex() else 'f64'}.{kind}"] += 1
    return out


def _check_permute_out(x: torch.Tensor, iperm: torch.Tensor, dtype: torch.dtype) -> str:
    if iperm.dtype != torch.int32 or iperm.dim() != 1:
        raise TypeError(f"permute_out takes a 1-D int32 permutation, got {iperm.dtype} "
                        f"{tuple(iperm.shape)}")
    if x.dtype == torch.complex64 and x.dim() == 2:
        kind = "c64"
    elif x.dtype == torch.float32 and x.dim() == 3 and x.shape[2] in (1, 2):
        kind = f"f32x{x.shape[2]}"
    else:
        raise TypeError(f"permute_out takes (nblk, nb) complex64 or (nblk, nb, m) float32 "
                        f"blocks, got {x.dtype} {tuple(x.shape)}")
    want = torch.complex128 if kind == "f32x2" else torch.float64 if kind == "f32x1" else None
    if dtype not in (torch.float64, torch.complex128) or (want is not None and dtype != want):
        raise TypeError(f"permute_out cannot make {dtype} from {kind} blocks")
    return kind


def permute_out(x: torch.Tensor, iperm: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """G, permute-out: :func:`permute_out_plain` in one launch."""
    kind = _check_permute_out(x, iperm, dtype)
    if not x.is_cuda:
        return permute_out_plain(x, iperm, dtype)
    _on_card((x, iperm), "permute_out")
    if kind == "f32x2" and x.data_ptr() % 8:
        raise ValueError("permute_out reads two float32 columns as one 8-byte value: align x")
    n = iperm.numel()
    out = torch.empty(n, dtype=dtype, device=x.device)
    err = _load().permute_out(x.data_ptr(), iperm.data_ptr(), out.data_ptr(), n,
                              1 if kind == "f32x1" else 2, 2 if dtype.is_complex else 1, stream())
    raise_on(err, "permute_out")
    LAUNCHES[f"permute_out.{kind}.{'c128' if dtype.is_complex else 'f64'}"] += 1
    return out


# ---------------------------------------------------------------------------
# S: tiled CSR SpMV, one matrix or the fused shifted pair
# ---------------------------------------------------------------------------


def _padded(count: int) -> int:
    """Entries an array of S must reach in storage: the next multiple of 4."""
    return -(-count // 4) * 4


def _padded_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array ``a`` as a 1-D ``dtype`` tensor on ``device`` whose storage
    reaches :func:`_padded` entries (the padding zero)."""
    a = torch.as_tensor(np.ascontiguousarray(a)).reshape(-1)
    out = torch.zeros(_padded(a.numel()), dtype=dtype, device=device)
    out[:a.numel()] = a.to(dtype)
    return out[:a.numel()]


def plan_tiles(crow: np.ndarray, cap: int = TILE_NNZ,
               row_cap: int = TILE_ROWS) -> tuple[np.ndarray, np.ndarray]:
    """S's tiles: consecutive whole rows, at most ``cap`` nonzeros and
    ``row_cap`` rows each; a row longer than ``cap`` is a tile of its own.
    Returns (tile_row int32, tile_ptr int64), each (ntiles + 1,)."""
    if not (0 < cap <= TILE_NNZ and 0 < row_cap <= TILE_ROWS):
        raise ValueError(f"tiles hold at most {TILE_NNZ} nonzeros and {TILE_ROWS} rows")
    crow = np.asarray(crow, dtype=np.int64)
    n = crow.size - 1
    bounds = [0]
    r = 0
    while r < n:
        r1 = int(np.searchsorted(crow, crow[r] + cap, side="right")) - 1
        r1 = min(max(r1, r + 1), r + row_cap, n)
        bounds.append(r1)
        r = r1
    rows = np.asarray(bounds, dtype=np.int64)
    return rows.astype(np.int32), crow[rows]


@dataclass(frozen=True, eq=False)
class TiledCSR:
    """S's operands of one CSR structure on one device: ``crow`` (n+1,)
    int64 row pointers, ``col`` (nnz,) int32 column ids, the tile plan
    ``tile_row`` int32 / ``tile_ptr`` int64 (:func:`plan_tiles`), ``src``
    (the value refill's slot map, int32, padded) and ``out`` (n,) int32:
    row r's result lands in y[out[r]] (None: y[r])."""

    crow: torch.Tensor
    col: torch.Tensor
    tile_row: torch.Tensor
    tile_ptr: torch.Tensor
    src: torch.Tensor
    out: torch.Tensor | None = None

    @classmethod
    def build(cls, indptr, cols, src, tiles, device, out=None) -> "TiledCSR":
        """The operands of host arrays on ``device``: row pointers ``indptr``,
        column ids ``cols``, ``src`` (each slot's index into the CSR data
        its value comes from), ``tiles`` (:func:`plan_tiles`) and ``out``,
        the arrays the kernel copies stored as it needs."""
        nnz = len(cols)
        return cls(crow=_padded_tensor(indptr, torch.int64, device),
                   col=_padded_tensor(cols, torch.int32, device),
                   tile_row=torch.as_tensor(tiles[0], dtype=torch.int32, device=device),
                   tile_ptr=torch.as_tensor(tiles[1], dtype=torch.int64, device=device),
                   src=torch.as_tensor(np.concatenate([src, np.zeros(_padded(nnz) - nnz, np.int64)]),
                                       dtype=torch.int32, device=device),  # the pad reads entry 0
                   out=None if out is None else _padded_tensor(out, torch.int32, device))

    @property
    def n(self) -> int:
        return self.crow.numel() - 1

    def values(self, data: torch.Tensor) -> torch.Tensor:
        """CSR data (in its own slot order) as f64 values in this
        structure's slot order: one G f64 launch, stored as S's copies
        need."""
        return gather(data.to(torch.float64).contiguous(), self.src)[:self.col.numel()]


def csr_spmv_plain(csr: TiledCSR, va, x, vm=None, sigma: complex = 0.0, mass: bool = False):
    """``index_add_`` of ``vals * x[col]`` by row: A x, or (A - sigma M) x
    (and M x when ``mass``); row r's result lands at ``csr.out[r]``."""
    n = csr.n
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), csr.crow.diff(),
                                   output_size=csr.col.numel())
    if csr.out is not None:
        rows = csr.out.long()[rows]
    xg = x[csr.col]

    def prod(v):
        return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, rows, v * xg)

    a = prod(va)
    if vm is None:
        return a
    m = prod(vm)
    y = a - sigma * m
    return (y, m) if mass else y


def _room(t: torch.Tensor, count: int) -> bool:
    """Does ``t``'s storage hold ``count`` entries from its first one?"""
    return t.untyped_storage().nbytes() >= (t.storage_offset() + count) * t.element_size()


def _check_spmv(csr: TiledCSR, va, vm, x) -> None:
    n, nnz = csr.n, csr.col.numel()
    if csr.crow.dtype != torch.int64 or csr.col.dtype != torch.int32:
        raise TypeError(f"S takes int64 row pointers and int32 columns, got {csr.crow.dtype}, "
                        f"{csr.col.dtype}")
    if csr.tile_row.dtype != torch.int32 or csr.tile_ptr.dtype != torch.int64 or \
            csr.tile_row.shape != csr.tile_ptr.shape:
        raise TypeError("S takes an int32 tile_row and an int64 tile_ptr of one shape")
    if csr.out is not None and (csr.out.dtype != torch.int32 or csr.out.shape != (n,)):
        raise ValueError(f"S takes an int32 output permutation of shape ({n},)")
    for v in (va, vm):
        if v is not None and (v.dtype != torch.float64 or v.shape != csr.col.shape):
            raise ValueError("S takes f64 values, one per column index")
    if x.dtype not in _SPMV_FN or x.shape != (n,):
        raise ValueError(f"S takes an f64 or complex128 x of shape ({n},), got {x.dtype} "
                         f"{tuple(x.shape)}")
    copied = [(csr.col, _padded(nnz)), (va, _padded(nnz)), (vm, _padded(nnz)),
              (csr.crow, -(-(n + 1) // 2) * 2), (csr.out, _padded(n))]
    for t, count in copied:
        if t is not None and (t.data_ptr() % 16 or not _room(t, count)):
            raise ValueError("S copies aligned supersets: its arrays must start 16-byte aligned "
                             "and their storage must reach a multiple of 4 entries")
    _on_card([t for t in (csr.crow, csr.col, csr.tile_row, csr.tile_ptr, csr.out, va, vm, x)
              if t is not None], "csr_spmv")


def _launch(csr: TiledCSR, va, vm, x, sigma: complex, mass: bool):
    y = torch.empty(csr.n, dtype=x.dtype, device=x.device)
    ym = torch.empty_like(y) if mass else None
    err = getattr(_load(), _SPMV_FN[x.dtype])(
        csr.tile_row.data_ptr(), csr.tile_ptr.data_ptr(), csr.tile_row.numel() - 1,
        csr.crow.data_ptr(), csr.col.data_ptr(), va.data_ptr(), _ptr(vm), _ptr(csr.out),
        x.data_ptr(), y.data_ptr(), _ptr(ym), float(sigma.real), float(sigma.imag), stream())
    raise_on(err, "csr_tiled_spmv")
    return y, ym


def _count(mode: str, csr: TiledCSR) -> None:
    LAUNCHES[mode if csr.out is None else mode + ".original"] += 1


def csr_spmv(csr: TiledCSR, vals, x):
    """S, one matrix: y = A x for an f64 or complex128 x."""
    if not x.is_cuda:
        return csr_spmv_plain(csr, vals, x)
    _check_spmv(csr, vals, None, x)
    y, _ = _launch(csr, vals, None, x, 0.0, False)
    _count("spmv_complex" if x.is_complex() else "spmv_real", csr)
    return y


def csr_shifted_spmv(csr: TiledCSR, va, vm, x, sigma: complex, *, mass: bool = False):
    """S, fused pair: (A - sigma M) x for a complex128 x, or for an f64 x
    with a real sigma (then f64 out), and M x from the same pass when
    ``mass`` (then a tuple)."""
    sigma = complex(sigma)
    if not x.is_complex() and sigma.imag != 0.0:
        raise TypeError("the shifted apply on an f64 x takes a real sigma")
    if not x.is_cuda:
        return csr_spmv_plain(csr, va, x, vm, sigma if x.is_complex() else sigma.real, mass)
    _check_spmv(csr, va, vm, x)
    y, ym = _launch(csr, va, vm, x, sigma, mass)
    _count("spmv_shifted" if x.is_complex() else "spmv_shifted_real", csr)
    return (y, ym) if mass else y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "LAUNCHES", "PERMUTES", "TILE_NNZ", "TILE_ROWS", "TiledCSR", "band_kind", "build",
    "csr_shifted_spmv", "csr_spmv", "csr_spmv_plain", "gather", "gather_plain", "gather_two_pass",
    "gather_two_pass_plain", "permute_in", "permute_in_plain",
    "permute_out", "permute_out_plain", "plan_tiles", "reset_launches",
]
