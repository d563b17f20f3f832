"""Banded block substitution through the band LU factors, as hand-written
CUDA kernels: forward (K1) and backward with the inverse diagonal (K2),
each in a pivot-free mode (:class:`~lsafw_tpu_torch.solver.band.BandedLU`,
``RealBandedLU``) and a pivoted mode (``PivotedBandedLU``,
``RealPivotedBandedLU``), in complex64 with one right-hand-side column or
float32 with m = 1 or 2 columns.

``csrc/band_subst.cu`` holds the kernels (their design and bound are in
its head comment).  It is compiled with ``nvcc`` for ``sm_90a`` on first
use into ``build/kernels/``, once per block size nb in ``NBS`` (128 and
256), and loaded with ctypes.  Each wrapper takes CUDA tensors to its
kernel and CPU tensors to the plain step-by-step recursion beside it
(``*_plain``); a CUDA launch that fails, or CUDA tensors the kernels do
not take (another nb among them), raise.  ``LAUNCHES`` counts kernel
launches per kernel, mode, storage, type and nb (:func:`launch_key`:
``"K1.pivoted.c64"``, ``"K2.pivot_free.bf16.c64"``,
``"K1.pivot_free.c64.nb256"``, ...).

Layouts (the factors' own, folded as :mod:`~lsafw_tpu_torch.solver.band`
stores them): ``band`` is the (rows_total, 2B+1, nb, nb) band;
pivot-free, L sits in slots 0..B-1 and Dinv_K U_K,K+1+t in slots
B+1..2B, and ``dinv`` holds the (nblk, nb, nb) inverse diagonal blocks;
pivoted, slots 1..2B of block row K hold Uinv_K U_K,K+j, with ``L2``
(nblk, B, nb, nb) holding L2_K L1inv_K, ``L1inv`` and ``Uinv``
(nblk, nb, nb) and ``perms`` (nblk, (B+1) nb) int64 beside it.  A
pivot-free band may be stored in bf16 (the at-rest band over the memory
budget): real as bfloat16 (rows_total, 2B+1, nb, nb), complex as
bfloat16 (rows_total, 2B+1, nb, nb, 2) with (re, im) interleaved; its
Dinv stays complex64 / float32, and the plain versions widen each step's
blocks to float32 (:func:`widen`) as the kernels do.  Right-hand sides
are (nblk, nb) complex64 blocks or (nblk, nb, m) float32 blocks.  The
pivot-free B lookahead rows past nblk take a zero right-hand side and
Dinv = I (their U blocks are not folded).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from lsafw_tpu_torch.utils.cuda_build import CSRC, compile_library, raise_on, stream

TYPES = ("c64", "f32x1", "f32x2")
NBS = (128, 256)  # the block sizes the kernels are built for


def launch_key(k: str, mode: str, kind: str, bf16: bool = False, nb: int = 128) -> str:
    """The ``LAUNCHES`` key of kernel ``k`` (K1, K2) in ``mode``
    (pivot_free, pivoted) and type ``kind``, on a bf16 band or not, at
    block size ``nb``."""
    return f"{k}.{mode}{'.bf16' if bf16 else ''}.{kind}{'' if nb == 128 else f'.nb{nb}'}"


LAUNCHES = {launch_key(k, mode, t, bf16, nb): 0 for nb in NBS for bf16 in (False, True)
            for k in ("K1", "K2") for mode in ("pivot_free", "pivoted") for t in TYPES
            if not (bf16 and mode == "pivoted")}

_SRC = CSRC / "band_subst.cu"
_libs: dict[int, ctypes.CDLL] = {}


def build(nb: int = 128) -> Path:
    """Compile ``band_subst.cu`` for sm_90a at block size ``nb`` (once per
    source version) and return the shared library's path."""
    check_nb(nb)
    return compile_library(_SRC, (f"BAND_NB={nb}",))


def _load(nb: int) -> ctypes.CDLL:
    lib = _libs.get(nb)
    if lib is None:
        lib = ctypes.CDLL(str(build(nb)))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.band_fwd.argtypes = [i32, i32, p, p, p, i64, i64, i32, p]
        lib.band_fwd_pivoted.argtypes = [i32, p, p, p, p, p, i64, i32, p]
        lib.band_bwd.argtypes = [i32, i32, p, p, p, p, i64, i64, i32, i32, i32, p]
        lib.band_last_choice.argtypes = [p]
        lib.band_last_choice.restype = None
        lib.band_room.argtypes = [i32, i32, i32, i32, i32, p]
        for f in (lib.band_fwd, lib.band_fwd_pivoted, lib.band_bwd, lib.band_nb, lib.band_room):
            f.restype = ctypes.c_int
        if lib.band_nb() != nb:
            raise RuntimeError(f"{build(nb).name} was built for nb = {lib.band_nb()}, not {nb}")
        _libs[nb] = lib
    return lib


def last_choice(nb: int = 128) -> dict:
    """The last K1/K2 launch's window size (``window``: B forward, S
    backward), cluster size, ring tiles and shared-memory bytes, as the
    library of block size ``nb`` chose them for that kernel and window."""
    out = (ctypes.c_int64 * 4)()
    _load(nb).band_last_choice(out)
    return dict(zip(("window", "cluster", "tiles", "smem"), (int(v) for v in out)))


# ---------------------------------------------------------------------------
# Room: the cluster a kernel takes for a window, checked before a factor
# ---------------------------------------------------------------------------

# ``csrc/band_subst.cu``'s shared-memory plan (kSmemMax, kMaxTiles,
# kMaxCluster; Tr::Vec and Tr::Mat bytes per type and storage)
SMEM_MAX, MAX_TILES, MAX_CLUSTER = 232448, 64, 16
_VEC_BYTES = {"c64": 8, "f32x1": 4, "f32x2": 8}
_MAT_BYTES = {("c64", False): 8, ("f32x1", False): 4, ("f32x2", False): 4,
              ("c64", True): 4, ("f32x1", True): 2, ("f32x2", True): 2}


class NoRoom(RuntimeError):
    """K1 or K2 cannot hold a factor's window in a block's shared memory at
    any cluster size: the plan is refused before its factor is built."""


def _align128(n: int) -> int:
    return (n + 127) & ~127


def _layout_total(nt: int, tile: int, side: int, rest: int) -> int:
    """``Layout(nt, tile, side, rest).total``: the mbarriers, the ring of nt
    tiles, two side buffers, then the windows and partial sums."""
    return _align128(8 * (nt + 3)) + _align128(nt * tile) + 2 * _align128(side) + rest


def window(k: str, mode: str, B: int) -> int:
    """The window size a kernel is launched with: B forward; backward B
    pivot-free and 2B pivoted (U widens to 2B upper blocks)."""
    return 2 * B if (k == "K2" and mode == "pivoted") else B


def room(k: str, mode: str, kind: str, B: int, nb: int = 128, bf16: bool = False) -> dict | None:
    """The cluster, ring tiles and shared-memory bytes a block of K1 or K2
    (``k``) takes in ``mode`` and type ``kind`` for a factor of B
    off-diagonal blocks at block size ``nb``: the largest cluster of 16, 8,
    ..., 1 blocks whose windows and one ring tile fit 232,448 B, by the
    formula ``choose`` in ``csrc/band_subst.cu`` applies before it asks the
    card whether it can co-schedule the cluster (:func:`query_room` asks);
    None where no cluster fits.  A pure function: it needs no card."""
    v, w = _VEC_BYTES[kind], window(k, mode, B)
    mat = _MAT_BYTES[(kind, bf16 and k == "K1")]  # K2's ring streams the f32/c64 Dinv tiles
    c = MAX_CLUSTER
    while c >= 1:
        rc, rw = nb // c, w * nb // c
        if k == "K2":
            side, rest = nb * v, v * ((w + 1) * nb + rc * (w + 1))
        elif mode == "pivoted":  # perm head, my perm tail, the fresh block; 2 windows, f[:nb], part
            side = _align128(nb * 8) + _align128(rw * 8) + nb * v
            rest = v * (2 * (w + 1) * nb + nb + rc + rw)
        else:  # my b slice; the window ring, part
            side, rest = rc * v, v * ((w + 1) * nb + rc * w)
        tile = rc * nb * mat
        fixed = _layout_total(0, tile, side, rest)
        if fixed + 8 * MAX_TILES + tile <= SMEM_MAX:
            nt = min((SMEM_MAX - fixed - 8 * MAX_TILES) // tile, MAX_TILES)
            return dict(cluster=c, tiles=nt, smem=_layout_total(nt, tile, side, rest))
        c //= 2
    return None


def query_room(k: str, mode: str, kind: str, B: int, nb: int = 128,
               bf16: bool = False) -> dict | None:
    """:func:`room` as the card answers it: the library's ``band_room``
    runs the launch's own ``choose`` (the card's co-scheduling included)
    without launching, and keeps the choice for the launches; None where
    no cluster fits (CUDA error 9).  Needs the current CUDA device."""
    out = (ctypes.c_int64 * 3)()
    err = _load(nb).band_room(0 if k == "K1" else 1, _code(kind), int(bf16),
                              int(mode == "pivoted"), window(k, mode, B), out)
    if err == 9:  # cudaErrorInvalidConfiguration: no cluster fits
        return None
    raise_on(err, f"band_room ({k} {mode} {kind})")
    return dict(zip(("cluster", "tiles", "smem"), (int(x) for x in out)))


def require_room(mode: str, kinds: tuple, B: int, nb: int, *, bf16: bool = False,
                 device=None) -> None:
    """Raise :class:`NoRoom`, naming the kernel, mode, type, B and nb,
    where K1 or K2 cannot take a factor of B off-diagonal blocks at block
    size ``nb`` in ``mode`` for each right-hand-side type of ``kinds``:
    on a CUDA ``device`` through :func:`query_room`, elsewhere by
    :func:`room`'s formula (for the nb the kernels are built for; the plain
    versions take any nb).  Called before any factor work."""
    on_card = device is not None and torch.device(device).type == "cuda"
    if not on_card and nb not in NBS:
        return
    for kind in kinds:
        for k in ("K1", "K2"):
            fit = (query_room if on_card else room)(k, mode, kind, B, nb, bf16)
            if fit is None:
                raise NoRoom(
                    f"{k} {mode}{' bf16' if bf16 else ''} {kind} finds no room at nb = {nb}, "
                    f"B = {B}: its window of {window(k, mode, B)} block rows and one ring tile "
                    f"exceed a block's {SMEM_MAX} B of shared memory at every cluster size")


def check_nb(nb: int) -> None:
    """Raise unless the kernels are built for block size ``nb``."""
    if nb not in NBS:
        raise ValueError(f"the CUDA band kernels are built for nb in {NBS}, got nb={nb}")


# ---------------------------------------------------------------------------
# bf16 band storage
# ---------------------------------------------------------------------------


def band_is_complex(band: torch.Tensor) -> bool:
    """A complex64 band, or a bf16 one with a trailing (re, im) axis."""
    return band.is_complex() or (band.dtype == torch.bfloat16 and band.dim() == 5)


def widen(blocks: torch.Tensor, cplx: bool) -> torch.Tensor:
    """bf16 band blocks as complex64 (``cplx``: (..., 2) pairs) or float32,
    the types their products run in; other blocks as they are."""
    if blocks.dtype != torch.bfloat16:
        return blocks
    return torch.view_as_complex(blocks.float()) if cplx else blocks.float()


def narrow(blocks: torch.Tensor) -> torch.Tensor:
    """float32 or complex64 blocks rounded (once) to the bf16 storage."""
    if blocks.is_complex():
        return torch.view_as_real(blocks).to(torch.bfloat16)
    return blocks.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def compute_dtype(factor: torch.Tensor) -> torch.dtype:
    """The type a factor's products run in: complex64 or float32 (a bf16
    band's widened type)."""
    if factor.dtype == torch.bfloat16:
        return torch.complex64 if band_is_complex(factor) else torch.float32
    if factor.dtype not in (torch.complex64, torch.float32):
        raise TypeError(f"band substitution takes complex64, float32 or bf16 factors, got "
                        f"{factor.dtype}")
    return factor.dtype


def _kind(factor: torch.Tensor, v: torch.Tensor, what: str) -> str:
    """The type of a (factor, right-hand side) pair: ``c64`` for a
    complex factor with complex64 (rows, nb) blocks, ``f32x<m>`` for a
    real factor with float32 (rows, nb, m) blocks, m in (1, 2)."""
    dtype = compute_dtype(factor)
    if v.dtype != dtype:
        raise TypeError(f"{what} must be {dtype} like the factor, got {v.dtype}")
    if dtype == torch.complex64:
        if v.dim() != 2:
            raise ValueError(f"{what} of a complex factor must be (rows, nb), got {tuple(v.shape)}")
        return "c64"
    if v.dim() != 3 or v.shape[2] not in (1, 2):
        raise ValueError(f"{what} of a real factor must be (rows, nb, m) with m in (1, 2), "
                         f"got {tuple(v.shape)}")
    return f"f32x{v.shape[2]}"


def _band_geometry(band: torch.Tensor) -> tuple[int, int]:
    dims = 5 if band.dtype == torch.bfloat16 and band.dim() == 5 else 4
    if (band.dim() != dims or band.shape[2] != band.shape[3] or band.shape[1] % 2 != 1
            or (dims == 5 and band.shape[4] != 2)):
        raise ValueError(f"band must be (rows_total, 2B+1, nb, nb), or (..., 2) complex bf16, got "
                         f"{tuple(band.shape)} {band.dtype}")
    return (band.shape[1] - 1) // 2, band.shape[2]


def _shape(t: torch.Tensor, shape: tuple, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")


def _same(factor: torch.Tensor, tensors: list) -> None:
    """One device for the factor tensors and one compute dtype for those
    that are not the (possibly bf16) ``factor``; on the card, what the
    kernels take: contiguous 16-byte aligned tensors and nb in ``NBS``.
    (A carry window too large for shared memory fails the launch.)"""
    dtype = compute_dtype(factor)
    for t in tensors:
        if t.device != factor.device:
            raise ValueError("band substitution tensors must share one device")
        if t is not factor and (t.is_floating_point() or t.is_complex()) and t.dtype != dtype:
            raise TypeError(f"band substitution factors must share one dtype ({dtype}), got "
                            f"{t.dtype}")
    if not factor.is_cuda:
        return
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("band substitution tensors must be contiguous and 16-byte aligned")
    check_nb(factor.shape[2])


def _check_fwd(band: torch.Tensor, b: torch.Tensor) -> tuple[int, int, str]:
    """K1 pivot-free: b is (nblk <= rows_total, nb[, m]); returns (B, nb, kind)."""
    B, nb = _band_geometry(band)
    kind = _kind(band, b, "right-hand side")
    if b.shape[1] != nb or b.shape[0] > band.shape[0]:
        raise ValueError(f"right-hand side must be (nblk <= {band.shape[0]}, {nb}, ...), "
                         f"got {tuple(b.shape)}")
    _same(band, [band, b])
    return B, nb, kind


def _check_bwd(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor, *, pivoted: bool
               ) -> tuple[int, int, str]:
    """K2: y is K1's full output, (rows_total, nb[, m]) pivot-free or
    (nblk, nb[, m]) pivoted; dinv (Uinv pivoted) is (nblk, nb, nb).  A
    pivoted factor is never stored in bf16."""
    B, nb = _band_geometry(band)
    if pivoted and band.dtype == torch.bfloat16:
        raise TypeError("a pivoted factor's band is complex64 or float32, never bf16")
    kind = _kind(band, y, "y")
    nblk = dinv.shape[0]
    rows = nblk if pivoted else band.shape[0]
    if nblk > band.shape[0]:
        raise ValueError(f"{nblk} diagonal blocks for a band of {band.shape[0]} rows")
    _shape(dinv, (nblk, nb, nb), "Uinv" if pivoted else "dinv")
    _shape(y, (rows, nb) + tuple(y.shape[2:]), "y")
    _same(band, [band, dinv, y])
    return B, nb, kind


def _check_fwd_pivoted(L2: torch.Tensor, L1inv: torch.Tensor, perms: torch.Tensor,
                       b: torch.Tensor) -> tuple[int, int, str]:
    """K1 pivoted: L2 (nblk, B, nb, nb), L1inv (nblk, nb, nb), perms
    (nblk, (B+1) nb) int64, b (nblk, nb[, m])."""
    if L2.dim() != 4 or L2.shape[2] != L2.shape[3]:
        raise ValueError(f"L2 must be (nblk, B, nb, nb), got {tuple(L2.shape)}")
    if L2.dtype == torch.bfloat16:
        raise TypeError("a pivoted factor's L2 is complex64 or float32, never bf16")
    nblk, B, nb = L2.shape[0], L2.shape[1], L2.shape[2]
    kind = _kind(L2, b, "right-hand side")
    _shape(L1inv, (nblk, nb, nb), "L1inv")
    _shape(b, (nblk, nb) + tuple(b.shape[2:]), "right-hand side")
    if perms.dtype != torch.int64:
        raise TypeError(f"perms must be int64, got {perms.dtype}")
    _shape(perms, (nblk, (B + 1) * nb), "perms")
    _same(L2, [L2, L1inv, perms, b])
    return B, nb, kind


# ---------------------------------------------------------------------------
# Plain versions: the step-by-step recursions in torch
# ---------------------------------------------------------------------------


def _cols(v: torch.Tensor) -> torch.Tensor:
    """(rows, nb[, m]) blocks as (rows, nb, m)."""
    return v[:, :, None] if v.is_complex() else v


def _like(out: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(rows, nb, m) blocks back in the layout of ``v``."""
    return out[:, :, 0] if v.is_complex() else out


def fwd_substitute_plain(band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y_K = b_K - sum_{t<B} L[K,t] y_{K-B+t}, K ascending; (rows_total, nb[, m])."""
    B, nb, _ = _check_fwd(band, b)
    b3 = _cols(b)
    rows_total, nblk, m = band.shape[0], b3.shape[0], b3.shape[2]
    cplx = band_is_complex(band)
    y = torch.zeros((B + rows_total, nb, m), dtype=b.dtype, device=b.device)  # B zero rows first
    y[B:B + nblk] = b3
    for k in range(rows_total):
        y[B + k] -= torch.bmm(widen(band[k, :B], cplx), y[k:k + B]).sum(0)
    return _like(y[B:], b)


def bwd_substitute_plain(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x_K = Dinv_K y_K - sum_{t<B} (Dinv_K U)[K,B+1+t] x_{K+1+t}, K
    descending (Dinv = I past nblk); returns the first nblk =
    dinv.shape[0] blocks."""
    B, nb, _ = _check_bwd(band, dinv, y, pivoted=False)
    y3 = _cols(y)
    rows_total, nblk, m = band.shape[0], dinv.shape[0], y3.shape[2]
    cplx = band_is_complex(band)
    x = torch.zeros((rows_total + B, nb, m), dtype=y.dtype, device=y.device)  # B zero rows last
    for k in range(rows_total - 1, -1, -1):
        yk = dinv[k] @ y3[k] if k < nblk else y3[k]
        x[k] = yk - torch.bmm(widen(band[k, B + 1:], cplx), x[k + 1:k + 1 + B]).sum(0)
    return _like(x[:nblk], y)


def fwd_substitute_pivoted_plain(L2: torch.Tensor, L1inv: torch.Tensor, perms: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Forward through the panel-pivoted factors, per block row K: permute
    the window of rows K..K+B (updated in place in ``work``) by the panel
    permutation, y_K = L1^-1 f[:nb], and rows K+1..K+B become
    f[nb:] - (L2 L1^-1) f[:nb]; (nblk, nb[, m])."""
    B, nb, _ = _check_fwd_pivoted(L2, L1inv, perms, b)
    b3 = _cols(b)
    nblk, m = b3.shape[0], b3.shape[2]
    work = torch.zeros(((nblk + B + 1) * nb, m), dtype=b.dtype, device=b.device)
    work[:nblk * nb] = b3.reshape(nblk * nb, m)
    y = torch.empty((nblk, nb, m), dtype=b.dtype, device=b.device)
    L2m = L2.reshape(nblk, B * nb, nb)
    for k in range(nblk):
        win = work[k * nb:(k + B + 1) * nb]
        f = win.index_select(0, perms[k])
        torch.mm(L1inv[k], f[:nb], out=y[k])
        torch.addmm(f[nb:], L2m[k], f[:nb], alpha=-1, out=win[nb:])
    return _like(y, b)


def bwd_substitute_pivoted_plain(band: torch.Tensor, Uinv: torch.Tensor,
                                 y: torch.Tensor) -> torch.Tensor:
    """Backward through the panel-pivoted factors:
    x_K = U_KK^-1 y_K - sum_j (U_KK^-1 U_{K,K+j}) x_{K+j}, j = 1..2B;
    (nblk, nb[, m])."""
    B, nb, _ = _check_bwd(band, Uinv, y, pivoted=True)
    y3 = _cols(y)
    nblk, m = y3.shape[0], y3.shape[2]
    x = torch.zeros(((nblk + 2 * B) * nb, m), dtype=y.dtype, device=y.device)
    for k in range(nblk - 1, -1, -1):
        X = x[(k + 1) * nb:(k + 1 + 2 * B) * nb].view(2 * B, nb, m)
        x[k * nb:(k + 1) * nb] = Uinv[k] @ y3[k] - torch.bmm(band[k, 1:], X).sum(0)
    return _like(x[:nblk * nb].view(nblk, nb, m), y)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _code(kind: str) -> int:
    return TYPES.index(kind)


def fwd_substitute(band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 pivot-free: forward substitution through L; (rows_total, nb[, m])
    out."""
    if not band.is_cuda:
        return fwd_substitute_plain(band, b)
    B, nb, kind = _check_fwd(band, b)
    bf16 = band.dtype == torch.bfloat16
    y = torch.empty((band.shape[0],) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
    err = _load(nb).band_fwd(_code(kind), int(bf16), band.data_ptr(), b.data_ptr(), y.data_ptr(),
                             band.shape[0], b.shape[0], B, stream())
    raise_on(err, "band_fwd_kernel")
    LAUNCHES[launch_key("K1", "pivot_free", kind, bf16, nb)] += 1
    return y


def bwd_substitute(band: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2 pivot-free: backward substitution through U with the Dinv
    product; (nblk, nb[, m]) out."""
    if not band.is_cuda:
        return bwd_substitute_plain(band, dinv, y)
    B, nb, kind = _check_bwd(band, dinv, y, pivoted=False)
    bf16 = band.dtype == torch.bfloat16
    nblk = dinv.shape[0]
    x = torch.empty((nblk,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    err = _load(nb).band_bwd(_code(kind), int(bf16), band.data_ptr(), dinv.data_ptr(),
                             y.data_ptr(), x.data_ptr(), band.shape[0], nblk, 2 * B + 1, B + 1, B,
                             stream())
    raise_on(err, "band_bwd_kernel")
    LAUNCHES[launch_key("K2", "pivot_free", kind, bf16, nb)] += 1
    return x


def fwd_substitute_pivoted(L2: torch.Tensor, L1inv: torch.Tensor, perms: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """K1 pivoted: forward through the panel permutations, L1^-1 and the
    L2 window update; (nblk, nb[, m]) out."""
    if not L2.is_cuda:
        return fwd_substitute_pivoted_plain(L2, L1inv, perms, b)
    B, nb, kind = _check_fwd_pivoted(L2, L1inv, perms, b)
    y = torch.empty_like(b)
    err = _load(nb).band_fwd_pivoted(_code(kind), L2.data_ptr(), L1inv.data_ptr(),
                                     perms.data_ptr(), b.data_ptr(), y.data_ptr(), b.shape[0], B,
                                     stream())
    raise_on(err, "band_fwd_kernel (pivoted)")
    LAUNCHES[launch_key("K1", "pivoted", kind, nb=nb)] += 1
    return y


def bwd_substitute_pivoted(band: torch.Tensor, Uinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2 pivoted: backward through the 2B upper slots with U^-1;
    (nblk, nb[, m]) out."""
    if not band.is_cuda:
        return bwd_substitute_pivoted_plain(band, Uinv, y)
    B, nb, kind = _check_bwd(band, Uinv, y, pivoted=True)
    nblk = Uinv.shape[0]
    x = torch.empty_like(y)
    err = _load(nb).band_bwd(_code(kind), 0, band.data_ptr(), Uinv.data_ptr(), y.data_ptr(),
                             x.data_ptr(), nblk, nblk, 2 * B + 1, 1, 2 * B, stream())
    raise_on(err, "band_bwd_kernel (pivoted)")
    LAUNCHES[launch_key("K2", "pivoted", kind, nb=nb)] += 1
    return x


def solve_banded(band: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivot-free solve: K1 then K2; (nblk, nb[, m]) in and out."""
    return bwd_substitute(band, dinv, fwd_substitute(band, b))


def solve_pivoted(band: torch.Tensor, L2: torch.Tensor, L1inv: torch.Tensor, Uinv: torch.Tensor,
                  perms: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivoted solve: K1 then K2, both pivoted; (nblk, nb[, m]) in and out."""
    return bwd_substitute_pivoted(band, Uinv, fwd_substitute_pivoted(L2, L1inv, perms, b))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "LAUNCHES", "NBS", "NoRoom", "TYPES", "band_is_complex", "build", "bwd_substitute",
    "bwd_substitute_pivoted", "bwd_substitute_pivoted_plain", "bwd_substitute_plain",
    "check_nb", "compute_dtype", "fwd_substitute", "fwd_substitute_pivoted",
    "fwd_substitute_pivoted_plain", "fwd_substitute_plain", "last_choice", "launch_key", "narrow",
    "query_room", "require_room", "reset_launches", "room", "solve_banded", "solve_pivoted",
    "widen",
]
