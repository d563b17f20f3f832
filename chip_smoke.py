#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1 and 2 only, no result lines

Phases, one or more lines each (a failure raises and the exit code is
non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build:
     ``csrc/band_subst.cu`` and ``csrc/spmv_gather.cu``, one nvcc each,
     started together;
  2. kernels against their plain PyTorch versions on the card, relative
     error <= 1e-5: the band substitution K1/K2 in both modes and every
     type (complex64; float32 with one and two columns) on random factors
     at the 43k cylinder shapes (B = 7, nb = 128, 384 block rows) and at
     the 167k mesh's B = 26 with 32 block rows: pivot-free on a random
     band scaled by 2e-3, pivoted on a random band that needs pivoting
     within and across block rows, factored on the card by the port's
     ``_pfactor`` (each pair is timed once); the gather G against
     ``x[idx]`` at the probes' shapes (``run_a``: x 2^17 f32, idx
     (1024, 16); ``pallas_two_pass``: x (4096, 128) f32, 2^18 x 128
     lane-unique indices), exact; G's permute-in and permute-out in every
     type pair (f64 / complex128 into complex64, float32 x1 and x2, and
     back) on a random padded permutation, exact; S in every mode (real,
     complex, shifted, shifted with M x) and both orders against its
     plain version, relative error <= 1e-12 (``SPMV_REL_TOL``), on a
     random matrix with empty rows, tiles of the most rows a tile holds
     and a row longer than a tile;
  3. this slice's main path, the reference's device path
     (``bench.py`` ``_pipeline``): the reduced cylinder (43,671
     Taylor-Hood DOFs) at Re = 47, ramped Newton baseflow on the banded
     inner solve (real pivoted band factors, GCR refinement whose
     matvecs run through S), eigensystem, and the shift-invert
     Krylov-Schur at 0.74j on the default pivoted complex factor with the
     fused (A, M) refinement matvecs (S).  Host LU and the torch
     substitution loops are patched to raise (the loops on a CUDA
     tensor).  Launch counts are zeroed just before and read after each
     stage: the leading eigenvalue must be within 1e-4 of +0.0050+0.7526j
     and within 5e-7 of the card's recorded +0.004991+0.752636j, with
     residual <= 1e-8; in each stage K1/K2 once per band solve (pivoted
     f32 with one column in the baseflow, pivoted complex64 in the eigen
     stage), G's permute-in and permute-out once each per band solve in
     the factor's type, no flat-form complex128 G, and exactly one S
     launch, in the original order, per original-order matvec
     (``matvecs()`` counts them);
  3b. the pivot-free path on the same (A, M): ``LSAFW_PIVOT_MEM_GB=0``
     takes the pivot-free factor, whose substitution runs through K1/K2
     pivot-free (counts zeroed just before, read after): sigma within
     1e-8 of phase 3's, the residual gate, the launch gates of phase 3,
     and the card's factor contracting within 3x of the same factor
     built in f32 on the host CPU;
  4. S against its plain version on the slice's (A, M) at sigma = 0.74j
     in each mode and order (relative error <= 1e-12); G against its
     plain versions on the main path's own inputs, exact: the f64 CSR
     value refill (nnz indices), the complex128 flat gather, and the
     permute forms on the eigen stage's complex plan and the baseflow's
     real plan; K1/K2 in each mode and type against their plain versions
     on the main path's own factors (the eigen stage's pivoted factor,
     phase 3b's pivot-free one, and a real pivoted and pivot-free factor
     on the baseflow's plan), and the times (medians of CUDA-event
     timings: K1/K2 one call at a time, each band being larger than L2;
     G and S with the L2 cache evicted before each call, as the main
     path's band solves leave it) of every kernel beside its plain
     version, bound and library call (for the permute forms also the op
     sequence they replace); one pivoted solve against the torch loops,
     the panel LU backends, and the device operations, wall time and
     busy share of one pivoted shift-invert apply and of eight GCR
     iterations of a real banded solve under ``torch.profiler``.

The last lines are the card's name and power limit, one JSON object of
kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

SIGMA_REF = 0.0050 + 0.7526j  # reduced cylinder at Re = 47, recorded to 4 digits
SIGMA_CARD = 0.004991 + 0.752636j  # the port's sigma on the H100, as printed to 6 digits
TARGET = 0.74j
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
REL_TOL = 1e-5
DEVICE = "cuda"
PHASE2_SHAPES = ((7, 384), (26, 32))  # (B, nblk): the 43k cylinder's, the 167k mesh's B with few rows
SPMV_REL_TOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median device time of one call of ``fn``: ``calls`` calls captured
    in one CUDA graph (so no host launch overhead between them), replayed
    ``reps`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


_FLUSH: list = []


def cold_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with the L2 cache cold: the graph
    time of ``calls`` x (a 128 MB write, which evicts the 50 MB L2, then
    ``fn``) less that of the writes alone.  Warm replays of one call keep
    a working set under 50 MB in L2, where it can beat the HBM bound; on
    the main path the band solves between two calls evict it."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    flush = _FLUSH[0]
    return graph_ms(lambda: (flush.zero_(), fn()), calls, reps) - graph_ms(flush.zero_, calls, reps)


def device_busy(fn) -> tuple[float, float, int]:
    """(wall ms, device-busy ms, device operations) of one synchronised call
    of ``fn`` under ``torch.profiler``: the kernels' summed self time, and
    the count of kernels, copies and fills the card ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) / 1e3
    ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy, ops


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def bound(nbytes: float, ops: float, flops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) from the bytes moved and the operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def build_all() -> None:
    """nvcc on both CUDA sources at once."""
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda
    from lsafw_tpu_torch.utils.cuda_build import BUILD_LOGS

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(lambda m: m.build(), (band_cuda, spmv_cuda)))
    log(f"phase 1: built {', '.join(p.name for p in libs)} in {time.time() - t0:.1f} s")
    for src, text in BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


# ---------------------------------------------------------------------------
# K1/K2
# ---------------------------------------------------------------------------


def kinds(factor) -> tuple[str, ...]:
    """The right-hand-side types a factor takes: one complex64 column, or
    one or two float32 columns."""
    return ("c64",) if factor.band.is_complex() else ("f32x1", "f32x2")


def mode_of(factor) -> str:
    return "pivoted" if hasattr(factor, "perms") else "pivot_free"


def rhs(kind: str, nblk: int, nb: int, device, seed: int):
    """(nblk, nb) complex64 or (nblk, nb, m) float32 blocks from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "c64":
        return torch.randn((nblk, nb), dtype=torch.complex64, generator=g, device=device)
    return torch.randn((nblk, nb, int(kind[-1])), generator=g, device=device)


def substitutions(f) -> tuple:
    """(K1, K1 plain, K2, K2 plain) of a factor in its mode: K1 takes b,
    K2 takes K1's result."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    if mode_of(f) == "pivoted":
        return (lambda b: bc.fwd_substitute_pivoted(f.L2, f.L1inv, f.perms, b),
                lambda b: bc.fwd_substitute_pivoted_plain(f.L2, f.L1inv, f.perms, b),
                lambda y: bc.bwd_substitute_pivoted(f.band, f.Uinv, y),
                lambda y: bc.bwd_substitute_pivoted_plain(f.band, f.Uinv, y))
    return (lambda b: bc.fwd_substitute(f.band, b),
            lambda b: bc.fwd_substitute_plain(f.band, b),
            lambda y: bc.bwd_substitute(f.band, f.dinv, y),
            lambda y: bc.bwd_substitute_plain(f.band, f.dinv, y))


def check_kernels(f, b, what: str, tol: float = REL_TOL) -> dict:
    """K1 and K2 of the factor's mode against their plain versions on the
    same inputs (K2 takes the plain forward result for both)."""
    import torch

    fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
    y_ref = fwd_plain(b)
    y = fwd(b)
    x_ref = bwd_plain(y_ref)
    x = bwd(y_ref)
    torch.cuda.synchronize()
    out = {"K1": rel_err(y, y_ref), "K2": rel_err(x, x_ref)}
    for k, (a, r) in out.items():
        log(f"  {what}: {k} {mode_of(f)} {kind_name(b)}: max abs err {a:.3e}, rel {r:.3e} "
            f"(limit {tol:.0e})")
        if not np.isfinite(r) or r > tol:
            raise RuntimeError(f"{what}: {k} ({mode_of(f)}, {kind_name(b)}) disagrees with its plain "
                               f"version (rel {r:.3e})")
    return out


def kind_name(b) -> str:
    return "c64" if b.is_complex() else f"f32x{b.shape[2]}"


def random_band(B: int, nb: int, rows_total: int, nblk: int, device, real: bool = False):
    """A random factored pivot-free band and Dinv (scaled by 2e-3 so the
    recursion stays bounded)."""
    import torch

    rng = np.random.default_rng(0)

    def rand(shape, scale):
        z = rng.standard_normal(shape + (1 if real else 2,), dtype=np.float32) * np.float32(scale)
        t = torch.from_numpy(z[..., 0] if real else z)
        return (t if real else torch.view_as_complex(t)).to(device)

    eye = torch.eye(nb, dtype=torch.float32 if real else torch.complex64, device=device)
    return SimpleNamespace(band=rand((rows_total, 2 * B + 1, nb, nb), 2e-3),
                           dinv=(rand((nblk, nb, nb), 2e-3) + eye).contiguous())


def random_pivoted(B: int, nb: int, nblk: int, device, real: bool = False):
    """A random band that needs pivoting, factored on the card by the
    port's ``_pfactor``.  The matrix is a row permutation of I + 0.005 N
    (N standard normal, zero in the band's two outermost slots): half the
    rows of each even block row trade places with rows of the next block
    row, and the rows inside each diagonal block are shuffled.  So the
    panel LU pivots within and across block rows, and the factor is well
    conditioned: f32 solves agree with f64 to about 3e-7 (a CPU run at
    B = 7, 24 block rows)."""
    import torch
    from lsafw_tpu_torch.solver import band as tband

    g = torch.Generator().manual_seed(0)
    rows_total, R = nblk + B, 2 * B + 1

    def noise():
        return torch.randn((rows_total, R, nb, nb), generator=g) * 0.005

    band = noise() if real else torch.complex(noise(), noise())
    band[:, 0] = 0
    band[:, 2 * B] = 0
    band[:, B] += torch.eye(nb)
    band = band.to(device)
    for K in range(0, nblk - 1, 2):
        a, a2 = (torch.randperm(nb, generator=g)[:nb // 2].to(device) for _ in range(2))
        row_a, row_b = band[K, :, a].clone(), band[K + 1, :, a2].clone()
        band[K, :, a] = torch.cat([torch.zeros_like(row_b[:1]), row_b[:-1]])  # one slot right
        band[K + 1, :, a2] = torch.cat([row_a[1:], torch.zeros_like(row_a[:1])])  # one slot left
    for K in range(nblk):
        band[K] = band[K][:, torch.randperm(nb, generator=g).to(device)]
    L2, L1inv, Uinv, perms = tband._pfactor(band, nblk, 0.0)
    return SimpleNamespace(band=band, L2=L2, L1inv=L1inv, Uinv=Uinv, perms=perms)


def subst_bounds(f, kind: str) -> dict:
    """Least time of K1 and K2 of a factor in its mode from the bytes they
    must move (each factor input read once, right-hand side and result
    once each) and their float32 operations (a complex multiply-add is 8
    flops, a real one 2 per column)."""
    e = f.band.element_size()
    v = 8 if kind == "c64" else 4 * int(kind[-1])
    per_entry = 8 if kind == "c64" else 2 * int(kind[-1])
    nb = f.band.shape[-1]
    B = (f.band.shape[1] - 1) // 2
    if mode_of(f) == "pivoted":
        nblk = f.L1inv.shape[0]
        fwd_entries = nblk * (B + 1) * nb * nb  # L2 and L1inv
        fwd_bytes = fwd_entries * e + f.perms.numel() * 8 + 2 * nblk * nb * v
        bwd_entries = nblk * (2 * B + 1) * nb * nb  # 2B U slots and Uinv
        bwd_bytes = bwd_entries * e + 2 * nblk * nb * v
    else:
        rows_total, nblk = f.band.shape[0], f.dinv.shape[0]
        fwd_entries = rows_total * B * nb * nb
        fwd_bytes = fwd_entries * e + (nblk + rows_total) * nb * v
        bwd_entries = fwd_entries + nblk * nb * nb
        bwd_bytes = bwd_entries * e + (rows_total + nblk) * nb * v
    return {"K1": bound(fwd_bytes, fwd_entries * per_entry, FP32_FLOPS_PER_S),
            "K2": bound(bwd_bytes, bwd_entries * per_entry, FP32_FLOPS_PER_S)}


PLAIN_LOOPS = ("fwd_substitute_plain", "bwd_substitute_plain", "fwd_substitute_pivoted_plain",
               "bwd_substitute_pivoted_plain")


@contextmanager
def plain_loops_forbidden():
    """While the block runs, the torch substitution loops raise on a CUDA
    tensor: the card path must run the kernels.  (The host-f32 factor of
    phase 3b takes them on CPU tensors.)"""
    from lsafw_tpu_torch.solver import band_cuda as bc

    saved = {name: getattr(bc, name) for name in PLAIN_LOOPS}

    def guard(name, plain):
        def no_loop_on_card(*args):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise RuntimeError(f"band_cuda.{name} ran on a CUDA tensor")
            return plain(*args)

        return no_loop_on_card

    for name, plain in saved.items():
        setattr(bc, name, guard(name, plain))
    try:
        yield
    finally:
        for name, plain in saved.items():
            setattr(bc, name, plain)


@contextmanager
def band_solves():
    """Count band solves (``solve`` of any band factor) per factor class
    while the block runs."""
    from lsafw_tpu_torch.solver import band as tband

    seen: dict = {}
    solve = tband._PermutedSolve.solve

    def counted(self, b):
        seen[type(self).__name__] = seen.get(type(self).__name__, 0) + 1
        return solve(self, b)

    tband._PermutedSolve.solve = counted
    try:
        yield seen
    finally:
        tband._PermutedSolve.solve = solve


@contextmanager
def matvecs():
    """Count the original-order matvecs of the refinement operators
    (``BCSROperator.matvec``, which ``matvec_pair`` calls, and
    ``BCSRShiftedOp.matvec_pair`` / ``mass_pair``) while the block runs."""
    from lsafw_tpu_torch.ops import bcsr

    seen = {"matvecs": 0}
    methods = [(bcsr.BCSROperator, "matvec"), (bcsr.BCSRShiftedOp, "matvec_pair"),
               (bcsr.BCSRShiftedOp, "mass_pair")]
    saved = [getattr(cls, name) for cls, name in methods]

    def counted(fn):
        def call(*args, **kw):
            seen["matvecs"] += 1
            return fn(*args, **kw)

        return call

    for (cls, name), fn in zip(methods, saved):
        setattr(cls, name, counted(fn))
    try:
        yield seen
    finally:
        for (cls, name), fn in zip(methods, saved):
            setattr(cls, name, fn)


def gate_permutes_and_spmv(what: str, launches: dict, types: str, solves: int,
                           n_matvecs: int) -> None:
    """G's permute-in and permute-out once each per band solve, in the
    stage's types (``"f64.f32x1"``: an f64 vector into one float32
    column and back); no flat-form complex128 G; and exactly one S launch,
    in the original order, per original-order matvec."""
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    src, kind = types.split(".")
    pin = {t: launches[f"permute_in.{t}"] for t in sc.PERMUTES["in"]}
    pout = {t: launches[f"permute_out.{t}"] for t in sc.PERMUTES["out"]}
    s_orig = sum(launches[m + ".original"] for m in sc.SPMV_KEYS)
    s_perm = sum(launches[m] for m in sc.SPMV_KEYS)
    if not (pin[types] == pout[f"{kind}.{src}"] == sum(pin.values()) == sum(pout.values())
            == solves > 0):
        raise RuntimeError(f"{what}: permute-in {pin} and permute-out {pout} for {solves} band "
                           f"solves of types {types}")
    if launches["gather_c128"]:
        raise RuntimeError(f"{what}: {launches['gather_c128']} flat-form complex128 G launches")
    if not (s_orig == n_matvecs > 0) or s_perm:
        raise RuntimeError(f"{what}: {s_orig} original-order and {s_perm} permuted S launches for "
                           f"{n_matvecs} original-order matvecs")


def gate_band_launches(what: str, launches: dict, key: str, solves: int) -> None:
    """K1 and K2 in one mode and type launched once per band solve, and no
    other band substitution launched."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    k1, k2 = launches[f"K1.{key}"], launches[f"K2.{key}"]
    others = {k: launches[k] for k in bc.LAUNCHES if key not in k and launches[k]}
    if not (k1 == k2 == solves > 0) or others:
        raise RuntimeError(f"{what}: K1/K2 {key} launched {k1}/{k2} times for {solves} band "
                           f"solves (other band launches {others})")


# ---------------------------------------------------------------------------
# G
# ---------------------------------------------------------------------------


def gather_inputs(device, *, Na: int = 1 << 17, R: int = 1024, W: int = 16, N: int = 1 << 19,
                  M: int = 1 << 18) -> dict:
    """The probes' inputs from seeds: ``run_a`` (flat) and
    ``pallas_two_pass`` (lane-unique rows of 128, as the probe builds them),
    at the probes' sizes by default."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    xa = torch.randn(Na, generator=g, device=device)
    idx = torch.randint(0, Na, (R, W), generator=g, device=device, dtype=torch.int32)
    x = torch.randn(N, generator=g, device=device)
    rows = torch.randint(0, N // 128, (M, 128), generator=g, device=device, dtype=torch.int32)
    perm = torch.argsort(torch.rand((M, 128), generator=g, device=device), dim=1)
    lanes = perm.to(torch.int32)  # a shuffle of 0..127 per row
    rowsel = torch.gather(rows, 1, torch.argsort(perm, dim=1)).contiguous()
    flat = (rows.long() * 128 + lanes).to(torch.int32)
    return dict(xa=xa, idx=idx, x=x, x2d=x.view(N // 128, 128), rowsel=rowsel, lanesel=lanes,
                flat=flat)


def check_gather(gi: dict) -> dict:
    """G against ``x[idx]`` in both forms: exact."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    out = {}
    ya = sc.gather(gi["xa"], gi["idx"])
    y2 = sc.gather_two_pass(gi["x2d"], gi["rowsel"], gi["lanesel"])
    torch.cuda.synchronize()
    for name, got, refs in (
        ("flat", ya, (sc.gather_plain(gi["xa"], gi["idx"]),)),
        ("two_pass", y2, (sc.gather_two_pass_plain(gi["x2d"], gi["rowsel"], gi["lanesel"]),
                          gi["x"][gi["flat"]])),
    ):
        err = max(float((got - r).abs().max()) for r in refs)
        log(f"  G {name}: {got.numel()} values, max abs err {err:.1e}")
        if err != 0.0:
            raise RuntimeError(f"G ({name}) disagrees with x[idx]: max abs err {err}")
        out[name] = err
    return out


def permute_cases(b_real, b_cplx, perm, iperm, nb: int, keys=None) -> dict:
    """G's permutation forms in every type pair of ``spmv_cuda.PERMUTES``
    (or those of ``keys``), as ``(form, "<from>.<to>")`` -> (kernel call,
    plain call): into the band's order from an f64 or complex128 b
    (complex64, or float32 with one or two columns) and out of it (to f64
    or complex128; a complex64 x to f64 keeps its real part), on
    band-order blocks made from the b's."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    b_of = {"f64": b_real, "c128": b_cplx}
    dt_of = {"c64": torch.complex64, "f32x1": torch.float32, "f32x2": torch.float32}
    out = {}
    for src, kind in (t.split(".") for t in sc.PERMUTES["in"]):
        b, dt = b_of[src], dt_of[kind]
        if keys is None or ("in", f"{src}.{kind}") in keys:
            out[("in", f"{src}.{kind}")] = (lambda b=b, dt=dt: sc.permute_in(b, perm, nb, dt),
                                            lambda b=b, dt=dt: sc.permute_in_plain(b, perm, nb, dt))
        if keys is None or ("out", f"{kind}.{src}") in keys:
            x = sc.permute_in_plain(b, perm, nb, dt)
            out[("out", f"{kind}.{src}")] = (
                lambda x=x, to=b.dtype: sc.permute_out(x, iperm, to),
                lambda x=x, to=b.dtype: sc.permute_out_plain(x, iperm, to))
    return out


def check_permutes(cases: dict, what: str) -> None:
    """Each permute form against its plain version: equal, bit for bit."""
    import torch

    for (form, types), (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        same = got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)
        log(f"  G permute-{form} {types} {what}: {tuple(got.shape)} {got.dtype}, "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"G permute-{form} ({types}) disagrees with its plain version "
                               f"{what}")


def random_permutation(n: int, nb: int, device, seed: int):
    """A padded band permutation from a seed: n vector entries and their
    padding up to whole blocks of nb (plus one), shuffled together; the
    inverse gives each entry's slot.  Returns (f64 b, complex128 b, perm,
    iperm)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    npad = (n // nb + 2) * nb
    perm = torch.randperm(npad, generator=g, device=device)
    iperm = torch.argsort(perm)[:n].to(torch.int32)
    br = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    bc = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                       torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return br, bc, perm.to(torch.int32), iperm


def gather_bound(elem: int, x_touched: int, index_bytes: int, count: int) -> tuple[float, str]:
    """The x elements this run's indices touch, the indices, the output
    (``elem`` bytes per value)."""
    return bound(elem * x_touched + index_bytes + elem * count, 0, FP32_FLOPS_PER_S)


def main_path_gathers(A, cop, device) -> dict:
    """G at the main path's own types and shapes: the flat form as (x, idx)
    pairs, the f64 CSR value refill (A's values through the permuted CSR's
    slot map, nnz indices, padded) and a complex128 band permutation (not
    on the main path since the permute forms); the permute forms on the
    eigen stage's complex plan (complex128 b) and the baseflow's real
    plan (f64 b), on vectors from a seed."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.solver.band import plan_for_csr

    ix = plan_for_csr(A).on(device)  # the eigen stage's cached complex plan
    rx = plan_for_csr(A, real=True).on(device)  # the baseflow's real plan of the same pattern
    g = torch.Generator(device=device).manual_seed(3)
    n = A.shape[0]
    npad = ix["perm_pad"].numel()
    xc = torch.complex(torch.randn(npad, generator=g, device=device, dtype=torch.float64),
                       torch.randn(npad, generator=g, device=device, dtype=torch.float64))
    br = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    bc = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                       torch.randn(n, generator=g, device=device, dtype=torch.float64))
    nb = 128
    cplx = {(f, t) for f in ("in", "out") for t in sc.PERMUTES[f] if "c64" in t}
    real = {(f, t) for f in ("in", "out") for t in sc.PERMUTES[f] if "f32" in t}
    permutes = {**permute_cases(br, bc, ix["perm_pad"], ix["iperm"], nb, cplx),
                **permute_cases(br, bc, rx["perm_pad"], rx["iperm"], nb, real)}
    return {"f64": [(A.data.contiguous(), cop.plan.on(device).src)],
            "c128": [(xc, ix["perm_pad"])], "permutes": permutes,
            "plans": {"c64": (ix, bc, br), "f32": (rx, bc, br)}}


def check_main_gathers(pairs: dict) -> dict:
    """G's flat form against ``x[idx]`` and the permute forms against
    their plain versions on the main path's inputs: exact."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    out = {}
    for kind in ("f64", "c128"):
        errs = []
        for x, idx in pairs[kind]:
            got = sc.gather(x, idx)
            ref = sc.gather_plain(x, idx)
            torch.cuda.synchronize()
            errs.append(float((got - ref).abs().max()))
            log(f"  G {kind} at the main path's shape: {idx.numel()} of {x.numel()} values, "
                f"max abs err {errs[-1]:.1e}")
        if max(errs) != 0.0:
            raise RuntimeError(f"G ({kind}) disagrees with x[idx] on the main path's inputs: {errs}")
        out[kind] = max(errs)
    check_permutes(pairs["permutes"], "on the main path's plans")
    return out


def op_sequence_in(b, perm, n: int, nb: int, dtype):
    """The op sequence the permute-in form replaces (zeros, copy, the flat
    G gather, the cast, and the stack into columns), as a yardstick."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    cols = [b] if dtype.is_complex else ([b.real, b.imag] if b.is_complex() else [b])
    outs = []
    for c in cols:
        bp = torch.zeros(perm.numel(), dtype=c.dtype, device=c.device)
        bp[:n] = c
        outs.append(sc.gather(bp, perm).to(dtype).reshape(-1, nb))
    return outs[0] if dtype.is_complex else torch.stack(outs, dim=2)


def op_sequence_out(x, iperm, dtype):
    """The op sequence the permute-out form replaces (the cast up and the
    flat G gather, per column)."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    if x.is_complex():
        return sc.gather(x.reshape(-1).to(torch.complex128), iperm)
    return sc.gather(x[:, :, 0].reshape(-1).to(torch.float64), iperm)


# ---------------------------------------------------------------------------
# The cylinder
# ---------------------------------------------------------------------------


def cylinder_case(device) -> dict:
    """bench.py's reduced cylinder: mesh, spaces, BCs, assembly context."""
    import torch
    from lsafw_tpu_torch.config import BoundaryConditionsConfig, CylinderFlowGeometryConfig
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    geo = CylinderFlowGeometryConfig(
        dim=2, cylinder_radius=0.5, cylinder_center=(0.0, 0.0),
        x_range=(-10.0, 30.0), y_range=(-10.0, 10.0), resolution=0.5,
        resolution_around_cylinder=0.15, influence_radius=8.0,
    )
    mesh = cylinder_flow_mesh(geo, max_iter=80, seed=0)
    INLET, OUTLET, BOTTOM, TOP, CYL = 1, 2, 3, 4, 5

    def marker(x):
        out = np.full(x.shape[0], CYL, dtype=np.int32)
        out[np.isclose(x[:, 1], -10.0, atol=1e-6)] = BOTTOM
        out[np.isclose(x[:, 1], 10.0, atol=1e-6)] = TOP
        out[np.isclose(x[:, 0], -10.0, atol=1e-6)] = INLET
        out[np.isclose(x[:, 0], 30.0, atol=1e-6)] = OUTLET
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    C = BoundaryConditionsConfig
    bcs_base = define_bcs(mesh, spaces, [
        C(marker=INLET, type="dirichlet_velocity", value=(1.0, 0.0)),
        C(marker=BOTTOM, type="neumann_velocity", value=(0.0, 0.0)),
        C(marker=TOP, type="neumann_velocity", value=(0.0, 0.0)),
        C(marker=OUTLET, type="dirichlet_pressure", value=0.0),
        C(marker=CYL, type="dirichlet_velocity", value=(0.0, 0.0)),
    ])
    bcs_pert = define_bcs(mesh, spaces, [
        C(marker=INLET, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=CYL, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=OUTLET, type="dirichlet_pressure", value=0.0),
    ])
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0)


def forbid_host_lu() -> None:
    """Make every host LU of the port raise: the device path must not use it."""
    from lsafw_tpu_torch.solver import baseflow, direct, newton

    def no_host_lu(*args, **kw):
        raise RuntimeError("host LU called on the device path")

    for mod, name in ((direct, "SparseLU"), (direct, "direct_solve"), (newton, "SparseLU"),
                      (baseflow, "direct_solve")):
        setattr(mod, name, no_host_lu)


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def counts() -> dict:
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda

    return {**band_cuda.LAUNCHES, **spmv_cuda.LAUNCHES}


def reset_counts() -> None:
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda

    band_cuda.reset_launches()
    spmv_cuda.reset_launches()


def leading_pair(A, M):
    import torch
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    t0 = time.time()
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(TARGET)
    es.set_st_pc_type("banded")
    pairs = es.solve()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return pairs[0][0], float(eigen_residuals(A, M, pairs)[0]), es.operator, seconds


def gate_sigma(what: str, sigma: complex, resid: float) -> None:
    if abs(sigma - SIGMA_REF) > 1e-4:
        raise RuntimeError(f"{what}: sigma {sigma} is not within 1e-4 of {SIGMA_REF}")
    if abs(sigma - SIGMA_CARD) > 5e-7:
        raise RuntimeError(f"{what}: sigma {sigma} is not within 5e-7 of {SIGMA_CARD}")
    if not resid <= 1e-8:
        raise RuntimeError(f"{what}: eigen residual {resid:.2e} > 1e-8")


def main_path(case) -> dict:
    """Phase 3: banded baseflow, eigensystem, pivoted shift-invert."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    reset_counts()
    t0 = time.time()
    with band_solves() as base_solves, matvecs() as base_mv:
        solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=47.0)
        w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
        torch.cuda.synchronize()
    t_base = time.time() - t0
    base_counts = counts()
    t0 = time.time()
    A, M = LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                           case["mesh"]).assemble_eigensystem()
    torch.cuda.synchronize()
    t_asm = time.time() - t0
    reset_counts()
    with band_solves() as eig_solves, matvecs() as eig_mv:
        sigma, resid, op, t_eig = leading_pair(A, M)
    eig_counts = counts()
    st = solver.stats
    log(f"phase 3: {case['spaces'].num_dofs} DOFs; stages mesh {case['seconds']:.2f} s, "
        f"baseflow {t_base:.2f} s (factor {st['factor_s']:.2f} s in {st['factors']}, "
        f"band solves {st['solve_s']:.2f} s in {st['solves']}, SpMV {st['spmv_s']:.2f} s in "
        f"{st['spmvs']}), assemble {t_asm:.2f} s, eigen {t_eig:.2f} s (factor "
        f"{op.factor_seconds:.2f} s)")
    log(f"phase 3: Newton iterations {[r.iterations for r in solver.newton_results]}, "
        f"GCR iterations {st['gcr_its']}, real pivoted factors {st['pivoted']}/{st['factors']}")
    log(f"phase 3: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; "
        f"pivoted factor {op.pivoted}, contraction {op.rho:.2e}, refinement cap "
        f"{op.refine_its}, {op.applies} shift-invert applies")
    log(f"phase 3: band solves in baseflow {base_solves}, in eigen {eig_solves}; original-order "
        f"matvecs in baseflow {base_mv['matvecs']}, in eigen {eig_mv['matvecs']}")
    log(f"phase 3: launches in baseflow {nonzero(base_counts)}; in eigen {nonzero(eig_counts)}")
    ours = sum(base_counts.values())
    log(f"phase 3: baseflow: {ours} launches of the port's kernels in {st['gcr_its']} GCR "
        f"iterations and {st['solves']} band solves: {ours / max(st['gcr_its'], 1):.2f} per GCR "
        f"iteration")
    gate_sigma("phase 3", sigma, resid)
    gate_band_launches("phase 3 baseflow", base_counts, "pivoted.f32x1",
                       base_solves.get("RealPivotedBandedLU", 0))
    if base_solves.get("RealPivotedBandedLU", 0) != st["solves"]:
        raise RuntimeError(f"baseflow band solves {base_solves} against its count {st['solves']}")
    gate_band_launches("phase 3 eigen", eig_counts, "pivoted.c64",
                       eig_solves.get("PivotedBandedLU", 0))
    if not op.pivoted or op.device_op.Cop is None:
        raise RuntimeError("phase 3 did not take the pivoted factor with the fused matvecs")
    if st["pivoted"] != st["factors"] or st["factors"] == 0:
        raise RuntimeError(f"the baseflow did not factor pivoted on the card: {st}")
    gate_permutes_and_spmv("phase 3 baseflow", base_counts, "f64.f32x1",
                           base_solves.get("RealPivotedBandedLU", 0), base_mv["matvecs"])
    gate_permutes_and_spmv("phase 3 eigen", eig_counts, "c128.c64",
                           eig_solves.get("PivotedBandedLU", 0), eig_mv["matvecs"])
    if min(base_counts["spmv_real.original"], base_counts["gather_f64"]) <= 0:
        raise RuntimeError(f"S or G never launched in the baseflow: {nonzero(base_counts)}")
    if min(eig_counts["spmv_shifted.original"], eig_counts["spmv_complex.original"],
           eig_counts["gather_f64"]) <= 0:
        raise RuntimeError(f"S or G never launched in the eigen stage: {nonzero(eig_counts)}")
    launches = {k: base_counts[k] + eig_counts[k] for k in base_counts}
    stages = dict(mesh=case["seconds"], baseflow=t_base, assemble=t_asm, eigen=t_eig,
                  factor=op.factor_seconds)
    return dict(A=A, M=M, op=op, launches=launches, stages=stages, newton=st,
                sigma=sigma, resid=resid, per_gcr=ours / max(st["gcr_its"], 1))


def host_contraction(op) -> float:
    """Calibration contraction of the pivot-free shift-invert operator with
    its band factored on the host CPU (true f32 products): the yardstick
    for the card's factor precision."""
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    def cpu(m):
        return CSRMatrix(m.pattern, m.data.cpu())

    return ShiftInvertOperator(cpu(op.A), cpu(op.M), op.sigma).rho


def pivot_free_path(A, M, sigma_main: complex) -> dict:
    """Phase 3b: the pivot-free factor, its substitution through K1/K2."""
    os.environ["LSAFW_PIVOT_MEM_GB"] = "0"
    try:
        reset_counts()
        with band_solves() as solves, matvecs() as mv, plain_loops_forbidden():
            sigma, resid, op, t_eig = leading_pair(A, M)
        launches = counts()
        log(f"phase 3b: pivot-free: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual "
            f"{resid:.2e}, eigen {t_eig:.2f} s (factor {op.factor_seconds:.2f} s), contraction "
            f"{op.rho:.2e}, {op.applies} applies, band solves {solves}, original-order matvecs "
            f"{mv['matvecs']}; launches {nonzero(launches)}")
        gate_sigma("phase 3b", sigma, resid)
        if abs(sigma - sigma_main) > 1e-8:
            raise RuntimeError(f"phase 3b: sigma {sigma} is not within 1e-8 of phase 3's "
                               f"{sigma_main}")
        if op.pivoted:
            raise RuntimeError("phase 3b did not take the pivot-free factor")
        gate_band_launches("phase 3b", launches, "pivot_free.c64", solves.get("BandedLU", 0))
        gate_permutes_and_spmv("phase 3b", launches, "c128.c64", solves.get("BandedLU", 0),
                               mv["matvecs"])
        t0 = time.time()
        rho_host = host_contraction(op)
    finally:
        del os.environ["LSAFW_PIVOT_MEM_GB"]
    log(f"phase 3b: the same factor built in f32 on the host CPU contracts by {rho_host:.2e} "
        f"(card {op.rho:.2e}; {time.time() - t0:.1f} s)")
    if not op.rho <= 3 * rho_host:
        raise RuntimeError("the card's factor contracts far worse than the host's f32 factor: "
                           "check the matmul precision (TF32)")
    return dict(op=op, launches=launches)


# ---------------------------------------------------------------------------
# S
# ---------------------------------------------------------------------------


S_KEYS = {"real": "spmv_real", "shifted": "spmv_shifted", "shifted_mass": "spmv_shifted",
          "mass": "spmv_complex"}


def spmv_cases(cop, device, csrs: dict | None = None) -> dict:
    """S's modes in both orders on a shifted operator's storage, as
    ``(mode, order)`` -> (kernel call, plain call), on vectors made from a
    seed: real (A x, f64 x), shifted ((A - sigma M) x), shifted_mass (the
    same and M x), mass (M x, complex128 x).  ``csrs`` replaces the
    plan's operands in either order."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    csrs = csrs or {o: cop.plan.on(device, o) for o in ("permuted", "original")}
    g = torch.Generator(device=device).manual_seed(2)
    n = cop.plan.n
    xr = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    xc = torch.complex(xr, torch.randn(n, generator=g, device=device, dtype=torch.float64))
    s = cop.sigma
    out = {}
    for order in ("permuted", "original"):
        c = csrs[order]
        out[("real", order)] = (lambda c=c: sc.csr_spmv(c, cop.vA, xr),
                                lambda c=c: sc.csr_spmv_plain(c, cop.vA, xr))
        out[("shifted", order)] = (lambda c=c: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xc, s),
                                   lambda c=c: sc.csr_spmv_plain(c, cop.vA, xc, cop.vM, s))
        out[("shifted_mass", order)] = (
            lambda c=c: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xc, s, mass=True),
            lambda c=c: sc.csr_spmv_plain(c, cop.vA, xc, cop.vM, s, mass=True))
        out[("mass", order)] = (lambda c=c: sc.csr_spmv(c, cop.vM, xc),
                                lambda c=c: sc.csr_spmv_plain(c, cop.vM, xc))
    return out


def spmv_library(A, M, sigma, device) -> dict:
    """The cuSPARSE yardstick of each mode (the CSR pair in the original
    order, which is each original-order apply's own function), on the
    vectors of :func:`spmv_cases`."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    g = torch.Generator(device=device).manual_seed(2)
    n = A.shape[0]
    xr = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    xc = torch.complex(xr, torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return {"real": lambda: spmv(A, xr),
            "shifted": lambda: spmv(A, xc) - sigma * spmv(M, xc),
            "shifted_mass": lambda: (lambda m: (spmv(A, xc) - sigma * m, m))(spmv(M, xc)),
            "mass": lambda: spmv(M, xc)}


def spmv_work(mode: str, order: str, n: int, nnz: int, ntiles: int) -> tuple[float, float]:
    """(bytes, f64 operations) S must move and do: columns and values,
    row pointers, S's tiles, x once, the permutation in the original
    order, the outputs (complex multiply-add of a real value 4 flops)."""
    structure = (n + 1) * 8 + nnz * 4 + (ntiles + 1) * 12 + (n * 4 if order == "original" else 0)
    return {"real": (structure + nnz * 8 + 2 * n * 8, 2 * nnz),
            "shifted": (structure + 2 * nnz * 8 + 2 * n * 16, 8 * nnz + 8 * n),
            "shifted_mass": (structure + 2 * nnz * 8 + 3 * n * 16, 8 * nnz + 8 * n),
            "mass": (structure + nnz * 8 + 2 * n * 16, 4 * nnz)}[mode]


def check_spmv(cases: dict, what: str) -> dict:
    """S against its plain version in every mode and order: rel <= 1e-12
    (and one call's time with its host overhead, CUDA events)."""
    import torch

    out = {}
    for (mode, order), (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        a, r = (max(v) for v in zip(*(rel_err(g_, r_) for g_, r_ in pairs)))
        log(f"  S {mode} {order} {what}: max abs err {a:.3e}, rel {r:.3e}; one call "
            f"{cuda_ms(kern, 3):.4f} ms")
        if not np.isfinite(r) or r > SPMV_REL_TOL:
            raise RuntimeError(f"S ({mode}, {order}) {what} disagrees with its plain version "
                               f"(rel {r:.3e})")
        out[(mode, order)] = a
    return out


def random_shifted_op(n: int, device, seed: int):
    """A shifted operator on a random pattern from a seed: 0 to 59
    nonzeros a row, every 97th row empty, row 5 of 5,000 nonzeros (longer
    than a tile), under a random permutation that puts rows of one nonzero
    at 1,000 to 1,599 (tiles of the most rows a tile holds)."""
    import torch
    import scipy.sparse as sp
    from lsafw_tpu_torch.ops import bcsr

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    lens = rng.integers(0, 60, n)
    lens[perm[1000:1600]] = 1
    lens[::97] = 0
    lens[5] = 5000
    rows = [np.unique(rng.integers(0, n, k)) for k in lens]
    cols = np.concatenate(rows)
    indptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    A = sp.csr_matrix((rng.standard_normal(cols.size), cols, indptr), shape=(n, n))
    plan = bcsr.BCSRPlan.build(A, perm=perm)

    def vals():
        return bcsr._values(plan, torch.as_tensor(rng.standard_normal(A.nnz), device=device))

    return bcsr.BCSRShiftedOp(vals(), vals(), 0.3 + 0.74j, plan)


def main_path_factors(mp: dict, pf: dict) -> list:
    """The band factors of the main path's operators, one per mode and
    type: the eigen stage's pivoted complex factor (phase 3), phase 3b's
    pivot-free complex factor, and a real pivoted and a real pivot-free
    factor of A - Re(sigma) M on the baseflow's real plan (the Newton
    Jacobians' pattern and geometry)."""
    import torch
    from lsafw_tpu_torch.solver import band as tband

    A, M, s = mp["A"], mp["M"], mp["op"].sigma
    dre = A.data - s.real * M.data
    plan = tband.plan_for_csr(A, real=True)
    torch.cuda.synchronize()
    t0 = time.time()
    real_pivoted = tband.factor_auto(plan, dre)[0]
    torch.cuda.synchronize()
    t_factor = time.time() - t0
    os.environ["LSAFW_PIVOT_MEM_GB"] = "0"
    try:
        real_pivot_free = tband.factor_auto(plan, dre, diag_slots=A.pattern.diag_slots)[0]
    finally:
        del os.environ["LSAFW_PIVOT_MEM_GB"]
    log(f"phase 4: {type(real_pivoted).__name__}: factor {t_factor:.3f} s (host clock, "
        f"synchronised); the eigen stage's complex factor took {mp['op'].factor_seconds:.3f} s")
    return [mp["op"].device_op.blu, pf["op"].device_op.blu, real_pivoted, real_pivot_free]


def band_kernels(mp: dict, pf: dict, errs: dict, device) -> list:
    """K1/K2 in each mode and type on the main path's own factors: held
    against their plain versions, then timed one call at a time with CUDA
    events (each band exceeds the 50 MB L2, so every call is cold) beside
    the plain loops and the bounds.  Returns the kernels-line entries."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    launches = {k: mp["launches"][k] + pf["launches"][k] for k in bc.LAUNCHES}
    names = {"K1": "band_fwd_kernel (K1)", "K2": "band_bwd_kernel (K2)"}
    out = []
    for f in main_path_factors(mp, pf):
        fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
        md, nb = mode_of(f), f.band.shape[-1]
        nblk = f.L1inv.shape[0] if md == "pivoted" else f.dinv.shape[0]
        for seed, kind in enumerate(kinds(f)):
            b = rhs(kind, nblk, nb, device, 10 + seed)
            res = check_kernels(f, b, f"phase 4 {type(f).__name__}")
            for k, (a, _) in res.items():
                errs[f"{k}.{md}.{kind}"] = max(errs.get(f"{k}.{md}.{kind}", 0.0), a)
            y = fwd_plain(b)
            times = {"K1": (cuda_ms(lambda: fwd(b), 20), cuda_ms(lambda: fwd_plain(b), 3)),
                     "K2": (cuda_ms(lambda: bwd(y), 20), cuda_ms(lambda: bwd_plain(y), 3))}
            bounds = subst_bounds(f, kind)
            for k, (ms, plain_ms) in times.items():
                if md == "pivoted":  # the XLA scans of the reference's pivoted factors
                    line = "lsafw_tpu/solver/band.py:" + ("1035" if kind == "c64" else "839")
                else:
                    line = "lsafw_tpu/solver/band_pallas.py:" + ("92" if k == "K1" else "191")
                key = f"{k}.{md}.{kind}"
                out.append(dict(name=f"{names[k]}, {md.replace('_', '-')}, {kind}", route="cuda",
                                source="lsafw_tpu_torch/csrc/band_subst.cu", replaces=line,
                                launches=launches[key], max_abs_err=errs[key], ms=ms,
                                plain_ms=plain_ms, bound_ms=bounds[k][0], bound_by=bounds[k][1],
                                library_ms=None))
            if kind in ("c64", "f32x1"):
                plain_solve = cuda_ms(lambda: bwd_plain(fwd_plain(b)), 3)
                solve = cuda_ms(lambda: bwd(fwd(b)), 10)
                log(f"phase 4: one {md} {kind} solve (K1 + K2) {solve:.4f} ms, the torch loops "
                    f"{plain_solve:.3f} ms: {plain_solve / solve:.1f}x; bound "
                    f"{bounds['K1'][0] + bounds['K2'][0]:.4f} ms")
    return out


def gcr_iterations(mp: dict, device, its: int = 8) -> tuple[float, float, int, int]:
    """(wall ms, busy ms, device operations, iterations) of ``its`` GCR
    iterations of ``_banded_mr`` (the baseflow's refinement) on the real
    pivoted factor of A - Re(sigma) M, under the profiler (after one warm
    run)."""
    import torch
    from lsafw_tpu_torch.ops.bcsr import operator_for_budget
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.newton import _banded_mr

    A, M = mp["A"], mp["M"]
    J = CSRMatrix(A.pattern, A.data - mp["op"].sigma.real * M.data)
    blu = tband.factor_auto(tband.plan_for_csr(J, real=True), J.data)[0]
    Jop = operator_for_budget(J)
    b = torch.randn(J.shape[0], dtype=torch.float64, device=device)

    def run():
        return _banded_mr(J, blu, b, Jop, tol=0.0, max_its=its)

    run()
    wall, busy, ops = device_busy(run)
    return wall, busy, ops, its


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    t_start = time.time()
    dev = torch.device(DEVICE)
    name_power = card()
    log(f"phase 1: card {name_power}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()

    nb = 128
    errs: dict = {}  # "K1.pivoted.c64", ... -> max abs error over phases 2 and 4

    def note(out: dict, f, kind: str) -> None:
        for k, (a, _) in out.items():
            key = f"{k}.{mode_of(f)}.{kind}"
            errs[key] = max(errs.get(key, 0.0), a)

    for B, nblk in PHASE2_SHAPES:
        for real in (False, True):
            for pivoted in (False, True):
                f = (random_pivoted(B, nb, nblk, dev, real) if pivoted
                     else random_band(B, nb, nblk + B, nblk, dev, real))
                for seed, kind in enumerate(kinds(f)):
                    b = rhs(kind, nblk, nb, dev, seed)
                    note(check_kernels(f, b, f"phase 2 random B={B} nblk={nblk}"), f, kind)
                    fwd, _, bwd, _ = substitutions(f)
                    y = fwd(b)
                    log(f"  phase 2 random B={B} nblk={nblk}: {mode_of(f)} {kind}: K1 "
                        f"{cuda_ms(lambda: fwd(b), 5):.4f} ms, K2 {cuda_ms(lambda: bwd(y), 5):.4f} ms")
                del f
    gi = gather_inputs(dev)
    g_errs = check_gather(gi)
    br, bc, perm, iperm = random_permutation(10007, nb, dev, seed=4)
    check_permutes(permute_cases(br, bc, perm, iperm, nb), "on a random permutation")
    rop = random_shifted_op(20011, dev, seed=5)
    check_spmv(spmv_cases(rop, dev), "on a random matrix")
    del rop
    log(f"phase 2: K1/K2 match their plain versions in both modes and every type at (B, block "
        f"rows) {PHASE2_SHAPES}; G matches x[idx] at the probes' shapes, its permute forms "
        f"their plain versions; S its plain version in every mode and order")
    if "--kernels" in sys.argv[1:]:
        return 0

    forbid_host_lu()
    case = cylinder_case(dev)
    with plain_loops_forbidden():
        mp = main_path(case)
    pf = pivot_free_path(mp["A"], mp["M"], mp["sigma"])

    # phase 4: agreement and times
    cop = mp["op"].device_op.Cop
    cases = spmv_cases(cop, dev)
    s_errs = check_spmv(cases, "on the main path's (A, M)")
    mg = main_path_gathers(mp["A"], cop, dev)
    mg_errs = check_main_gathers(mg)
    kernels = band_kernels(mp, pf, errs, dev)
    launches = {k: mp["launches"][k] + pf["launches"][k] for k in sc.LAUNCHES}

    src = "lsafw_tpu_torch/csrc/spmv_gather.cu"
    run_a, two_pass = "scripts/dev_pallas_gather.py:55", "scripts/dev_pallas_gather2.py:111"
    g_cases = []  # (name, replaces, launch key, error, kernel, plain, library, bound)
    for kind, elem in (("f64", 8), ("c128", 16)):
        x, idx = mg[kind][0]
        what = ("CSR value refill" if kind == "f64" else
                "a band permutation (not on the main path)") + \
            f" at the main path's shapes (x {x.numel()}, idx {idx.numel()})"
        g_cases.append((f"flat form, {kind}, {what}", run_a, f"gather_{kind}", mg_errs[kind],
                        lambda x=x, idx=idx: sc.gather(x, idx),
                        lambda x=x, idx=idx: sc.gather_plain(x, idx), lambda x=x, idx=idx: x[idx],
                        gather_bound(elem, int(torch.unique(idx).numel()), idx.numel() * 4,
                                     idx.numel())))
    g_cases += [
        ("flat form, f32, at run_a's shapes (a probe's type, not on the main path)", run_a,
         "gather_f32", g_errs["flat"],
         lambda: sc.gather(gi["xa"], gi["idx"]), lambda: sc.gather_plain(gi["xa"], gi["idx"]),
         lambda: gi["xa"][gi["idx"]],
         gather_bound(4, int(torch.unique(gi["idx"]).numel()), gi["idx"].numel() * 4,
                      gi["idx"].numel())),
        ("two-pass form, f32, at pallas_two_pass's shapes (not on the main path)", two_pass,
         "gather_two_pass", g_errs["two_pass"],
         lambda: sc.gather_two_pass(gi["x2d"], gi["rowsel"], gi["lanesel"]),
         lambda: sc.gather_two_pass_plain(gi["x2d"], gi["rowsel"], gi["lanesel"]),
         lambda: gi["x"][gi["flat"]],
         gather_bound(4, int(torch.unique(gi["flat"]).numel()), gi["rowsel"].numel() * 8,
                      gi["rowsel"].numel())),
    ]
    for form, line, key, err, kern, plain, lib, (bound_ms, bound_by) in g_cases:
        kernels.append(dict(name=f"gather_kernel (G), {form}", route="cuda", source=src,
                            replaces=line, launches=launches[key], max_abs_err=err,
                            ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=cold_ms(lib)))
        log(f"phase 4: G {form}: with L2 warm (graph replays) {graph_ms(kern):.4f} ms, x[idx] "
            f"{graph_ms(lib):.4f} ms; one call with its host overhead (CUDA events) "
            f"{cuda_ms(kern, 20):.4f} ms, x[idx] {cuda_ms(lib, 20):.4f} ms")
    size = {"f64": 8, "c128": 16, "c64": 8, "f32x1": 4, "f32x2": 8}
    main_types = {"in.c128.c64", "out.c64.c128", "in.f64.f32x1", "out.f32x1.f64"}
    for (form, types), (kern, plain) in mg["permutes"].items():
        a, b = types.split(".")
        ix, bcx, brx = mg["plans"]["c64" if "c64" in types else "f32"]
        n, npad = ix["iperm"].numel(), ix["perm_pad"].numel()
        if form == "in":  # perm, b, the band-order output
            nbytes = npad * 4 + n * size[a] + npad * size[b]
            bvec = bcx if a == "c128" else brx
            dt = torch.complex64 if b == "c64" else torch.float32
            seq = (lambda v=bvec, p=ix["perm_pad"], dt=dt: op_sequence_in(v, p, n, nb, dt))
        else:  # iperm, the n band-order slots it reads, the output
            nbytes = n * 4 + n * size[a] + n * size[b]
            x = sc.permute_in_plain(bcx if b == "c128" else brx, ix["perm_pad"], nb,
                                    torch.complex64 if a == "c64" else torch.float32)
            to = torch.complex128 if b == "c128" else torch.float64
            seq = (lambda x=x, p=ix["iperm"], to=to: op_sequence_out(x, p, to))
        on_main = f"{form}.{types}" in main_types
        bound_ms, bound_by = bound(nbytes, 0, FP32_FLOPS_PER_S)
        e = dict(name=f"permute_{form}_kernel (G, permute-{form}), {types.replace('.', ' to ')}"
                      f"{'' if on_main else ' (not on the main path)'}", route="cuda", source=src,
                 replaces=run_a, launches=launches[f"permute_{form}.{types}"], max_abs_err=0.0,
                 ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)
        kernels.append(e)
        log(f"phase 4: G permute-{form} {types}: one call with its host overhead (CUDA events) "
            f"{cuda_ms(kern, 20):.4f} ms, plain {cuda_ms(plain, 20):.4f} ms")
        if on_main:
            log(f"phase 4: G permute-{form} {types}: the op sequence it replaces: cold "
                f"{cold_ms(seq):.4f} ms, with its host overhead {cuda_ms(seq, 20):.4f} ms")
    s_lines = {"real": "lsafw_tpu/ops/bcsr.py:388", "shifted": "lsafw_tpu/ops/bcsr.py:615",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:587", "mass": "lsafw_tpu/ops/bcsr.py:622"}
    o_lines = {"real": "lsafw_tpu/ops/bcsr.py:446", "shifted": "lsafw_tpu/ops/bcsr.py:638",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:638", "mass": "lsafw_tpu/ops/bcsr.py:646"}
    libs = spmv_library(mp["A"], mp["M"], cop.sigma, dev)
    ntiles = cop.plan.tile_row.size - 1
    for (mode, order), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(*spmv_work(mode, order, cop.plan.n, cop.plan.nnz, ntiles),
                                   FP64_FLOPS_PER_S)
        key = S_KEYS[mode] + ("" if order == "permuted" else ".original")
        on_main = order == "original" and mode != "shifted_mass"  # never both outputs at once
        e = dict(name=f"csr_tiled_spmv_kernel (S), {mode.replace('_', '+')}, {order} order"
                      f"{'' if on_main else ' (not on the main path)'}", route="cuda", source=src,
                 replaces=(s_lines if order == "permuted" else o_lines)[mode],
                 launches=launches[key] if mode != "shifted_mass" else 0,
                 max_abs_err=s_errs[(mode, order)], ms=cold_ms(kern), plain_ms=cold_ms(plain),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=cold_ms(libs[mode]))
        kernels.append(e)
        log(f"phase 4: S {mode} {order}: with L2 warm (graph replays) {graph_ms(kern):.4f} ms, "
            f"cuSPARSE {graph_ms(libs[mode]):.4f} ms; one call with its host overhead (CUDA "
            f"events) {cuda_ms(kern, 20):.4f} ms, cuSPARSE {cuda_ms(libs[mode], 20):.4f} ms")
    for e in kernels:
        log(f"phase 4: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{100 * e['bound_ms'] / e['ms']:.1f}% of bound, {e['launches']} launches")

    # the panel LU backends
    for dt in (torch.float32, torch.complex64):
        panel = torch.randn(((mp["op"].device_op.blu.B + 1) * nb, nb), dtype=dt, device=dev)
        times = {}
        for lib in ("default", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            times[lib] = cuda_ms(lambda: torch.linalg.lu_factor_ex(panel), 20)
        torch.backends.cuda.preferred_linalg_library("default")
        log(f"phase 4: one {tuple(panel.shape)} {dt} panel LU: PyTorch's default backend "
            f"{times['default']:.3f} ms, cuSOLVER {times['cusolver']:.3f} ms")
    v = torch.randn(mp["A"].shape[0], dtype=torch.complex128, device=dev)
    reset_counts()
    wall, busy, ops = device_busy(lambda: mp["op"].apply(v))
    log(f"phase 4: one pivoted shift-invert apply under the profiler: {ops} device operations "
        f"({sum(counts().values())} of the port's kernels), {wall:.1f} ms wall, the card busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
    gcr_ms, gcr_busy, gcr_ops, its = gcr_iterations(mp, dev)
    log(f"phase 4: {its} GCR iterations of a real banded solve under the profiler: {gcr_ops} "
        f"device operations ({gcr_ops / its:.1f} per iteration), {gcr_ms:.1f} ms wall, the card "
        f"busy {gcr_busy:.2f} ms ({100 * gcr_busy / gcr_ms:.1f}%); the baseflow launched "
        f"{mp['per_gcr']:.2f} of the port's kernels per GCR iteration")
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")

    log(name_power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
