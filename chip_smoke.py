#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1 and 2 only, no result lines

Phases, one or more lines each (a failure raises and the exit code is
non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build:
     ``csrc/band_subst.cu`` at nb = 128 and at nb = 256 and
     ``csrc/spmv_gather.cu``, one nvcc each, started together;
  2. kernels against their plain PyTorch versions on the card, relative
     error <= 1e-5: the band substitution K1/K2 in both modes and every
     type (complex64; float32 with one and two columns) on random factors
     (``PHASE2_SHAPES``): at nb = 128 at the 43k cylinder shapes (B = 7,
     384 block rows) and at a wider B = 26 with 32 block rows; the
     pivot-free modes on a bf16 band at B = 7 and at the 175k production
     mesh's B = 17; every mode, f32 and bf16, at nb = 256 at B = 4 and
     B = 9 (the two meshes' B at that nb).  Pivot-free on a random band
     scaled by 2e-3, pivoted on a random band that needs pivoting within
     and across block rows, factored on the card by the port's
     ``_pfactor`` (each pair is timed once); the gather G against
     ``x[idx]`` at the probes' shapes (``run_a``: x 2^17 f32, idx
     (1024, 16); ``pallas_two_pass``: x (4096, 128) f32, 2^18 x 128
     lane-unique indices), exact; G's permute-in and permute-out in every
     type pair (f64 / complex128 into complex64, float32 x1 and x2, and
     back) on a random padded permutation at nb = 128 and at nb = 256,
     exact; S in every mode (real,
     complex, shifted, shifted with M x, and shifted with and without M x
     on an f64 x at a real shift) and both orders against its plain
     version, relative error <= 1e-12 (``SPMV_REL_TOL``), on a random
     matrix with empty rows, tiles of the most rows a tile holds and a row
     longer than a tile;
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
  3c. the bf16 band on the same (A, M): ``LSAFW_PIVOT_MEM_GB=0`` and
     ``LSAFW_BAND_MEM_GB=0.5`` (0.77 GB in f32 over it, 0.38 GB in bf16
     under it: bf16 at full width), K1/K2 pivot-free bf16 complex64 once
     per band solve, sigma within 1e-8 of phase 3's, the residual gate,
     its contraction printed beside phase 3b's; and one banded real solve
     of phase 3's last Jacobian with ``LSAFW_BAND_MEM_GB=0.3`` (a bf16
     band, K1/K2 pivot-free bf16 float32 with one column), GCR to 1e-10;
  4. S against its plain version on phase 3's (A, M) at sigma = 0.74j
     (the real-shift modes at CN_SHIFT = 16, phase 7's) in each mode and
     order (relative error <= 1e-12); G against its
     plain versions on the main path's own inputs, exact: the f64 CSR
     value refill (nnz indices), the complex128 flat gather, and the
     permute forms on the eigen stage's complex plan and the baseflow's
     real plan; K1/K2 in each mode and type against their plain versions
     on the main path's own factors (the eigen stage's pivoted factor,
     phase 3b's pivot-free one, a real pivoted and pivot-free factor
     on the baseflow's plan, phase 3c's bf16 factors, after phase 6
     the 175k factors of phases 6, 6b and 6c, and after phase 7b the 175k
     transient's real pivoted factor), and the times (medians of CUDA-event
     timings: K1/K2 one call at a time, each band being larger than L2;
     G and S with the L2 cache evicted before each call, as the main
     path's band solves leave it) of every kernel beside its plain
     version, bound and library call (for the permute forms also the op
     sequence they replace); one pivoted solve against the torch loops,
     the panel LU backends, and the device operations, wall time and
     busy share of one pivoted shift-invert apply and of eight GCR
     iterations of a real banded solve under ``torch.profiler``;
  5. adjoint sensitivity at full width on phase 3's baseflow and (A, M):
     ``EigenSensitivitySolver(..., target=sigma_3, si_method="banded")``,
     ``evaluate()`` (direct mode, nev 5 and ncv 80; adjoint mode on the
     transposed pair; du/dRe on the banded real solve) and
     ``compute_wavemaker()``, with host LU and the torch substitution
     loops patched to raise.  Counts are zeroed just before and read
     after each stage (direct, adjoint, du/dRe, integrals, wavemaker):
     K1/K2 once per band solve (pivoted complex64 in the direct and
     adjoint stages, pivoted f32 with one column in du/dRe), G's
     permute-in and permute-out once each per band solve in the stage's
     types, one original-order S launch per original-order matvec, no
     flat complex128 G, and no plan built for any pattern (the adjoint
     shares the pattern's plans).  Gates: the direct sigma within 1e-8 of
     phase 3's, sigma_adj within 1e-7 of conj(sigma_3), the adjoint
     residual ||A^T a - sigma_adj M^T a|| / ||a|| <= 1e-8,
     |a^H M v - 1| <= 1e-10, the du/dRe residual ||J s - r|| / ||r|| <=
     1e-9, the reference's finite-difference check (banded Newton
     baseflows at Re = 46 and 48 started from phase 3's, their
     eigenvalues near sigma_3: |d sigma/dRe - FD| <= 0.15 |FD| and
     Re(d sigma/dRe) > 0), and the wavemaker's peak at 0.5 < x < 5,
     |y| < 2, its velocity slots 0 and its CG converged;
  6. the repository's production cylinder, built from
     ``config_files/2D/cylinder/*.toml`` (175,491 DOFs): ramped banded
     Newton (3 steps, tol 1e-8) on real pivoted f32 factors, the
     eigensystem, and the shift-invert eigenpair at 0.74j on the default
     plan (the pivot-free complex64 band, B = 17 at nb = 128), with host
     LU and the torch substitution loops on CUDA tensors raising; each
     stage read on its own: residual <= 1e-8, |Re sigma - 0.0004| <= 1e-3
     and |sigma - (0.0008+0.7354j)| <= 3e-3, K1/K2 pivot-free complex64
     once per band solve in the eigen stage and pivoted float32 x1 in the
     baseflow, whose band stays f32; stage times, launches, peak memory;
  6b. phase 6's eigen stage with ``LSAFW_BAND_NB=256``: sigma within 1e-8
     of phase 6's, K1/K2 pivot-free complex64 at nb = 256 once per band
     solve; the factor and band-solve times beside nb = 128's;
  6c. phase 6's eigen stage with ``LSAFW_BAND_MEM_GB=4`` (a bf16 band):
     sigma within 1e-8 of phase 6's, K1/K2 pivot-free bf16 complex64 once
     per band solve, and the stage's peak device memory above its start
     at most 0.6 of phase 6's eigen stage.  Phase 4's K1/K2 checks and
     times then run on the factors of phases 6, 6b and 6c;
  7. (after phase 5, on phase 3's mesh) the non-modal toolbox of
     ``examples/resolvent_gains.py`` and ``examples/transient_growth.py``:
     the Re = 40 baseflow (ramped banded Newton, 4 steps, tol 1e-9) and
     its (A, M) with the perturbation BCs; ``ResolventSolver(method=
     "banded")``: the gain curve at omega = 0.3 and 1.2 (k = 1) and 0.75
     (k = 2, whose leading gain is the curve's), ``resolvent_norm(
     -0.05+0.75j)``;
     ``TransientGrowthSolver(method="banded").solve(4, 32)``; each a
     stage (counts zeroed before, read after): K1/K2 once per band solve
     (pivoted complex64 in the resolvent stages; pivoted float32 x1
     alone in the transient stage, no complex64 and no two-column
     launch), G's permute-in and permute-out once each per band solve,
     one original-order S launch per original-order matvec (the Cayley
     right-hand side and each adjoint step's (A^T + s M^T) y included),
     no flat complex128 G, no plan built but the direct operator's where
     none was cached, and host LU raising; forcing and response energies
     1 within 1e-8, the response residual ||(i omega M - A)(g q) - M f||
     / ||M f|| <= 1e-8, each raw response C^-1 M f of energy norm the gain
     within 1e-6, q(T)^T M q(T) = G within 1e-6 max(G, 1), forcings and
     initial states zero on pressure and Dirichlet DOFs; then, with
     ``method="lu"`` (asked for; six host LU factors, counted), the same
     k = 2 solve and norm (gains within 1e-6, the norm within 1e-5 of the
     banded answers) and, in place of a full host-LU gain solve (2,752
     sequential host solves), the host-LU propagators on the banded
     optimum q0: its energy at T (the host-LU gain operator's Rayleigh
     quotient) within 1e-6 of G, its state at T and its gain-operator
     image within 1e-6 of the banded ones;
  7b. (after 6c, on phase 6's mesh, 175,491 DOFs) phase 7 at full width
     without the sweep, the norm and the host LU: the Re = 40 baseflow,
     the resolvent at omega = 0.75 (k = 1; the default plan's pivot-free
     complex64 band) and G(4) with 32 steps, with phase 7's gates; then
     phase 4's K1/K2 checks and times on the transient's real pivoted
     factor (B = 17, 1,408 block rows).

The last lines are the card's name and power limit, one JSON object of
kernel numbers, one entry per kernel, mode, storage and type and per
main-path factor (``launches``: phases 3, 3b, 3c, 6, 6b and 6c;
``launches_phase5``: the stages of phase 5; ``launches_phase6``: phases
6 to 6c; ``launches_phase7``: the stages of phases 7 and 7b; modes no
main path runs carry phase 2's random factors), and
``{"ok": true, "device": {...}}``.
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
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SIGMA_REF = 0.0050 + 0.7526j  # reduced cylinder at Re = 47, recorded to 4 digits
SIGMA_175K_RE = 0.0004  # the production mesh's Re sigma at Re = 47 (VALIDATION.md), 4 digits
SIGMA_167K = 0.0008 + 0.7354j  # sigma of the older 167k production mesh (README.md)
PRODUCTION_CONFIG = Path(__file__).resolve().parent / "config_files" / "2D" / "cylinder"
SIGMA_CARD = 0.004991 + 0.752636j  # the port's sigma on the H100, as printed to 6 digits
TARGET = 0.74j
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
REL_TOL = 1e-5
DEVICE = "cuda"
# phase 2's random factors, (B, block rows) per (nb, storage): every mode and
# type at nb = 128 (the 43k cylinder's B and a wider one), the bf16
# pivot-free modes at the 43k's and the 175k production mesh's B, and every
# mode at nb = 256 at the B of both meshes at that nb
PHASE2_SHAPES = {(128, "f32"): ((7, 384), (26, 32)), (128, "bf16"): ((7, 384), (17, 64)),
                 (256, "f32"): ((4, 192), (9, 96)), (256, "bf16"): ((4, 192), (9, 96))}
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
    """nvcc on every library at once: the band kernels at each nb, and G/S."""
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda
    from lsafw_tpu_torch.utils.cuda_build import BUILD_LOGS

    t0 = time.time()
    jobs = [lambda nb=nb: band_cuda.build(nb) for nb in band_cuda.NBS] + [spmv_cuda.build]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda job: job(), jobs))
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
    from lsafw_tpu_torch.solver import band_cuda as bc

    return ("c64",) if bc.band_is_complex(factor.band) else ("f32x1", "f32x2")


def mode_of(factor) -> str:
    return "pivoted" if hasattr(factor, "perms") else "pivot_free"


def key_of(k: str, f, kind: str) -> str:
    """The ``band_cuda.LAUNCHES`` key of kernel ``k`` on factor ``f``."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    return bc.launch_key(k, mode_of(f), kind, f.band.dtype == torch.bfloat16, f.band.shape[2])


def mode_name(f, kind: str) -> str:
    """A factor's mode, storage, type and nb, as the log and the kernels
    line name them ("pivot-free bf16 c64 nb=256", ...)."""
    import torch

    bf16 = " bf16" if f.band.dtype == torch.bfloat16 else ""
    return f"{mode_of(f).replace('_', '-')}{bf16} {kind} nb={f.band.shape[2]}"


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
        log(f"  {what}: {k} {mode_name(f, kind_name(b))}: max abs err {a:.3e}, rel {r:.3e} "
            f"(limit {tol:.0e})")
        if not np.isfinite(r) or r > tol:
            raise RuntimeError(f"{what}: {k} ({mode_name(f, kind_name(b))}) disagrees with its "
                               f"plain version (rel {r:.3e})")
    return out


def kind_name(b) -> str:
    return "c64" if b.is_complex() else f"f32x{b.shape[2]}"


def random_band(B: int, nb: int, rows_total: int, nblk: int, device, real: bool = False,
                bf16: bool = False):
    """A random factored pivot-free band and Dinv (scaled by 2e-3 so the
    recursion stays bounded); ``bf16``: the band rounded to bf16 storage."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    rng = np.random.default_rng(0)

    def rand(shape, scale):
        z = rng.standard_normal(shape + (1 if real else 2,), dtype=np.float32) * np.float32(scale)
        t = torch.from_numpy(z[..., 0] if real else z)
        return (t if real else torch.view_as_complex(t)).to(device)

    eye = torch.eye(nb, dtype=torch.float32 if real else torch.complex64, device=device)
    band = rand((rows_total, 2 * B + 1, nb, nb), 2e-3)
    return SimpleNamespace(band=bc.narrow(band) if bf16 else band,
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
    once each: a bf16 band's entries at 2 bytes a value, Dinv's at 4) and
    their float32 operations (a complex multiply-add is 8 flops, a real
    one 2 per column)."""
    v = 8 if kind == "c64" else 4 * int(kind[-1])
    per_entry = 8 if kind == "c64" else 2 * int(kind[-1])
    e = 8 if kind == "c64" else 4  # an entry of Dinv, L2, L1inv, Uinv, and of an f32 band
    eb = e // 2 if f.band.element_size() == 2 else e  # an entry of the band
    nb = f.band.shape[2]
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
        fwd_bytes = fwd_entries * eb + (nblk + rows_total) * nb * v
        bwd_entries = fwd_entries + nblk * nb * nb
        bwd_bytes = fwd_entries * eb + nblk * nb * nb * e + (rows_total + nblk) * nb * v
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
    others = {k: launches[k] for k in bc.LAUNCHES if k not in (f"K1.{key}", f"K2.{key}")
              and launches[k]}
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


_HOST_LU: dict = {}  # the port's host LU class, kept while forbid_host_lu() stubs it out


def forbid_host_lu() -> None:
    """Make every host LU of the port raise: the device path must not use it."""
    from lsafw_tpu_torch import sensitivity
    from lsafw_tpu_torch.solver import baseflow, direct, eigen, newton

    def no_host_lu(*args, **kw):
        raise RuntimeError("host LU called on the device path")

    _HOST_LU.setdefault("SparseLU", direct.SparseLU)
    for mod, name in ((direct, "SparseLU"), (direct, "direct_solve"), (newton, "SparseLU"),
                      (baseflow, "direct_solve"), (eigen, "SparseLU"), (sensitivity, "SparseLU")):
        setattr(mod, name, no_host_lu)


@contextmanager
def host_lu_counted():
    """The host LU of the shift-invert operator's ``"lu"`` method, asked
    for explicitly, while the block runs, counting its factorizations; it
    raises again after the block."""
    from lsafw_tpu_torch.solver import eigen

    seen = {"host_lu": 0}

    class Counted(_HOST_LU["SparseLU"]):
        def __init__(self, *args, **kw):
            seen["host_lu"] += 1
            super().__init__(*args, **kw)

    saved = eigen.SparseLU
    eigen.SparseLU = Counted
    try:
        yield seen
    finally:
        eigen.SparseLU = saved


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
    return dict(A=A, M=M, w=w, op=op, launches=launches, stages=stages, newton=st,
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
    with env(LSAFW_PIVOT_MEM_GB="0"):
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
    log(f"phase 3b: the same factor built in f32 on the host CPU contracts by {rho_host:.2e} "
        f"(card {op.rho:.2e}; {time.time() - t0:.1f} s)")
    if not op.rho <= 3 * rho_host:
        raise RuntimeError("the card's factor contracts far worse than the host's f32 factor: "
                           "check the matmul precision (TF32)")
    return dict(op=op, launches=launches)


@contextmanager
def env(**values: str):
    """The environment variables ``values`` set while the block runs."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def bf16_path(case, mp: dict, pf: dict) -> dict:
    """Phase 3c: the complex band over its budget on phase 3's (A, M)
    (``LSAFW_BAND_MEM_GB=0.5``: 0.77 GB in f32, 0.38 GB in bf16, so bf16
    at full width; pivot-free), its substitution through K1/K2 pivot-free
    bf16 complex64; then one banded real solve of phase 3's last Jacobian
    on a bf16 band (``LSAFW_BAND_MEM_GB=0.3``), K1/K2 pivot-free bf16
    float32 with one column, GCR to 1e-10."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.newton import banded_solve

    A, M = mp["A"], mp["M"]
    with env(LSAFW_PIVOT_MEM_GB="0", LSAFW_BAND_MEM_GB="0.5"):
        reset_counts()
        with band_solves() as solves, matvecs() as mv, plain_loops_forbidden():
            sigma, resid, op, t_eig = leading_pair(A, M)
        launches = counts()
        plan = tband.plan_for_csr(A)
    full = tband.plan_for_csr(A)  # the default budget's plan: f32, full width
    blu = op.device_op.blu
    log(f"phase 3c: bf16 band: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual "
        f"{resid:.2e}, eigen {t_eig:.2f} s (factor {op.factor_seconds:.2f} s), contraction "
        f"{op.rho:.2e} (phase 3b's f32 band: {pf['op'].rho:.2e}), trial GCR solve {op.trial_its} "
        f"iterations, refinement cap {op.refine_its}, "
        f"{op.applies} applies; plan B = {plan.B} ({plan.band_dtype}; f32 plan B = {full.B}), "
        f"band {blu.band.numel() * blu.band.element_size() / 1e9:.3f} GB; band solves {solves}, "
        f"original-order matvecs {mv['matvecs']}; launches {nonzero(launches)}")
    gate_sigma("phase 3c", sigma, resid)
    if abs(sigma - mp["sigma"]) > 1e-8:
        raise RuntimeError(f"phase 3c: sigma {sigma} is not within 1e-8 of phase 3's {mp['sigma']}")
    if op.pivoted or blu.band.dtype != torch.bfloat16 or plan.B != full.B:
        raise RuntimeError(f"phase 3c did not take the pivot-free bf16 band at full width: pivoted "
                           f"{op.pivoted}, {blu.band.dtype}, B {plan.B} of {full.B}")
    gate_band_launches("phase 3c", launches, "pivot_free.bf16.c64", solves.get("BandedLU", 0))
    gate_permutes_and_spmv("phase 3c", launches, "c128.c64", solves.get("BandedLU", 0),
                           mv["matvecs"])

    J = StationaryNavierStokesAssembler(case["ctx"], case["mesh"], case["bcs_base"]).jacobian(
        mp["w"], 47.0)
    g = torch.Generator(device=J.data.device).manual_seed(7)
    b = torch.randn(J.shape[0], generator=g, device=J.data.device, dtype=torch.float64)
    with env(LSAFW_PIVOT_MEM_GB="0", LSAFW_BAND_MEM_GB="0.3"):
        rplan = tband.plan_for_csr(J, real=True)
        reset_counts()
        with band_solves() as rsolves, plain_loops_forbidden():
            t0 = time.time()
            res = banded_solve(J, b, rplan, tol=1e-10)
            torch.cuda.synchronize()
            t_real = time.time() - t0
        rlaunches = counts()
    log(f"phase 3c: banded real solve of the last Jacobian on a {rplan.band_dtype} band (B = "
        f"{rplan.B}): {res.iterations} GCR iterations to {res.residual:.2e} in {t_real:.2f} s; "
        f"band solves {rsolves}; launches {nonzero(rlaunches)}")
    if rplan.band_dtype != "bf16" or not res.converged or not res.residual <= 1e-10:
        raise RuntimeError(f"phase 3c: the bf16 real solve: band {rplan.band_dtype}, converged "
                           f"{res.converged}, residual {res.residual:.2e}")
    gate_band_launches("phase 3c real", rlaunches, "pivot_free.bf16.f32x1",
                       rsolves.get("RealBandedLU", 0))
    launches = {k: launches[k] + rlaunches[k] for k in launches}
    return dict(op=op, launches=launches, J=J, rplan=rplan)


# ---------------------------------------------------------------------------
# S
# ---------------------------------------------------------------------------


S_KEYS = {"real": "spmv_real", "shifted": "spmv_shifted", "shifted_mass": "spmv_shifted",
          "mass": "spmv_complex", "shifted_real": "spmv_shifted_real",
          "shifted_real_mass": "spmv_shifted_real"}
CN_SHIFT = 16.0  # the Crank-Nicolson shift 2/dt of phase 7's horizon (T = 4, 32 steps)


def spmv_cases(cop, device, csrs: dict | None = None, s_real: float = CN_SHIFT) -> dict:
    """S's modes in both orders on a shifted operator's storage, as
    ``(mode, order)`` -> (kernel call, plain call), on vectors made from a
    seed: real (A x, f64 x), shifted ((A - sigma M) x), shifted_mass (the
    same and M x), mass (M x, complex128 x), shifted_real and
    shifted_real_mass ((A - s M) x on an f64 x at the real shift
    ``s_real``, and M x).  ``csrs`` replaces the plan's operands in either
    order."""
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
        for mode, mass in (("shifted_real", False), ("shifted_real_mass", True)):
            out[(mode, order)] = (
                lambda c=c, mass=mass: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xr, s_real,
                                                           mass=mass),
                lambda c=c, mass=mass: sc.csr_spmv_plain(c, cop.vA, xr, cop.vM, s_real, mass))
    return out


def spmv_library(A, M, sigma, device, s_real: float = CN_SHIFT) -> dict:
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
            "mass": lambda: spmv(M, xc),
            "shifted_real": lambda: spmv(A, xr) - s_real * spmv(M, xr),
            "shifted_real_mass": lambda: (lambda m: (spmv(A, xr) - s_real * m, m))(spmv(M, xr))}


def spmv_work(mode: str, order: str, n: int, nnz: int, ntiles: int) -> tuple[float, float]:
    """(bytes, f64 operations) S must move and do: columns and values,
    row pointers, S's tiles, x once, the permutation in the original
    order, the outputs (complex multiply-add of a real value 4 flops)."""
    structure = (n + 1) * 8 + nnz * 4 + (ntiles + 1) * 12 + (n * 4 if order == "original" else 0)
    return {"real": (structure + nnz * 8 + 2 * n * 8, 2 * nnz),
            "shifted": (structure + 2 * nnz * 8 + 2 * n * 16, 8 * nnz + 8 * n),
            "shifted_mass": (structure + 2 * nnz * 8 + 3 * n * 16, 8 * nnz + 8 * n),
            "mass": (structure + nnz * 8 + 2 * n * 16, 4 * nnz),
            "shifted_real": (structure + 2 * nnz * 8 + 2 * n * 8, 4 * nnz + 2 * n),
            "shifted_real_mass": (structure + 2 * nnz * 8 + 3 * n * 8, 4 * nnz + 2 * n)}[mode]


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
    with env(LSAFW_PIVOT_MEM_GB="0"):
        real_pivot_free = tband.factor_auto(plan, dre, diag_slots=A.pattern.diag_slots)[0]
    log(f"phase 4: {type(real_pivoted).__name__}: factor {t_factor:.3f} s (host clock, "
        f"synchronised); the eigen stage's complex factor took {mp['op'].factor_seconds:.3f} s")
    return [mp["op"].device_op.blu, pf["op"].device_op.blu, real_pivoted, real_pivot_free]


def band_entry(k: str, f, kind: str, label: str, err: float, ms: float, plain_ms: float) -> dict:
    """A kernels-line entry of K1 or K2 on factor ``f`` (``launches`` and
    ``launches_phase5`` are filled in from ``_key`` at the end)."""
    if mode_of(f) == "pivoted":  # the XLA scans of the reference's pivoted factors
        line = "lsafw_tpu/solver/band.py:" + ("1035" if kind == "c64" else "839")
    else:
        line = "lsafw_tpu/solver/band_pallas.py:" + ("92" if k == "K1" else "191")
    bound_ms, bound_by = subst_bounds(f, kind)[k]
    name = {"K1": "band_fwd_kernel (K1)", "K2": "band_bwd_kernel (K2)"}[k]
    return dict(name=f"{name}, {mode_name(f, kind)}{label}", route="cuda",
                source="lsafw_tpu_torch/csrc/band_subst.cu", replaces=line, launches=0,
                _key=key_of(k, f, kind), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def band_kernels(factors: list, errs: dict, device) -> list:
    """K1/K2 in each mode and type on the main path's own factors, given
    as (label, factor) pairs: held against their plain versions, then
    timed one call at a time with CUDA events (each band exceeds the 50 MB
    L2, so every call is cold) beside the plain loops and the bounds.
    Returns the kernels-line entries."""
    out = []
    for label, f in factors:
        fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
        md, nb = mode_of(f), f.band.shape[2]
        nblk = f.L1inv.shape[0] if md == "pivoted" else f.dinv.shape[0]
        for seed, kind in enumerate(kinds(f)):
            b = rhs(kind, nblk, nb, device, 10 + seed)
            res = check_kernels(f, b, f"phase 4 {type(f).__name__}{label}")
            for k, (a, _) in res.items():
                errs[key_of(k, f, kind)] = max(errs.get(key_of(k, f, kind), 0.0), a)
            y = fwd_plain(b)
            times = {"K1": (cuda_ms(lambda: fwd(b), 20), cuda_ms(lambda: fwd_plain(b), 3)),
                     "K2": (cuda_ms(lambda: bwd(y), 20), cuda_ms(lambda: bwd_plain(y), 3))}
            for k, (ms, plain_ms) in times.items():
                out.append(band_entry(k, f, kind, label, errs[key_of(k, f, kind)], ms, plain_ms))
            if kind in ("c64", "f32x1"):
                bounds = subst_bounds(f, kind)
                plain_solve = cuda_ms(lambda: bwd_plain(fwd_plain(b)), 3)
                solve = cuda_ms(lambda: bwd(fwd(b)), 10)
                log(f"phase 4: one {mode_name(f, kind)}{label} solve (K1 + K2) {solve:.4f} ms, "
                    f"the torch loops {plain_solve:.3f} ms: {plain_solve / solve:.1f}x; bound "
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


# ---------------------------------------------------------------------------
# Phase 5: adjoint sensitivity
# ---------------------------------------------------------------------------


@contextmanager
def stage(name: str, out: dict):
    """Counts zeroed just before the block and read just after it: kernel
    launches, band solves per factor class, original-order matvecs, plan
    builds of the per-pattern cache, seconds, and the device memory
    allocated at its start and at its peak."""
    import torch
    from lsafw_tpu_torch.ops import sparse

    reset_counts()
    builds = dict(sparse.PLAN_BUILDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    with band_solves() as solves, matvecs() as mv:
        yield
        torch.cuda.synchronize()
    out[name] = dict(seconds=time.time() - t0, launches=counts(), solves=dict(solves),
                     matvecs=mv["matvecs"], resident_gb=resident / 1e9,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     builds={k: v - builds.get(k, 0) for k, v in sparse.PLAN_BUILDS.items()
                             if v != builds.get(k, 0)})


def staged(solver, attr: str, name: str, out: dict) -> None:
    """Make ``solver.<attr>`` run as a stage of :func:`stage`, so that
    ``evaluate()`` reads each of its stages on its own."""
    fn = getattr(solver, attr)

    def run(*args, **kw):
        with stage(name, out):
            return fn(*args, **kw)

    setattr(solver, attr, run)


def eigenvalue_near(case, w, re: float, target: complex) -> complex:
    """The eigenvalue nearest ``target`` of the eigensystem around ``w``."""
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType

    A, M = LinearizedNavierStokesAssembler(w, case["ctx"], re, case["bcs_pert"],
                                           case["mesh"]).assemble_eigensystem()
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    es.set_st_pc_type("banded")
    return es.solve()[0][0]


def finite_difference(case, w, sigma: complex, dre: float = 1.0) -> tuple[complex, dict]:
    """The reference's validation of d sigma/dRe: banded Newton baseflows at
    Re = 47 -/+ dre started from w, their eigenvalues near sigma, and the
    centred difference."""
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    sig = {}
    for re in (47.0 - dre, 47.0 + dre):
        solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=re)
        solver._initial_guess = w
        wr = solver.solve(tol=1e-8, max_it=40, linear_solver="banded")
        if not solver.newton_results[-1].converged:
            raise RuntimeError(f"phase 5: the Newton baseflow at Re = {re} did not converge")
        sig[re] = eigenvalue_near(case, wr, re, sigma)
    return (sig[47.0 + dre] - sig[47.0 - dre]) / (2 * dre), sig


def sensitivity_path(case, mp: dict) -> dict:
    """Phase 5: ``EigenSensitivitySolver`` at full width on phase 3's
    baseflow and (A, M), target phase 3's sigma: ``evaluate()`` (direct
    mode, adjoint mode on the transposed pair, du/dRe) and
    ``compute_wavemaker()`` with host LU and the torch substitution loops
    on CUDA tensors raising; each stage's launches, band solves, matvecs
    and plan builds read on their own; the answers held to phase 3, to the
    residuals and to the reference's own check, finite differences."""
    import torch
    from lsafw_tpu_torch.ops import sparse
    from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver
    from lsafw_tpu_torch.solver.eigen import eigen_residuals

    sigma3, A, M = mp["sigma"], mp["A"], mp["M"]
    stages: dict = {}
    solver = EigenSensitivitySolver(case["ctx"], case["mesh"], case["bcs_base"], mp["w"], 47.0,
                                    A=A, M=M, perturbation_bcs=case["bcs_pert"], target=sigma3,
                                    si_method="banded", device=DEVICE)
    for attr, name in (("solve_direct_mode", "direct"), ("solve_adjoint_mode", "adjoint"),
                       ("compute_baseflow_sensitivity", "du/dRe"),
                       ("evaluate_sensitivity", "integrals")):
        staged(solver, attr, name, stages)
    with plain_loops_forbidden():
        d_sigma = solver.evaluate()
        with stage("wavemaker", stages):
            sw = solver.compute_wavemaker()
        t0 = time.time()
        fd, sig_fd = finite_difference(case, mp["w"], sigma3)
        t_fd = time.time() - t0
    sigma, v, a, s = solver._sigma, solver._v, solver._a, solver._baseflow_sens
    A_T, M_T = sparse.transpose_pair(A, M)
    adj_res = float(eigen_residuals(A_T, M_T, [(solver.sigma_adjoint, a.cpu().numpy())])[0])
    biorth = complex(torch.vdot(a, sparse.spmv(M, v)))
    J, r = solver.baseflow_sensitivity_system()
    s_res = float(torch.linalg.vector_norm(sparse.spmv(J, s) - r) / torch.linalg.vector_norm(r))
    spaces = case["spaces"]
    p = sw[torch.as_tensor(spaces.dofs_p, device=sw.device)].abs()
    peak = spaces.pressure.node_coords[int(torch.argmax(p))]
    vel_max = float(sw[torch.as_tensor(spaces.dofs_u, device=sw.device)].abs().max())
    for name, st in stages.items():
        log(f"phase 5: {name}: {st['seconds']:.3f} s, device memory {st['resident_gb']:.3f} GB at "
            f"its start, {st['peak_gb']:.3f} GB at its peak, "
            f"band solves {st['solves']}, original-order matvecs {st['matvecs']}, plan builds "
            f"{st['builds']}; launches {nonzero(st['launches'])}")
    for name, op in solver.operators.items():
        log(f"phase 5: {name} shift-invert: factor {op['factor_s']:.3f} s, contraction "
            f"{op['rho']:.2e}, {op['applies']} applies, pivoted {op['pivoted']}, fused matvecs "
            f"{op['fused']}")
    log(f"phase 5: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j (phase 3 "
        f"{sigma3.real:+.12f}{sigma3.imag:+.12f}j), sigma_adj = "
        f"{solver.sigma_adjoint.real:+.12f}{solver.sigma_adjoint.imag:+.12f}j, adjoint residual "
        f"{adj_res:.2e}, |a^H M v - 1| = {abs(biorth - 1):.2e}")
    ds = solver.stats
    log(f"phase 5: du/dRe: {solver.baseflow_solve.iterations} GCR iterations, relative residual "
        f"{s_res:.2e} (GCR's {solver.baseflow_solve.residual:.2e}), factor {ds['factor_s']:.3f} "
        f"s, band solves {ds['solve_s']:.3f} s in {ds['solves']}, SpMV {ds['spmv_s']:.3f} s in "
        f"{ds['spmvs']}")
    log(f"phase 5: d sigma/dRe = {d_sigma.real:+.8e}{d_sigma.imag:+.8e}j; finite difference "
        f"{fd.real:+.8e}{fd.imag:+.8e}j from sigma(46) = {sig_fd[46.0]:.10f}, sigma(48) = "
        f"{sig_fd[48.0]:.10f} ({t_fd:.2f} s); |adjoint - FD| / |FD| = "
        f"{abs(d_sigma - fd) / abs(fd):.3e}")
    log(f"phase 5: wavemaker peak at ({peak[0]:.3f}, {peak[1]:.3f}), CG "
        f"{solver.wavemaker_cg.iterations} iterations to {solver.wavemaker_cg.residual:.1e}, "
        f"largest velocity slot {vel_max}; live per-pattern plans {len(sparse._PER_PATTERN)}")
    log(f"phase 5: stages " + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in stages.items())
        + f", finite difference {t_fd:.2f} s")

    checks = [
        (abs(sigma - sigma3) <= 1e-8, f"direct sigma {sigma} not within 1e-8 of phase 3's"),
        (abs(solver.sigma_adjoint - np.conj(sigma3)) <= 1e-7,
         f"sigma_adj {solver.sigma_adjoint} not within 1e-7 of conj(sigma_3)"),
        (adj_res <= 1e-8, f"adjoint residual {adj_res:.2e} > 1e-8"),
        (abs(biorth - 1) <= 1e-10, f"|a^H M v - 1| = {abs(biorth - 1):.2e} > 1e-10"),
        (s_res <= 1e-9, f"du/dRe residual {s_res:.2e} > 1e-9"),
        (abs(d_sigma - fd) <= 0.15 * abs(fd), f"d sigma/dRe {d_sigma} not within 15% of FD {fd}"),
        (d_sigma.real > 0, f"Re(d sigma/dRe) = {d_sigma.real} is not positive"),
        (0.5 < peak[0] < 5.0 and abs(peak[1]) < 2.0, f"wavemaker peak at {peak}"),
        (vel_max == 0.0, f"wavemaker velocity slots not 0 ({vel_max})"),
        (solver.wavemaker_cg.converged, "the wavemaker's CG did not converge"),
        (all(op["pivoted"] and op["fused"] for op in solver.operators.values()),
         f"a shift-invert stage did not take the pivoted factor with fused matvecs: "
         f"{solver.operators}"),
    ]
    for ok, what in checks:
        if not ok:
            raise RuntimeError(f"phase 5: {what}")
    for name, key, cls, types in (("direct", "pivoted.c64", "PivotedBandedLU", "c128.c64"),
                                  ("adjoint", "pivoted.c64", "PivotedBandedLU", "c128.c64"),
                                  ("du/dRe", "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1")):
        st = stages[name]
        n = st["solves"].get(cls, 0)
        if set(st["solves"]) != {cls}:
            raise RuntimeError(f"phase 5 {name}: band solves {st['solves']}, expected {cls} alone")
        gate_band_launches(f"phase 5 {name}", st["launches"], key, n)
        gate_permutes_and_spmv(f"phase 5 {name}", st["launches"], types, n, st["matvecs"])
        if st["builds"]:
            raise RuntimeError(f"phase 5 {name} re-planned a pattern: {st['builds']}")
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in counts()}
    return dict(launches=launches, stages=stages, d_sigma=d_sigma, fd=fd)


# ---------------------------------------------------------------------------
# Phase 6: the production cylinder
# ---------------------------------------------------------------------------


def production_case(device) -> dict:
    """The repo's production configuration, from its TOML files
    (``config_files/2D/cylinder``: domain [-40, 120] x [-40, 40],
    resolution 1.25 / 0.115), built as ``scripts/dev_167k.py`` builds it."""
    import torch
    from lsafw_tpu_torch.config import load_bc_config, load_cylinder_flow_config, load_facet_config
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    cfg = PRODUCTION_CONFIG
    mesh = cylinder_flow_mesh(load_cylinder_flow_config(cfg / "geometry.toml"))
    mark_boundary_facets(mesh, load_facet_config(cfg / "facets.toml"))
    spaces = define_spaces(mesh)
    bcs_base = define_bcs(mesh, spaces, load_bc_config(cfg / "bcs.toml"))
    bcs_pert = define_bcs(mesh, spaces, load_bc_config(cfg / "bcs_perturbation.toml"))
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0)


def log_stage(what: str, st: dict) -> None:
    log(f"{what}: {st['seconds']:.2f} s, device memory {st['resident_gb']:.3f} GB at its start, "
        f"{st['peak_gb']:.3f} GB at its peak ({st['peak_gb'] - st['resident_gb']:.3f} GB above), "
        f"band solves {st['solves']}, original-order matvecs {st['matvecs']}; launches "
        f"{nonzero(st['launches'])}")


def one_band_solve_ms(blu, device) -> float:
    """CUDA-event time of one band solve (permute-in, K1, K2, permute-out)
    of a factor on a complex128 vector from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(12)
    n = blu.n
    b = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                      torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return cuda_ms(lambda: blu.solve(b), 10)


def production_path(dev) -> dict:
    """Phase 6: the production cylinder at Re = 47, banded Newton baseflow
    (ramped, 3 steps, tol 1e-8; real pivoted f32 factors), eigensystem,
    and the shift-invert eigenpair nearest 0.74j on the default plan (the
    pivot-free complex64 band, B = 17 at nb = 128: the pivoted factor's
    extras do not fit its 8 GB budget), with host LU and the torch
    substitution loops on CUDA tensors raising; each stage read on its
    own."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    case = production_case(dev)
    stages: dict = {}
    with plain_loops_forbidden():
        with stage("baseflow", stages):
            solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=47.0)
            w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                                   case["mesh"]).assemble_eigensystem()
        with stage("eigen", stages):
            sigma, resid, op, t_eig = leading_pair(A, M)
    st, plan, rplan = solver.stats, tband.plan_for_csr(A), tband.plan_for_csr(A, real=True)
    log(f"phase 6: production cylinder: {case['spaces'].num_dofs} DOFs, mesh {case['seconds']:.2f} "
        f"s; complex plan nb = {plan.nb}, B = {plan.B}, nblk_pad = {plan.nblk_pad}, "
        f"{plan.band_dtype}; real plan B = {rplan.B}, {rplan.band_dtype}")
    for name, s_ in stages.items():
        log_stage(f"phase 6: {name}", s_)
    log(f"phase 6: baseflow: factor {st['factor_s']:.2f} s in {st['factors']} ({st['pivoted']} "
        f"pivoted), band solves {st['solve_s']:.2f} s in {st['solves']}, SpMV {st['spmv_s']:.2f} s "
        f"in {st['spmvs']}; Newton iterations {[r.iterations for r in solver.newton_results]}, GCR "
        f"iterations {st['gcr_its']}")
    log(f"phase 6: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; factor "
        f"{op.factor_seconds:.2f} s, pivoted {op.pivoted}, contraction {op.rho:.2e}, refinement "
        f"cap {op.refine_its}, {op.applies} shift-invert applies")
    if not resid <= 1e-8:
        raise RuntimeError(f"phase 6: eigen residual {resid:.2e} > 1e-8")
    if abs(sigma.real - SIGMA_175K_RE) > 1e-3 or abs(sigma - SIGMA_167K) > 3e-3:
        raise RuntimeError(f"phase 6: sigma {sigma} is not within 1e-3 of Re {SIGMA_175K_RE} and "
                           f"3e-3 of {SIGMA_167K}")
    if not all(r.converged for r in solver.newton_results):
        raise RuntimeError("phase 6: a Newton solve of the ramp did not converge")
    if rplan.band_dtype != "f32" or tband.bf16_unstable(A.pattern):
        raise RuntimeError("phase 6: the baseflow's band left f32 (the bf16 rung fired)")
    if st["pivoted"] != st["factors"] or op.pivoted or op.device_op.Cop is None:
        raise RuntimeError(f"phase 6: baseflow factors {st}, eigen pivoted {op.pivoted}; expected "
                           f"real pivoted factors and the pivot-free complex one with fused matvecs")
    base, eig = stages["baseflow"], stages["eigen"]
    for what, s_, key, cls, types in (
            ("phase 6 baseflow", base, "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1"),
            ("phase 6 eigen", eig, "pivot_free.c64", "BandedLU", "c128.c64")):
        n = s_["solves"].get(cls, 0)
        if set(s_["solves"]) != {cls}:
            raise RuntimeError(f"{what}: band solves {s_['solves']}, expected {cls} alone")
        gate_band_launches(what, s_["launches"], key, n)
        gate_permutes_and_spmv(what, s_["launches"], types, n, s_["matvecs"])
    if base["solves"]["RealPivotedBandedLU"] != st["solves"]:
        raise RuntimeError(f"phase 6: baseflow band solves {base['solves']} against {st['solves']}")
    return dict(case=case, A=A, M=M, op=op, sigma=sigma, stages=stages,
                launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})


def production_rerun(p6: dict, phase: str, key: str, **switches: str) -> dict:
    """Phase 6b / 6c: phase 6's eigen stage again under ``switches`` (a
    plan switch), read as a stage: sigma within 1e-8 of phase 6's, the
    residual gate, and K1/K2 in mode ``key`` once per band solve."""
    with env(**switches), plain_loops_forbidden():
        stages: dict = {}
        with stage("eigen", stages):
            sigma, resid, op, t_eig = leading_pair(p6["A"], p6["M"])
    st = stages["eigen"]
    blu = op.device_op.blu
    log(f"phase {phase}: {' '.join(f'{k}={v}' for k, v in switches.items())}: sigma = "
        f"{sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; factor "
        f"{op.factor_seconds:.2f} s (phase 6: {p6['op'].factor_seconds:.2f} s), nb = {blu.nb}, "
        f"B = {blu.B}, band {blu.band.dtype} {blu.band.numel() * blu.band.element_size() / 1e9:.3f} "
        f"GB, contraction {op.rho:.2e} (phase 6: {p6['op'].rho:.2e}), trial GCR solve "
        f"{op.trial_its} iterations, refinement cap {op.refine_its}, {op.applies} applies")
    log_stage(f"phase {phase}: eigen", st)
    if not resid <= 1e-8:
        raise RuntimeError(f"phase {phase}: eigen residual {resid:.2e} > 1e-8")
    if abs(sigma - p6["sigma"]) > 1e-8:
        raise RuntimeError(f"phase {phase}: sigma {sigma} is not within 1e-8 of phase 6's "
                           f"{p6['sigma']}")
    n = st["solves"].get("BandedLU", 0)
    if set(st["solves"]) != {"BandedLU"}:
        raise RuntimeError(f"phase {phase}: band solves {st['solves']}, expected BandedLU alone")
    gate_band_launches(f"phase {phase}", st["launches"], key, n)
    gate_permutes_and_spmv(f"phase {phase}", st["launches"], "c128.c64", n, st["matvecs"])
    return dict(op=op, sigma=sigma, stage=st, launches=st["launches"])


# ---------------------------------------------------------------------------
# Phase 7: the non-modal toolbox (resolvent gains, transient growth)
# ---------------------------------------------------------------------------

NONMODAL_RE = 40.0  # examples/resolvent_gains.py, examples/transient_growth.py
OMEGAS = (0.3, 1.2)  # with OMEGA_CHECK's solve, the gain curve at 0.3, 0.75, 1.2
OMEGA_CHECK, Z_CHECK = 0.75, -0.05 + 0.75j
HORIZON, CN_STEPS = 4.0, 32  # dt = 1/8: the real shift 2/dt = CN_SHIFT


def gate_stage(what: str, st: dict, key: str, cls: str, types: str, builds: int = 0) -> None:
    """One stage's band solves all of factor class ``cls``, K1/K2 in mode
    ``key`` once per band solve and nothing else, G's permute forms in
    ``types`` once each per band solve, one original-order S launch per
    original-order matvec, no flat complex128 G, and at most ``builds``
    plans built of each kind (the direct operator's, where the pattern had
    none cached: the adjoint operator shares it)."""
    n = st["solves"].get(cls, 0)
    if set(st["solves"]) != {cls}:
        raise RuntimeError(f"{what}: band solves {st['solves']}, expected {cls} alone")
    gate_band_launches(what, st["launches"], key, n)
    gate_permutes_and_spmv(what, st["launches"], types, n, st["matvecs"])
    if any(v > builds for v in st["builds"].values()):
        raise RuntimeError(f"{what} planned a pattern again: {st['builds']} (at most {builds} "
                           f"each)")


def log_operators(what: str, operators: dict) -> None:
    for name, f in operators.items():
        log(f"{what}: {name} factor {f['factor_s']:.3f} s, contraction "
            f"{f['rho'] if f['rho'] is None else format(f['rho'], '.2e')}, trial GCR solve "
            f"{f['trial_its']} iterations, refinement cap {f['refine_its']}, {f['applies']} "
            f"applies, pivoted {f['pivoted']}, fused matvecs {f['fused']}")


def recorded_responses(rs) -> list:
    """Wrap the solver's raw response so that each raw response's energy
    norm sqrt(q^H M q) is recorded (before ``solve`` normalises it)."""
    raw: list = []
    response = rs._response

    def run(si1, f):
        q = response(si1, f)
        raw.append(float(np.sqrt(rs._energy(q))))
        return q

    rs._response = run
    return raw


def gate_resolvent_modes(what: str, modes, raw: list, A, M, mask, nu: int) -> None:
    """Unit forcing and response energies (1e-8); the response solves
    (i omega M - A)(g q) = M f (1e-8 relative); the raw response
    C^-1 M f has the gain for its energy norm (1e-6 relative); the forcing
    is zero on pressure and Dirichlet DOFs."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    dev = A.device
    bad = torch.as_tensor(np.asarray(mask) | (np.arange(A.shape[0]) >= nu), device=dev)
    for j, (f, q, g) in enumerate(zip(modes.forcings, modes.responses, modes.gains)):
        f, q = (torch.as_tensor(v, device=dev) for v in (f, q))
        Mf, Mq = spmv(M, f), spmv(M, q)
        ef, eq = float(torch.vdot(f, Mf).real), float(torch.vdot(q, Mq).real)
        res = float(torch.linalg.vector_norm(1j * modes.omega * g * Mq - g * spmv(A, q) - Mf)
                    / torch.linalg.vector_norm(Mf))
        graw = raw[j]
        log(f"{what}: mode {j}: gain {g:.10f}, energies f {ef:.12f} q {eq:.12f}, response "
            f"residual {res:.2e}, raw response energy norm {graw:.10f} (rel {abs(graw - g) / g:.1e})")
        checks = [(abs(ef - 1) <= 1e-8 and abs(eq - 1) <= 1e-8, "energies not 1 within 1e-8"),
                  (res <= 1e-8, f"response residual {res:.2e} > 1e-8"),
                  (abs(graw - g) <= 1e-6 * g, f"raw response norm {graw} is not the gain {g}"),
                  (not bool(f[bad].abs().max() > 0), "forcing on pressure or Dirichlet DOFs")]
        for ok, msg in checks:
            if not ok:
                raise RuntimeError(f"{what}: mode {j}: {msg}")


def gate_growth_modes(what: str, res, M, mask, nu: int) -> None:
    """Unit initial energy (1e-8), q(T)^T M q(T) = G within 1e-6 max(G, 1),
    the initial state zero on pressure and Dirichlet DOFs."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    dev = M.device
    bad = np.asarray(mask) | (np.arange(M.shape[0]) >= nu)
    for j, (q0, qT, g) in enumerate(zip(res.initials, res.finals, res.gains)):
        q0t, qTt = (torch.as_tensor(v, device=dev) for v in (q0, qT))
        e0, eT = float(q0t @ spmv(M, q0t)), float(qTt @ spmv(M, qTt))
        log(f"{what}: mode {j}: G = {g:.10f}, initial energy {e0:.12f}, final energy {eT:.10f} "
            f"(rel {abs(eT - g) / max(g, 1):.1e})")
        if not (abs(e0 - 1) <= 1e-8 and abs(eT - g) <= 1e-6 * max(g, 1.0)
                and not np.abs(q0[bad]).max() > 0):
            raise RuntimeError(f"{what}: mode {j}: energies {e0}, {eT} against G = {g}, or an "
                               f"initial state on pressure or Dirichlet DOFs")


def nonmodal_path(case, phase: str, dev, *, sweep=(), k: int = 1, norm: bool = False,
                  cross_check: bool = False, time_factors: list | None = None) -> dict:
    """Phase 7 / 7b: the Re = 40 baseflow (ramped banded Newton, 4 steps,
    tol 1e-9) and (A, M) on ``case``; ``ResolventSolver(method="banded")``
    over ``sweep`` (k = 1), at OMEGA_CHECK with ``k`` gains and, with
    ``norm``, its ``resolvent_norm`` at Z_CHECK;
    ``TransientGrowthSolver(method="banded").solve(HORIZON, CN_STEPS)``;
    each a stage, gated; with ``cross_check`` the same (k = 2 and the norm)
    on the host LU (asked for, counted), held to the banded answers.
    ``time_factors`` receives the transient's forward factor."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.resolvent import ResolventSolver
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.transient import TransientGrowthSolver

    what = f"phase {phase}"
    t_phase = time.time()
    stages: dict = {}
    spaces = case["spaces"]
    nu, mask = spaces.num_velocity_dofs, np.asarray(case["bcs_pert"].dirichlet_mask)
    with plain_loops_forbidden():
        with stage("baseflow", stages):
            solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=NONMODAL_RE)
            w = solver.solve(ramp=True, steps=4, tol=1e-9, max_it=40, linear_solver="banded")
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, case["ctx"], NONMODAL_RE, case["bcs_pert"],
                                                   case["mesh"]).assemble_eigensystem()
        if not all(r.converged for r in solver.newton_results):
            raise RuntimeError(f"{what}: a Newton solve of the Re = 40 ramp did not converge")
        rs = ResolventSolver(A, M, nu, mask, method="banded", device=dev)
        figures: dict = {}
        curve = []
        for om in sweep:
            with stage(f"resolvent omega={om}", stages):
                curve.append(rs.solve(om, k=1))
            figures[f"resolvent omega={om}"] = (rs.operators, rs.applies)
        raw = recorded_responses(rs)
        with stage(f"resolvent omega={OMEGA_CHECK} k={k}", stages):
            modes = rs.solve(OMEGA_CHECK, k=k)
        figures[f"resolvent omega={OMEGA_CHECK} k={k}"] = (rs.operators, rs.applies)
        rnorm = None
        if norm:
            with stage(f"resolvent norm z={Z_CHECK}", stages):
                rnorm = rs.resolvent_norm(Z_CHECK, tol=1e-9)
            figures[f"resolvent norm z={Z_CHECK}"] = (rs.operators, rs.applies)
        ts = TransientGrowthSolver(A, M, nu, mask, method="banded", device=dev)
        with stage(f"transient T={HORIZON:g}", stages):
            growth = ts.solve(HORIZON, CN_STEPS)
        figures[f"transient T={HORIZON:g}"] = (ts.operators, ts.applies)
        fw, ad, s = ts._propagators(HORIZON / CN_STEPS)
        if time_factors is not None:
            time_factors.append(fw.device_op.blu)
        if cross_check:  # one T apply of the optimal initial state, for the host LU's
            q0 = torch.as_tensor(growth.initials[0], device=A.device)
            z_bd = ts._march_adjoint(ad, s, ts._mass(ts._march(fw, q0, CN_STEPS)), CN_STEPS)
    del ts, fw, ad  # the transient's two factors
    for name, st in stages.items():
        log_stage(f"{what}: {name}", st)
        if name in figures:
            ops, applies = figures[name]
            log(f"{what}: {name}: {applies} T applies")
            log_operators(f"{what}: {name}", ops)
    curve = sorted(curve + [modes], key=lambda m: m.omega)
    log(f"{what}: {spaces.num_dofs} DOFs, Re = {NONMODAL_RE:g}: Newton iterations "
        f"{[r.iterations for r in solver.newton_results]}; gain curve " + ", ".join(
            f"sigma_1({m.omega:g}) = {m.gains[0]:.10f}" for m in curve))
    log(f"{what}: omega = {OMEGA_CHECK}: gains {modes.gains.tolist()}; ||R({Z_CHECK})||_E = "
        f"{rnorm}; transient G({HORIZON:g}) = {growth.gains[0]:.10f} ({CN_STEPS} CN steps)")
    gate_resolvent_modes(f"{what} resolvent", modes, raw, A, M, mask, nu)
    gate_growth_modes(f"{what} transient", growth, M, mask, nu)
    first = True
    for name, st in stages.items():
        if name.startswith("resolvent"):
            ops = figures[name][0]
            pivoted = ops["direct"]["pivoted"]
            if ops["adjoint"]["pivoted"] != pivoted or not all(o["fused"] for o in ops.values()):
                raise RuntimeError(f"{what} {name}: operators {ops}")
            gate_stage(f"{what} {name}", st, "pivoted.c64" if pivoted else "pivot_free.c64",
                       "PivotedBandedLU" if pivoted else "BandedLU", "c128.c64", int(first))
            first = False
        elif name.startswith("transient"):
            ops = figures[name][0]
            if not all(o["pivoted"] and o["fused"] for o in ops.values()):
                raise RuntimeError(f"{what} {name}: the factors are not real pivoted with fused "
                                   f"matvecs: {ops}")
            gate_stage(f"{what} {name}", st, "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1")
            if not st["launches"]["spmv_shifted_real.original"]:
                raise RuntimeError(f"{what} {name}: no real-shift S launch")
    out = dict(curve=curve, modes=modes, rnorm=rnorm, growth=growth, stages=stages,
               launches={k: sum(st["launches"][k] for st in stages.values()) for k in counts()})
    if cross_check:  # needs k = 2 and the norm
        # The resolvent's gains and norm are solved again on the host LU.  The
        # transient's full gain solve on it would take 2,752 sequential host
        # solves: instead the host-LU propagators march the banded optimum q0,
        # whose energy at T is the Rayleigh quotient of the host-LU gain
        # operator (equal to G to second order in q0's error), and apply the
        # gain operator to q0, held vector by vector.
        t0 = time.time()
        with host_lu_counted() as hl:
            rs_lu = ResolventSolver(A, M, nu, mask, method="lu", device=dev)
            g_lu = rs_lu.solve(OMEGA_CHECK, k=2).gains
            n_lu = rs_lu.resolvent_norm(Z_CHECK, tol=1e-9)
            ts_lu = TransientGrowthSolver(A, M, nu, mask, method="lu", device=dev)
            fw_lu, ad_lu, s = ts_lu._propagators(HORIZON / CN_STEPS)
            qT = ts_lu._march(fw_lu, q0, CN_STEPS)
            z_lu = ts_lu._march_adjoint(ad_lu, s, ts_lu._mass(qT), CN_STEPS)
            G_lu = float(qT @ ts_lu._mass(qT))
        rel_g = float(np.abs(modes.gains - g_lu).max() / np.abs(g_lu).max())
        rel_n, rel_G = abs(rnorm - n_lu) / n_lu, abs(growth.gains[0] - G_lu) / G_lu
        rel_z = float(torch.linalg.vector_norm(z_lu - z_bd) / torch.linalg.vector_norm(z_bd))
        rel_q = float(np.abs(qT.cpu().numpy() - growth.finals[0]).max()
                      / np.abs(growth.finals[0]).max())
        log(f"{what}: the host LU, asked for ({hl['host_lu']} host LU factors, "
            f"{time.time() - t0:.2f} s): gains {g_lu.tolist()} (rel {rel_g:.1e}), norm {n_lu:.10f} "
            f"(rel {rel_n:.1e}); the banded optimum's energy at T under the host-LU propagator "
            f"{G_lu:.10f} (rel {rel_G:.1e}), its state at T rel {rel_q:.1e}, the gain "
            f"operator's image rel {rel_z:.1e}")
        if hl["host_lu"] != 6 or not (rel_g <= 1e-6 and rel_n <= 1e-5 and rel_G <= 1e-6
                                      and rel_q <= 1e-6 and rel_z <= 1e-6):
            raise RuntimeError(f"{what}: banded against host LU: gains rel {rel_g:.1e} (1e-6), "
                               f"norm rel {rel_n:.1e} (1e-5), G rel {rel_G:.1e}, q(T) rel "
                               f"{rel_q:.1e}, T q0 rel {rel_z:.1e} (1e-6 each), {hl['host_lu']} host "
                               f"LU factors (6)")
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.solver import band as tband

    t_start = time.time()
    dev = torch.device(DEVICE)
    name_power = card()
    log(f"phase 1: card {name_power}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()

    nb = 128
    errs: dict = {}  # launch key ("K1.pivoted.c64", ...) -> max abs error over phases 2 and 4
    random_entries: dict = {}  # launch key -> phase 2's kernels-line entry

    def note(out: dict, f, kind: str) -> None:
        for k, (a, _) in out.items():
            errs[key_of(k, f, kind)] = max(errs.get(key_of(k, f, kind), 0.0), a)

    for (nb2, storage), shapes in PHASE2_SHAPES.items():
        bf16 = storage == "bf16"
        for B, nblk in shapes:
            for real in (False, True):
                for pivoted in ((False,) if bf16 else (False, True)):  # pivoted: never bf16
                    f = (random_pivoted(B, nb2, nblk, dev, real) if pivoted
                         else random_band(B, nb2, nblk + B, nblk, dev, real, bf16))
                    for seed, kind in enumerate(kinds(f)):
                        b = rhs(kind, nblk, nb2, dev, seed)
                        note(check_kernels(f, b, f"phase 2 random B={B} nblk={nblk}"), f, kind)
                        fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
                        y = fwd(b)
                        ms = {"K1": cuda_ms(lambda: fwd(b), 5), "K2": cuda_ms(lambda: bwd(y), 5)}
                        plain = {"K1": cuda_ms(lambda: fwd_plain(b), 1),
                                 "K2": cuda_ms(lambda: bwd_plain(y), 1)}
                        log(f"  phase 2 random B={B} nblk={nblk}: {mode_name(f, kind)}: K1 "
                            f"{ms['K1']:.4f} ms, K2 {ms['K2']:.4f} ms")
                        for k in ms:  # the last shape's, for modes no main path runs
                            random_entries[key_of(k, f, kind)] = band_entry(
                                k, f, kind, f", random factor B={B} nblk={nblk}",
                                errs[key_of(k, f, kind)], ms[k], plain[k])
                    del f
    gi = gather_inputs(dev)
    g_errs = check_gather(gi)
    for nb2, n in ((nb, 10007), (256, 20011)):
        br, bc, perm, iperm = random_permutation(n, nb2, dev, seed=4)
        check_permutes(permute_cases(br, bc, perm, iperm, nb2),
                       f"on a random permutation at nb = {nb2}")
    rop = random_shifted_op(20011, dev, seed=5)
    check_spmv(spmv_cases(rop, dev), "on a random matrix")
    del rop
    log(f"phase 2: K1/K2 match their plain versions in both modes and every type, f32 and bf16 "
        f"storage, at (B, block rows) per (nb, storage) {PHASE2_SHAPES}; G matches x[idx] at the "
        f"probes' shapes, its permute forms their plain versions at nb = 128 and 256; S its "
        f"plain version in every mode and order")
    if "--kernels" in sys.argv[1:]:
        return 0

    forbid_host_lu()
    case = cylinder_case(dev)
    with plain_loops_forbidden():
        mp = main_path(case)
    pf = pivot_free_path(mp["A"], mp["M"], mp["sigma"])
    p3c = bf16_path(case, mp, pf)

    # phase 4: agreement and times
    cop = mp["op"].device_op.Cop
    cases = spmv_cases(cop, dev)
    s_errs = check_spmv(cases, "on the main path's (A, M)")
    mg = main_path_gathers(mp["A"], cop, dev)
    mg_errs = check_main_gathers(mg)
    with env(LSAFW_PIVOT_MEM_GB="0"):  # phase 3c's real bf16 band, factored again
        J = p3c["J"]
        jac_bf16 = tband.factor_auto(p3c["rplan"], J.data, diag_slots=J.pattern.diag_slots)[0]
    kernels = band_kernels([("", f) for f in main_path_factors(mp, pf)]
                           + [(", 43k phase 3c", p3c["op"].device_op.blu),
                              (", 43k phase 3c Jacobian", jac_bf16)], errs, dev)
    del jac_bf16
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
                            replaces=line, launches=launches[key], _key=key, max_abs_err=err,
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
                 replaces=run_a, launches=launches[f"permute_{form}.{types}"],
                 _key=f"permute_{form}.{types}", max_abs_err=0.0,
                 ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)
        kernels.append(e)
        log(f"phase 4: G permute-{form} {types}: one call with its host overhead (CUDA events) "
            f"{cuda_ms(kern, 20):.4f} ms, plain {cuda_ms(plain, 20):.4f} ms")
        if on_main:
            log(f"phase 4: G permute-{form} {types}: the op sequence it replaces: cold "
                f"{cold_ms(seq):.4f} ms, with its host overhead {cuda_ms(seq, 20):.4f} ms")
    s_lines = {"real": "lsafw_tpu/ops/bcsr.py:388", "shifted": "lsafw_tpu/ops/bcsr.py:615",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:587", "mass": "lsafw_tpu/ops/bcsr.py:622",
               "shifted_real": "lsafw_tpu/ops/bcsr.py:615",
               "shifted_real_mass": "lsafw_tpu/ops/bcsr.py:587"}
    o_lines = {"real": "lsafw_tpu/ops/bcsr.py:446", "shifted": "lsafw_tpu/ops/bcsr.py:638",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:638", "mass": "lsafw_tpu/ops/bcsr.py:646",
               "shifted_real": "lsafw_tpu/ops/bcsr.py:638",
               "shifted_real_mass": "lsafw_tpu/ops/bcsr.py:638"}
    s_names = {"real": "real", "shifted": "shifted", "shifted_mass": "shifted+mass",
               "mass": "mass", "shifted_real": f"shifted, f64 x at the real shift {CN_SHIFT:g}",
               "shifted_real_mass": f"shifted+mass, f64 x at the real shift {CN_SHIFT:g}"}
    libs = spmv_library(mp["A"], mp["M"], cop.sigma, dev)
    ntiles = cop.plan.tile_row.size - 1
    for (mode, order), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(*spmv_work(mode, order, cop.plan.n, cop.plan.nnz, ntiles),
                                   FP64_FLOPS_PER_S)
        key = S_KEYS[mode] + ("" if order == "permuted" else ".original")
        # the complex shifted operator never asks for both outputs; the real one
        # does (the Cayley right-hand side of phase 7), and a mode with M x counts
        # its launches under the same mode without it (one kernel, one key)
        on_main = order == "original" and mode != "shifted_mass"
        paired = mode in ("shifted_mass", "shifted_real_mass")
        note = (" (launches counted with the mode without M x)" if paired and on_main else
                "" if on_main else " (not on the main path)")
        e = dict(name=f"csr_tiled_spmv_kernel (S), {s_names[mode]}, {order} order{note}",
                 route="cuda", source=src,
                 replaces=(s_lines if order == "permuted" else o_lines)[mode],
                 launches=0 if paired else launches[key],
                 _key=None if paired else key,
                 max_abs_err=s_errs[(mode, order)], ms=cold_ms(kern), plain_ms=cold_ms(plain),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=cold_ms(libs[mode]))
        kernels.append(e)
        log(f"phase 4: S {mode} {order}: with L2 warm (graph replays) {graph_ms(kern):.4f} ms, "
            f"cuSPARSE {graph_ms(libs[mode]):.4f} ms; one call with its host overhead (CUDA "
            f"events) {cuda_ms(kern, 20):.4f} ms, cuSPARSE {cuda_ms(libs[mode], 20):.4f} ms")
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

    p5 = sensitivity_path(case, mp)
    mp_launches, pf_launches, p3c_launches = mp["launches"], pf["launches"], p3c["launches"]
    del mp, pf, p3c, cop, cases, mg, p5["stages"]
    torch.cuda.empty_cache()
    p7 = nonmodal_path(case, "7", dev, sweep=OMEGAS, k=2, norm=True, cross_check=True)
    del case, p7["stages"]
    torch.cuda.empty_cache()

    p6 = production_path(dev)
    p6b = production_rerun(p6, "6b", "pivot_free.c64.nb256", LSAFW_BAND_NB="256")
    p6c = production_rerun(p6, "6c", "pivot_free.bf16.c64", LSAFW_BAND_MEM_GB="4")
    eig6, eig6c = p6["stages"]["eigen"], p6c["stage"]
    above6, above6c = (s_["peak_gb"] - s_["resident_gb"] for s_ in (eig6, eig6c))
    solve_ms = {ph: one_band_solve_ms(r["op"].device_op.blu, dev)
                for ph, r in (("6", p6), ("6b", p6b), ("6c", p6c))}
    log(f"phase 6: one band solve (permute-in, K1, K2, permute-out) {solve_ms['6']:.3f} ms at "
        f"nb = 128 (phase 6), {solve_ms['6b']:.3f} ms at nb = 256 (6b), {solve_ms['6c']:.3f} ms on "
        f"the bf16 band (6c); factors {p6['op'].factor_seconds:.2f} / "
        f"{p6b['op'].factor_seconds:.2f} / {p6c['op'].factor_seconds:.2f} s; eigen stages "
        f"{eig6['seconds']:.2f} / {p6b['stage']['seconds']:.2f} / {eig6c['seconds']:.2f} s")
    log(f"phase 6c: peak device memory {above6c:.3f} GB above the stage's start against phase 6's "
        f"{above6:.3f} GB: {above6c / max(above6, 1e-9):.3f} (limit 0.6)")
    if not above6c <= 0.6 * above6:
        raise RuntimeError(f"phase 6c: the bf16 stage's peak {above6c:.3f} GB above its start is "
                           f"over 0.6 x phase 6's {above6:.3f} GB")
    # phase 4, continued: K1/K2 on the production factors
    kernels += band_kernels([(", 175k phase 6", p6["op"].device_op.blu),
                             (", 175k phase 6b", p6b["op"].device_op.blu),
                             (", 175k phase 6c", p6c["op"].device_op.blu)], errs, dev)
    mains = {"3": mp_launches, "3b": pf_launches, "3c": p3c_launches, "6": p6["launches"],
             "6b": p6b["launches"], "6c": p6c["launches"]}
    case6 = p6["case"]
    del p6, p6b, p6c
    torch.cuda.empty_cache()

    transient_factors: list = []
    p7b = nonmodal_path(case6, "7b", dev, time_factors=transient_factors)
    del case6, p7b["stages"]
    # phase 4, continued: K1/K2 pivoted f32 on the 175k transient's real factor
    kernels += band_kernels([(", 175k phase 7b", transient_factors[0])], errs, dev)
    del transient_factors
    log(f"phase 7: phases 7 and 7b took {p7['seconds'] + p7b['seconds']:.1f} s (budget 150 s)")
    timed = {e["_key"] for e in kernels}
    kernels += [e for key, e in random_entries.items() if key not in timed]
    for e in kernels:
        key = e.pop("_key")
        if key:
            e["launches"] = sum(m[key] for m in mains.values())
        e["launches_phase5"] = p5["launches"][key] if key else 0
        e["launches_phase6"] = sum(mains[ph][key] for ph in ("6", "6b", "6c")) if key else 0
        e["launches_phase7"] = p7["launches"][key] + p7b["launches"][key] if key else 0
    for e in kernels:
        log(f"phase 4: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{100 * e['bound_ms'] / e['ms']:.1f}% of bound, {e['launches']} launches "
            f"({e['launches_phase5']} in phase 5, {e['launches_phase6']} in phase 6, "
            f"{e['launches_phase7']} in phase 7)")
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")

    log(name_power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
