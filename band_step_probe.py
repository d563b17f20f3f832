#!/usr/bin/env python3
"""Where a step of the band substitution kernels K1/K2 spends its time.

    python3 band_step_probe.py   # needs one CUDA card; run from the repo root

Builds instrumented copies of ``lsafw_tpu_torch/csrc/band_subst.cu``: the
first thread of the cluster's first block reads ``clock64()`` at the
borders of each step's parts and sums the cycles in shared memory, and
the producer thread of that block sums the cycles of its refills.  Parts
of a step:

  pre              from the last step's barrier to the row dots (the side
                   buffer's wait; the pivoted forward's window gather);
  dots             the first warp's row dots over the factor tiles in
                   shared memory, with its waits for tiles that have not
                   landed (shown again on their own as ``tile waits``);
  sync             the computing warps' barrier after the dots (the first
                   warp waiting for the others' dots);
  reduce+bcast     the sums of the partial dots, the result's store and
                   its broadcast into every block's window (DSMEM);
  cluster barrier  the cluster's arrive/wait that publishes the step.

Variants, each built and timed in the same run (the last two give wrong
results: they only time what they leave out):

  main      the kernels as committed, instrumented;
  cluster8  clusters of at most 8 blocks instead of 16;
  novec     the row dots multiply each factor entry by itself instead of
            loading the shared-memory vector (times the vector loads;
            complex64 and float32 with one column);
  noshfl    no shuffle sums over a row's lanes.

Each line gives the mode, type and kernel, the median CUDA-event time of
one call (and of the committed, uninstrumented kernel), and the cycles per
step of each part, on random factors at the 43k cylinder's shapes
(B = 7, nb = 128, 384 block rows) as ``chip_smoke.py`` builds them.
"""

from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from lsafw_tpu_torch.solver import band_cuda as bc
from lsafw_tpu_torch.utils.cuda_build import BUILD_DIR, compile_library

PARTS = {5: "pre", 1: "dots", 2: "sync", 3: "reduce+bcast", 4: "cluster barrier"}
ASIDE = {6: "tile waits", 7: "producer refill"}  # inside dots / off the critical path

HEAD = r"""
__device__ unsigned long long g_prof[16];
__device__ __forceinline__ long long* prof_sm() { __shared__ long long p[16]; return p; }
__device__ __forceinline__ unsigned prof_rank() {
  unsigned r; asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r)); return r; }
__device__ __forceinline__ bool prof_me() { return threadIdx.x == 0 && prof_rank() == 0; }
#define PMARK(i) if (prof_me()) { \
    long long _t = clock64(); prof_sm()[i] += _t - prof_sm()[15]; prof_sm()[15] = _t; }
#define PSTART if (prof_me()) { \
    for (int _i = 0; _i < 15; ++_i) prof_sm()[_i] = 0; prof_sm()[15] = clock64(); }
#define PEND if (prof_me()) { \
    for (int _i = 0; _i < 15; ++_i) atomicAdd(&g_prof[_i], (unsigned long long)prof_sm()[_i]); }
"""

READ = r"""
extern "C" int probe_read(unsigned long long* out) {
  static unsigned long long zeros[16];
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
  return (int)e;
}
"""


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"band_subst.cu no longer holds, once, the text:\n{old}")
    return src.replace(old, new)


def instrumented(src: str) -> str:
    src = replace_once(src, "namespace {\n", "namespace {\n" + HEAD)
    # the static shared array above takes 128 bytes from the ring
    src = replace_once(src, "constexpr size_t kSmemMax = 232448;",
                       "constexpr size_t kSmemMax = 232448 - 1024;")
    src = replace_once(src, "  for (int c0 = 0; c0 < n; c0 += ring.nt) {\n",
                       "  for (int c0 = 0; c0 < n; c0 += ring.nt) {\n    PMARK(5);\n")
    src = replace_once(src, "      ring.wait(slot0",
                       "      long long _w0 = clock64();\n      ring.wait(slot0")
    src = replace_once(src, "                slot0 + j < ring.nt ? fill0 : fill0 + 1);\n",
                       "                slot0 + j < ring.nt ? fill0 : fill0 + 1);\n"
                       "      if (prof_me()) prof_sm()[6] += clock64() - _w0;\n")
    src = replace_once(src, "  if (threadIdx.x == kProducer) refill(consumed);",
                       "  if (threadIdx.x == kProducer) {\n    long long _r0 = clock64();\n"
                       "    refill(consumed);\n    if (prof_rank() == 0) atomicAdd(&g_prof[7], "
                       "(unsigned long long)(clock64() - _r0));\n  }")
    sync = "    if (threadIdx.x < kWarps * 32) consumer_sync();\n"
    src = replace_once(src, sync + "    if (c0 + nc < n || more) {",
                       "    PMARK(1);\n" + sync + "    PMARK(2);\n    if (c0 + nc < n || more) {")
    src, n = re.subn(r"\n(    publish\(refill, [^;]*\);)\n  }\n}\n",
                     r"\n    PMARK(3);\n\1\n    PMARK(4);\n  }\n  PEND;\n}\n", src)
    starts = src.count("  cluster.sync();\n")
    src = src.replace("  cluster.sync();\n", "  cluster.sync();\n  PSTART;\n")
    if n != 3 or starts != 3:
        raise RuntimeError(f"expected three step loops in band_subst.cu, found {n} ends and "
                           f"{starts} starts")
    return src + READ


def variants(src: str) -> dict:
    main = instrumented(src)
    load_vec = "    const float4 x = reinterpret_cast<const float4*>(v)[p];\n"
    if main.count(load_vec) != 2:
        raise RuntimeError("band_subst.cu no longer loads the vectors of C64 and R32x1 as before")
    return {
        "main": main,
        "cluster8": replace_once(main, "constexpr int kMaxCluster = 16;",
                                 "constexpr int kMaxCluster = 8;"),
        "novec": main.replace(load_vec, "    const float4 x = a;\n"),
        "noshfl": replace_once(main, "    for (int off = kLpr / 2; off > 0; off >>= 1) "
                               "acc = vadd(acc, shfl_xor(acc, off));\n", ""),
    }


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.band_fwd.argtypes = [i32, i32, p, p, p, i64, i64, i32, p]
    lib.band_fwd_pivoted.argtypes = [i32, p, p, p, p, p, i64, i32, p]
    lib.band_bwd.argtypes = [i32, i32, p, p, p, p, i64, i64, i32, i32, i32, p]
    lib.probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    for f in (lib.band_fwd, lib.band_fwd_pivoted, lib.band_bwd, lib.band_nb, lib.probe_read):
        f.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("band_step_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"card {cs.card()}")
    src = bc._SRC.read_text()
    out = BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, code in variants(src).items():
        paths.append(out / f"band_subst_{name}.cu")
        paths[-1].write_text(code)
    with ThreadPoolExecutor(max_workers=len(paths) + 1) as pool:
        committed, *built = pool.map(lambda src: compile_library(src, ("BAND_NB=128",)),
                                     [bc._SRC] + paths)
    libs = {p.stem.removeprefix("band_subst_"): load(lib) for p, lib in zip(paths, built)}
    bc._libs.clear()
    bc._load(128)
    buf = (ctypes.c_ulonglong * 16)()
    B, nblk, nb = 7, 384, 128
    for real, pivoted in ((False, False), (False, True), (True, True)):
        f = (cs.random_pivoted(B, nb, nblk, dev, real) if pivoted
             else cs.random_band(B, nb, nblk + B, nblk, dev, real))
        kind = cs.kinds(f)[0]
        b = cs.rhs(kind, nblk, nb, dev, 0)
        fwd, fwd_plain, bwd, _ = cs.substitutions(f)
        y = fwd_plain(b)
        steps = nblk if pivoted else nblk + B
        for kname, fn in (("K1", lambda: fwd(b)), ("K2", lambda: bwd(y))):
            committed_lib = bc._libs[128]
            base_ms = cs.cuda_ms(fn, 20)
            for vname, lib in libs.items():
                bc._libs[128] = lib
                fn()
                torch.cuda.synchronize()
                bc.raise_on(lib.probe_read(buf), "probe_read")
                ms = cs.cuda_ms(fn, 20)  # one warm-up and 20 timed calls
                bc.raise_on(lib.probe_read(buf), "probe_read")
                per = {i: buf[i] / (21 * steps) for i in (*PARTS, *ASIDE)}
                total = sum(per[i] for i in PARTS)
                cs.log(f"{vname:8s} {cs.mode_of(f):10s} {kind} {kname}: {ms:.4f} ms a call "
                       f"(uninstrumented {base_ms:.4f} ms), {1e3 * ms / steps:.3f} us a step; "
                       f"cycles a step {total:.0f}: "
                       + ", ".join(f"{PARTS[i]} {per[i]:.0f}" for i in PARTS)
                       + "; " + ", ".join(f"{ASIDE[i]} {per[i]:.0f}" for i in ASIDE))
            bc._libs[128] = committed_lib
        del f
    cs.log(f"built from {committed.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
