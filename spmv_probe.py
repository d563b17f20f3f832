#!/usr/bin/env python3
"""Design variants of the tiled CSR SpMV (S) at the 43k cylinder's shapes.

    python3 spmv_probe.py   # needs one CUDA card; run from the repo root

Builds copies of ``lsafw_tpu_torch/csrc/spmv_gather.cu`` that differ in
constants (a tile's nonzeros ``kCap``, the lanes that reduce one row
``kG``, the x gathers each lane keeps in flight ``kPer``) or in one line
of text, and times S with each, and with tiles of at most 256 or 64 rows, on
the 43k cylinder's pattern (``chip_smoke.cylinder_case``, the main
path's RCM plan) with values and vectors from a seed.  Each variant but
the timing-only ones is first held against the plain version (relative
error <= 1e-12).

Each line gives the variant, the mode and order, the tiles, and the time
of one call with the L2 cache evicted by a write (``chip_smoke.cold_ms``,
with the cold time's share of the byte bound, ``chip_smoke.spmv_work``),
evicted by a read (``cold_after_read_ms``: no dirty lines to write back)
and warm (``chip_smoke.graph_ms``).
"""

from __future__ import annotations

import dataclasses
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from lsafw_tpu_torch.ops import bcsr
from lsafw_tpu_torch.ops import spmv_cuda as sc
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.utils.cuda_build import BUILD_DIR, compile_library

# name -> (constants to set, a text edit or None, tile cap in nonzeros)
VARIANTS = {
    "committed": ({}, None, 2048),
    "kG4 kPer8": ({"kG": 4, "kPer": 8}, None, 2048),
    "kCap1024": ({"kCap": 1024}, None, 1024),
    "kCap1024 kG4 kPer8": ({"kCap": 1024, "kG": 4, "kPer": 8}, None, 1024),
    "kCap512": ({"kCap": 512}, None, 512),
    # timing only (wrong results): each lane reads x at its row instead of
    # gathering it, so x costs one L1 line a row: what the gathers cost
    "x at the row": ({}, ("gather_at(x, (int64_t)scol[k])", "gather_at(x, (int64_t)r)"), 2048),
}
ROW_CAPS = (256, 64)
MODES = (("shifted", "original"), ("real", "original"), ("mass", "original"),
         ("shifted", "permuted"))


def variant_source(consts: dict, edit) -> str:
    text = sc._SRC.read_text()
    for name, value in consts.items():
        text, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                             text)
        if hits != 1:
            raise RuntimeError(f"spmv_gather.cu has no single 'constexpr int {name}'")
    if edit is not None:
        if edit[0] not in text:
            raise RuntimeError(f"spmv_gather.cu has no '{edit[0]}'")
        text = text.replace(edit[0], edit[1])
    return text


_READ_FLUSH: list = []


def cold_after_read_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """``chip_smoke.cold_ms`` with the L2 evicted by a 128 MB read (a sum)
    instead of a write: the read leaves clean lines, as the band solves'
    factor reads do, so ``fn`` writes no dirty lines back to HBM."""
    if not _READ_FLUSH:
        _READ_FLUSH.append(torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    evict = _READ_FLUSH[0].sum
    return cs.graph_ms(lambda: (evict(), fn()), calls, reps) - cs.graph_ms(evict, calls, reps)


def main() -> int:
    if not torch.cuda.is_available():
        print("spmv_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"card {cs.card()}")
    paths = {}
    for name, (consts, edit, _) in VARIANTS.items():
        if consts or edit:
            path = BUILD_DIR / "probe" / f"spmv_gather_{name.replace(' ', '_')}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(variant_source(consts, edit))
            paths[name] = path
        else:
            paths[name] = sc._SRC
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        list(pool.map(compile_library, paths.values()))

    case = cs.cylinder_case(dev)
    pat = case["ctx"].pattern
    g = torch.Generator(device=dev).manual_seed(7)
    A = CSRMatrix(pat, torch.randn(pat.nnz, generator=g, device=dev, dtype=torch.float64))
    M = CSRMatrix(pat, torch.randn(pat.nnz, generator=g, device=dev, dtype=torch.float64))
    cop = bcsr.BCSRShiftedOp.from_csr(A, M, 0.74j)
    plan = cop.plan
    for name, path in paths.items():
        sc._lib, sc._SRC = None, path
        consts, edit, cap = VARIANTS[name]
        for row_cap in ROW_CAPS:
            tile_row, tile_ptr = sc.plan_tiles(plan.indptr, cap=cap, row_cap=row_cap)
            tr, tp = (torch.as_tensor(a, device=dev) for a in (tile_row, tile_ptr))
            csrs = {k: dataclasses.replace(plan.on(dev, k), tile_row=tr, tile_ptr=tp)
                    for k in ("permuted", "original")}
            cases = cs.spmv_cases(cop, dev, csrs)
            for mode, order in MODES:
                kern, plain = cases[(mode, order)]
                err = cs.rel_err(kern(), plain())[1]
                if edit is None and not err <= cs.SPMV_REL_TOL:
                    raise RuntimeError(f"{name}: S {mode} {order} disagrees (rel {err:.2e})")
                cold, clean = cs.cold_ms(kern), cold_after_read_ms(kern)
                warm = cs.graph_ms(kern)
                need = cs.spmv_work(mode, order, plan.n, plan.nnz, tile_row.size - 1)
                bound_ms = cs.bound(*need, cs.FP64_FLOPS_PER_S)[0]
                cs.log(f"{name}: S {mode} {order}, tiles of <= {row_cap} rows "
                       f"({tile_row.size - 1}): cold {1e3 * cold:.2f} us "
                       f"({100 * bound_ms / cold:.1f}% of the bound, {1e3 * bound_ms:.2f} us), "
                       f"cold after a read {1e3 * clean:.2f} us ({100 * bound_ms / clean:.1f}%), "
                       f"warm {1e3 * warm:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
