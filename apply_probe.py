#!/usr/bin/env python3
"""Device operations, wall time and busy share of the main path's inner
loops, for the port in a given checkout.

    python3 apply_probe.py [CHECKOUT]   # needs one CUDA card; CHECKOUT
                                        # defaults to this script's own

Imports ``lsafw_tpu_torch`` from CHECKOUT (an unpacked ``git archive`` of
another commit, say) and the measuring helpers from this script's own
``chip_smoke.py``, so that two commits are measured the same way in one
call: run them in turns (parent, change, change, parent).  It runs the
43k cylinder's banded baseflow (``chip_smoke.cylinder_case``, Re = 47)
and assembles (A, M), then measures under ``torch.profiler``
(``chip_smoke.device_busy``), three times each after two warm-up runs:

  * one shift-invert apply of ``ShiftInvertOperator(A, M, 0.74j)``
    (the pivoted complex factor and its GCR refinement);
  * eight GCR iterations of the baseflow's refinement ``_banded_mr`` on
    the real pivoted factor of A - 0 M (``chip_smoke.gcr_iterations``).

Each line gives the checkout, the loop, the device operations (kernels,
copies and fills), the wall time and the busy share.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import torch

    import lsafw_tpu_torch

    if not Path(lsafw_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"lsafw_tpu_torch came from {lsafw_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        print("apply_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    dev = torch.device("cuda")
    label = root.name
    case = cs.cylinder_case(dev)
    solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=47.0)
    w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
    A, M = LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                           case["mesh"]).assemble_eigensystem()
    op = ShiftInvertOperator(A, M, cs.TARGET)
    g = torch.Generator(device=dev).manual_seed(5)
    v = torch.complex(torch.randn(A.shape[0], generator=g, device=dev, dtype=torch.float64),
                      torch.randn(A.shape[0], generator=g, device=dev, dtype=torch.float64))
    for _ in range(2):
        op.apply(v)
    for _ in range(3):
        wall, busy, ops = cs.device_busy(lambda: op.apply(v))
        cs.log(f"{label}: one shift-invert apply: {ops} device operations, {wall:.2f} ms wall, "
               f"the card busy {busy:.2f} ms ({100 * busy / wall:.1f}%)")
    mp = dict(A=A, M=M, op=op)
    for _ in range(3):
        wall, busy, ops, its = cs.gcr_iterations(mp, dev)
        cs.log(f"{label}: {its} GCR iterations of the baseflow's refinement: {ops} device "
               f"operations ({ops / its:.1f} per iteration), {wall:.2f} ms wall, the card busy "
               f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
