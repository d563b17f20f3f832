#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases, one line each (a failure raises and the exit code is non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build;
  2. the band-substitution kernels K1/K2 against their plain PyTorch
     versions on the card, on a random band at the 43k cylinder shapes
     (B = 7, nb = 128, rows_total = 391), scaled by 2e-3 so the
     recursion stays bounded: relative error <= 1e-5;
  3. the port's main path: the reduced cylinder (43,671 Taylor-Hood
     DOFs) at Re = 47, ramped Newton baseflow, eigensystem, shift-invert
     Krylov-Schur at 0.74j on the pivot-free band factor whose
     substitution runs through K1/K2.  Launch counts are zeroed just
     before and read just after; the leading eigenvalue must be within
     1e-4 of +0.0050+0.7526j with residual <= 1e-8.  The card's factor
     must contract within 3x of the same factor built in f32 on the host
     CPU (TF32 or another reduced-precision product would show here);
  4. K1/K2 against their plain versions on the slice's own factor, and
     their times (median of CUDA-event timings) beside the bound.

The last lines are the card's name and power limit, one JSON object of
kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SIGMA_REF = 0.0050 + 0.7526j  # reduced cylinder at Re = 47, recorded to 4 digits
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REL_TOL = 1e-5


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


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def check_kernels(band, dinv, b, what: str) -> dict:
    """K1 and K2 against their plain versions on the same inputs (K2 takes
    the plain forward result for both)."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda

    y_ref = band_cuda.fwd_substitute_plain(band, b)
    y = band_cuda.fwd_substitute(band, b)
    x_ref = band_cuda.bwd_substitute_plain(band, dinv, y_ref)
    x = band_cuda.bwd_substitute(band, dinv, y_ref)
    torch.cuda.synchronize()
    out = {"fwd": rel_err(y, y_ref), "bwd": rel_err(x, x_ref)}
    for k, (a, r) in out.items():
        log(f"  {what}: {k} max abs err {a:.3e}, rel {r:.3e}")
        if not np.isfinite(r) or r > REL_TOL:
            raise RuntimeError(f"{what}: {k} kernel disagrees with its plain version (rel {r:.3e})")
    return out


def random_band(B: int, nb: int, rows_total: int, nblk: int, device):
    import torch

    rng = np.random.default_rng(0)

    def c64(shape, scale):
        z = rng.standard_normal(shape + (2,), dtype=np.float32) * np.float32(scale)
        return torch.view_as_complex(torch.from_numpy(z)).to(device)

    band = c64((rows_total, 2 * B + 1, nb, nb), 2e-3)
    dinv = c64((nblk, nb, nb), 2e-3) + torch.eye(nb, dtype=torch.complex64, device=device)
    return band, dinv.contiguous(), c64((nblk, nb), 1.0)


def cylinder_slice(device):
    """bench.py's reduced-cylinder pipeline, through the port."""
    import torch
    from lsafw_tpu_torch.config import BoundaryConditionsConfig, CylinderFlowGeometryConfig
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    stages = {}
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
    stages["mesh"] = time.time() - t0

    t0 = time.time()
    w = BaseFlowSolver(ctx, mesh, bcs_base, re=47.0).solve(
        ramp=True, steps=3, tol=1e-8, max_it=40)
    torch.cuda.synchronize()
    stages["baseflow"] = time.time() - t0

    t0 = time.time()
    A, M = LinearizedNavierStokesAssembler(w, ctx, 47.0, bcs_pert, mesh).assemble_eigensystem()
    torch.cuda.synchronize()
    stages["assemble"] = time.time() - t0

    t0 = time.time()
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(0.0 + 0.74j)
    es.set_st_pc_type("banded")
    pairs = es.solve()
    torch.cuda.synchronize()
    stages["eigen"] = time.time() - t0
    stages["factor"] = es.operator.factor_seconds
    resid = float(eigen_residuals(A, M, pairs)[0])
    return spaces.num_dofs, stages, pairs[0][0], resid, es.operator


def host_contraction(op) -> float:
    """Calibration contraction of the main path's shift-invert operator
    with its band factored on the host CPU (true f32 products): the
    yardstick for the card's factor precision."""
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    def cpu(m):
        return CSRMatrix(m.pattern, m.data.cpu())

    return ShiftInvertOperator(cpu(op.A), cpu(op.M), op.sigma).rho


def kernel_bounds(B: int, nb: int, rows_total: int, nblk: int) -> dict:
    """Least time of K1 and K2 from the bytes they must move (each input
    read once, each output written once) and their float32 operations."""
    c = 8  # bytes of one complex64
    band_part = rows_total * B * nb * nb * c
    flops = rows_total * B * nb * nb * 8  # one complex multiply-add is 8 flops
    fwd_bytes = band_part + nblk * nb * c + rows_total * nb * c
    bwd_bytes = band_part + nblk * nb * nb * c + rows_total * nb * c + nblk * nb * c
    bwd_flops = flops + nblk * nb * nb * 8
    out = {}
    for k, nbytes, ops in (("fwd", fwd_bytes, flops), ("bwd", bwd_bytes, bwd_flops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
        out[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from lsafw_tpu_torch.solver import band_cuda

    dev = torch.device("cuda")
    name_power = card()
    log(f"phase 1: card {name_power}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    lib = band_cuda.build()
    log(f"phase 1: built {lib.name} in {time.time() - t0:.1f} s")
    for line in band_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    B, nb, rows_total, nblk = 7, 128, 391, 384
    band, dinv, b = random_band(B, nb, rows_total, nblk, dev)
    errs = check_kernels(band, dinv, b, "phase 2 random band")
    del band, dinv, b
    log("phase 2: K1/K2 match their plain versions on a random band at B=7 nb=128 rows=391")

    band_cuda.reset_launches()
    ndofs, stages, sigma, resid, op = cylinder_slice(dev)
    launches = dict(band_cuda.LAUNCHES)
    blu = op.device_op.blu
    log(f"phase 3: {ndofs} DOFs, B={blu.B} nb={blu.nb} rows_total={blu.band.shape[0]}, "
        f"stages " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; contraction {op.rho:.2e}, refinement cap {op.refine_its}, "
        f"{op.applies} shift-invert applies")
    log(f"phase 3: sigma = {sigma.real:+.6f}{sigma.imag:+.6f}j, residual {resid:.2e}, "
        f"launches K1 {launches['fwd']} K2 {launches['bwd']}")
    if abs(sigma - SIGMA_REF) > 1e-4:
        raise RuntimeError(f"sigma {sigma} is not within 1e-4 of {SIGMA_REF}")
    if not resid <= 1e-8:
        raise RuntimeError(f"eigen residual {resid:.2e} > 1e-8")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")

    t0 = time.time()
    rho_host = host_contraction(op)
    log(f"phase 3: the same factor built in f32 on the host CPU contracts by {rho_host:.2e} "
        f"(card {op.rho:.2e}; {time.time() - t0:.1f} s)")
    if not op.rho <= 3 * rho_host:
        raise RuntimeError("the card's factor contracts far worse than the host's f32 factor: "
                           "check the matmul precision (TF32)")

    band, dinv = blu.band, blu.dinv
    B, nb, rows_total, nblk = blu.B, blu.nb, band.shape[0], dinv.shape[0]
    rng = np.random.default_rng(1)
    z = rng.standard_normal((nblk, nb, 2), dtype=np.float32)
    b = torch.view_as_complex(torch.from_numpy(z)).to(dev)
    real = check_kernels(band, dinv, b, "phase 4 slice factor")
    y = band_cuda.fwd_substitute_plain(band, b)
    bounds = kernel_bounds(B, nb, rows_total, nblk)
    result = {}
    timings = {
        "fwd": (cuda_ms(lambda: band_cuda.fwd_substitute(band, b), 20),
                cuda_ms(lambda: band_cuda.fwd_substitute_plain(band, b), 3)),
        "bwd": (cuda_ms(lambda: band_cuda.bwd_substitute(band, dinv, y), 20),
                cuda_ms(lambda: band_cuda.bwd_substitute_plain(band, dinv, y), 3)),
    }
    for k in ("fwd", "bwd"):
        ms, plain_ms = timings[k]
        bound_ms, bound_by = bounds[k]
        result[k] = dict(
            launches=launches[k], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=max(errs[k][0], real[k][0]))
        log(f"phase 4: {k} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of bound")
    src = "lsafw_tpu_torch/csrc/band_subst.cu"
    kernels = [
        dict(name="band_fwd_kernel (K1)", route="cuda", source=src,
             replaces="lsafw_tpu/solver/band_pallas.py:92", library_ms=None, **result["fwd"]),
        dict(name="band_bwd_kernel (K2)", route="cuda", source=src,
             replaces="lsafw_tpu/solver/band_pallas.py:191", library_ms=None, **result["bwd"]),
    ]
    log(name_power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
