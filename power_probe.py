#!/usr/bin/env python3
"""Sizes at which ``shift_invert_power``'s fixed 200-step Jacobi CG still
converges, on one CUDA card.

    python3 power_probe.py [nx ...]      # default 64 96 128 160 192 240

For each nx: the P2 membrane of the 2 x 4 rectangle on an nx x 2nx grid,
``solver.power.shift_invert_power`` at sigma = 1 (tol 1e-12, at most 50
outer steps, 200 Jacobi-CG steps a solve) and the gates of
tests/unit/test_power_stencil.py (lambda_1 within 1e-4 relative of the
analytic value, residual below 1e-6), with the outer steps and seconds.
Prints the card's name and power limit first.
"""

import subprocess
import sys
import time

import numpy as np
import torch


def main(sizes) -> int:
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
    from lsafw_tpu_torch.models.membrane import analytic_eigenvalues, assemble_membrane_evp
    from lsafw_tpu_torch.ops.stencil import build_stencil_operator
    from lsafw_tpu_torch.solver.power import shift_invert_power

    if not torch.cuda.is_available():
        print("power_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    exact = analytic_eigenvalues(2.0, 4.0, 1)[0]
    for nx in sizes:
        mesh = rectangle_mesh((0.0, 0.0), (2.0, 4.0), nx, 2 * nx)
        K, M, mask = assemble_membrane_evp(mesh, device="cuda")
        blocks = [(make_scalar_space(mesh, "p2"), 1)]
        Kop = build_stencil_operator(K.pattern, K.data, blocks, bc_mask=mask, bc_diag=1.0)
        Mop = build_stencil_operator(K.pattern, M.data, blocks, bc_mask=mask, bc_diag=0.0)
        d = (K.diagonal() - M.diagonal())[Kop.structure.on(K.device)["perm"].long()]
        inv = torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                          torch.ones_like(d))
        x0 = torch.as_tensor(np.random.default_rng(0).standard_normal(Kop.structure.packed_size),
                             device=K.device)
        torch.cuda.synchronize()
        t0 = time.time()
        r = shift_invert_power(Kop, Mop, 1.0, x0, inv, tol=1e-12, max_outer=50, cg_iters=200)
        torch.cuda.synchronize()
        rel = abs(r.eigenvalue - exact) / exact
        ok = rel < 1e-4 and r.residual < 1e-6
        print(f"nx={nx} dofs={K.shape[0]} lambda={r.eigenvalue:.12f} rel={rel:.2e} "
              f"residual={r.residual:.2e} outer={r.iterations} seconds={time.time() - t0:.2f} "
              f"{'converged' if ok else 'NOT converged'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [64, 96, 128, 160, 192, 240]))
