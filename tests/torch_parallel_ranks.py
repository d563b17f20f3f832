"""Rank side of ``tests/test_torch_parallel.py``: one process per rank of a
two-rank gloo group on the CPU.

Imports torch, numpy, scipy and the port only (never JAX): the spawned
ranks import this module.  :func:`spawn` starts the ranks on a
``file://`` store and waits for them; :func:`run` is one rank: it reads
the inputs the test module wrote (``inputs.npz``), runs every sharded
path of the port on them and writes what the tests compare
(``rank<r>.npz``).
"""

from __future__ import annotations

import multiprocessing
import os
import traceback
from pathlib import Path

import numpy as np
import scipy.sparse as sp

NB, CHUNK = 16, 2  # the reference tests' block size and chunk (the plain versions take any nb)
# the Krylov types that need neither a transpose, spectrum bounds nor a preconditioner
KSPS = ("cg", "gmres", "fgmres", "bcgs", "minres", "cgs", "gcr", "lgmres", "qcg")
THREAD_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _csr(z, name: str) -> sp.csr_matrix:
    return sp.csr_matrix((z[f"{name}_data"], z[f"{name}_indices"], z[f"{name}_indptr"]),
                         shape=tuple(z[f"{name}_shape"]))


def run(rank: int, world: int, store: str, folder: str) -> None:
    """One rank: every sharded path on the inputs of ``folder``."""
    import torch

    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the strips decay into f32 subnormals, slow on a CPU
    from lsafw_tpu_torch.interop import segment_lus_from_numpy
    from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
    from lsafw_tpu_torch.parallel import (
        device_mesh, initialize_distributed, shard_csr, shard_vector, sharded_eigensolve,
        sharded_si_eigensolve, sharded_solve)
    from lsafw_tpu_torch.parallel.sharded import gather_vector
    from lsafw_tpu_torch.solver.band_sharded import (
        SegmentPlan, ShardedBandedPrecond, ShardedSpikeSolver)
    from lsafw_tpu_torch.solver.eigen import EpsWhich, PlainOperator, krylov_schur
    from lsafw_tpu_torch.ops.sparse import CSRMatrix

    initialize_distributed(f"file://{store}", world, rank, backend="gloo", device="cpu")
    mesh = device_mesh(device="cpu")
    z = np.load(Path(folder) / "inputs.npz")
    out: dict = {}

    # the row-distributed matvec
    S = _csr(z, "spmv")
    op = shard_csr(CSRMatrix.from_scipy(S, device="cpu"), mesh)
    out["spmv_y"] = gather_vector(op.matvec(shard_vector(z["spmv_x"], mesh)), op.n, mesh)

    # exact SPIKE: the reduced blocks and the refined solve; its segment factors
    # alone are the truncated SPIKE, with the port's factors and the carried-over JAX ones
    C = _csr(z, "band")
    b = z["band_b"]
    solver = ShardedSpikeSolver.build(C, mesh, nb=NB, chunk=CHUNK)
    for name in ("R", "L", "Sinv", "Msub", "Sup"):
        out[f"spike_{name}"] = getattr(solver, name).cpu().numpy()
    x = solver.pc.gather(solver.solve_pair_sharded(solver.pc.local(b)))
    out["spike_x0"] = x
    for _ in range(2):  # defect correction against the true C on the host
        x = x + solver.pc.gather(solver.solve_pair_sharded(solver.pc.local(b - C @ x)))
    out["spike_x"] = x
    pc = solver.pc
    out["pc_x"] = pc.gather(pc.seg_solve_sharded(pc.local(b)))
    out["pc_perm"] = pc.perm_pad
    out["pc_pivoted"] = pc.pivoted
    lus = segment_lus_from_numpy(z["jf_band_re"], z["jf_band_im"], z["jf_dinv_r"],
                                 z["jf_dinv_i"], NB, int(z["jf_B"]), device="cpu")
    pcj = ShardedBandedPrecond(lus[rank], False, SegmentPlan.build(C, world, nb=NB, chunk=CHUNK),
                               mesh)
    out["pcj_x"] = pcj.gather(pcj.seg_solve_sharded(pcj.local(b)))
    W = _csr(z, "wide")
    try:
        ShardedSpikeSolver.build(W, mesh, nb=NB, chunk=1)
        out["spike_refused"] = False
    except ValueError:
        out["spike_refused"] = True
    # ... and the shift-invert then degrades to the truncated SPIKE, recording it
    r = sharded_si_eigensolve(W.real, None, 2.5, mesh, nev=1, ncv=8, tol=1e-10, nb=NB, chunk=1)
    out.update(wide_lam=r.eigenvalues[0], wide_path=r.spike, wide_degraded=r.degraded,
               wide_calibration=np.nan if r.calibration_residual is None else
               r.calibration_residual)

    # the Krylov types on the distributed tridiagonal operator
    T = shard_csr(_csr(z, "tri"), mesh)
    for ksp in KSPS:
        res = sharded_solve(T, z["tri_b"], ksp_type=ksp, tol=1e-12, maxiter=300)
        out.update({f"ksp_{ksp}_x": res.x, f"ksp_{ksp}_converged": res.converged})

    # Krylov-Schur with the RCB renumbering, and on one rank's worth of rows
    K2 = _csr(z, "stiff")
    gm = Mesh(z["stiff_vertices"], z["stiff_cells"], CellType.TRIANGLE)
    got = sharded_eigensolve(K2, mesh, nev=4, ncv=20, which="largest_magnitude", tol=1e-12,
                             locality=(gm, z["stiff_cell_dofs"]))
    out.update(ks_lam=got.eigenvalues, ks_x=got.eigenvectors[0])
    ref = krylov_schur(PlainOperator(CSRMatrix.from_scipy(K2, device="cpu")).apply,
                       K2.shape[0], nev=4, ncv=20, which=EpsWhich.LARGEST_MAGNITUDE, tol=1e-12,
                       device="cpu")
    out["ks_ref"] = ref.eigenvalues

    # the shift-invert eigensolve, both SPIKE paths
    K, M = _csr(z, "memK"), _csr(z, "memM")
    for path in ("exact", "truncated"):
        r = sharded_si_eigensolve(K, M, complex(z["mem_sigma"]), mesh, nev=2, ncv=12, tol=1e-10,
                                  nb=NB, chunk=CHUNK, spike=path)
        out.update({f"si_{path}_lam": r.eigenvalues, f"si_{path}_x": r.eigenvectors[0],
                    f"si_{path}_path": r.spike, f"si_{path}_degraded": r.degraded})
    np.savez(Path(folder) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def _rank(rank: int, world: int, store: str, folder: str) -> None:
    try:
        run(rank, world, store, folder)
    except BaseException:
        (Path(folder) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(folder: Path, world: int = 2) -> list:
    """Start :func:`run` on ``world`` spawned ranks (one thread each) on
    the inputs of ``folder``; returns the processes (:func:`collect`)."""
    ctx = multiprocessing.get_context("spawn")
    saved = {k: os.environ.get(k) for k in THREAD_ENV}
    os.environ.update(THREAD_ENV)
    try:
        procs = [ctx.Process(target=_rank, args=(r, world, str(folder / "store"), str(folder)))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return procs


def stop(procs: list) -> None:
    """End the ranks that are still running."""
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()


def collect(folder: Path, procs: list, timeout: float = 240.0) -> list[dict]:
    """Wait for the ranks :func:`start` started and return each rank's
    outputs."""
    for p in procs:
        p.join(timeout)
    stop(procs)
    errs = [f.read_text() for f in sorted(folder.glob("rank*.err"))]
    if errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}:\n" + "\n".join(errs))
    return [dict(np.load(folder / f"rank{r}.npz")) for r in range(len(procs))]
