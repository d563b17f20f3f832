"""Operators, vectors and solvers distributed by rows over the ranks.

Counterpart of the reference's ``parallel/sharded.py``.  The reference
is single-controller SPMD: one process holds a ``jax.sharding`` mesh and
GSPMD inserts the collectives.  Here every rank is a process of a
``torch.distributed`` group (:mod:`~lsafw_tpu_torch.parallel.launch`)
that holds its own block of rows, and the collectives are explicit
(:mod:`~lsafw_tpu_torch.parallel.collectives`): an all-gather of the
operand before a local matvec (the halo exchange; the reference's ELL
column gather), all-reduces of the inner products and norms, and
all-gathers of the small SPIKE strips and interface values.

The layout: the DOF axis is padded to ``npad``, a multiple of the
number of ranks, and rank r holds rows ``[r * npad / size, (r + 1) *
npad / size)``.  A local matvec is one launch of S
(:mod:`~lsafw_tpu_torch.ops.spmv_cuda`) on the rank's rows with their
global column ids.  The shift-invert eigensolve keeps its vectors in
the SPIKE segments' RCM order, so that rank r's rows are exactly its
segment and the segment solves need no collective.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.parallel.collectives import all_gather
from lsafw_tpu_torch.solver.eigen import EpsWhich, KrylovSchurResult, krylov_schur
from lsafw_tpu_torch.solver.linear import _norm, fgmres
from lsafw_tpu_torch.solver.linear import solve as _solve
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(eq=False)
class DeviceMesh:
    """A 1D mesh of ranks over the DOF axis: the process group (None for a
    world of one without one), this rank, the number of ranks and this
    rank's device (the reference's ``jax.sharding.Mesh``)."""

    group: object | None
    rank: int
    size: int
    device: torch.device


def device_mesh(group=None, *, device=None) -> DeviceMesh:
    """The mesh over ``group`` (default: the whole process group, or a
    world of one where none is initialized), on this rank's device
    (default: the one :func:`~lsafw_tpu_torch.parallel.launch.initialize_distributed`
    gave it, else ``cuda``)."""
    from lsafw_tpu_torch.parallel.launch import default_device

    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, size = None, 0, 1
    return DeviceMesh(group, rank, size, resolve_device(device or default_device()))


def _padded(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _block(npad: int, mesh: DeviceMesh) -> tuple[int, int]:
    rows = npad // mesh.size
    return mesh.rank * rows, (mesh.rank + 1) * rows


def shard_vector(x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``x`` padded with zeros to a multiple of the
    mesh size, on the rank's device."""
    x = np.asarray(x)
    xp = np.zeros((_padded(x.shape[0], mesh.size),) + x.shape[1:], dtype=x.dtype)
    xp[: x.shape[0]] = x
    r0, r1 = _block(xp.shape[0], mesh)
    return torch.as_tensor(xp[r0:r1], device=mesh.device)


def gather_vector(x: torch.Tensor, n: int, mesh: DeviceMesh) -> np.ndarray:
    """Every rank's block of a sharded vector, trimmed to ``n``, on the host."""
    return all_gather(x, mesh.group).cpu().numpy()[:n]


def _ell_of(S: sp.spmatrix, npad: int, *, identity_pad: bool,
            rows: tuple[int, int] | None = None) -> sp.csr_matrix:
    """Rows ``[r0, r1)`` (default: all) of the (n, n) scipy matrix ``S``
    padded to (npad, npad), as a scipy CSR of global column ids: the
    rank's block of the reference's ELL expansion.  Pad rows are the
    identity (or empty), so that padded entries stay exactly zero
    through applies."""
    S = sp.csr_matrix(S)
    S.sum_duplicates()
    n = S.shape[0]
    r0, r1 = rows or (0, npad)
    top = S[r0:min(r1, n)]
    lo = max(r0, n)
    m = max(r1 - lo, 0)
    pad = (sp.csr_matrix((np.ones(m), (np.arange(m), np.arange(lo, r1))), shape=(m, npad))
           if identity_pad else sp.csr_matrix((m, npad)))
    top = sp.csr_matrix((top.data, top.indices, top.indptr), shape=(top.shape[0], npad))
    out = sp.vstack([top, pad], format="csr") if m > 0 else top
    out.sort_indices()
    return out


def _operand(blocks: list, npad: int, device) -> tuple[spmv_cuda.TiledCSR, list]:
    """S's operand of the union pattern of row blocks of one shape, and
    each block's f64 values on it (zero where a block has no entry)."""
    blocks = [sp.csr_matrix(b) for b in blocks]
    coos = [b.tocoo() for b in blocks]
    keys = [c.row.astype(np.int64) * npad + c.col for c in coos]
    union = np.unique(np.concatenate(keys))
    rows = union // npad
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=blocks[0].shape[0]))])
    csr = spmv_cuda.TiledCSR.build(indptr, (union % npad).astype(np.int32),
                                   np.arange(union.size), spmv_cuda.plan_tiles(indptr), device,
                                   ncols=npad)
    vals = []
    for c, k in zip(coos, keys):
        v = np.zeros(union.size)
        v[np.searchsorted(union, k)] = c.data
        vals.append(csr.values(torch.as_tensor(v, device=device)))
    return csr, vals


def _scipy(A) -> sp.csr_matrix:
    return A.to_scipy() if hasattr(A, "to_scipy") else sp.csr_matrix(A)


@dataclass(eq=False)
class ShardedOperator:
    """This rank's rows of a real matrix, padded to ``npad`` rows: S's
    operand with global column ids.  ``matvec`` takes and returns the
    rank's block of a vector: an all-gather of the operand, then one S
    launch (f64 or complex128).  ``matvecs`` counts them."""

    csr: spmv_cuda.TiledCSR
    vals: torch.Tensor
    n: int
    npad: int
    mesh: DeviceMesh
    matvecs: int = 0

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        self.matvecs += 1
        return spmv_cuda.csr_spmv(self.csr, self.vals, all_gather(x, self.mesh.group))

    def __matmul__(self, x):
        return self.matvec(x)


def shard_csr(A, mesh: DeviceMesh) -> ShardedOperator:
    """This rank's row block of the CSRMatrix (or scipy matrix) ``A`` as a
    :class:`ShardedOperator` (zero pad rows, as the reference's)."""
    S = _scipy(A)
    n = S.shape[0]
    npad = _padded(n, mesh.size)
    csr, (vals,) = _operand([_ell_of(S, npad, identity_pad=False, rows=_block(npad, mesh))],
                            npad, mesh.device)
    return ShardedOperator(csr, vals, n, npad, mesh)


def sharded_eigensolve(A, mesh: DeviceMesh, *, nev: int, ncv: int | None = None,
                       which="largest_magnitude", tol: float = 1e-10, max_restarts: int = 200,
                       locality: tuple[object, np.ndarray] | None = None) -> KrylovSchurResult:
    """Krylov-Schur on a row-distributed operator: the basis holds this
    rank's rows, its projections and norms are all-reduced, the Schur
    bookkeeping is replicated.  ``locality``: ``(geom_mesh, cell_dofs)``,
    the RCB-partition renumbering
    (:mod:`~lsafw_tpu_torch.parallel.partition`), so that each rank's rows
    follow the mesh.  The start vector is the single-device solver's
    default one over the padded length.  Returns the eigenpairs
    with every vector in the original numbering, on every rank."""
    which = EpsWhich(which) if isinstance(which, str) else which
    S = _scipy(A)
    n = S.shape[0]
    perm = None
    if locality is not None:
        from lsafw_tpu_torch.parallel.partition import partition_cells, renumber_dofs_by_partition

        geom_mesh, cell_dofs = locality
        parts = partition_cells(geom_mesh, mesh.size)
        perm = renumber_dofs_by_partition(np.asarray(cell_dofs), n, parts, mesh.size)
        C = S.tocoo()
        S = sp.csr_matrix((C.data, (perm[C.row], perm[C.col])), shape=S.shape)
    op = shard_csr(S, mesh)
    rng = np.random.default_rng(7)  # krylov_schur's default seed
    v0 = rng.standard_normal(op.npad) + 1j * rng.standard_normal(op.npad)
    r0, r1 = _block(op.npad, mesh)
    res = krylov_schur(op.matvec, r1 - r0, nev=nev, ncv=ncv, which=which, tol=tol,
                       max_restarts=max_restarts, v0=v0[r0:r1], device=mesh.device,
                       group=mesh.group)
    vecs = all_gather(torch.as_tensor(res.eigenvectors.T.copy(), device=mesh.device),
                      mesh.group).cpu().numpy().T[:, :n]
    if perm is not None:
        vecs = vecs[:, perm]
    res.eigenvectors = vecs
    return res


def sharded_solve(op: ShardedOperator, b, *, ksp_type="gmres", tol: float = 1e-10,
                  maxiter: int = 500, restart: int = 30):
    """Any of :mod:`~lsafw_tpu_torch.solver.linear`'s Krylov types on the
    row-distributed operator: the single-device solver with its inner
    products and norms summed over the ranks.  Returns the
    ``SolveResult`` with ``x`` the whole solution (n,) on the host."""
    b = np.asarray(b)
    res = _solve(op.matvec, shard_vector(b.astype(np.result_type(b, np.float64)), op.mesh),
                 ksp_type=ksp_type, tol=tol, maxiter=maxiter, restart=restart,
                 group=op.mesh.group)
    res.x = gather_vector(res.x, op.n, op.mesh)
    return res


# ---------------------------------------------------------------------------
# The shift-invert eigensolve across ranks
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class ShardedPencil:
    """This rank's rows of C = A - sigma M (identity pad rows) and of M
    (empty pad rows), in the segments' order, on one S operand: ``matvec``
    is (A - sigma M) x, ``mass`` is M x, each an all-gather and one S
    launch; ``matvecs`` counts them."""

    csr: spmv_cuda.TiledCSR
    vA: torch.Tensor
    vM: torch.Tensor
    sigma: complex
    mesh: DeviceMesh
    matvecs: int = 0

    @classmethod
    def build(cls, As, Ms, sigma: complex, perm_pad: np.ndarray, npad: int,
              rows: tuple[int, int], mesh: DeviceMesh) -> "ShardedPencil":
        n = As.shape[0]
        perm = perm_pad[:n]
        blocks = [_ell_of(S.tocsr()[perm][:, perm], npad, identity_pad=pad, rows=rows)
                  for S, pad in ((As, True), (Ms, False))]
        csr, (vA, vM) = _operand(blocks, npad, mesh.device)
        return cls(csr, vA, vM, complex(sigma), mesh)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        self.matvecs += 1
        return spmv_cuda.csr_shifted_spmv(self.csr, self.vA, self.vM,
                                          all_gather(x, self.mesh.group), self.sigma)

    def mass(self, x: torch.Tensor) -> torch.Tensor:
        self.matvecs += 1
        return spmv_cuda.csr_spmv(self.csr, self.vM, all_gather(x, self.mesh.group))


def _si_apply_sharded(pc, cop: ShardedPencil, v: torch.Tensor, *, inner_tol: float,
                      inner_restart: int, inner_maxiter: int):
    """One shift-invert apply y = (A - sigma M)^-1 (M v) on this rank's
    rows: FGMRES on C, right-preconditioned by the truncated-SPIKE segment
    solves, on complex128 vectors; returns (y, its residual, iterations)."""
    res = fgmres(cop.matvec, cop.mass(v), tol=inner_tol, restart=inner_restart,
                 maxiter=inner_maxiter, M=pc.seg_solve_sharded, group=cop.mesh.group)
    return res.x, res.residual, res.iterations


def _si_apply_spike(solver, cop: ShardedPencil, v: torch.Tensor, *, tol: float,
                    max_refine: int):
    """One shift-invert apply through the exact SPIKE solver: y0 =
    spike(M v), then defect-correction refinement against the true C
    until the relative residual reaches ``tol``; returns (y, its
    residual, refinement steps)."""
    group = cop.mesh.group
    b = cop.mass(v)
    nb0 = _norm(b, group) + 1e-300
    x = solver.solve_pair_sharded(b)
    r = b - cop.matvec(x)
    rn = _norm(r, group) / nb0
    steps = 0
    while rn > tol and steps < max_refine:
        x = x + solver.solve_pair_sharded(r)
        r = b - cop.matvec(x)
        rn = _norm(r, group) / nb0
        steps += 1
    return x, rn, steps


@dataclass
class ShardedSIResult(KrylovSchurResult):
    """:func:`sharded_si_eigensolve`'s result: the eigenpairs, the SPIKE
    path that ran (``"exact"`` or ``"truncated"``), whether it was a
    degradation from the exact path, the exact path's calibration
    residual (None where it did not run) and the figures of the run."""

    spike: str = "exact"
    degraded: bool = False
    calibration_residual: float | None = None
    stats: dict = field(default_factory=dict)


def sharded_si_eigensolve(A, M, sigma: complex, mesh: DeviceMesh, *, nev: int = 2,
                          ncv: int | None = None, tol: float = 1e-9, max_restarts: int = 60,
                          nb: int | None = None, chunk: int = 2, inner_tol: float = 1e-11,
                          inner_restart: int = 80, inner_maxiter: int | None = None,
                          spike: str = "exact") -> ShardedSIResult:
    """Shift-invert Krylov-Schur across ranks: eigenvalues of ``A x = lam
    M x`` nearest ``sigma`` (M None: the identity).

    ``spike="exact"`` solves each apply with :class:`ShardedSpikeSolver`
    (two segment solves and the reduced sweep) refined against the true
    C; ``spike="truncated"`` runs FGMRES on C preconditioned by the
    truncated-SPIKE segment factors.  The exact path is first calibrated
    on a random vector; where its refinement stalls above 100 x
    ``inner_tol`` (or the bandwidth exceeds the segments) the solve
    degrades to the truncated path, as the reference does, with a
    warning, and the result records it.  ``nb`` defaults to the port's
    :func:`~lsafw_tpu_torch.solver.band.band_nb`; on the card the kernels
    take 128 and 256.  Host planning (RCM, segmentation, the reduced
    system) is replicated on every rank; the eigenvectors come back in
    the original order, on every rank."""
    from lsafw_tpu_torch.solver.band import band_nb
    from lsafw_tpu_torch.solver.band_sharded import (
        SegmentPlan, ShardedBandedPrecond, ShardedSpikeSolver)

    t0 = time.time()
    As = _scipy(A)
    n = As.shape[0]
    Ms = _scipy(M) if M is not None else sp.identity(n, format="csr")
    Cs = (As.astype(np.complex128) - complex(sigma) * Ms).tocsr()
    plan = SegmentPlan.build(Cs, mesh.size, nb=nb or band_nb(), chunk=chunk)
    t_plan = time.time() - t0
    solver = None
    degraded = False
    if spike == "exact":
        try:
            solver = ShardedSpikeSolver.build(Cs, mesh, chunk=chunk, plan=plan)
        except ValueError as e:
            logger.warning("exact SPIKE unavailable (%s); degrading to the truncated-SPIKE "
                           "FGMRES inner solves", e)
            degraded = True
    elif spike != "truncated":
        raise ValueError(f"spike is 'exact' or 'truncated', not {spike!r}")
    pc = solver.pc if solver is not None else ShardedBandedPrecond.build(
        Cs, mesh, chunk=chunk, plan=plan)
    cop = ShardedPencil.build(As, Ms, sigma, pc.perm_pad, pc.npad, pc.rows, mesh)
    im = inner_maxiter if inner_maxiter is not None else 4 * inner_restart

    def start(seed: int) -> torch.Tensor:
        """This rank's rows of the reference's random start vector."""
        return pc.local(np.random.default_rng(seed).standard_normal(n).astype(np.complex128))

    stats = dict(plan_seconds=t_plan, applies=0, refinements=0, fgmres_its=0,
                 worst_inner=0.0, seg_rows=pc.seg_rows, npad=pc.npad, B=pc.B, nb=pc.nb,
                 dropped=plan.dropped, pivoted=pc.pivoted, factor_seconds=pc.factor_seconds)
    calib = None
    if solver is not None:
        stats.update(solver.stats, bw=solver.bw)
        # the exact path is exact to the segment factors' grade only; where
        # its refinement cannot reach inner_tol, inexact applies would make
        # Krylov-Schur converge to eigenvalues of the wrong operator
        t1 = time.time()
        _, calib, steps = _si_apply_spike(solver, cop, start(17), tol=inner_tol, max_refine=20)
        stats.update(calibration_steps=steps, calibration_seconds=time.time() - t1)
        if not np.isfinite(calib) or calib > 100 * inner_tol:
            logger.warning("exact-SPIKE refinement stalls at %.1e on this operator; degrading "
                           "to the truncated-SPIKE FGMRES inner solves", calib)
            solver, degraded = None, True
    warned = [False]

    def apply_op(v: torch.Tensor) -> torch.Tensor:
        stats["applies"] += 1
        if solver is not None:
            y, rres, steps = _si_apply_spike(solver, cop, v, tol=inner_tol, max_refine=20)
            stats["refinements"] += steps
        else:
            y, rres, its = _si_apply_sharded(pc, cop, v, inner_tol=inner_tol,
                                             inner_restart=inner_restart, inner_maxiter=im)
            stats["fgmres_its"] += its
        stats["worst_inner"] = max(stats["worst_inner"], float(rres))
        if not warned[0] and rres > 100 * inner_tol:
            logger.warning("sharded shift-invert inner solve reached only %.1e (tol %.0e): "
                           "eigenvalue accuracy is bounded by the inner solves", rres, inner_tol)
            warned[0] = True
        return y

    t1 = time.time()
    res = krylov_schur(apply_op, pc.seg_rows, nev=nev, ncv=ncv,
                       which=EpsWhich.LARGEST_MAGNITUDE, tol=tol, max_restarts=max_restarts,
                       v0=start(3).cpu().numpy(),
                       device=mesh.device, group=mesh.group)
    stats.update(krylov_seconds=time.time() - t1, matvecs=cop.matvecs)
    vecs = all_gather(torch.as_tensor(res.eigenvectors.T.copy(), device=mesh.device),
                      mesh.group).cpu().numpy().T[:, pc.iperm]  # the original order
    stats["seconds"] = time.time() - t0
    path = "exact" if solver is not None else "truncated"
    logger.info("sharded shift-invert: %s SPIKE%s over %d ranks, %d applies in %.2f s", path,
                " (degraded)" if degraded else "", mesh.size, stats["applies"],
                stats["krylov_seconds"])
    return ShardedSIResult(
        eigenvalues=complex(sigma) + 1.0 / res.eigenvalues, eigenvectors=vecs,
        residuals=res.residuals, iterations=res.iterations, converged=res.converged,
        nconv=res.nconv, restarts=res.restarts, spike=path, degraded=degraded,
        calibration_residual=calib, stats=stats)
