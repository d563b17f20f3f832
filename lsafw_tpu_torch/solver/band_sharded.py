"""Banded shift-invert across ranks: truncated and exact SPIKE.

Counterpart of the reference's ``solver/band_sharded.py``.  The band
factorization is sequential over block rows, so it is not split across
ranks; the SPIKE family splits the operator instead:

  * every rank RCM-orders the operator (host, replicated) and splits its
    rows into one contiguous segment per rank, ``seg_rows`` rows each,
    the last one padded with identity rows to ``npad`` in all;
  * rank r factors the diagonal band block of its own segment on its
    own device, through :func:`~lsafw_tpu_torch.solver.band.factor_auto`
    (panel-pivoted where the memory fits, else pivot-free with the
    saddle regularization), all segments at one block bandwidth B;
  * a rank's vectors are its segment's rows in that order, so a segment
    solve is the factor's own ``solve``: G's permute-in, K1, K2, G's
    permute-out, and no collective.

:class:`ShardedBandedPrecond` is the truncated SPIKE: the couplings
between segments are dropped from the factor and left to an outer
Krylov iteration on the true operator.  :class:`ShardedSpikeSolver`
makes them exact through the SPIKE reduced system (Polizzi & Sameh):
each apply is a segment solve, an all-gather of every rank's top and
bottom interface values, a block-tridiagonal sweep replicated on every
rank, a local coupling correction and a second segment solve.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.parallel.collectives import all_gather
from lsafw_tpu_torch.solver.band import BandPlan, band_nb, factor_auto, rcm_permutation
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(eq=False)
class SegmentPlan:
    """Host segmentation of one operator, the same on every rank: the RCM
    order ``perm`` (position -> original index), the permuted operator
    ``Cp``, the segment geometry and the RCM bandwidth ``bw``."""

    perm: np.ndarray
    Cp: sp.csr_matrix
    n: int
    nb: int
    num_segments: int
    seg_rows: int
    B: int
    bw: int
    dropped: int

    @property
    def npad(self) -> int:
        return self.num_segments * self.seg_rows

    @classmethod
    def build(cls, C: sp.spmatrix, n_segments: int, *, nb: int, chunk: int) -> "SegmentPlan":
        """RCM, segmentation and the uniform B (capped at the segment) of
        the reference's ``ShardedBandedPrecond.build``."""
        C = C.tocsr()
        n = C.shape[0]
        pat = sp.csr_matrix((np.ones(C.nnz, np.int8), C.indices, C.indptr), shape=C.shape)
        perm = rcm_permutation(pat + pat.T)
        Cp = C[perm][:, perm].tocsr()
        nblk = -(-n // nb)
        per_seg = -(-nblk // n_segments)
        nblk_seg = -(-per_seg // chunk) * chunk
        seg_rows = nblk_seg * nb
        coo = Cp.tocoo()
        bw = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0
        B = min(max(1, -(-bw // nb)), nblk_seg)
        dropped = 0
        for s in range(n_segments):
            r0, r1 = s * seg_rows, min((s + 1) * seg_rows, n)
            if r0 < n:
                rows = Cp[r0:r1]
                dropped += int(rows.nnz - rows[:, r0:r1].nnz)
        return cls(perm=np.asarray(perm, dtype=np.int64), Cp=Cp, n=n, nb=nb,
                   num_segments=n_segments, seg_rows=seg_rows, B=B, bw=bw, dropped=dropped)

    def segment(self, s: int) -> sp.csr_matrix:
        """Segment s's diagonal block, identity-padded to ``seg_rows``, with
        every diagonal entry stored (the saddle regularization adds to it)."""
        sr, n = self.seg_rows, self.n
        r0, r1 = s * sr, min((s + 1) * sr, n)
        if r0 >= n:
            return sp.identity(sr, format="csr", dtype=np.complex128)
        blk = self.Cp[r0:r1, r0:r1].tocoo()
        m = r1 - r0
        diag = np.arange(sr)
        seg = sp.csr_matrix(
            (np.concatenate([blk.data.astype(np.complex128), np.zeros(m), np.ones(sr - m)]),
             (np.concatenate([blk.row, diag]), np.concatenate([blk.col, diag]))), shape=(sr, sr))
        seg.sort_indices()
        return seg


def _diag_slots(seg: sp.csr_matrix) -> np.ndarray:
    rows = np.repeat(np.arange(seg.shape[0]), np.diff(seg.indptr))
    return np.flatnonzero(rows == seg.indices)


@dataclass(eq=False)
class ShardedBandedPrecond:
    """This rank's segment factor of the truncated SPIKE, with the host
    segmentation every rank shares.  Its solve, ``seg_solve_sharded``,
    runs on the rank's rows, in segment order."""

    seg: object  # the rank's band factor (a _PermutedSolve)
    pivoted: bool
    plan: SegmentPlan
    mesh: object  # parallel.sharded.DeviceMesh
    factor_seconds: float = 0.0

    @property
    def num_segments(self) -> int:
        return self.plan.num_segments

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def nb(self) -> int:
        return self.plan.nb

    @property
    def B(self) -> int:
        return self.plan.B

    @property
    def seg_rows(self) -> int:
        return self.plan.seg_rows

    @property
    def npad(self) -> int:
        return self.plan.npad

    @property
    def perm_pad(self) -> np.ndarray:
        """(npad,) padded position -> original index (pads map to themselves)."""
        return np.concatenate([self.plan.perm, np.arange(self.n, self.npad)])

    @property
    def iperm(self) -> np.ndarray:
        """(n,) original index -> position."""
        iperm = np.empty(self.n, dtype=np.int64)
        iperm[self.plan.perm] = np.arange(self.n)
        return iperm

    @property
    def rows(self) -> tuple[int, int]:
        """This rank's positions [r0, r1)."""
        r0 = self.mesh.rank * self.seg_rows
        return r0, r0 + self.seg_rows

    @classmethod
    def build(cls, C: sp.spmatrix, mesh, *, nb: int | None = None, chunk: int = 8,
              delta: float = 0.0, plan: SegmentPlan | None = None) -> "ShardedBandedPrecond":
        """Segment the complex ``C`` over ``mesh``'s ranks and factor this
        rank's diagonal block on its device (``nb`` defaults to
        :func:`~lsafw_tpu_torch.solver.band.band_nb`)."""
        if plan is None:
            plan = SegmentPlan.build(C, mesh.size, nb=nb or band_nb(), chunk=chunk)
        t0 = time.time()
        seg = plan.segment(mesh.rank)
        bplan = BandPlan.build(seg, nb=plan.nb, chunk=chunk, perm=np.arange(plan.seg_rows),
                               min_B=plan.B)
        data = torch.as_tensor(seg.data, dtype=torch.complex128, device=mesh.device)
        lu, pivoted = factor_auto(bplan, data.real.contiguous(), data.imag.contiguous(),
                                  diag_slots=_diag_slots(seg), delta=delta)
        if lu.B != plan.B:
            raise RuntimeError(f"segment factor B = {lu.B}, the segmentation's B = {plan.B}")
        seconds = time.time() - t0
        logger.info("ShardedBandedPrecond: %d segments of %d rows (B=%d, %d cross-segment "
                    "couplings dropped into the outer iteration); segment %d factored %s in "
                    "%.2f s", plan.num_segments, plan.seg_rows, plan.B, plan.dropped, mesh.rank,
                    "pivoted" if pivoted else "pivot-free", seconds)
        return cls(lu, pivoted, plan, mesh, seconds)

    def seg_solve_sharded(self, b: torch.Tensor) -> torch.Tensor:
        """The segment solve of this rank's rows (no collective)."""
        return self.seg.solve(b)

    def local(self, v) -> torch.Tensor:
        """This rank's rows, in segment order, of an original-order vector
        (numpy or tensor, length n or npad), on the rank's device."""
        v = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        full = np.zeros(self.npad, dtype=v.dtype)
        full[: self.n] = v[: self.n]
        r0, r1 = self.rows
        return torch.as_tensor(full[self.perm_pad[r0:r1]], device=self.mesh.device)

    def gather(self, x: torch.Tensor) -> np.ndarray:
        """Every rank's rows of x, in the original order (n,), on the host."""
        return all_gather(x, self.mesh.group).cpu().numpy()[self.iperm]


@dataclass(eq=False)
class ShardedSpikeSolver:
    """Exact SPIKE over the segment factors: a direct solver across ranks.

    Writing segment j's block row as ``A_j x_j + R_j x_{j+1}^top +
    L_j x_{j-1}^bot = f_j`` and multiplying by ``A_j^-1`` gives ``x_j +
    V_j t_{j+1} + W_j b_{j-1} = g_j`` with ``V_j = A_j^-1 [0; R_j]`` and
    ``W_j = A_j^-1 [L_j; 0]``; their top and bottom ``bw``-row strips
    close a block-tridiagonal system in the interface values ``u_k =
    [b_k; t_{k+1}]`` of the D - 1 boundaries, factored once by block
    Thomas (``Sinv``, ``Msub``, ``Sup``).  Rank k computes the strips of
    V_k and rank k + 1 those of W_{k+1}, one segment solve a column; the
    strips are all-gathered and the reduced factor is built on the host,
    the same on every rank, and kept on the device in complex128."""

    pc: ShardedBandedPrecond
    R: torch.Tensor  # (D-1, bw, bw): segment k's bottom rows x segment k+1's top columns
    L: torch.Tensor  # (D-1, bw, bw): segment k+1's top rows x segment k's bottom columns
    Sinv: torch.Tensor  # (D-1, 2bw, 2bw) block-Thomas Schur inverses
    Msub: torch.Tensor  # (D-1, 2bw, 2bw) forward multipliers (k = 0: zero)
    Sup: torch.Tensor  # (D-1, 2bw, 2bw) super blocks (k = D-2: zero)
    bw: int
    stats: dict = field(default_factory=dict)

    @property
    def npad(self) -> int:
        return self.pc.npad

    @property
    def n(self) -> int:
        return self.pc.n

    @classmethod
    def build(cls, C: sp.spmatrix, mesh, *, nb: int | None = None, chunk: int = 8,
              delta: float = 0.0, plan: SegmentPlan | None = None) -> "ShardedSpikeSolver":
        """Factor the segments and the reduced system.  Raises ValueError,
        before any factor work, where the bandwidth exceeds the segment
        factors' width (the segments are then truncated and the reduced
        system cannot be exact)."""
        t0 = time.time()
        if plan is None:
            plan = SegmentPlan.build(C, mesh.size, nb=nb or band_nb(), chunk=chunk)
        if -(-plan.bw // plan.nb) > plan.B:
            raise ValueError(f"bandwidth {plan.bw} exceeds the segment factor width "
                             f"{plan.B * plan.nb}: the segment factors are truncated and the "
                             "SPIKE reduced system cannot be exact")
        pc = ShardedBandedPrecond.build(C, mesh, chunk=chunk, delta=delta, plan=plan)
        D, sr, n, npad, k = plan.num_segments, plan.seg_rows, plan.n, plan.npad, mesh.rank
        bw = plan.B * plan.nb
        DB = D - 1
        Cpad = sp.block_diag([plan.Cp, sp.identity(npad - n, dtype=np.complex128)], format="csr")
        Rb = np.zeros((max(DB, 1), bw, bw), np.complex128)
        Lb = np.zeros_like(Rb)
        for j in range(DB):
            r1 = (j + 1) * sr
            Rb[j] = Cpad[r1 - bw:r1, r1:r1 + bw].toarray()
            Lb[j] = Cpad[r1:r1 + bw, r1 - bw:r1].toarray()

        dev = mesh.device
        t1 = time.time()
        solves = 0

        def strips(blk: np.ndarray, top: bool):
            """Top and bottom bw-row strips of A_k^-1 [blk at the top | bottom]."""
            nonlocal solves
            X = torch.empty((2, bw, bw), dtype=torch.complex128, device=dev)
            cols = torch.as_tensor(blk, device=dev)
            rhs = torch.zeros(sr, dtype=torch.complex128, device=dev)
            at = slice(0, bw) if top else slice(sr - bw, sr)
            for c in range(bw):
                rhs[at] = cols[:, c]
                x = pc.seg_solve_sharded(rhs)
                X[0, :, c], X[1, :, c] = x[:bw], x[sr - bw:]
                solves += 1
            return X

        mine = torch.zeros((1, 4, bw, bw), dtype=torch.complex128, device=dev)
        if k < DB:
            mine[0, :2] = strips(Rb[k], top=False)  # V_k
        if k > 0:
            mine[0, 2:] = strips(Lb[k - 1], top=True)  # W_k
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_strips = time.time() - t1
        G = all_gather(mine, mesh.group).cpu().numpy()  # (D, 4, bw, bw)
        Vt, Vb = G[:DB, 0], G[:DB, 1]
        Wt, Wb = G[1:, 2], G[1:, 3]

        I2 = np.eye(bw)
        Sinv = np.zeros((max(DB, 1), 2 * bw, 2 * bw), np.complex128)
        Msub = np.zeros_like(Sinv)
        Sup = np.zeros_like(Sinv)
        for j in range(DB - 1):
            Sup[j, bw:, bw:] = Vt[j + 1]
        for j in range(DB):
            Sk = np.block([[I2, Vb[j]], [Wt[j], I2]])
            if j > 0:
                Sub = np.zeros((2 * bw, 2 * bw), np.complex128)
                Sub[:bw, :bw] = Wb[j - 1]  # W_j^bot acting on b_{j-1}
                Msub[j] = Sub @ Sinv[j - 1]
                Sk = Sk - Msub[j] @ Sup[j - 1]
            Sinv[j] = np.linalg.inv(Sk)

        def put(a):
            return torch.as_tensor(a, device=dev)

        stats = dict(strip_solves=solves, strip_seconds=t_strips,
                     build_seconds=time.time() - t0, factor_seconds=pc.factor_seconds)
        logger.info("ShardedSpikeSolver: %d boundaries, bw=%d (reduced blocks %dx%d); strips: "
                    "%d segment solves in %.2f s on rank %d; built in %.1f s", DB, bw, 2 * bw,
                    2 * bw, solves, t_strips, k, stats["build_seconds"])
        return cls(pc, put(Rb), put(Lb), put(Sinv), put(Msub), put(Sup), bw, stats)

    def solve_pair_sharded(self, b: torch.Tensor) -> torch.Tensor:
        """One exact SPIKE solve of C x = b on this rank's rows (segment
        order, complex128): a segment solve, the all-gather of every
        rank's interface values, the reduced sweep, the coupling
        correction and a second segment solve."""
        pc, bw, k = self.pc, self.bw, self.pc.mesh.rank
        D = pc.num_segments
        g = pc.seg_solve_sharded(b)
        if D == 1:
            return g
        edges = all_gather(torch.stack([g[:bw], g[-bw:]])[None], pc.mesh.group)  # (D, 2, bw)
        rhs = torch.cat([edges[:-1, 1], edges[1:, 0]], dim=1)  # r_k = [g_k^bot; g_{k+1}^top]
        Y = torch.empty_like(rhs)
        y = torch.zeros_like(rhs[0])
        for j in range(D - 1):  # forward sweep
            y = rhs[j] - self.Msub[j] @ y
            Y[j] = y
        U = torch.empty_like(rhs)
        u = torch.zeros_like(rhs[0])
        for j in reversed(range(D - 1)):  # backward sweep
            u = self.Sinv[j] @ (Y[j] - self.Sup[j] @ u)
            U[j] = u
        b = b.clone()
        if k < D - 1:
            b[-bw:] -= self.R[k] @ U[k, bw:]  # R_k t_{k+1}
        if k > 0:
            b[:bw] -= self.L[k - 1] @ U[k - 1, :bw]  # L_{k-1} b_{k-1}
        return pc.seg_solve_sharded(b)
