"""Smoothed-aggregation algebraic multigrid (the PETSc GAMG / HYPRE role).

Counterpart of the reference's ``solver/amg.py``: multigrid on the bare
assembled matrix (Vanek-Mandel-Brezina).  The hierarchy is built on the
host with scipy, as the reference builds it (strength graph, greedy
aggregation, piecewise-constant tentative prolongator, one Jacobi
smoothing pass, Galerkin coarse operators, recursively; a dense
pseudo-inverse on the coarsest level).  The V-cycle runs on the device:
damped-Jacobi smoothing and residuals with each level's operator through
S (:func:`~lsafw_tpu_torch.ops.bcsr.matvec_of`), the transfer products
with P and R, which are rectangular, as CSR products
(:func:`~lsafw_tpu_torch.ops.sparse.spmv`), and one dense product with
the coarse inverse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.interop import csr_from_numpy
from lsafw_tpu_torch.ops.bcsr import matvec_of
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _on_device(S: sp.spmatrix, device) -> CSRMatrix:
    S = sp.csr_matrix(S)
    S.sort_indices()
    return csr_from_numpy(S.indptr, S.indices, S.data, S.shape, device=device)


def _strength_graph(S: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength filter: keep |a_ij| > theta sqrt(|a_ii a_jj|)."""
    C = S.tocoo()
    d = np.abs(S.diagonal())
    d = np.where(d > 0, d, 1.0)
    keep = (C.row != C.col) & (np.abs(C.data) > theta * np.sqrt(d[C.row] * d[C.col]))
    return sp.csr_matrix((np.ones(int(keep.sum())), (C.row[keep], C.col[keep])), shape=S.shape)


def _aggregate(G: sp.csr_matrix) -> np.ndarray:
    """Greedy aggregation over the strength graph: seed disjoint root
    neighbourhoods, then attach each leftover to a neighbouring aggregate
    (isolated nodes become singletons)."""
    n = G.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = G.indptr, G.indices
    next_id = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]: indptr[i + 1]]
        if np.all(agg[nbrs] < 0):
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]: indptr[i + 1]]
        joined = nbrs[agg[nbrs] >= 0]
        if joined.size:
            agg[i] = agg[joined[0]]
        else:
            agg[i] = next_id
            next_id += 1
    return agg


def _spectral_radius_dinv_a(S: sp.csr_matrix, iters: int = 12) -> float:
    """Power-iteration estimate of rho(D^-1 A) on the host."""
    n = S.shape[0]
    d = S.diagonal()
    d = np.where(np.abs(d) > 0, d, 1.0)
    x = np.random.default_rng(0).standard_normal(n)
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = (S @ x) / d
        lam = float(np.linalg.norm(y))
        if lam == 0:
            return 1.0
        x = y / lam
    return lam


@dataclass(eq=False)
class AMGLevel:
    A: CSRMatrix  # this level's operator
    P: CSRMatrix  # prolongation from the next coarser level
    R: CSRMatrix  # restriction to it, P^T
    dinv: torch.Tensor  # the damped-Jacobi smoother's inverse diagonal
    mv: object  # x -> A x through S


@dataclass(eq=False)
class AMGHierarchy:
    levels: list  # [AMGLevel], finest first; level l's P / R map l <-> l + 1
    coarse_inv: torch.Tensor  # dense pseudo-inverse of the coarsest operator
    omega: float
    smooth_steps: int


def build_amg(A: CSRMatrix, *, theta: float = 0.08, coarse_size: int = 200,
              max_levels: int = 12, omega: float = 0.7, smooth_steps: int = 2) -> AMGHierarchy:
    """Build the SA-AMG hierarchy of a bare CSR operator (host), its level
    operators on A's device."""
    dev = A.device
    S = A.to_scipy().tocsr()
    levels = []
    Af = A
    for _ in range(max_levels):
        n = S.shape[0]
        if n <= coarse_size:
            break
        agg = _aggregate(_strength_graph(S, theta))
        nagg = int(agg.max()) + 1
        if nagg >= n or nagg == 0:
            break  # aggregation stalled: the coarsening stops here
        counts = np.bincount(agg, minlength=nagg).astype(np.float64)
        P0 = sp.csr_matrix((1.0 / np.sqrt(counts[agg]), (np.arange(n), agg)), shape=(n, nagg))
        d = S.diagonal()
        d = np.where(np.abs(d) > 0, d, 1.0)
        w = (4.0 / 3.0) / max(_spectral_radius_dinv_a(S), 1e-12)
        P = sp.csr_matrix((sp.identity(n) - w * (sp.diags(1.0 / d) @ S)) @ P0)
        R = sp.csr_matrix(P.T)
        Sc = sp.csr_matrix(R @ S @ P)
        Sc.sort_indices()
        levels.append(AMGLevel(A=Af, P=_on_device(P, dev), R=_on_device(R, dev),
                               dinv=torch.as_tensor(1.0 / d, device=dev), mv=matvec_of(Af)))
        S = Sc
        Af = _on_device(S, dev)
    logger.info("SA-AMG: %d levels, coarsest n=%d (finest n=%d)", len(levels) + 1, S.shape[0],
                A.shape[0])
    coarse_inv = torch.as_tensor(np.linalg.pinv(S.toarray()), device=dev)
    return AMGHierarchy(levels=levels, coarse_inv=coarse_inv, omega=omega,
                        smooth_steps=smooth_steps)


def _vcycle(h: AMGHierarchy, r: torch.Tensor) -> torch.Tensor:
    """One V-cycle of ``h`` on the residual ``r``."""

    def smooth(lv: AMGLevel, b, x):
        for _ in range(h.smooth_steps):
            x = x + h.omega * lv.dinv * (b - lv.mv(x))
        return x

    def cycle(level: int, b):
        if level == len(h.levels):
            return h.coarse_inv.to(b.dtype) @ b
        lv = h.levels[level]
        x = smooth(lv, b, torch.zeros_like(b))
        rc = spmv(lv.R, b - lv.mv(x))
        x = x + spmv(lv.P, cycle(level + 1, rc))
        return smooth(lv, b, x)

    return cycle(0, r)


def amg_preconditioner(A: CSRMatrix, **kw):
    """SA-AMG V-cycle preconditioner closure (the GAMG / HYPRE roles);
    its hierarchy is the closure's ``hierarchy`` attribute."""
    h = build_amg(A, **kw)

    def apply(r):
        return _vcycle(h, r)

    apply.hierarchy = h
    return apply
