"""p-multigrid preconditioner for unstructured P2 operators (P2 -> P1).

Counterpart of the reference's ``solver/pmg.py`` (the GAMG / HYPRE role
for general simplicial meshes): a two-level V-cycle.

* Transfers are gathers: the P2 layout puts vertices at [0, nv) and edge
  midpoints at [nv, nv + ne), and P1 -> P2 interpolation at a midpoint is
  the mean of its edge's two vertices, so prolongation is a copy and a
  two-point gather per edge, restriction its adjoint (an ``index_add_``).
* The coarse P1 Galerkin operator P^T A P is formed on the host
  (:func:`_coarse_galerkin`) and factored once by the port's band plan
  (:func:`~lsafw_tpu_torch.solver.band.plan_for_csr`,
  :func:`~lsafw_tpu_torch.solver.band.factor_auto`, a real factor): each
  V-cycle's coarse solve is one band solve, on the card one K1 / K2
  launch pair with G's permute-in and permute-out.
* Smoothing is damped Jacobi, its fine products through S
  (:func:`~lsafw_tpu_torch.ops.bcsr.matvec_of`).

The band's nb defaults to 128 (the card's kernels are built for 128 and
256; the reference's default is 64).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.fem.elements import ElementFamily
from lsafw_tpu_torch.interop import csr_from_numpy
from lsafw_tpu_torch.ops.bcsr import matvec_of
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.solver.band import factor_auto, plan_for_csr
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(eq=False)
class PMGPreconditioner:
    """Two-level p-multigrid V-cycle: P2 Jacobi smoothing, the band-factor
    P1 coarse solve, nodal transfers."""

    fine: CSRMatrix
    fine_mv: object  # x -> fine x through S
    inv_diag: torch.Tensor  # (n2,) fine Jacobi inverse diagonal
    e0: torch.Tensor  # (ne,) each edge's first vertex
    e1: torch.Tensor  # (ne,) and its second
    bc2: torch.Tensor  # (n2,) bool fine Dirichlet mask
    bc1: torch.Tensor  # (n1,) bool coarse Dirichlet mask
    coarse: object  # a real band factor (``solve`` of an f64 vector)
    coarse_matrix: CSRMatrix  # the coarse Galerkin operator
    nv: int  # vertices (coarse nodes)
    bs: int  # components per node
    omega: float
    smooth_steps: int

    def prolong(self, c: torch.Tensor) -> torch.Tensor:
        """P1 -> P2 nodal interpolation (vertex copy, edge-midpoint mean)."""
        cn = c.reshape(self.nv, self.bs)
        mid = 0.5 * (cn[self.e0] + cn[self.e1])
        return torch.cat([cn, mid], dim=0).reshape(-1)

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        """The adjoint of :meth:`prolong` (edge rows added to their ends)."""
        fn = f.reshape(-1, self.bs)
        fv, fe = fn[: self.nv].clone(), 0.5 * fn[self.nv:]
        fv.index_add_(0, self.e0, fe)
        fv.index_add_(0, self.e1, fe)
        return fv.reshape(-1)

    def _smooth(self, x, b):
        for _ in range(self.smooth_steps):
            x = x + self.omega * self.inv_diag * (b - self.fine_mv(x))
        return x

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle approximating fine^-1 r."""
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        x = self._smooth(torch.zeros_like(r), r)
        res = r - self.fine_mv(x)
        r1 = torch.where(self.bc1, zero, self.restrict(torch.where(self.bc2, zero, res)))
        e = torch.where(self.bc1, zero, self.coarse.solve(r1))
        x = x + torch.where(self.bc2, zero, self.prolong(e))
        x = torch.where(self.bc2, r, x)  # Dirichlet rows are identity rows: r passes through
        return self._smooth(x, r)


def _coarse_galerkin(A2: CSRMatrix, nv: int, ne: int, bs: int, e0: np.ndarray, e1: np.ndarray,
                     bc2: np.ndarray) -> tuple[sp.csr_matrix, np.ndarray]:
    """P^T A P on the host, with identity rows and columns at the coarse
    Dirichlet DOFs."""
    n1 = nv * bs
    rows = np.concatenate([np.arange(nv), nv + np.arange(ne), nv + np.arange(ne)])
    cols = np.concatenate([np.arange(nv), e0, e1])
    vals = np.concatenate([np.ones(nv), np.full(2 * ne, 0.5)])
    Pn = sp.coo_matrix((vals, (rows, cols)), shape=(nv + ne, nv)).tocsr()
    P = sp.kron(Pn, sp.identity(bs, format="csr"), format="csr") if bs > 1 else Pn
    A1 = (P.T @ A2.to_scipy() @ P).tocsr()
    bc1 = np.asarray(bc2[:n1], dtype=bool)
    if bc1.any():
        d = np.ones(n1)
        d[bc1] = 0.0
        D = sp.diags(d)
        A1 = (D @ A1 @ D + sp.diags(np.where(bc1, 1.0, 0.0))).tocsr()
    A1.sum_duplicates()
    return A1, bc1


def build_pmg_pc(space2, A2: CSRMatrix, bc_mask2: np.ndarray, *, omega: float = 0.7,
                 smooth_steps: int = 3, nb: int = 128, delta: float = 0.0) -> PMGPreconditioner:
    """The p-MG V-cycle of a P2 Lagrange operator ``A2`` (Dirichlet rows
    identity) on the space ``space2``: the coarse Galerkin operator, its
    band plan at block size ``nb`` and its real factor on A2's device."""
    if space2.element.family is not ElementFamily.P2:
        raise ValueError("p-multigrid requires a P2 space")
    mesh = space2.mesh
    nv, bs = mesh.num_vertices, space2.bs
    ne = space2.num_nodes - nv
    if ne != mesh.edges.shape[0]:
        raise ValueError("P2 node layout mismatch (vertices + edges expected)")
    e0 = mesh.edges[:, 0].astype(np.int64)
    e1 = mesh.edges[:, 1].astype(np.int64)
    bc2 = np.asarray(bc_mask2, dtype=bool)
    dev = A2.device
    A1h, bc1 = _coarse_galerkin(A2, nv, ne, bs, e0, e1, bc2)
    A1h.sort_indices()
    A1 = csr_from_numpy(A1h.indptr, A1h.indices, A1h.data, A1h.shape, device=dev)
    plan = plan_for_csr(A1, nb=nb, real=True)
    lu, pivoted = factor_auto(plan, A1.data, delta=delta)
    logger.info("p-MG: coarse P1 n=%d (fine n=%d), band B=%d nb=%d pivoted=%s", A1h.shape[0],
                A2.shape[0], plan.B, plan.nb, pivoted)
    d = A2.diagonal()
    inv_diag = torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                           torch.ones_like(d))
    return PMGPreconditioner(
        fine=A2, fine_mv=matvec_of(A2), inv_diag=inv_diag, e0=torch.as_tensor(e0, device=dev),
        e1=torch.as_tensor(e1, device=dev), bc2=torch.as_tensor(bc2, device=dev),
        bc1=torch.as_tensor(bc1, device=dev), coarse=lu, coarse_matrix=A1, nv=nv, bs=bs,
        omega=omega, smooth_steps=smooth_steps)
