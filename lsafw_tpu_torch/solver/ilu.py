"""ILU(0) and SSOR preconditioning as parallel sweeps.

Counterpart of the reference's ``solver/ilu.py`` (the PETSc ILU / ICC /
SOR roles):

* the factor is the Chow-Patel fixed-point ILU(0) (SIAM J. Sci. Comput.
  37(2), 2015): every nonzero's equation (LU)_ij = a_ij on the pattern
  is relaxed at once; a sweep is one gather of the products l_ik u_kj
  over the pattern-intersection triples (i, k, j) and one segmented sum
  over the runs of triples that share a target slot (sorted at plan
  time; no atomics, so the same values give the same factor on every
  run).  The triples are enumerated on the host once per pattern
  (:meth:`ILU0Plan.build`); the sweeps run on the values' device.
* the triangular applies are Jacobi sweeps: L y = r with unit lower L
  iterates y <- r - L_strict y, one S product per sweep
  (:func:`~lsafw_tpu_torch.ops.bcsr.matvec_of`; L and U share A's
  pattern and its plan), truncated to a fixed count.

ICC(0) on an SPD matrix is the same factor.  SSOR takes L, U and D from
A itself.  Zero diagonals (the pressure block of a saddle-point
operator) become unit pivots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from lsafw_tpu_torch.ops.bcsr import matvec_of
from lsafw_tpu_torch.ops.sparse import CSRMatrix, pattern_csr


@dataclass(eq=False)
class ILU0Plan:
    """The static geometry of the Chow-Patel sweeps for one pattern (host
    numpy; :meth:`on` caches device copies)."""

    n: int
    nnz: int
    tr_e: np.ndarray  # (ntr,) target slot of each intersection triple, sorted
    tr_len: np.ndarray  # (nnz,) the number of triples of each target slot
    tr_p: np.ndarray  # (ntr,) slot of l_ik
    tr_q: np.ndarray  # (ntr,) slot of u_kj
    is_lower: np.ndarray  # (nnz,) bool: strictly-lower slot
    diag_of_col: np.ndarray  # (nnz,) slot of (j, j) for each entry's column j
    diag_slots: np.ndarray  # (n,) slot of (i, i)
    _device: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, pattern: sp.spmatrix) -> "ILU0Plan":
        """Enumerate the triples (i, k, j) with (i, k), (k, j), (i, j) all
        in the pattern and k < min(i, j)."""
        S = pattern.tocsr()
        S.sort_indices()
        n, nnz = S.shape[0], S.nnz
        indptr = S.indptr.astype(np.int64)
        cols = S.indices.astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        slots = np.arange(nnz, dtype=np.int64)
        keys = rows * n + cols
        lower, supper = cols < rows, cols > rows
        dpos = np.searchsorted(keys, np.arange(n, dtype=np.int64) * (n + 1))
        if not ((0 if n == 0 else int(dpos.max())) < nnz
                and np.array_equal(keys[dpos], np.arange(n, dtype=np.int64) * (n + 1))):
            raise ValueError("ILU(0) requires a pattern with a full diagonal.")
        # the strictly upper part of each row k (u_kj, j > k) and the
        # strictly lower part of each column k (l_ik, i > k), carrying
        # their CSR slots (+1: no slot is an implicit zero)
        U = sp.csr_matrix(
            (slots[supper] + 1, cols[supper],
             np.concatenate([[0], np.cumsum(np.bincount(rows[supper], minlength=n))])),
            shape=(n, n))
        Lc = sp.csc_matrix((slots[lower] + 1, (rows[lower], cols[lower])), shape=(n, n))
        a = np.diff(Lc.indptr).astype(np.int64)  # per-k lower count
        b = np.diff(U.indptr).astype(np.int64)  # per-k upper count
        ntr = int((a * b).sum())
        if ntr > 300_000_000:
            raise ValueError(f"ILU(0) intersection planning would expand {ntr:.2e} triples; use "
                             "gamg / pmg or the band factor at this scale.")
        if ntr == 0:
            e_tr = p_tr = q_tr = np.zeros(0, np.int64)
        else:
            # each lower entry (i, k) pairs with every upper entry (k, j)
            elem_rep = np.repeat(b, a)
            i_tr = np.repeat(Lc.indices.astype(np.int64), elem_rep)
            p_all = np.repeat(Lc.data.astype(np.int64) - 1, elem_rep)
            csum = np.cumsum(elem_rep)
            run_starts = np.concatenate([[0], csum[:-1]])
            within = np.arange(ntr, dtype=np.int64) - np.repeat(run_starts, elem_rep)
            u_idx = np.repeat(np.repeat(U.indptr[:-1].astype(np.int64), a), elem_rep) + within
            j_tr = U.indices.astype(np.int64)[u_idx]
            q_all = U.data.astype(np.int64)[u_idx] - 1
            key_tr = i_tr * n + j_tr
            pos = np.minimum(np.searchsorted(keys, key_tr), nnz - 1)
            keep = np.flatnonzero(keys[pos] == key_tr)
            e_tr, p_tr, q_tr = pos[keep], p_all[keep], q_all[keep]
            order = np.argsort(e_tr, kind="stable")
            e_tr, p_tr, q_tr = e_tr[order], p_tr[order], q_tr[order]
        return cls(n=n, nnz=nnz, tr_e=e_tr, tr_len=np.bincount(e_tr, minlength=nnz),
                   tr_p=p_tr, tr_q=q_tr, is_lower=lower,
                   diag_of_col=dpos[cols], diag_slots=dpos)

    def on(self, device) -> dict[str, torch.Tensor]:
        """The plan's arrays on ``device`` (cached)."""
        key = str(torch.device(device))
        hit = self._device.get(key)
        if hit is None:
            hit = {k: torch.as_tensor(getattr(self, k), device=device)
                   for k in ("tr_len", "tr_p", "tr_q", "is_lower", "diag_of_col", "diag_slots")}
            self._device[key] = hit
        return hit


def ilu0_factor_values(plan: ILU0Plan, a: torch.Tensor, *, sweeps: int = 8) -> torch.Tensor:
    """Chow-Patel fixed-point sweeps on the values' device.  Returns the
    factor in the CSR slot layout: strictly lower slots hold l_ij (unit
    diagonal implicit), diagonal and upper slots u_ij.  Each sweep sums a
    slot's products in the plan's order (a segmented sum, no atomics)."""
    ix = plan.on(a.device)
    a = a.clone()
    d = a[ix["diag_slots"]]
    a[ix["diag_slots"]] = torch.where(d.abs() > 0, d, torch.ones_like(d))
    vals = a
    for _ in range(sweeps):
        s = torch.segment_reduce(vals[ix["tr_p"]] * vals[ix["tr_q"]], "sum",
                                 lengths=ix["tr_len"], unsafe=True)
        new = a - s
        ujj = vals[ix["diag_of_col"]]
        ujj = torch.where(ujj.abs() > 1e-300, ujj, torch.ones_like(ujj))
        vals = torch.where(ix["is_lower"], new / ujj, new)
    return vals


def _tri_apply(L, U, dinv: torch.Tensor, r: torch.Tensor, *, sweeps: int) -> torch.Tensor:
    """x ~= U^-1 L^-1 r by fixed Jacobi triangular sweeps (the products
    ``L`` with the unit lower factor, held strictly, and ``U`` with the
    strictly upper one; ``dinv`` = 1 / diag(U))."""
    y = r
    for _ in range(sweeps):
        y = r - L(y)
    x = dinv * y
    for _ in range(sweeps):
        x = dinv * (y - U(x))
    return x


def ilu0(A: CSRMatrix, *, factor_sweeps: int = 8, apply_sweeps: int = 6,
         plan: ILU0Plan | None = None):
    """ILU(0) preconditioner closure (the PETSc ILU / ICC roles); ``plan``,
    A's pattern's :class:`ILU0Plan` where the caller has it."""
    plan = plan or ILU0Plan.build(pattern_csr(A.pattern))
    ix = plan.on(A.device)
    fvals = ilu0_factor_values(plan, A.data.to(torch.float64), sweeps=factor_sweeps)
    zero = torch.zeros_like(fvals)
    lvals = torch.where(ix["is_lower"], fvals, zero)
    uvals = torch.where(ix["is_lower"], zero, fvals)
    dinv = 1.0 / fvals[ix["diag_slots"]]
    uvals[ix["diag_slots"]] = 0.0
    L, U = matvec_of(CSRMatrix(A.pattern, lvals)), matvec_of(CSRMatrix(A.pattern, uvals))

    def apply(r):
        return _tri_apply(L, U, dinv, r, sweeps=apply_sweeps)

    return apply


def ssor(A: CSRMatrix, *, omega: float = 1.0, sweeps: int = 6):
    """SSOR preconditioner closure (PETSc's SOR):
    M = (D/w + L) ((2 - w)/w D)^-1 (D/w + U), L, U and D from A, the
    triangular solves by Jacobi sweeps."""
    ix = A.idx()
    rows, cols = ix["row_ids"], ix["col"]
    zero = torch.zeros_like(A.data)
    L = matvec_of(CSRMatrix(A.pattern, torch.where(cols < rows, A.data, zero)))
    U = matvec_of(CSRMatrix(A.pattern, torch.where(cols > rows, A.data, zero)))
    d = A.diagonal()
    d = torch.where(d.abs() > 0, d, torch.ones_like(d))
    w = float(omega)
    dws_inv = w / d  # (D / w)^-1

    def apply(r):
        y = dws_inv * r
        for _ in range(sweeps):
            y = dws_inv * (r - L(y))
        y = ((2.0 - w) / w) * d * y
        x = dws_inv * y
        for _ in range(sweeps):
            x = dws_inv * (y - U(x))
        return x

    return apply
