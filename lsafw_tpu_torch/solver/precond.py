"""Preconditioners: the reference's PC menu.

Counterpart of the reference's ``solver/precond.py``: pointwise Jacobi,
dense block-Jacobi (the 64 x 64 diagonal blocks gathered on the device
and inverted in one batched call), the fine-grained-parallel ILU(0) /
ICC / SSOR of :mod:`~lsafw_tpu_torch.solver.ilu`, smoothed-aggregation
AMG (:mod:`~lsafw_tpu_torch.solver.amg`, the GAMG / HYPRE role), the
P2 -> P1 p-multigrid (:mod:`~lsafw_tpu_torch.solver.pmg`, its coarse
solve on the card's band factor), a user apply (SHELL), and a host
SuperLU for ``lu`` / ``cholesky`` / ``redundant``.  The host LU runs only
when the caller names it; nothing here falls back to it.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable

import torch

from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.solver.direct import SparseLU


class PreconditionerType(Enum):
    """PC names (the reference's ``PreconditionerType``): ASM is
    zero-overlap, so block-Jacobi on one device; ICC is served by ILU(0)
    (on an SPD matrix U = D L^T); HYPRE is SA-AMG as GAMG; CHOLESKY and
    REDUNDANT are the host LU."""

    NONE = "none"
    JACOBI = "jacobi"
    BLOCK_JACOBI = "bjacobi"
    LU = "lu"
    PMG = "pmg"
    GAMG = "gamg"
    HYPRE = "hypre"
    ILU = "ilu"
    ICC = "icc"
    SOR = "sor"
    ASM = "asm"
    CHOLESKY = "cholesky"
    REDUNDANT = "redundant"
    SHELL = "shell"

    @classmethod
    def from_string(cls, value: str) -> "PreconditionerType":
        return cls(value.lower().strip())


def jacobi(A: CSRMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pointwise Jacobi M^-1 = diag(A)^-1 (1 where the diagonal is 0)."""
    d = A.diagonal()
    inv = torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.ones_like(d))

    def apply(x):
        return inv.to(x.dtype) * x

    return apply


def block_jacobi(A: CSRMatrix, block_size: int = 64) -> Callable[[torch.Tensor], torch.Tensor]:
    """Dense block-Jacobi over contiguous DOF blocks: the (nb, bs, bs)
    block diagonal is gathered on the data's device and inverted in one
    batched call, and an apply is one batched product.  Rows with a zero
    diagonal (the pressure block of a saddle-point operator) and the
    padding rows become identity rows and columns, as PETSc's zero-pivot
    shift would keep them nonsingular; a batch with a singular block takes
    the pseudo-inverse of every block, as the reference does."""
    n, bs = A.shape[0], block_size
    nb = -(-n // bs)
    ix = A.idx()
    rows, cols = ix["row_ids"], ix["col"]
    same = rows // bs == cols // bs
    r, c = rows[same], cols[same]
    blocks = torch.zeros((nb, bs, bs), dtype=A.data.dtype, device=A.device)
    blocks[r // bs, r % bs, c % bs] = A.data[same]
    diag = torch.zeros(nb * bs, dtype=A.data.dtype, device=A.device)
    diag[:n] = A.diagonal()
    z = torch.nonzero(diag == 0).flatten()
    blocks[z // bs, z % bs, :] = 0.0
    blocks[z // bs, :, z % bs] = 0.0
    blocks[z // bs, z % bs, z % bs] = 1.0
    inv, info = torch.linalg.inv_ex(blocks)
    if bool((info != 0).any()):
        inv = torch.linalg.pinv(blocks)

    def apply(x):
        xp = torch.nn.functional.pad(x, (0, nb * bs - n)).reshape(nb, bs, 1)
        return torch.bmm(inv.to(x.dtype), xp).reshape(-1)[:n]

    return apply


def _host_lu(A: CSRMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
    """The exact PC by one host SuperLU of A: right-hand sides cross to
    the host and back."""
    lu = SparseLU(A)

    def apply(r):
        return torch.as_tensor(lu.solve(r.detach().cpu().numpy()), dtype=r.dtype, device=r.device)

    return apply


def make_preconditioner(A: CSRMatrix, pc_type: PreconditionerType | str,
                        **kw) -> Callable[[torch.Tensor], torch.Tensor] | None:
    """The apply of the named PC on ``A`` (None for ``"none"``).  Keywords:
    ``block_size`` (bjacobi, asm); ``theta``, ``coarse_size``, ``omega``,
    ``smooth_steps`` (gamg, hypre); ``factor_sweeps``, ``apply_sweeps``
    (ilu, icc); ``omega``, ``sweeps`` (sor); ``space``, ``bc_mask``,
    ``nb`` (default 128), ``omega``, ``smooth_steps`` (pmg); ``apply``
    (shell)."""
    pc = PreconditionerType.from_string(pc_type) if isinstance(pc_type, str) else pc_type
    P = PreconditionerType
    if pc is P.NONE:
        return None
    if pc is P.JACOBI:
        return jacobi(A)
    if pc in (P.BLOCK_JACOBI, P.ASM):
        return block_jacobi(A, kw.get("block_size", 64))
    if pc in (P.LU, P.CHOLESKY, P.REDUNDANT):
        return _host_lu(A)
    if pc is P.SHELL:
        fn = kw.get("apply")
        if fn is None:
            raise ValueError("SHELL preconditioner requires apply=<callable>.")
        return fn
    if pc in (P.GAMG, P.HYPRE):
        from lsafw_tpu_torch.solver.amg import amg_preconditioner

        return amg_preconditioner(A, theta=kw.get("theta", 0.08),
                                  coarse_size=kw.get("coarse_size", 200),
                                  omega=kw.get("omega", 0.7),
                                  smooth_steps=kw.get("smooth_steps", 2))
    if pc in (P.ILU, P.ICC):
        from lsafw_tpu_torch.solver.ilu import ilu0

        return ilu0(A, factor_sweeps=kw.get("factor_sweeps", 8),
                    apply_sweeps=kw.get("apply_sweeps", 6))
    if pc is P.SOR:
        from lsafw_tpu_torch.solver.ilu import ssor

        return ssor(A, omega=kw.get("omega", 1.0), sweeps=kw.get("sweeps", 6))
    if pc is P.PMG:
        from lsafw_tpu_torch.solver.pmg import build_pmg_pc

        return build_pmg_pc(kw["space"], A, kw["bc_mask"], nb=kw.get("nb", 128),
                            omega=kw.get("omega", 0.7),
                            smooth_steps=kw.get("smooth_steps", 3)).apply
    raise ValueError(f"Unsupported preconditioner: {pc}")
