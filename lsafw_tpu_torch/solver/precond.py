"""Preconditioners (subset): pointwise Jacobi.

Counterpart of the reference's ``solver/precond.py`` ``jacobi``; the rest
of its preconditioner menu is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from lsafw_tpu_torch.ops.sparse import CSRMatrix


def jacobi(A: CSRMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pointwise Jacobi M^-1 = diag(A)^-1 (1 where the diagonal is 0)."""
    d = A.diagonal()
    inv = torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.ones_like(d))

    def apply(x):
        return inv * x

    return apply
