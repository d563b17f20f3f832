"""Matrix-free element-operator apply.

Counterpart of the reference's ``ops/elementop.py`` (``ElementOperator``,
``CElementOperator``, ``element_operator_from_context``): the per-cell
element matrices (nc, nd, nd) are kept and the operator applied as

    y = segment_sum_c( A_el[c] @ x[dofs_c] )

one G gather of x over the cells' DOFs, one batched product
(``torch.bmm``) and one segmented sum.  The sum is not an atomic
``index_add_``: the (cell, local DOF) slots are sorted by DOF once
(:class:`SegmentSum`), the products are gathered into that order by G and
summed run by run with ``torch.segment_reduce``, so the same input gives
the same bits on every run (as the ILU(0) sweeps of
:mod:`~lsafw_tpu_torch.solver.ilu`).

Dirichlet elimination happens at apply time (constrained columns zeroed
before the gather, constrained rows overwritten after the sum), as
:func:`~lsafw_tpu_torch.fem.assembly.dirichlet_matrix_data` does to
assembled data.  Complex vectors are complex128 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from lsafw_tpu_torch.ops import spmv_cuda


@dataclass(eq=False)
class SegmentSum:
    """y[i] = sum of values[k] over the k with index[k] == i, summed in a
    fixed order: ``order`` sorts the slots by target (stable), ``lengths``
    counts each target's run (zero for a target no slot reaches)."""

    order: torch.Tensor  # (nslots,) int32, G's index type
    lengths: torch.Tensor  # (n,) int64

    @classmethod
    def build(cls, index: torch.Tensor, n: int) -> "SegmentSum":
        index = index.reshape(-1).long()
        return cls(torch.argsort(index, stable=True).to(torch.int32),
                   torch.bincount(index, minlength=n))

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        v = spmv_cuda.gather(values.reshape(-1).contiguous(), self.order)
        if v.is_complex():
            s = torch.segment_reduce(torch.view_as_real(v), "sum", lengths=self.lengths,
                                     axis=0, unsafe=True)
            return torch.view_as_complex(s.contiguous())
        return torch.segment_reduce(v, "sum", lengths=self.lengths, unsafe=True)


def _columns(x_el: torch.Tensor) -> torch.Tensor:
    """(nc, nd) element vectors as real columns for ``bmm``: (nc, nd, 1)
    for a real x, (nc, nd, 2) (re, im) for a complex one."""
    return torch.view_as_real(x_el) if x_el.is_complex() else x_el.unsqueeze(-1)


@dataclass(eq=False)
class _CellMap:
    """The gather and segmented-sum geometry of one cell DOF map."""

    cell_dofs: torch.Tensor  # (nc, nd)
    n: int
    _idx: torch.Tensor = field(default=None, repr=False)
    _sum: SegmentSum = field(default=None, repr=False)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self._idx is None:
            self._idx = self.cell_dofs.to(torch.int32).contiguous()
        return spmv_cuda.gather(x.contiguous(), self._idx)

    def scatter(self, y_el: torch.Tensor) -> torch.Tensor:
        if self._sum is None:
            self._sum = SegmentSum.build(self.cell_dofs, self.n)
        return self._sum(y_el)


def _masked(x: torch.Tensor, bc_mask) -> torch.Tensor:
    if bc_mask is None:
        return x
    return torch.where(bc_mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


@dataclass(eq=False)
class ElementOperator:
    """y = A x from per-cell element matrices; a real or complex x."""

    Ael: torch.Tensor  # (nc, nd, nd) f64
    cell_dofs: torch.Tensor  # (nc, nd) int
    n: int
    bc_mask: torch.Tensor | None = None  # (n,) bool
    bc_diag: float = 1.0
    _map: _CellMap = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._map = _CellMap(self.cell_dofs, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y_el = torch.bmm(self.Ael, _columns(self._map.gather(_masked(x, self.bc_mask))))
        y_el = torch.view_as_complex(y_el) if x.is_complex() else y_el.squeeze(-1)
        y = self._map.scatter(y_el)
        if self.bc_mask is not None:
            y = torch.where(self.bc_mask, self.bc_diag * x, y)
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_pair(self, x: torch.Tensor) -> torch.Tensor:
        """The real operator on a complex x (the reference's (re, im) pair)."""
        return self.matvec(x)


@dataclass(eq=False)
class CElementOperator:
    """The complex element operator y = (E_re + i E_im) x: the
    matrix-free form of C = A - sigma M in the shift-invert refinement.
    ``El_im`` None is a real operator (a real shift), under which a real x
    stays real.  BC rows act as the diagonal ``bc_diag`` (1 for C = A -
    sigma M with A's Dirichlet diagonal 1 and M's 0); BC columns are
    eliminated by zeroing the constrained entries of x first."""

    El_re: torch.Tensor  # (nc, nd, nd)
    El_im: torch.Tensor | None  # (nc, nd, nd)
    cell_dofs: torch.Tensor  # (nc, nd)
    n: int
    bc_mask: torch.Tensor | None = None
    bc_diag: complex = 1.0
    _map: _CellMap = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._map = _CellMap(self.cell_dofs, self.n)

    def matvec_pair(self, x: torch.Tensor) -> torch.Tensor:
        if self.El_im is not None and not x.is_complex():
            x = x.to(torch.complex128)
        cols = _columns(self._map.gather(_masked(x, self.bc_mask)))
        a = torch.bmm(self.El_re, cols)
        if self.El_im is None:
            y_el = torch.view_as_complex(a) if x.is_complex() else a.squeeze(-1)
        else:
            b = torch.bmm(self.El_im, cols)
            y_el = torch.complex(a[..., 0] - b[..., 1], a[..., 1] + b[..., 0])
        y = self._map.scatter(y_el)
        if self.bc_mask is not None:
            d = self.bc_diag.real if not x.is_complex() else self.bc_diag
            y = torch.where(self.bc_mask, d * x, y)
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec_pair(x)


def element_operator_from_context(ctx, element_mats: torch.Tensor, bc_mask=None,
                                  bc_diag: float = 1.0) -> ElementOperator:
    """Wrap the mixed-space element matrices of an AssemblyContext."""
    if bc_mask is not None:
        bc_mask = torch.as_tensor(bc_mask, dtype=torch.bool, device=element_mats.device)
    return ElementOperator(Ael=element_mats, cell_dofs=ctx.mixed_cell_dofs,
                           n=ctx.spaces.num_dofs, bc_mask=bc_mask, bc_diag=bc_diag)
