"""Dimension-generic structured-grid stencil operator (2D and 3D).

Counterpart of the reference's ``ops/stencil_nd.py``
(``StencilNDStructure``, ``StencilNDOperator``, ``build_stencil_nd``).
The DOF classes are the 2^d half-integer signatures per block component
(on Kuhn-split boxes with P2: the vertex class and 7 edge-direction
classes), and the operator applies as variable-coefficient stencils over
d-dimensional class grids: static slices and multiply-adds, as
:mod:`~lsafw_tpu_torch.ops.stencil`'s 2D operator, whose bucket loop it
shares.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.meshing.mesh import CellType
from lsafw_tpu_torch.ops.sparse import SparsityPattern
from lsafw_tpu_torch.ops.stencil import (
    StencilOperator,
    StencilStructure,
    blocks_of,
    coefficients,
    unique_keys,
)
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True, eq=False)
class StencilNDStructure(StencilStructure):
    """:class:`~lsafw_tpu_torch.ops.stencil.StencilStructure` over
    d-dimensional class grids; a bucket is ``(cr, cc, offsets)``."""

    ndim: int = 2


class StencilNDOperator(StencilOperator):
    """y = A x on packed class-grid vectors (any dimension): the apply of
    :class:`~lsafw_tpu_torch.ops.stencil.StencilOperator`, whose bucket
    loop takes d-dimensional class grids."""


def _classify_nd(coords: np.ndarray, h: np.ndarray, origin: np.ndarray):
    """(class signature id, grid index (n, d)) from half-integer grids."""
    f = (coords - origin[None, :]) / h[None, :] * 2
    g = np.round(f).astype(np.int64)
    if not (np.abs(f - g) < 1e-6).all():
        raise ValueError("Node set is not translation-structured.")
    r = g % 2  # (n, d) half bits
    d = coords.shape[1]
    weights = 2 ** np.arange(d - 1, -1, -1)
    return (r * weights[None, :]).sum(axis=1).astype(np.int32), g // 2


# Strong pattern reference: a new pattern at a freed pattern's id must
# not hit a stale structure.
_CACHE: dict[int, tuple[SparsityPattern, StencilNDStructure]] = {}
_CACHE_MAX = 8


def build_stencil_nd(pattern: SparsityPattern, data, spaces: "FunctionSpaces | list", *,
                     bc_mask: np.ndarray | None = None, bc_diag: float = 1.0,
                     max_buckets: int = 20000, device="cuda") -> StencilNDOperator:
    """The N-D stencil operator; arguments as
    :func:`~lsafw_tpu_torch.ops.stencil.build_stencil_operator`'s."""
    structure = _structure_nd(pattern, blocks_of(spaces), max_buckets)
    coeffs = coefficients(structure, data, device)
    mask_p = None
    if bc_mask is not None:
        mask_p = torch.as_tensor(np.asarray(bc_mask, dtype=bool)[structure.perm],
                                 device=coeffs.device)
    return StencilNDOperator(structure, coeffs, mask_p, bc_diag)


def _structure_nd(pattern: SparsityPattern, blocks, max_buckets: int) -> StencilNDStructure:
    key = id(pattern)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is pattern:
        return hit[1]
    mesh = blocks[0][0].mesh
    if mesh.cell_type not in (CellType.TRIANGLE, CellType.TETRAHEDRON):
        raise ValueError("Stencil operator supports structured simplex meshes.")
    d = mesh.gdim
    n = sum(space.num_nodes * bs for space, bs in blocks)

    h, origin = np.empty(d), np.empty(d)
    for a in range(d):
        va = np.unique(mesh.vertices[:, a])
        h[a] = float(np.diff(va).min())
        origin[a] = float(va.min())

    dof_cls = np.empty(n, dtype=np.int32)
    dof_pos = np.empty((n, d), dtype=np.int64)
    dof_base = cls_base = 0
    for space, bs in blocks:
        scls, spos = _classify_nd(space.node_coords[:, :d], h, origin)
        nd_ = space.num_nodes * bs
        dofs = dof_base + np.arange(nd_)
        node, comp = (dofs - dof_base) // bs, (dofs - dof_base) % bs
        dof_cls[dofs] = cls_base + scls[node] * bs + comp
        dof_pos[dofs] = spos[node]
        dof_base += nd_
        cls_base += (2 ** d) * bs

    used = np.unique(dof_cls)
    remap = np.full(cls_base, -1, dtype=np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    dof_cls = remap[dof_cls]
    num_classes = int(used.size)

    shapes, bases, perm_parts = [], [], []
    base = 0
    for k in range(num_classes):
        sel = np.nonzero(dof_cls == k)[0]
        shp = tuple(int(dof_pos[sel, a].max()) + 1 for a in range(d))
        if sel.size != int(np.prod(shp)):
            raise ValueError(f"Class {k} grid is not dense ({sel.size} vs {np.prod(shp)}).")
        lin = np.zeros(sel.size, dtype=np.int64)
        stride = 1
        for a in range(d - 1, -1, -1):
            lin += dof_pos[sel, a] * stride
            stride *= shp[a]
        order = np.empty(sel.size, dtype=np.int64)
        order[lin] = sel
        shapes.append(shp)
        bases.append(base)
        base += sel.size
        perm_parts.append(order)
    perm = np.concatenate(perm_parts)
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)

    rows = pattern.row_ids.astype(np.int64)
    cols = pattern.indices.astype(np.int64)
    cr, cc = dof_cls[rows], dof_cls[cols]
    off = dof_pos[cols] - dof_pos[rows]  # (nnz, d)
    pad = int(np.abs(off).max())
    OFF = 2 * pad + 1
    bkey = cr.astype(np.int64) * num_classes + cc
    for a in range(d):
        bkey = bkey * OFF + (off[:, a] + pad)
    uniq, inverse = unique_keys(bkey, num_classes * num_classes * OFF ** d)
    if uniq.size > max_buckets:
        raise ValueError(f"{uniq.size} stencil buckets exceed max_buckets={max_buckets}.")

    buckets, bucket_slices = [], []
    sizes = np.zeros(uniq.size, dtype=np.int64)
    start = 0
    for b, kkey in enumerate(uniq):
        rem = int(kkey)
        offs = []
        for a in range(d):
            offs.append(rem % OFF - pad)
            rem //= OFF
        offs = tuple(reversed(offs))
        cc_, cr_ = rem % num_classes, rem // num_classes
        buckets.append((int(cr_), int(cc_), offs))
        sz = int(np.prod(shapes[cr_]))
        bucket_slices.append((start, sz))
        sizes[b] = sz
        start += sz

    bstart = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    strides = np.ones((num_classes, d), dtype=np.int64)  # row-major strides of each class grid
    for kcls, shp in enumerate(shapes):
        for a in range(d - 2, -1, -1):
            strides[kcls, a] = strides[kcls, a + 1] * shp[a + 1]
    rowlin = (dof_pos[rows] * strides[cr]).sum(axis=1)
    nnz_slot = (bstart[inverse] + rowlin).astype(np.int64)
    if np.bincount(nnz_slot, minlength=start).max(initial=0) > 1:
        raise ValueError("Stencil slot collision (duplicate (row, offset) pair).")

    structure = StencilNDStructure(
        n=n, num_classes=num_classes, class_shapes=tuple(shapes), class_bases=tuple(bases),
        buckets=tuple(buckets), pad=pad, perm=perm, inv_perm=inv_perm, nnz_slot=nnz_slot,
        coeff_size=start, bucket_slices=tuple(bucket_slices), ndim=d)
    logger.info("StencilND structure: %dD, %d classes, %d buckets, pad %d (nnz %d)",
                d, num_classes, len(buckets), pad, pattern.nnz)
    while len(_CACHE) >= _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = (pattern, structure)
    return structure
