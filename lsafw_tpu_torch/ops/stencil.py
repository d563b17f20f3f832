"""Structured-grid stencil operator: a gather-free SpMV.

Counterpart of the reference's ``ops/stencil.py`` (``StencilStructure``,
``StencilOperator``, ``build_stencil_operator``), under the same names.
On a mesh whose DOF graph is translation-invariant (everything
``rectangle_mesh`` makes) the operator is a set of variable-coefficient
stencils:

    y[class_r][i, j] += sum_buckets C[bucket][i, j] * x[class_c][i+oi, j+oj]

static slices of padded class grids and multiply-adds, no gather.  The
DOF classes on a diagonally split rectangle with Taylor-Hood are vertex /
horizontal-edge / vertical-edge / diagonal-edge nodes times velocity
components, plus vertex pressure: 9 classes.  The host construction (numpy, as
the reference's) classifies nodes geometrically, derives integer grid
positions and maps every CSR entry to a (class_r, class_c, offset)
bucket; vectors live in a packed per-class-grid layout between solver
iterations, and :meth:`StencilOperator.pack` / ``unpack`` are one G
gather each at the boundaries.

The reference built this as the TPU's way around its gather cost.  On an
H100 the assembled CSR product is S (:mod:`~lsafw_tpu_torch.ops.bcsr`);
here the apply is PyTorch slices and ``addcmul_``, one multiply-add
launch per bucket, which ``chip_smoke.py`` phase 13a times beside S.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.meshing.mesh import CellType
from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.ops.sparse import SparsityPattern
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True, eq=False)
class StencilStructure:
    """Static structure: classes, grids, packing and the nnz -> bucket map
    (host numpy; :meth:`on` caches the permutations on a device)."""

    n: int
    num_classes: int
    class_shapes: tuple[tuple[int, int], ...]
    class_bases: tuple[int, ...]  # packed offset of each class block
    buckets: tuple[tuple[int, int, int, int], ...]  # (class_r, class_c, oi, oj)
    pad: int
    perm: np.ndarray  # (n,) packed_index -> dof
    inv_perm: np.ndarray  # (n,) dof -> packed_index
    nnz_slot: np.ndarray  # (nnz,) -> flat position in the coeff storage
    coeff_size: int
    bucket_slices: tuple[tuple[int, int], ...]  # (start, size) per bucket
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def packed_size(self) -> int:
        return self.class_bases[-1] + int(np.prod(self.class_shapes[-1]))

    def on(self, device) -> dict[str, torch.Tensor]:
        """``perm``, ``inv_perm`` (int32, G's index type) and ``nnz_slot``
        (int64) on ``device`` (cached)."""
        key = str(torch.device(device))
        hit = self._device.get(key)
        if hit is None:
            hit = dict(perm=torch.as_tensor(self.perm.astype(np.int32), device=device),
                       inv_perm=torch.as_tensor(self.inv_perm.astype(np.int32), device=device),
                       nnz_slot=torch.as_tensor(self.nnz_slot, device=device))
            self._device[key] = hit
        return hit


def _coeff_views(structure, coeffs: torch.Tensor) -> list[torch.Tensor]:
    """Each bucket's coefficient grid, a view of the flat storage."""
    out = []
    for b, bucket in enumerate(structure.buckets):
        start, size = structure.bucket_slices[b]
        out.append(coeffs[start:start + size].view(structure.class_shapes[bucket[0]]))
    return out


def _offsets(bucket) -> tuple[int, ...]:
    """A bucket's grid offset: (oi, oj) of a 2D bucket (cr, cc, oi, oj), the
    tuple of an N-D one (cr, cc, offsets)."""
    return tuple(bucket[2:]) if len(bucket) == 4 else tuple(bucket[2])


@dataclass(eq=False)
class _Workspace:
    """Zero-bordered class grids kept between applies (the borders stay
    zero; an apply writes the interiors), their interiors, and each
    bucket's shifted read as a view made once."""

    interior: list
    sources: list


def _workspace(structure, dtype: torch.dtype, device) -> _Workspace:
    P = structure.pad
    padded = [torch.zeros(tuple(m + 2 * P for m in shp), dtype=dtype, device=device)
              for shp in structure.class_shapes]
    interior = [g[tuple(slice(P, P + m) for m in shp)]
                for g, shp in zip(padded, structure.class_shapes)]
    sources = [padded[b[1]][tuple(slice(P + o, P + o + m) for o, m in
                                  zip(_offsets(b), structure.class_shapes[b[0]]))]
               for b in structure.buckets]
    return _Workspace(interior, sources)


@dataclass(eq=False)
class StencilOperator:
    """y = A x on packed class-grid vectors (any dimension)."""

    structure: StencilStructure
    coeffs: torch.Tensor  # (coeff_size,) flat bucket coefficient grids
    bc_mask: torch.Tensor | None = None  # (packed_size,) bool
    bc_diag: float = 1.0
    _views: list = field(default=None, repr=False)
    _ws: dict = field(default_factory=dict, repr=False)

    @property
    def views(self) -> list[torch.Tensor]:
        if self._views is None:
            self._views = _coeff_views(self.structure, self.coeffs)
        return self._views

    # --- packing (one G gather each way; outside the hot loops) ---
    def pack(self, x: torch.Tensor) -> torch.Tensor:
        return spmv_cuda.gather(x.contiguous(), self.structure.on(x.device)["perm"])

    def unpack(self, xp: torch.Tensor) -> torch.Tensor:
        return spmv_cuda.gather(xp.contiguous(), self.structure.on(xp.device)["inv_perm"])

    def split_grids(self, xp: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Packed vector -> tuple of class grids (views)."""
        s = self.structure
        return tuple(xp[s.class_bases[k]:s.class_bases[k] + int(np.prod(s.class_shapes[k]))]
                     .view(s.class_shapes[k]) for k in range(s.num_classes))

    def join_grids(self, grids) -> torch.Tensor:
        return torch.cat([g.reshape(-1) for g in grids])

    def _apply(self, grids) -> torch.Tensor:
        """The packed product of per-class grids: the grids copied into the
        kept zero-bordered ones, then one ``addcmul_`` per bucket, in bucket
        order, into the class grids of a fresh packed vector."""
        key = (grids[0].dtype, grids[0].device)
        ws = self._ws.get(key)
        if ws is None:
            ws = self._ws[key] = _workspace(self.structure, *key)
        for dst, g in zip(ws.interior, grids):
            dst.copy_(g)
        y = torch.zeros(self.structure.packed_size, dtype=key[0], device=key[1])
        ys = self.split_grids(y)
        for C, b, src in zip(self.views, self.structure.buckets, ws.sources):
            ys[b[0]].addcmul_(C, src)
        return y

    def matvec_grids(self, grids) -> tuple[torch.Tensor, ...]:
        """Stencil apply on per-class grids (no BC handling)."""
        return self.split_grids(self._apply(grids))

    def matvec(self, xp: torch.Tensor) -> torch.Tensor:
        """Packed-layout matvec: static slices and multiply-adds only."""
        zero = torch.zeros((), dtype=xp.dtype, device=xp.device)
        xe = torch.where(self.bc_mask, zero, xp) if self.bc_mask is not None else xp
        y = self._apply(self.split_grids(xe))
        if self.bc_mask is not None:
            y = torch.where(self.bc_mask, self.bc_diag * xp, y)
        return y

    def __matmul__(self, xp):
        return self.matvec(xp)


def _classify_nodes(coords: np.ndarray, hx: float, hy: float, x0: float, y0: float):
    """Classify structured-grid nodes by their half-integer signature
    relative to the cell spacing (hx, hy): (class_id, ix, iy), the class
    signature (rx, ry) in {0, 1}^2 (offsets of 0 or h/2 within a cell).
    Raises ValueError if the point set is not grid-structured."""
    x, y = coords[:, 0], coords[:, 1]
    gx = np.round((x - x0) / hx * 2).astype(np.int64)
    gy = np.round((y - y0) / hy * 2).astype(np.int64)
    if (not (np.abs((x - x0) / hx * 2 - gx) < 1e-6).all()
            or not (np.abs((y - y0) / hy * 2 - gy) < 1e-6).all()):
        raise ValueError("Node set is not translation-structured.")
    rx, ry = gx % 2, gy % 2
    cls = rx * 2 + ry  # 0: vertex, 1: y-half, 2: x-half, 3: both-half
    return cls.astype(np.int32), gx // 2, gy // 2


def unique_keys(keys: np.ndarray, bound: int) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(keys, return_inverse=True)`` for non-negative integer keys
    below ``bound``: a presence count and a lookup table instead of a sort
    (the stencils' keys take a few thousand values over millions of
    entries)."""
    present = np.bincount(keys, minlength=bound) > 0
    lut = np.cumsum(present) - 1
    return np.flatnonzero(present), lut[keys]


def blocks_of(spaces) -> list:
    """``[(space, block_size), ...]`` of a mixed :class:`FunctionSpaces`
    (velocity, pressure) or of a list of blocks."""
    if isinstance(spaces, FunctionSpaces):
        return [(spaces.velocity, spaces.velocity.bs), (spaces.pressure, 1)]
    return list(spaces)


def coefficients(structure, data, device) -> torch.Tensor:
    """The flat coefficient storage from CSR ``data`` (a tensor, on its
    own device, or numpy, on ``device``): one scatter of the nnz values."""
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data), device=resolve_device(device))
    coeffs = torch.zeros(structure.coeff_size, dtype=data.dtype, device=data.device)
    coeffs[structure.on(data.device)["nnz_slot"]] = data
    return coeffs


def build_stencil_operator(pattern: SparsityPattern, data, spaces: "FunctionSpaces | list", *,
                           bc_mask: np.ndarray | None = None, bc_diag: float = 1.0,
                           max_buckets: int = 2000, device="cuda") -> StencilOperator:
    """Reindex an assembled operator into stencil buckets.

    ``spaces`` is a mixed :class:`FunctionSpaces` (velocity + pressure) or
    a list of ``(FunctionSpace, block_size)`` blocks laid out
    consecutively in the DOF vector (``[(scalar_space, 1)]`` for the
    membrane).  ``data`` is the CSR data: a tensor (the operator lives on
    its device, in its dtype) or numpy (on ``device``, which defaults to
    the card).  The structure depends only on the pattern and the spaces
    and is cached per pattern, so a rebuild after a refill is one scatter
    of the nnz data."""
    structure = _structure_for(pattern, blocks_of(spaces), max_buckets)
    coeffs = coefficients(structure, data, device)
    mask_p = None
    if bc_mask is not None:
        mask_p = torch.as_tensor(np.asarray(bc_mask, dtype=bool)[structure.perm],
                                 device=coeffs.device)
    return StencilOperator(structure, coeffs, mask_p, bc_diag)


# Keyed by id(pattern), holding a strong reference to the pattern (a freed
# pattern's id could be reused by a new one); a bounded LRU.
_STRUCT_CACHE: dict[int, tuple[SparsityPattern, StencilStructure]] = {}
_STRUCT_CACHE_MAX = 8


def _structure_for(pattern: SparsityPattern, blocks, max_buckets: int) -> StencilStructure:
    key = id(pattern)
    hit = _STRUCT_CACHE.get(key)
    if hit is not None and hit[0] is pattern:
        _STRUCT_CACHE[key] = _STRUCT_CACHE.pop(key)  # refresh the LRU order
        return hit[1]
    mesh = blocks[0][0].mesh
    if mesh.tdim != 2 or mesh.cell_type is not CellType.TRIANGLE:
        raise ValueError("Stencil operator supports 2D structured triangle meshes.")
    n = sum(space.num_nodes * bs for space, bs in blocks)

    # cell spacing and origin from the mesh vertices (node sets include
    # half-offset midpoints, so the spacing cannot come from them)
    vx = np.unique(mesh.vertices[:, 0])
    vy = np.unique(mesh.vertices[:, 1])
    hx, hy = float(np.diff(vx).min()), float(np.diff(vy).min())
    x0, y0 = float(vx.min()), float(vy.min())

    # dof -> (class, ix, iy): per block, 4 geometric classes x block_size
    dof_cls = np.empty(n, dtype=np.int32)
    dof_ix = np.empty(n, dtype=np.int64)
    dof_iy = np.empty(n, dtype=np.int64)
    dof_base = cls_base = 0
    for space, bs in blocks:
        scls, six, siy = _classify_nodes(space.node_coords, hx, hy, x0, y0)
        nd = space.num_nodes * bs
        dofs = dof_base + np.arange(nd)
        node, comp = (dofs - dof_base) // bs, (dofs - dof_base) % bs
        dof_cls[dofs] = cls_base + scls[node] * bs + comp
        dof_ix[dofs] = six[node]
        dof_iy[dofs] = siy[node]
        dof_base += nd
        cls_base += 4 * bs

    # compact away empty classes (P1 blocks have vertex nodes only)
    used_cls = np.unique(dof_cls)
    remap_cls = np.full(cls_base, -1, dtype=np.int32)
    remap_cls[used_cls] = np.arange(used_cls.size, dtype=np.int32)
    dof_cls = remap_cls[dof_cls]
    num_classes = int(used_cls.size)
    shapes, bases, perm_parts = [], [], []
    base = 0
    for k in range(num_classes):
        sel = np.nonzero(dof_cls == k)[0]
        nxk = int(dof_ix[sel].max()) + 1
        nyk = int(dof_iy[sel].max()) + 1
        if sel.size != nxk * nyk:
            raise ValueError(f"Class {k} grid is not dense ({sel.size} vs {nxk * nyk}).")
        order = np.empty(nxk * nyk, dtype=np.int64)
        order[dof_ix[sel] * nyk + dof_iy[sel]] = sel
        shapes.append((nxk, nyk))
        bases.append(base)
        base += nxk * nyk
        perm_parts.append(order)
    perm = np.concatenate(perm_parts)
    if (perm < 0).any():
        raise ValueError("Empty DOF class encountered.")
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)

    # bucket every nnz entry
    rows = pattern.row_ids.astype(np.int64)
    cols = pattern.indices.astype(np.int64)
    cr, cc = dof_cls[rows], dof_cls[cols]
    oi = dof_ix[cols] - dof_ix[rows]
    oj = dof_iy[cols] - dof_iy[rows]
    pad = int(max(np.abs(oi).max(), np.abs(oj).max()))
    OFF = 2 * pad + 1
    bkey = ((cr * num_classes + cc) * OFF + (oi + pad)) * OFF + (oj + pad)
    uniq, inverse = unique_keys(bkey, num_classes * num_classes * OFF * OFF)
    if uniq.size > max_buckets:
        raise ValueError(f"{uniq.size} stencil buckets exceed max_buckets={max_buckets}.")

    buckets, bucket_slices = [], []
    sizes = np.zeros(uniq.size, dtype=np.int64)
    start = 0
    for b, k in enumerate(uniq):
        oj_ = int(k % OFF) - pad
        oi_ = int((k // OFF) % OFF) - pad
        cc_ = int((k // (OFF * OFF)) % num_classes)
        cr_ = int(k // (OFF * OFF * num_classes))
        nxr, nyr = shapes[cr_]
        buckets.append((cr_, cc_, oi_, oj_))
        bucket_slices.append((start, nxr * nyr))
        sizes[b] = nxr * nyr
        start += nxr * nyr

    # nnz -> flat coefficient slot: bucket start + row position in its grid
    bstart = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    nyr_of_row = np.array([shapes[c][1] for c in range(num_classes)])[cr]
    nnz_slot = (bstart[inverse] + dof_ix[rows] * nyr_of_row + dof_iy[rows]).astype(np.int64)
    if np.bincount(nnz_slot, minlength=start).max(initial=0) > 1:
        raise ValueError("Stencil slot collision (duplicate (row, offset) pair).")

    structure = StencilStructure(
        n=n, num_classes=num_classes, class_shapes=tuple(shapes), class_bases=tuple(bases),
        buckets=tuple(buckets), pad=pad, perm=perm, inv_perm=inv_perm, nnz_slot=nnz_slot,
        coeff_size=start, bucket_slices=tuple(bucket_slices))
    logger.info("Stencil structure: %d buckets, pad %d, %d coeff entries (nnz %d)",
                len(buckets), pad, start, pattern.nnz)
    while len(_STRUCT_CACHE) >= _STRUCT_CACHE_MAX:
        _STRUCT_CACHE.pop(next(iter(_STRUCT_CACHE)))
    _STRUCT_CACHE[key] = (pattern, structure)
    return structure
