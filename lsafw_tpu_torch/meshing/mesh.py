"""Mesh data structures and canonical structured generators.

Replaces the reference's ``Mesher`` over dolfinx/gmsh
(``Meshing/core.py:28-262``, enums ``Meshing/utils.py:12-120``) with
plain numpy arrays: a mesh is host data, consumed when building
dofmaps, quadrature tables and sparsity patterns.

Supported cell types: interval, triangle, tetrahedron (the simplex
path: affine geometry, a constant Jacobian per cell, batched assembly
on the device), plus quadrilateral/hexahedron generation for parity
with the reference's ``iCellType`` coverage (assembly takes simplices
only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from functools import cached_property

import numpy as np


class CellType(Enum):
    """Supported cell types (parity: ``Meshing/utils.py:12-54``)."""

    INTERVAL = "interval"
    TRIANGLE = "triangle"
    QUADRILATERAL = "quadrilateral"
    TETRAHEDRON = "tetrahedron"
    HEXAHEDRON = "hexahedron"

    @property
    def dim(self) -> int:
        return {
            CellType.INTERVAL: 1,
            CellType.TRIANGLE: 2,
            CellType.QUADRILATERAL: 2,
            CellType.TETRAHEDRON: 3,
            CellType.HEXAHEDRON: 3,
        }[self]

    @property
    def num_vertices(self) -> int:
        return {
            CellType.INTERVAL: 2,
            CellType.TRIANGLE: 3,
            CellType.QUADRILATERAL: 4,
            CellType.TETRAHEDRON: 4,
            CellType.HEXAHEDRON: 8,
        }[self]

    @property
    def facet_type(self) -> "CellType":
        return {
            CellType.TRIANGLE: CellType.INTERVAL,
            CellType.QUADRILATERAL: CellType.INTERVAL,
            CellType.TETRAHEDRON: CellType.TRIANGLE,
            CellType.HEXAHEDRON: CellType.QUADRILATERAL,
        }[self]

    @classmethod
    def from_string(cls, value: str) -> "CellType":
        return cls(value.lower().strip())


class Shape(Enum):
    """Canonical shapes (parity: ``Meshing/utils.py:56-87``)."""

    UNIT_INTERVAL = "unit_interval"
    UNIT_SQUARE = "unit_square"
    UNIT_CUBE = "unit_cube"
    BOX = "box"
    CYLINDER_FLOW = "cylinder_flow"
    STEP_FLOW = "step_flow"
    CUSTOM = "custom"

    @classmethod
    def from_string(cls, value: str) -> "Shape":
        return cls(value.lower().strip())


# Local vertex numbering of the facets of each cell type.  The simplex
# conventions match the "sorted opposite-vertex" rule: facet i of a
# simplex is the face not containing local vertex i.
_FACET_VERTICES: dict[CellType, tuple[tuple[int, ...], ...]] = {
    CellType.INTERVAL: ((0,), (1,)),
    CellType.TRIANGLE: ((1, 2), (0, 2), (0, 1)),
    CellType.TETRAHEDRON: ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
    CellType.QUADRILATERAL: ((0, 1), (1, 3), (2, 3), (0, 2)),
    CellType.HEXAHEDRON: (
        (0, 1, 2, 3),
        (4, 5, 6, 7),
        (0, 1, 4, 5),
        (2, 3, 6, 7),
        (0, 2, 4, 6),
        (1, 3, 5, 7),
    ),
}


# Local vertex numbering of the edges of each cell type.  For 2D cells
# edges coincide with facets (same ordering), so P2 dofmaps can share
# the facet arrays; tetrahedra/hexahedra get their own edge sets.
_EDGE_VERTICES: dict[CellType, tuple[tuple[int, int], ...]] = {
    CellType.TRIANGLE: ((1, 2), (0, 2), (0, 1)),
    CellType.QUADRILATERAL: ((0, 1), (1, 3), (2, 3), (0, 2)),
    CellType.TETRAHEDRON: ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    CellType.HEXAHEDRON: (
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ),
}


@dataclass
class Mesh:
    """An unstructured mesh as static host arrays.

    Attributes:
        vertices: (num_vertices, gdim) float64 coordinates.
        cells: (num_cells, verts_per_cell) int32 connectivity.
        cell_type: the cell type.
        facet_tags: optional (num_facets,) int32 markers over *all*
            facets (0 = untagged); see :mod:`lsafw_tpu_torch.meshing.tags`.
        cell_tags: optional (num_cells,) int32 markers.
    """

    vertices: np.ndarray
    cells: np.ndarray
    cell_type: CellType
    facet_tags: np.ndarray | None = None
    cell_tags: np.ndarray | None = None
    _cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)

    # ---- basic queries -------------------------------------------------
    @property
    def gdim(self) -> int:
        return int(self.vertices.shape[1])

    @property
    def tdim(self) -> int:
        return self.cell_type.dim

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_cells(self) -> int:
        return int(self.cells.shape[0])

    # ---- facet topology ------------------------------------------------
    @cached_property
    def _facet_data(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compute (facets, facet_to_cells, cell_to_facets).

        facets: (num_facets, verts_per_facet) int32, vertex-sorted.
        facet_to_cells: (num_facets, 2) int32; second entry -1 on boundary.
        cell_to_facets: (num_cells, facets_per_cell) int32.
        """
        local = np.asarray(_FACET_VERTICES[self.cell_type], dtype=np.int64)
        nfpc, nvpf = local.shape
        # all facets with duplicates: (num_cells * nfpc, nvpf)
        all_facets = self.cells[:, local.reshape(-1)].reshape(-1, nvpf)
        key = np.sort(all_facets, axis=1)
        uniq, inverse = np.unique(key, axis=0, return_inverse=True)
        cell_to_facets = inverse.reshape(self.num_cells, nfpc).astype(np.int32)
        facet_to_cells = np.full((uniq.shape[0], 2), -1, dtype=np.int32)
        owner_cell = np.repeat(np.arange(self.num_cells, dtype=np.int32), nfpc)
        # first occurrence -> col 0, second -> col 1
        order = np.argsort(inverse, kind="stable")
        sorted_inv = inverse[order]
        first_mask = np.ones_like(sorted_inv, dtype=bool)
        first_mask[1:] = sorted_inv[1:] != sorted_inv[:-1]
        facet_to_cells[sorted_inv[first_mask], 0] = owner_cell[order][first_mask]
        second = ~first_mask
        facet_to_cells[sorted_inv[second], 1] = owner_cell[order][second]
        return uniq.astype(np.int32), facet_to_cells, cell_to_facets

    @property
    def facets(self) -> np.ndarray:
        return self._facet_data[0]

    @property
    def facet_to_cells(self) -> np.ndarray:
        return self._facet_data[1]

    @property
    def cell_to_facets(self) -> np.ndarray:
        return self._facet_data[2]

    @cached_property
    def _edge_data(self) -> tuple[np.ndarray, np.ndarray]:
        """(edges, cell_to_edges): unique vertex-sorted edges + per-cell map.

        Used by quadratic dofmaps (one DOF per edge).  For 2D cells this
        equals the facet arrays; for 3D cells edges are distinct entities.
        """
        if self.tdim == 2:
            return self.facets, self.cell_to_facets
        local = np.asarray(_EDGE_VERTICES[self.cell_type], dtype=np.int64)
        nepc = local.shape[0]
        all_edges = self.cells[:, local.reshape(-1)].reshape(-1, 2)
        key = np.sort(all_edges, axis=1)
        uniq, inverse = np.unique(key, axis=0, return_inverse=True)
        return uniq.astype(np.int32), inverse.reshape(self.num_cells, nepc).astype(np.int32)

    @property
    def edges(self) -> np.ndarray:
        return self._edge_data[0]

    @property
    def cell_to_edges(self) -> np.ndarray:
        return self._edge_data[1]

    @cached_property
    def boundary_facets(self) -> np.ndarray:
        """Indices of facets on the boundary (exactly one adjacent cell)."""
        return np.nonzero(self.facet_to_cells[:, 1] < 0)[0].astype(np.int32)

    @cached_property
    def facet_midpoints(self) -> np.ndarray:
        """(num_facets, gdim) midpoints, used by marker functions
        (parity: ``Meshing/core.py:264-292`` midpoint predicates)."""
        return self.vertices[self.facets].mean(axis=1)

    @cached_property
    def cell_volumes(self) -> np.ndarray:
        """Measure (length/area/volume) of every cell (simplices only)."""
        v = self.vertices[self.cells]
        if self.cell_type is CellType.INTERVAL:
            return np.abs(v[:, 1, 0] - v[:, 0, 0])
        if self.cell_type is CellType.TRIANGLE:
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            return 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        if self.cell_type is CellType.TETRAHEDRON:
            e = v[:, 1:] - v[:, :1]
            return np.abs(np.linalg.det(e)) / 6.0
        raise NotImplementedError(f"cell_volumes for {self.cell_type}")

    @cached_property
    def hmin(self) -> float:
        """Minimum cell diameter (edge-length based)."""
        return float(self._edge_lengths().min())

    @cached_property
    def hmax(self) -> float:
        return float(self._edge_lengths().max())

    def _edge_lengths(self) -> np.ndarray:
        v = self.vertices[self.cells]
        k = v.shape[1]
        pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
        return np.stack(
            [np.linalg.norm(v[:, i] - v[:, j], axis=1) for i, j in pairs], axis=1
        )

    def summary(self) -> str:
        """Human-readable summary (parity: ``Meshing/plot.py:124``)."""
        tagged = 0 if self.facet_tags is None else int((self.facet_tags != 0).sum())
        return (
            f"Mesh({self.cell_type.value}, gdim={self.gdim}): "
            f"{self.num_vertices} vertices, {self.num_cells} cells, "
            f"{self.facets.shape[0]} facets ({self.boundary_facets.size} boundary, "
            f"{tagged} tagged), h=[{self.hmin:.3g},{self.hmax:.3g}]"
        )


# ---------------------------------------------------------------------------
# Structured generators (parity: Meshing/core.py:162-213 generate())
# ---------------------------------------------------------------------------


def unit_interval(n: int) -> Mesh:
    """Uniform mesh of [0, 1] with ``n`` cells."""
    x = np.linspace(0.0, 1.0, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(x, cells, CellType.INTERVAL)


def _grid_vertices_2d(p0, p1, nx, ny):
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([X.ravel(), Y.ravel()], axis=1)


def rectangle_mesh(
    p0: tuple[float, float],
    p1: tuple[float, float],
    nx: int,
    ny: int,
    cell_type: CellType = CellType.TRIANGLE,
) -> Mesh:
    """Structured mesh of the axis-aligned rectangle [p0, p1]."""
    verts = _grid_vertices_2d(p0, p1, nx, ny)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(i, j).ravel()
    v10 = vid(i + 1, j).ravel()
    v01 = vid(i, j + 1).ravel()
    v11 = vid(i + 1, j + 1).ravel()
    if cell_type is CellType.QUADRILATERAL:
        cells = np.stack([v00, v10, v01, v11], axis=1)
    elif cell_type is CellType.TRIANGLE:
        # split each quad along the (v00, v11) diagonal
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        cells = np.concatenate([t1, t2], axis=0)
    else:
        raise ValueError(f"rectangle_mesh does not support {cell_type}")
    return Mesh(verts, cells, cell_type)


def unit_square(nx: int, ny: int | None = None, cell_type: CellType = CellType.TRIANGLE) -> Mesh:
    """Structured mesh of the unit square (parity: ``Meshing/core.py`` UNIT_SQUARE)."""
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), nx, ny or nx, cell_type)


# Kuhn subdivision of a cube into 6 tetrahedra sharing the main diagonal.
_KUHN_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    dtype=np.int64,
)


def box_mesh(
    p0: tuple[float, float, float],
    p1: tuple[float, float, float],
    nx: int,
    ny: int,
    nz: int,
    cell_type: CellType = CellType.TETRAHEDRON,
) -> Mesh:
    """Structured mesh of the axis-aligned box [p0, p1]
    (parity: ``Meshing/core.py`` BOX generation)."""
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    zs = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    corners = np.stack(
        [
            vid(i + di, j + dj, k + dk).ravel()
            for di in (0, 1)
            for dj in (0, 1)
            for dk in (0, 1)
        ],
        axis=1,
    )  # (ncubes, 8), binary order (di,dj,dk)
    if cell_type is CellType.HEXAHEDRON:
        cells = corners
    elif cell_type is CellType.TETRAHEDRON:
        cells = corners[:, _KUHN_TETS.reshape(-1)].reshape(-1, 4)
    else:
        raise ValueError(f"box_mesh does not support {cell_type}")
    return Mesh(verts, cells, cell_type)


def unit_cube(nx: int, ny: int | None = None, nz: int | None = None,
              cell_type: CellType = CellType.TETRAHEDRON) -> Mesh:
    """Structured mesh of the unit cube (parity: ``Meshing/core.py`` UNIT_CUBE)."""
    return box_mesh((0, 0, 0), (1, 1, 1), nx, ny or nx, nz or nx, cell_type)


def generate_mesh(shape: Shape | str, **kw) -> Mesh:
    """Dispatch generator by shape name (parity: ``Meshing/core.py:162``)."""
    shape = Shape.from_string(shape) if isinstance(shape, str) else shape
    if shape is Shape.UNIT_INTERVAL:
        return unit_interval(kw.get("n", 16))
    if shape is Shape.UNIT_SQUARE:
        return unit_square(kw.get("nx", 16), kw.get("ny"), kw.get("cell_type", CellType.TRIANGLE))
    if shape is Shape.UNIT_CUBE:
        return unit_cube(
            kw.get("nx", 8), kw.get("ny"), kw.get("nz"), kw.get("cell_type", CellType.TETRAHEDRON)
        )
    if shape is Shape.BOX:
        return box_mesh(
            kw["p0"], kw["p1"], kw["nx"], kw["ny"], kw["nz"],
            kw.get("cell_type", CellType.TETRAHEDRON),
        )
    if shape is Shape.CYLINDER_FLOW:
        from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh

        return cylinder_flow_mesh(kw["config"])
    if shape is Shape.STEP_FLOW:
        from lsafw_tpu_torch.meshing.geometries import step_flow_mesh

        return step_flow_mesh(kw["config"])
    raise ValueError(f"Cannot generate shape {shape}")
