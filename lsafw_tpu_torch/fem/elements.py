"""Reference finite elements: analytic tabulation of Lagrange bases.

Replaces the reference's basix element tabulation (reached through
``FEM/spaces.py:110-145``) with closed-form shape functions on the
reference simplex, evaluated once on the quadrature points and baked
into the assembly plan as static constants — exactly what a TPU kernel
wants (no runtime tabulation, just einsum contractions).

Supported families (parity: ``FEM/utils.py:36-90`` ``iElementFamily`` /
``FEM/spaces.py:62-100`` space types):
  * P1 / P2 Lagrange on interval, triangle, tetrahedron,
  * interior bubble (degree tdim+1) on triangle/tetrahedron,
  * P1+bubble enrichment (the MINI velocity element),
  * Q1 on quadrilateral (membrane/elasticity benchmarks).

Node ordering convention: vertex DOFs first (mesh vertex order), then
edge DOFs ordered by the cell's local edge numbering
(``meshing.mesh._EDGE_VERTICES``), then one interior DOF for bubbles.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from lsafw_tpu_torch.meshing.mesh import _EDGE_VERTICES, CellType


class ElementFamily(Enum):
    """Element family (parity: ``FEM/utils.py:36`` iElementFamily)."""

    P1 = "p1"
    P2 = "p2"
    BUBBLE = "bubble"
    P1_BUBBLE = "p1_bubble"  # MINI enrichment
    Q1 = "q1"
    Q2 = "q2"  # biquadratic (9-node quad); Taylor-Hood velocity on quads

    @classmethod
    def from_string(cls, value: str) -> "ElementFamily":
        return cls(value.lower().strip())


@dataclass(frozen=True)
class Tabulation:
    """Basis values / reference gradients at a point set.

    phi:  (npts, ndofs) float64.
    grad: (npts, ndofs, tdim) float64 (reference-coordinate gradients).
    """

    phi: np.ndarray
    grad: np.ndarray


@dataclass(frozen=True)
class ReferenceElement:
    """A scalar reference element on a simplex/quad cell."""

    family: ElementFamily
    cell_type: CellType
    degree: int
    ndofs: int
    num_vertex_dofs: int
    num_edge_dofs: int
    num_interior_dofs: int
    nodes: np.ndarray  # (ndofs, tdim) nodal points on the reference cell

    def tabulate(self, points: np.ndarray) -> Tabulation:
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        phi, grad = _TABULATORS[(self.family, self.cell_type)](points)
        return Tabulation(phi=phi, grad=grad)


# ---------------------------------------------------------------------------
# Barycentric helpers
# ---------------------------------------------------------------------------


def _bary_triangle(p: np.ndarray):
    x, y = p[:, 0], p[:, 1]
    lam = np.stack([1.0 - x - y, x, y], axis=1)  # (n, 3)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    return lam, dlam


def _bary_tet(p: np.ndarray):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    lam = np.stack([1.0 - x - y - z, x, y, z], axis=1)
    dlam = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    return lam, dlam


_BARY = {CellType.TRIANGLE: _bary_triangle, CellType.TETRAHEDRON: _bary_tet}


# ---------------------------------------------------------------------------
# Tabulators
# ---------------------------------------------------------------------------


def _tab_p1_interval(p):
    x = p[:, 0]
    phi = np.stack([1.0 - x, x], axis=1)
    grad = np.broadcast_to(np.array([[[-1.0], [1.0]]]), (p.shape[0], 2, 1)).copy()
    return phi, grad


def _tab_p2_interval(p):
    x = p[:, 0]
    # vertices then midpoint (edge DOF)
    phi = np.stack(
        [(1 - x) * (1 - 2 * x), x * (2 * x - 1), 4 * x * (1 - x)], axis=1
    )
    dphi = np.stack([4 * x - 3, 4 * x - 1, 4 - 8 * x], axis=1)
    return phi, dphi[:, :, None]


def _simplex_p1(cell: CellType):
    def tab(p):
        lam, dlam = _BARY[cell](p)
        grad = np.broadcast_to(dlam[None], (p.shape[0],) + dlam.shape).copy()
        return lam.copy(), grad

    return tab


def _simplex_p2(cell: CellType):
    edges = np.asarray(_EDGE_VERTICES[cell], dtype=np.int64)

    def tab(p):
        lam, dlam = _BARY[cell](p)
        nverts = lam.shape[1]
        npts = p.shape[0]
        tdim = dlam.shape[1]
        ndofs = nverts + edges.shape[0]
        phi = np.empty((npts, ndofs))
        grad = np.empty((npts, ndofs, tdim))
        for i in range(nverts):
            phi[:, i] = lam[:, i] * (2 * lam[:, i] - 1)
            grad[:, i] = (4 * lam[:, i] - 1)[:, None] * dlam[i]
        for e, (a, b) in enumerate(edges):
            j = nverts + e
            phi[:, j] = 4 * lam[:, a] * lam[:, b]
            grad[:, j] = 4 * (lam[:, a, None] * dlam[b] + lam[:, b, None] * dlam[a])
        return phi, grad

    return tab


def _simplex_bubble(cell: CellType):
    nverts = 3 if cell is CellType.TRIANGLE else 4
    scale = 27.0 if cell is CellType.TRIANGLE else 256.0

    def tab(p):
        lam, dlam = _BARY[cell](p)
        prod = np.prod(lam, axis=1)
        phi = (scale * prod)[:, None]
        grad = np.zeros((p.shape[0], 1, dlam.shape[1]))
        for i in range(nverts):
            others = np.prod(np.delete(lam, i, axis=1), axis=1)
            grad[:, 0] += scale * others[:, None] * dlam[i]
        return phi, grad

    return tab


def _simplex_p1_bubble(cell: CellType):
    p1 = _simplex_p1(cell)
    bub = _simplex_bubble(cell)

    def tab(p):
        phi1, g1 = p1(p)
        phib, gb = bub(p)
        return np.concatenate([phi1, phib], axis=1), np.concatenate([g1, gb], axis=1)

    return tab


def _tab_q1_quad(p):
    x, y = p[:, 0], p[:, 1]
    # vertex order (0,0),(1,0),(0,1),(1,1) matching rectangle_mesh quads
    phi = np.stack(
        [(1 - x) * (1 - y), x * (1 - y), (1 - x) * y, x * y], axis=1
    )
    gx = np.stack([-(1 - y), (1 - y), -y, y], axis=1)
    gy = np.stack([-(1 - x), -x, (1 - x), x], axis=1)
    return phi, np.stack([gx, gy], axis=2)


def _tab_q2_quad(p):
    """Biquadratic 9-node quad.  Node order matches the dofmap construction:
    vertices (0,0),(1,0),(0,1),(1,1), then edge midpoints in
    ``_EDGE_VERTICES[QUADRILATERAL]`` order ((0,1),(1,3),(2,3),(0,2)),
    then the centre."""
    x, y = p[:, 0], p[:, 1]

    def L(t):  # 1D quadratic Lagrange at nodes {0, 1, 1/2}
        return (2 * t - 1) * (t - 1), t * (2 * t - 1), 4 * t * (1 - t)

    def dL(t):
        return 4 * t - 3, 4 * t - 1, 4 - 8 * t

    Lx, dLx = L(x), dL(x)
    Ly, dLy = L(y), dL(y)
    # (a_x, a_y) per node; index 2 = midpoint
    nodes = [(0, 0), (1, 0), (0, 1), (1, 1),
             (2, 0), (1, 2), (2, 1), (0, 2), (2, 2)]
    phi = np.stack([Lx[a] * Ly[b] for a, b in nodes], axis=1)
    gx = np.stack([dLx[a] * Ly[b] for a, b in nodes], axis=1)
    gy = np.stack([Lx[a] * dLy[b] for a, b in nodes], axis=1)
    return phi, np.stack([gx, gy], axis=2)


def _tab_q1_hex(p):
    """Trilinear Q1 on the unit cube, vertex order = box_mesh's binary
    (di, dj, dk) with k fastest (``meshing/mesh.py`` box corners)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    Lx = [1 - x, x]
    Ly = [1 - y, y]
    Lz = [1 - z, z]
    dLx = [-np.ones_like(x), np.ones_like(x)]
    phi, gx, gy, gz = [], [], [], []
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                phi.append(Lx[di] * Ly[dj] * Lz[dk])
                gx.append(dLx[di] * Ly[dj] * Lz[dk])
                gy.append(Lx[di] * dLx[dj] * Lz[dk])
                gz.append(Lx[di] * Ly[dj] * dLx[dk])
    phi = np.stack(phi, axis=1)
    grad = np.stack([np.stack(g, axis=1) for g in (gx, gy, gz)], axis=2)
    return phi, grad


_TABULATORS = {
    (ElementFamily.P1, CellType.INTERVAL): _tab_p1_interval,
    (ElementFamily.P2, CellType.INTERVAL): _tab_p2_interval,
    (ElementFamily.P1, CellType.TRIANGLE): _simplex_p1(CellType.TRIANGLE),
    (ElementFamily.P2, CellType.TRIANGLE): _simplex_p2(CellType.TRIANGLE),
    (ElementFamily.BUBBLE, CellType.TRIANGLE): _simplex_bubble(CellType.TRIANGLE),
    (ElementFamily.P1_BUBBLE, CellType.TRIANGLE): _simplex_p1_bubble(CellType.TRIANGLE),
    (ElementFamily.P1, CellType.TETRAHEDRON): _simplex_p1(CellType.TETRAHEDRON),
    (ElementFamily.P2, CellType.TETRAHEDRON): _simplex_p2(CellType.TETRAHEDRON),
    (ElementFamily.BUBBLE, CellType.TETRAHEDRON): _simplex_bubble(CellType.TETRAHEDRON),
    (ElementFamily.P1_BUBBLE, CellType.TETRAHEDRON): _simplex_p1_bubble(CellType.TETRAHEDRON),
    (ElementFamily.Q1, CellType.QUADRILATERAL): _tab_q1_quad,
    (ElementFamily.Q2, CellType.QUADRILATERAL): _tab_q2_quad,
    (ElementFamily.Q1, CellType.HEXAHEDRON): _tab_q1_hex,
    # Q2 on hexahedra needs face DOFs, which the (vertex, edge,
    # interior) dofmap does not model — make_element raises cleanly
}


def _reference_nodes(family: ElementFamily, cell: CellType) -> np.ndarray:
    verts = {
        CellType.INTERVAL: np.array([[0.0], [1.0]]),
        CellType.TRIANGLE: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
        CellType.TETRAHEDRON: np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        ),
        CellType.QUADRILATERAL: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
        CellType.HEXAHEDRON: np.array(
            [[di, dj, dk] for di in (0.0, 1.0) for dj in (0.0, 1.0) for dk in (0.0, 1.0)]
        ),
    }[cell]
    if family in (ElementFamily.P1, ElementFamily.Q1):
        return verts
    if family is ElementFamily.P2:
        if cell is CellType.INTERVAL:
            return np.vstack([verts, [[0.5]]])
        edges = np.asarray(_EDGE_VERTICES[cell])
        mids = verts[edges].mean(axis=1)
        return np.vstack([verts, mids])
    if family is ElementFamily.Q2:
        edges = np.asarray(_EDGE_VERTICES[cell])
        mids = verts[edges].mean(axis=1)
        return np.vstack([verts, mids, verts.mean(axis=0, keepdims=True)])
    centroid = verts.mean(axis=0, keepdims=True)
    if family is ElementFamily.BUBBLE:
        return centroid
    if family is ElementFamily.P1_BUBBLE:
        return np.vstack([verts, centroid])
    raise ValueError(f"No nodes for {family} on {cell}")


def make_element(family: ElementFamily | str, cell: CellType) -> ReferenceElement:
    """Construct a scalar reference element."""
    family = ElementFamily.from_string(family) if isinstance(family, str) else family
    if (family, cell) not in _TABULATORS:
        raise NotImplementedError(f"{family} on {cell} is not supported.")
    nodes = _reference_nodes(family, cell)
    nverts = cell.num_vertices
    if family in (ElementFamily.P1, ElementFamily.Q1):
        nvd, ned, nid, deg = nverts, 0, 0, 1
    elif family is ElementFamily.P2:
        nedges = 1 if cell is CellType.INTERVAL else len(_EDGE_VERTICES[cell])
        nvd, ned, nid, deg = nverts, nedges, 0, 2
    elif family is ElementFamily.Q2:
        nvd, ned, nid, deg = nverts, len(_EDGE_VERTICES[cell]), 1, 2
    elif family is ElementFamily.BUBBLE:
        nvd, ned, nid, deg = 0, 0, 1, cell.dim + 1
    elif family is ElementFamily.P1_BUBBLE:
        nvd, ned, nid, deg = nverts, 0, 1, cell.dim + 1
    else:
        raise NotImplementedError(family)
    return ReferenceElement(
        family=family,
        cell_type=cell,
        degree=deg,
        ndofs=nvd + ned + nid,
        num_vertex_dofs=nvd,
        num_edge_dofs=ned,
        num_interior_dofs=nid,
        nodes=nodes,
    )
