"""Quadrature rules on reference cells.

The reference delegates quadrature selection to FFCx's degree
estimation (``FEM/spaces.py:38-43`` only records max degree + 1).
Here rules are explicit static point/weight arrays baked into the
assembly plan: hardcoded symmetric Gauss rules for common degrees on
simplices (standard published constants) with a collapsed
(Duffy-transform) Gauss-Legendre tensor rule as the general fallback.
Weights include the reference-cell volume (sum(w) == |ref cell|).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from lsafw_tpu_torch.meshing.mesh import CellType


@dataclass(frozen=True, eq=False)
class QuadratureRule:
    points: np.ndarray  # (nq, tdim)
    weights: np.ndarray  # (nq,)

    @property
    def num_points(self) -> int:
        return int(self.weights.size)


def _gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


# --- symmetric triangle rules (barycentric orbits; weights sum to 1/2) -----

def _tri_rule(degree: int) -> QuadratureRule | None:
    if degree <= 1:
        pts = np.array([[1 / 3, 1 / 3]])
        w = np.array([0.5])
    elif degree == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        w = np.full(3, 1 / 6)
    elif degree in (3, 4):
        # Dunavant degree-4, 6 points
        a, wa = 0.445948490915965, 0.223381589678011
        b, wb = 0.091576213509771, 0.109951743655322
        pts = np.array(
            [
                [a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                [b, b], [1 - 2 * b, b], [b, 1 - 2 * b],
            ]
        )
        w = 0.5 * np.array([wa] * 3 + [wb] * 3)
    elif degree == 5:
        # Dunavant degree-5, 7 points
        a, wa = 0.470142064105115, 0.132394152788506
        b, wb = 0.101286507323456, 0.125939180544827
        pts = np.array(
            [
                [1 / 3, 1 / 3],
                [a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                [b, b], [1 - 2 * b, b], [b, 1 - 2 * b],
            ]
        )
        w = 0.5 * np.array([0.225] + [wa] * 3 + [wb] * 3)
    else:
        return None
    return QuadratureRule(points=pts, weights=w)


def _tet_rule(degree: int) -> QuadratureRule | None:
    if degree <= 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        w = np.array([1 / 6])
    elif degree == 2:
        a = 0.585410196624969  # (5 + 3*sqrt(5)) / 20
        b = 0.138196601125011
        pts = np.array([[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
        w = np.full(4, 1 / 24)
    else:
        return None
    return QuadratureRule(points=pts, weights=w)


def _duffy_triangle(degree: int) -> QuadratureRule:
    q = max(2, (degree + 2 + 1) // 2 + 1)
    u, wu = _gauss_legendre_01(q)
    v, wv = _gauss_legendre_01(q)
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    x = U
    y = V * (1.0 - U)
    w = WU * WV * (1.0 - U)
    return QuadratureRule(
        points=np.stack([x.ravel(), y.ravel()], axis=1), weights=w.ravel()
    )


def _duffy_tet(degree: int) -> QuadratureRule:
    q = max(2, (degree + 3 + 1) // 2 + 1)
    u, wu = _gauss_legendre_01(q)
    U, V, W = np.meshgrid(u, u, u, indexing="ij")
    WU, WV, WW = np.meshgrid(wu, wu, wu, indexing="ij")
    x = U
    y = V * (1 - U)
    z = W * (1 - U) * (1 - V)
    w = WU * WV * WW * (1 - U) ** 2 * (1 - V)
    return QuadratureRule(
        points=np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1),
        weights=w.ravel(),
    )


@lru_cache(maxsize=64)
def quadrature_rule(cell_type: CellType, degree: int) -> QuadratureRule:
    """Return a rule exact for polynomials of the given total degree."""
    if cell_type is CellType.INTERVAL:
        n = max(1, (degree + 2) // 2)
        x, w = _gauss_legendre_01(n)
        return QuadratureRule(points=x[:, None], weights=w)
    if cell_type is CellType.TRIANGLE:
        return _tri_rule(degree) or _duffy_triangle(degree)
    if cell_type is CellType.TETRAHEDRON:
        return _tet_rule(degree) or _duffy_tet(degree)
    if cell_type is CellType.QUADRILATERAL:
        n = max(1, (degree + 2) // 2)
        x, w = _gauss_legendre_01(n)
        X, Y = np.meshgrid(x, x, indexing="ij")
        WX, WY = np.meshgrid(w, w, indexing="ij")
        return QuadratureRule(
            points=np.stack([X.ravel(), Y.ravel()], axis=1),
            weights=(WX * WY).ravel(),
        )
    if cell_type is CellType.HEXAHEDRON:
        n = max(1, (degree + 2) // 2)
        x, w = _gauss_legendre_01(n)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        WX, WY, WZ = np.meshgrid(w, w, w, indexing="ij")
        return QuadratureRule(
            points=np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1),
            weights=(WX * WY * WZ).ravel(),
        )
    raise NotImplementedError(f"Quadrature on {cell_type}")
