"""Boundary facet tagging.

Counterpart of ``Meshing/core.py:264-292`` (midpoint-predicate facet
marking) and the TOML facet-rule system of ``config.py:152-237``; here
marker functions are vectorized over all facet midpoints at once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from lsafw_tpu_torch.meshing.mesh import Mesh

MarkerFn = Callable[[np.ndarray], np.ndarray]
"""Maps (n, gdim) midpoints -> (n,) int32 markers (vectorized)."""


def mark_boundary_facets(mesh: Mesh, marker_fn: MarkerFn) -> np.ndarray:
    """Tag boundary facets of ``mesh`` by their midpoints.

    ``marker_fn`` receives the (nb, gdim) midpoints of all *boundary*
    facets and returns int markers.  Interior facets keep marker 0.
    The tags array is stored on the mesh and returned.
    """
    tags = np.zeros(mesh.facets.shape[0], dtype=np.int32)
    bidx = mesh.boundary_facets
    mids = mesh.facet_midpoints[bidx]
    markers = np.asarray(marker_fn(mids), dtype=np.int32)
    if markers.shape != (bidx.size,):
        raise ValueError(
            f"marker_fn returned shape {markers.shape}, expected {(bidx.size,)}"
        )
    tags[bidx] = markers
    mesh.facet_tags = tags
    return tags


def facets_with_marker(mesh: Mesh, marker: int) -> np.ndarray:
    """Facet indices carrying ``marker`` (parity: ``MeshTags.find``)."""
    if mesh.facet_tags is None:
        raise ValueError("Mesh boundaries are not tagged.")
    return np.nonzero(mesh.facet_tags == marker)[0].astype(np.int32)


def scalar_marker(fn: Callable[[np.ndarray], int]) -> MarkerFn:
    """Lift a per-point marker function (the reference's scalar
    ``marker_fn(x)->int`` closures, ``config.py:231-237``) to the
    vectorized interface."""

    def _vec(x: np.ndarray) -> np.ndarray:
        return np.array([fn(p) for p in x], dtype=np.int32)

    return _vec
