"""Mesh partitioning for locality-aware DOF sharding.

Counterpart of the reference's ``parallel/partition.py`` (host numpy,
kept as the port's own copy): recursive coordinate bisection (RCB) of
the cell centroids gives contiguous cell blocks per rank, and a DOF
renumbering groups each rank's rows contiguously, so that the sharded
row blocks follow the mesh and the operand all-gather of a matvec
carries mostly rows the rank already holds.
"""

from __future__ import annotations

import numpy as np

from lsafw_tpu_torch.meshing.mesh import Mesh


def partition_cells(mesh: Mesh, num_parts: int) -> np.ndarray:
    """(num_cells,) part id per cell by recursive coordinate bisection."""
    if num_parts & (num_parts - 1):
        raise ValueError("num_parts must be a power of two for RCB.")
    centroids = mesh.vertices[mesh.cells].mean(axis=1)
    parts = np.zeros(mesh.num_cells, dtype=np.int32)
    _rcb(centroids, np.arange(mesh.num_cells), parts, 0, num_parts)
    return parts


def _rcb(centroids, idx, parts, base, n):
    if n == 1:
        parts[idx] = base
        return
    pts = centroids[idx]
    axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
    order = np.argsort(pts[:, axis], kind="stable")
    half = idx.size // 2
    _rcb(centroids, idx[order[:half]], parts, base, n // 2)
    _rcb(centroids, idx[order[half:]], parts, base + n // 2, n // 2)


def renumber_dofs_by_partition(
    cell_dofs: np.ndarray, num_dofs: int, cell_parts: np.ndarray, num_parts: int
) -> np.ndarray:
    """Permutation old->new grouping DOFs by their owning partition.

    A DOF is owned by the lowest-id partition touching it (the
    dolfinx-style ownership rule).  Returns ``perm`` with
    ``new_dof = perm[old_dof]``.
    """
    owner = np.full(num_dofs, num_parts, dtype=np.int32)
    order = np.argsort(cell_parts, kind="stable")[::-1]  # high parts first
    for c in order:  # later (lower part) assignments win
        owner[cell_dofs[c]] = cell_parts[c]
    perm = np.empty(num_dofs, dtype=np.int64)
    perm[np.lexsort((np.arange(num_dofs), owner))] = np.arange(num_dofs)
    return perm
