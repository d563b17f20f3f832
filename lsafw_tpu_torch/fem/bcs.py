"""Boundary conditions on the mixed velocity-pressure space.

Dirichlet velocity/pressure (strong, as masked DOFs + values),
Neumann velocity/pressure and Robin (weak, consumed by the
facet-integral kernels), Symmetry (component pinning) and Periodic
(geometric DOF pairing and post-assembly constraint folding on the
host, ``FEM/bcs.py:198-304``).

Strong conditions are a boolean mask + value vector over the mixed
DOF layout; application to operators is the pure-data transform
:func:`lsafw_tpu_torch.fem.assembly.dirichlet_matrix_data`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Sequence

import numpy as np
import scipy.sparse as sp

from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class BoundaryConditionType(Enum):
    """Supported BC types (parity: ``FEM/bcs.py:26-54``)."""

    DIRICHLET_VELOCITY = "dirichlet_velocity"
    DIRICHLET_PRESSURE = "dirichlet_pressure"
    NEUMANN_VELOCITY = "neumann_velocity"
    NEUMANN_PRESSURE = "neumann_pressure"
    PERIODIC = "periodic"
    ROBIN = "robin"
    SYMMETRY = "symmetry"
    DIRICHLET_DISPLACEMENT = "dirichlet_displacement"

    @classmethod
    def from_string(cls, value: str) -> "BoundaryConditionType":
        return cls(value.lower().strip().replace(" ", "_"))


@dataclass
class BoundaryConditions:
    """All BCs of a problem over the mixed layout
    (parity: ``FEM/bcs.py:57-74``)."""

    num_dofs: int
    dirichlet_mask: np.ndarray  # (num_dofs,) bool
    dirichlet_values: np.ndarray  # (num_dofs,) float64
    velocity_neumann: list[tuple[int, tuple[float, ...]]] = field(default_factory=list)
    pressure_neumann: list[tuple[int, float]] = field(default_factory=list)
    robin: list[tuple[int, float, tuple[float, ...]]] = field(default_factory=list)
    velocity_periodic: list[tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    pressure_periodic: list[tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    outlet_markers: list[int] = field(default_factory=list)

    @property
    def periodic_pairs(self) -> list[tuple[np.ndarray, np.ndarray]]:
        return self.velocity_periodic + self.pressure_periodic

    def homogeneous(self) -> "BoundaryConditions":
        """Same constrained DOFs with zero values: the perturbation BCs of
        the linearized eigenproblem (homogeneous Dirichlet on every
        baseflow Dirichlet boundary)."""
        return BoundaryConditions(
            num_dofs=self.num_dofs,
            dirichlet_mask=self.dirichlet_mask.copy(),
            dirichlet_values=np.zeros_like(self.dirichlet_values),
            velocity_neumann=[(m, tuple(0.0 for _ in v)) for m, v in self.velocity_neumann],
            pressure_neumann=[(m, 0.0) for m, _ in self.pressure_neumann],
            robin=[(m, a, tuple(0.0 for _ in v)) for m, a, v in self.robin],
            velocity_periodic=list(self.velocity_periodic),
            pressure_periodic=list(self.pressure_periodic),
            outlet_markers=list(self.outlet_markers),
        )


def define_bcs(
    mesh: Mesh,
    spaces: FunctionSpaces,
    configs: Sequence[BoundaryConditionsConfig],
) -> BoundaryConditions:
    """Construct all boundary conditions (parity: ``FEM/bcs.py:77-195``)."""
    if mesh.facet_tags is None:
        raise ValueError("Mesh boundaries are not properly tagged.")
    gdim = mesh.gdim
    n = spaces.num_dofs
    nu = spaces.num_velocity_dofs
    mask = np.zeros(n, dtype=bool)
    values = np.zeros(n, dtype=np.float64)
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=mask, dirichlet_values=values)

    for cfg in configs:
        kind = BoundaryConditionType.from_string(cfg.type)
        marker = cfg.marker
        if kind is not BoundaryConditionType.PERIODIC:
            facets = facets_with_marker(mesh, marker)

        if kind in (
            BoundaryConditionType.DIRICHLET_VELOCITY,
            BoundaryConditionType.DIRICHLET_DISPLACEMENT,
        ):
            dofs = spaces.velocity.dofs_on_facets(facets)
            vals = _velocity_values(spaces, dofs, cfg.value, gdim)
            mask[dofs] = True
            values[dofs] = vals

        elif kind is BoundaryConditionType.DIRICHLET_PRESSURE:
            nodes = spaces.pressure.nodes_on_facets(facets)
            dofs = nu + nodes
            mask[dofs] = True
            values[dofs] = _scalar_values(spaces.pressure.node_coords[nodes], cfg.value)
            bcs.outlet_markers.append(marker)

        elif kind is BoundaryConditionType.SYMMETRY:
            # pin the wall-normal component (component 1, matching the
            # reference's hard-coded comp=1, ``FEM/bcs.py:178-182``)
            dofs = spaces.velocity.dofs_on_facets(facets, component=1)
            mask[dofs] = True
            values[dofs] = 0.0

        elif kind is BoundaryConditionType.NEUMANN_VELOCITY:
            bcs.velocity_neumann.append((marker, _as_vector(cfg.value, gdim)))

        elif kind is BoundaryConditionType.NEUMANN_PRESSURE:
            bcs.pressure_neumann.append((marker, float(cfg.value)))

        elif kind is BoundaryConditionType.ROBIN:
            if cfg.robin_alpha is None:
                raise ValueError("robin_alpha must be provided for Robin BC")
            bcs.robin.append((marker, float(cfg.robin_alpha), _as_vector(cfg.value, gdim)))

        elif kind is BoundaryConditionType.PERIODIC:
            if not (isinstance(cfg.value, tuple) and len(cfg.value) == 2):
                raise TypeError("PERIODIC value must be (from_marker, to_marker)")
            fm, tm = int(cfg.value[0]), int(cfg.value[1])
            bcs.velocity_periodic.append(compute_periodic_dof_pairs(spaces.velocity, mesh, fm, tm))
            to_p, from_p = compute_periodic_dof_pairs(spaces.pressure, mesh, fm, tm)
            bcs.pressure_periodic.append((to_p + nu, from_p + nu))

        else:
            raise AssertionError(f"Unhandled boundary condition type: {kind!r}")

    free_p = decoupled_pressure_dofs(spaces, bcs)
    if free_p.size:
        logger.warning("%d pressure DOFs couple only to Dirichlet velocity DOFs (their rows and "
                       "columns vanish after the Dirichlet elimination; pin them with pin_dofs): "
                       "%s", free_p.size, free_p.tolist())
    return bcs


def decoupled_pressure_dofs(spaces: FunctionSpaces, bcs: BoundaryConditions) -> np.ndarray:
    """The pressure DOFs (not already Dirichlet) whose every coupling in the
    mixed pattern is to a Dirichlet velocity DOF: a vertex whose cells have
    all their velocity nodes on no-slip or inflow walls (a corner
    tetrahedron of a distmesh3d mesh).  After the Dirichlet elimination
    their rows and columns of the Stokes operator, of J and of A - sigma M
    are zero: the pressure there is free, as an enclosed flow's constant
    is, and each is pinned (:func:`pin_dofs`) as one pins that constant.
    The mixed pattern couples the DOFs of each cell, so a pressure DOF is
    coupled where one of its cells has a velocity DOF off the mask."""
    nu, n = spaces.num_velocity_dofs, spaces.num_dofs
    mask = np.asarray(bcs.dirichlet_mask, dtype=bool)
    live_cells = ~mask[spaces.velocity.cell_dofs].all(axis=1)
    coupled = np.zeros(n, dtype=bool)
    coupled[nu + spaces.pressure.cell_dofs[live_cells].ravel()] = True
    p = np.arange(nu, n)
    return p[~coupled[p] & ~mask[p]]


def pin_dofs(bcs: BoundaryConditions, dofs, values: float | np.ndarray = 0.0) -> None:
    """Pin extra DOFs as Dirichlet constraints in place: e.g. a single
    pressure DOF of an enclosed flow, whose constant pressure is otherwise
    in the kernel of every operator (parity: ``iPETScMatrix.pin_dof``,
    ``FEM/utils.py:596-602``, done at the BC level so every operator sees
    it)."""
    dofs = np.asarray(dofs).ravel()
    bcs.dirichlet_mask[dofs] = True
    bcs.dirichlet_values[dofs] = values


def _as_vector(value, gdim: int) -> tuple[float, ...]:
    arr = np.atleast_1d(np.asarray(value, dtype=float)).ravel()
    if arr.size == 1:
        arr = np.repeat(arr, gdim)
    if arr.size != gdim:
        raise ValueError(f"Vector value must have length {gdim}, got {arr.size}")
    return tuple(arr)


def _velocity_values(spaces: FunctionSpaces, dofs: np.ndarray, value, gdim: int) -> np.ndarray:
    coords = spaces.velocity.dof_coords[dofs]
    comp = dofs % gdim
    if callable(value):
        full = np.asarray(value(coords))  # (ndofs, gdim) values at each dof coord
        return full[np.arange(dofs.size), comp]
    vec = np.asarray(_as_vector(value, gdim))
    return vec[comp]


def _scalar_values(coords: np.ndarray, value) -> np.ndarray:
    if callable(value):
        return np.asarray(value(coords), dtype=np.float64).ravel()
    return np.full(coords.shape[0], float(value))


# ---------------------------------------------------------------------------
# Periodic constraints (parity: FEM/bcs.py:198-304)
# ---------------------------------------------------------------------------


def compute_periodic_dof_pairs(space, mesh: Mesh, from_marker: int, to_marker: int,
                               tolerance: float = 1e-8) -> tuple[np.ndarray, np.ndarray]:
    """Match the DOFs on the 'to' boundary to the translated 'from' DOFs:
    (to_dofs, from_dofs), blocked DOFs in the space's own layout (the
    caller offsets them into the mixed layout).  Each 'to' node takes the
    nearest translated 'from' node, within ``tolerance``."""
    from_nodes = space.nodes_on_facets(facets_with_marker(mesh, from_marker))
    to_nodes = space.nodes_on_facets(facets_with_marker(mesh, to_marker))
    if from_nodes.size == 0 or to_nodes.size == 0:
        raise ValueError(f"No DOFs found on facets for markers {from_marker} or {to_marker}")
    fc = space.node_coords[from_nodes]
    tc = space.node_coords[to_nodes]
    shifted = fc + (tc.mean(axis=0) - fc.mean(axis=0))
    d2 = ((tc[:, None, :] - shifted[None, :, :]) ** 2).sum(-1)
    nearest = d2.argmin(axis=1)
    dist = np.sqrt(d2[np.arange(to_nodes.size), nearest])
    if (dist > tolerance).any():
        raise ValueError(f"Could not match periodic DOFs: min distance {dist.max():.3g} exceeds "
                         f"tolerance {tolerance}")
    to_n, from_n = to_nodes.astype(np.int64), from_nodes[nearest].astype(np.int64)
    if space.bs == 1:
        return to_n, from_n
    comp = np.arange(space.bs, dtype=np.int64)
    return (to_n[:, None] * space.bs + comp).ravel(), (from_n[:, None] * space.bs + comp).ravel()


def apply_periodic_constraints_matrix(A: CSRMatrix,
                                      pairs: tuple[np.ndarray, np.ndarray]) -> CSRMatrix:
    """Fold the 'to' rows and columns into the 'from' ones and pin the
    'to' DOFs (diagonal 1, in every folded matrix, a mass matrix too):
    the congruence P^T A P with the identification map P, its 'to' rows
    and columns dropped and their diagonal set to 1, on the host (scipy;
    per-problem preprocessing; the reference zeroes them through a LIL
    matrix, element by element).  The result is a CSRMatrix on a pattern
    of its own, on A's device."""
    to_d, from_d = pairs
    n = A.shape[0]
    master = np.arange(n, dtype=np.int64)
    master[to_d] = from_d
    P = sp.csr_matrix((np.ones(n), (np.arange(n), master)), shape=(n, n))
    folded = (P.T @ A.to_scipy() @ P).tocoo()
    is_to = np.zeros(n, dtype=bool)
    is_to[to_d] = True
    keep = ~(is_to[folded.row] | is_to[folded.col])
    rows = np.concatenate([folded.row[keep], to_d])
    cols = np.concatenate([folded.col[keep], to_d])
    vals = np.concatenate([folded.data[keep], np.ones(len(to_d))])
    return CSRMatrix.from_scipy(sp.csr_matrix((vals, (rows, cols)), shape=(n, n)),
                                device=A.device)


def apply_periodic_constraints_vector(b: np.ndarray,
                                      pairs: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Fold the 'to' entries into the 'from' ones and zero the 'to' ones
    (``FEM/bcs.py:291-299``)."""
    to_d, from_d = pairs
    out = np.array(b, copy=True)
    np.add.at(out, from_d, out[to_d])
    out[to_d] = 0.0
    return out
