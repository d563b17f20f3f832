"""Boundary conditions on the mixed velocity-pressure space.

Dirichlet velocity/pressure (strong, as masked DOFs + values),
Neumann velocity/pressure and Robin (weak, consumed by the
facet-integral kernels) and Symmetry (component pinning).  Periodic
conditions of the reference package are not ported.

Strong conditions are a boolean mask + value vector over the mixed
DOF layout; application to operators is the pure-data transform
:func:`lsafw_tpu_torch.fem.assembly.dirichlet_matrix_data`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Sequence

import numpy as np

from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker


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
    outlet_markers: list[int] = field(default_factory=list)

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
        if kind is BoundaryConditionType.PERIODIC:
            raise NotImplementedError("periodic boundary conditions are not ported")
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

        else:
            raise AssertionError(f"Unhandled boundary condition type: {kind!r}")

    return bcs


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
