"""Configuration dataclasses of the cylinder slice: boundary conditions
and the cylinder-in-channel geometry (the TOML loaders of the reference
package are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class BoundaryConditionsConfig:
    """One configured boundary condition (parity: ``config.py:19-33``)."""

    marker: int
    type: str
    value: float | tuple[float, ...] | tuple[int, int] | Callable
    robin_alpha: float | None = None


@dataclass(frozen=True)
class CylinderFlowGeometryConfig:
    """Cylinder-in-channel geometry (parity: ``config.py:89-111``)."""

    dim: int
    cylinder_radius: float
    cylinder_center: tuple[float, ...]
    x_range: tuple[float, float]
    y_range: tuple[float, float]
    resolution: float
    resolution_around_cylinder: float
    influence_radius: float
