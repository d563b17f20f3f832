"""Configuration of the cylinder slice: the TOML loaders of the reference
package (``lsafw_tpu/config.py``, copied so that the port imports
nothing of it) and their dataclasses: boundary conditions, the
cylinder-in-channel geometry and facet-tagging rules.  The production
case is built from ``config_files/2D/cylinder/*.toml`` through them."""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np


def read_toml(path: Path | str) -> dict[str, Any]:
    """Read a TOML file (parity: ``config.py:11-16``)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config TOML does not exist: {path}")
    with path.open("rb") as fh:
        return tomllib.load(fh)


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BoundaryConditionsConfig:
    """One configured boundary condition (parity: ``config.py:19-33``)."""

    marker: int
    type: str
    value: float | tuple[float, ...] | tuple[int, int] | Callable
    robin_alpha: float | None = None


_BC_EXPR_NAMES = {
    "pi": np.pi, "e": np.e,
    "sin": np.sin, "cos": np.cos, "tan": np.tan, "tanh": np.tanh,
    "exp": np.exp, "log": np.log, "sqrt": np.sqrt, "abs": np.abs,
    "minimum": np.minimum, "maximum": np.maximum, "where": np.where,
}


def _compile_bc_expr(exprs: list[str], *, scalar: bool):
    """Compile TOML expression strings like ``"4*y*(1 - y)"`` into the
    coordinate callables :func:`lsafw_tpu_torch.fem.bcs.define_bcs` accepts
    (value = "..." for scalars, value = ["...", "..."] per component
    for vectors).  Evaluation uses a restricted numpy namespace with
    ``x``/``y``/``z`` bound to node coordinates — the counterpart of
    passing a Python callable in code (``FEM/bcs.py`` interpolated
    Dirichlet values)."""
    codes = [compile(e, f"<bc expr {e!r}>", "eval") for e in exprs]

    def fn(coords: np.ndarray) -> np.ndarray:
        env = dict(_BC_EXPR_NAMES)
        env["x"] = coords[:, 0]
        if coords.shape[1] > 1:
            env["y"] = coords[:, 1]
        if coords.shape[1] > 2:
            env["z"] = coords[:, 2]
        cols = [
            np.broadcast_to(
                np.asarray(eval(c, {"__builtins__": {}}, env), dtype=np.float64),
                (coords.shape[0],),
            )
            for c in codes
        ]
        if scalar:
            return cols[0]
        return np.stack(cols, axis=1)

    return fn


def load_bc_config(path: Path | str) -> Sequence[BoundaryConditionsConfig]:
    """Load ``[[BC]]`` tables (parity: ``config.py:36-86``)."""
    cfg = read_toml(path)
    out: list[BoundaryConditionsConfig] = []
    for bc in cfg.get("BC", []):
        raw = bc.get("value", 0.0)
        kind = str(bc.get("type", "")).lower().strip()
        value: Any
        if kind == "periodic":
            if not (
                isinstance(raw, list)
                and len(raw) == 2
                and all(isinstance(v, int) for v in raw)
            ):
                raise TypeError("A periodic BC needs a pair of integer facet markers as its value.")
            value = (raw[0], raw[1])
        elif isinstance(raw, str):
            value = _compile_bc_expr([raw], scalar=True)
        elif isinstance(raw, list) and any(isinstance(v, str) for v in raw):
            value = _compile_bc_expr([str(v) for v in raw], scalar=False)
        elif isinstance(raw, list):
            value = tuple(float(v) for v in raw)
        elif isinstance(raw, (int, float)):
            value = float(raw)
        else:
            raise TypeError(f"Unsupported value type: {type(raw)}")
        out.append(
            BoundaryConditionsConfig(
                marker=int(bc["marker"]),
                type=kind,
                value=value,
                robin_alpha=bc.get("robin_alpha"),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


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
    z_range: tuple[float, float] | None = None


def load_cylinder_flow_config(path: Path | str) -> CylinderFlowGeometryConfig:
    raw = read_toml(path)
    for key in ("cylinder_center", "x_range", "y_range", "z_range"):
        if key in raw:
            raw[key] = tuple(raw[key])
    return CylinderFlowGeometryConfig(**raw)


# ---------------------------------------------------------------------------
# Facet tagging rules
# ---------------------------------------------------------------------------

_AXIS = {"x": 0, "y": 1, "z": 2}


@dataclass(frozen=True)
class FacetCondition:
    """Single-axis condition (parity: ``config.py:152-163``)."""

    axis: str
    equals: float | None = None
    less_than: float | None = None
    greater_than: float | None = None


@dataclass(frozen=True)
class FacetRule:
    """Tagging rule (parity: ``config.py:166-175``)."""

    marker: int
    when: FacetCondition | None = None
    otherwise: bool = False


def compile_facet_rules(rules: Sequence[FacetRule]) -> Callable[[np.ndarray], np.ndarray]:
    """Compile ordered rules into a vectorized marker function.

    Rules are evaluated in order; the first match wins (parity with the
    sequential evaluation in ``config.py:231-237``).  Points matching no
    rule raise unless an ``otherwise`` rule exists.
    """

    def marker_fn(x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(x)
        markers = np.zeros(x.shape[0], dtype=np.int32)
        assigned = np.zeros(x.shape[0], dtype=bool)
        for rule in rules:
            if rule.otherwise:
                hit = np.ones(x.shape[0], dtype=bool)
            else:
                cond = rule.when
                assert cond is not None
                coord = x[:, _AXIS[cond.axis]]
                hit = np.zeros(x.shape[0], dtype=bool)
                if cond.equals is not None:
                    hit |= np.isclose(coord, cond.equals)
                if cond.less_than is not None:
                    hit |= coord < cond.less_than
                if cond.greater_than is not None:
                    hit |= coord > cond.greater_than
            new = hit & ~assigned
            markers[new] = rule.marker
            assigned |= hit
        if not assigned.all():
            raise RuntimeError("Facet matched no rule and the config defines no 'otherwise' marker.")
        return markers

    return marker_fn


def load_facet_config(path: Path | str) -> Callable[[np.ndarray], np.ndarray]:
    """Load ``[[FaceTag]]`` rules into a marker function
    (parity: ``config.py:178-237``)."""
    cfg = read_toml(path)
    rules: list[FacetRule] = []
    for raw in cfg.get("FaceTag", []):
        when = None
        if "when" in raw:
            w = raw["when"]
            when = FacetCondition(
                axis=w["axis"],
                equals=w.get("equals"),
                less_than=w.get("less_than"),
                greater_than=w.get("greater_than"),
            )
        rules.append(
            FacetRule(
                marker=int(raw["marker"]),
                when=when,
                otherwise=bool(raw.get("otherwise", False)),
            )
        )
    return compile_facet_rules(rules)
