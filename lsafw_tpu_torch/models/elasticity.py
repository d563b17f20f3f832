"""Linear elasticity eigenproblem: K v = lambda M v.

Counterpart of the reference's second physics domain
(``Elasticity/operators.py``, ``Elasticity/bcs.py``,
``Elasticity/spaces.py``, ``Elasticity/utils.py``): isotropic
small-strain elasticity in Lame form with DG-0 (per-cell) material
fields, component-wise Dirichlet constraints, modal post-processing and
eigenvalue sensitivities to material parameters.

Element matrices (blocked DOFs (i, d)):
  K[(i,d),(j,e)] = mu [delta_de <grad phi_i, grad phi_j>
                       + <d phi_i/dx_e, d phi_j/dx_d>]
                   + lam <d phi_i/dx_d, d phi_j/dx_e>
  M[(i,d),(j,e)] = rho delta_de <phi_i, phi_j>
assembled on the device from the reference tensors of a
:class:`~lsafw_tpu_torch.fem.assembly.SpaceContext` (simplices), or
pointwise from its per-quadrature-point geometry (quads, hexes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from lsafw_tpu_torch.fem.assembly import (
    SpaceContext,
    dirichlet_matrix_data,
    mass_scalar,
    stiffness_scalar,
)
from lsafw_tpu_torch.fem.spaces import FunctionSpace, make_vector_space
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv


def define_space(mesh: Mesh, degree: int = 1) -> FunctionSpace:
    """Vector H1 Lagrange displacement space on simplices (parity:
    ``Elasticity/spaces.py:11``); on quads and hexes build it with
    ``make_vector_space(mesh, "q1")``."""
    return make_vector_space(mesh, {1: "p1", 2: "p2"}[degree])


# ---------------------------------------------------------------------------
# Boundary conditions (parity: Elasticity/bcs.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComponentDirichlet:
    """Dirichlet on selected displacement components
    (parity: ``Elasticity/bcs.py:24``)."""

    tags: Iterable[int]
    components: Sequence[int]
    value: float | Sequence[float] | Callable = 0.0


@dataclass(frozen=True)
class AxisNormalBc:
    """Axis-aligned normal-displacement constraint
    (parity: ``Elasticity/bcs.py:33``)."""

    tags: Iterable[int]
    axis: int
    value: float = 0.0


@dataclass
class BoundaryConditions:
    """(parity: ``Elasticity/bcs.py:15``)."""

    dirichlet_mask: np.ndarray
    dirichlet_values: np.ndarray


def define_bcs(
    mesh: Mesh,
    space: FunctionSpace,
    *,
    component: Iterable[ComponentDirichlet] = (),
    axis_normal: Iterable[AxisNormalBc] = (),
) -> BoundaryConditions:
    """(parity: ``Elasticity/bcs.py:106``)."""
    if mesh.facet_tags is None:
        raise ValueError("Mesh boundaries are not properly tagged.")
    mask = np.zeros(space.num_dofs, dtype=bool)
    values = np.zeros(space.num_dofs, dtype=np.float64)
    specs = list(component) + [
        ComponentDirichlet(tags=s.tags, components=(s.axis,), value=s.value) for s in axis_normal
    ]
    for spec in specs:
        for tag in spec.tags:
            facets = facets_with_marker(mesh, tag)
            for c in spec.components:
                dofs = space.dofs_on_facets(facets, component=c)
                mask[dofs] = True
                if callable(spec.value):
                    values[dofs] = np.asarray(spec.value(space.dof_coords[dofs])).ravel()
                else:
                    v = np.atleast_1d(spec.value).astype(float)
                    values[dofs] = v[c] if v.size > c else v[0]
    return BoundaryConditions(dirichlet_mask=mask, dirichlet_values=values)


# ---------------------------------------------------------------------------
# Material properties (parity: Elasticity/operators.py:67-121)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MaterialProperties:
    """DG-0 (per-cell) material fields, host arrays."""

    mu: np.ndarray
    lam: np.ndarray
    rho: np.ndarray
    young_modulus: np.ndarray
    poisson_ratio: np.ndarray

    @classmethod
    def from_basic_properties(cls, mesh: Mesh, young_modulus, poisson_ratio,
                              density) -> "MaterialProperties":
        nc = mesh.num_cells
        E = np.broadcast_to(np.asarray(young_modulus, dtype=float), (nc,)).copy()
        nu = np.broadcast_to(np.asarray(poisson_ratio, dtype=float), (nc,)).copy()
        rho = np.broadcast_to(np.asarray(density, dtype=float), (nc,)).copy()
        mu = E / (2.0 * (1.0 + nu))
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return cls(mu=mu, lam=lam, rho=rho, young_modulus=E, poisson_ratio=nu)


# ---------------------------------------------------------------------------
# Element matrices and the assembler (parity: Elasticity/operators.py:124)
# ---------------------------------------------------------------------------


def _grad_grad_tensor(ctx: SpaceContext) -> torch.Tensor:
    """D[c,i,d,j,e] = integral d phi_i/dx_d * d phi_j/dx_e."""
    if not ctx.is_affine:  # quads, hexes: per-point geometry
        g = ctx.phys_grad_u()  # (nc, nq, i, d)
        return torch.einsum("q,cq,cqid,cqje->cidje", ctx.w, ctx.detJ, g, g)
    return torch.einsum("tsij,ctd,cse,c->cidje", ctx.K0, ctx.Jinv, ctx.Jinv, ctx.detJ)


def elasticity_stiffness_elements(ctx: SpaceContext, mu: torch.Tensor,
                                  lam: torch.Tensor) -> torch.Tensor:
    """(nc, n_el g, n_el g) element stiffness matrices of the per-cell
    Lame fields ``mu``, ``lam``."""
    g = ctx.gdim
    S = stiffness_scalar(ctx)  # (nc, i, j)
    D = _grad_grad_tensor(ctx)  # (nc, i, d, j, e)
    eye = torch.eye(g, dtype=S.dtype, device=S.device)
    K = (torch.einsum("c,cij,de->cidje", mu, S, eye)
         + torch.einsum("c,ciejd->cidje", mu, D)  # the (i, e), (j, d) pairing
         + lam[:, None, None, None, None] * D)
    nc, n_el = S.shape[0], S.shape[1]
    return K.reshape(nc, n_el * g, n_el * g)


def elasticity_mass_elements(ctx: SpaceContext, rho: torch.Tensor) -> torch.Tensor:
    """(nc, n_el g, n_el g) element mass matrices of the per-cell density."""
    g = ctx.gdim
    Ms = mass_scalar(ctx)
    eye = torch.eye(g, dtype=Ms.dtype, device=Ms.device)
    nc, n_el = Ms.shape[0], Ms.shape[1]
    return torch.einsum("c,cij,de->cidje", rho, Ms, eye).reshape(nc, n_el * g, n_el * g)


class ElasticityEigenAssembler:
    """(K, M) of the elasticity eigenproblem on ``device`` (parity:
    ``ElasticityEigenAssembler``, ``Elasticity/operators.py:124-302``).
    The Dirichlet rows carry 1 in K and 0 in M, so the constrained DOFs
    sit at infinite frequency."""

    def __init__(self, space: FunctionSpace, *, young_modulus: float, poisson_ratio: float,
                 density: float, bcs: BoundaryConditions | None = None, device="cuda") -> None:
        self.space = space
        self.ctx = SpaceContext.build(space, quad_degree=2 * space.element.degree, device=device)
        self.material_properties = MaterialProperties.from_basic_properties(
            space.mesh, young_modulus, poisson_ratio, density)
        self.bcs = bcs
        self._cache: dict[str, CSRMatrix] = {}
        mask = (np.zeros(space.num_dofs, dtype=bool) if bcs is None
                else np.asarray(bcs.dirichlet_mask, dtype=bool))
        self._mask = torch.as_tensor(mask, device=self.ctx.device)

    def _field(self, a) -> torch.Tensor:
        """A per-cell field (or a scalar) as an f64 (nc,) tensor on the device."""
        t = torch.as_tensor(a, dtype=torch.float64, device=self.ctx.device)
        return t.expand(self.space.mesh.num_cells).contiguous() if t.ndim == 0 else t

    def _bc(self, X: CSRMatrix, diag: float) -> CSRMatrix:
        return CSRMatrix(self.ctx.pattern, dirichlet_matrix_data(self.ctx.pattern, X.data,
                                                                 self._mask, diag))

    def assemble_stiffness(self, *, mu=None, lam=None, apply_bcs: bool = True) -> CSRMatrix:
        """(parity: ``assemble_stiffness``, ``Elasticity/operators.py:229``)."""
        key = "k" if (mu is None and lam is None and apply_bcs) else None
        if key and key in self._cache:
            return self._cache[key]
        mp = self.material_properties
        K = self.ctx.scatter(elasticity_stiffness_elements(
            self.ctx, self._field(mp.mu if mu is None else mu),
            self._field(mp.lam if lam is None else lam)))
        if apply_bcs:
            K = self._bc(K, 1.0)
        if key:
            self._cache[key] = K
        return K

    def assemble_mass(self, *, rho=None, apply_bcs: bool = True) -> CSRMatrix:
        """(parity: ``assemble_mass``, ``Elasticity/operators.py:252``)."""
        key = "m" if (rho is None and apply_bcs) else None
        if key and key in self._cache:
            return self._cache[key]
        rho_t = self._field(self.material_properties.rho if rho is None else rho)
        M = self.ctx.scatter(elasticity_mass_elements(self.ctx, rho_t))
        if apply_bcs:
            M = self._bc(M, 0.0)
        if key:
            self._cache[key] = M
        return M

    def assemble_eigensystem(self) -> tuple[CSRMatrix, CSRMatrix]:
        """(M, K), the reference's order (``Elasticity/operators.py:273-275``)."""
        return self.assemble_mass(), self.assemble_stiffness()

    def compute_sensitivity(self, eigenfunction, eigenvalue: float, param: str = "rho",
                            dparam: np.ndarray | float = 1.0) -> float:
        """d lambda = v^T (dK/dp - lambda dM/dp) v in the direction
        ``dparam`` (parity: ``compute_sensitivity``,
        ``Elasticity/operators.py:277-302``): K is linear in (mu, lam) and
        M in rho, so the derivative forms are assembled directly.
        ``eigenfunction`` is a host or device vector."""
        v = _real_vector(eigenfunction, self.ctx.device)
        dp = self._field(dparam)
        if param == "rho":
            dM = self._bc(self.assemble_mass(rho=dp, apply_bcs=False), 0.0)
            return float(-eigenvalue * torch.dot(v, spmv(dM, v)))
        if param in ("e", "young_modulus"):
            nu = self._field(self.material_properties.poisson_ratio)
            dmu = dp / (2.0 * (1.0 + nu))  # mu and lam are linear in E at fixed nu
            dlam = dp * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
            dK = self._bc(self.assemble_stiffness(mu=dmu, lam=dlam, apply_bcs=False), 0.0)
            return float(torch.dot(v, spmv(dK, v)))
        raise ValueError(f"Unsupported parameter {param!r}")


def _real_vector(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    return (t.real if t.is_complex() else t).to(torch.float64)


# ---------------------------------------------------------------------------
# Post-processing (parity: Elasticity/utils.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Eigenmode:
    """(parity: ``Eigenmode``, ``Elasticity/utils.py:45``)."""

    value: complex
    function: np.ndarray  # mass-normalized real displacement vector (host)
    wn: float
    fn: float
    eta_r: float
    rq_omega2: float
    mass_chk: bool


def process_modes(eigenpairs, stiffness: CSRMatrix, mass: CSRMatrix, *,
                  skip_below_hz: float = 0.1) -> list[Eigenmode]:
    """Mass-normalize, compute natural frequencies, drop modes below
    ``skip_below_hz``, sort ascending (parity: ``process_modes``,
    ``Elasticity/utils.py:65-120``).  The products run on the matrices'
    device; eigenvectors may be host or device vectors."""
    dev = stiffness.device
    out: list[Eigenmode] = []
    for eigval, eigvec in eigenpairs:
        v = _real_vector(eigvec, dev)
        vMv = float(torch.dot(v, spmv(mass, v)))
        v = v * (1.0 / math.sqrt(vMv) if vMv > 0 else 1.0)
        vMv_n = float(torch.dot(v, spmv(mass, v)))
        vKv = float(torch.dot(v, spmv(stiffness, v)))
        lam = complex(eigval)
        wn = math.sqrt(abs(lam.real)) if lam.real > 0 else 0.0
        fn = wn / (2 * math.pi)
        if fn < skip_below_hz:
            continue
        out.append(Eigenmode(value=lam, function=v.cpu().numpy(), wn=wn, fn=fn,
                             eta_r=lam.imag / (wn**2) if wn > 0 else 0.0, rq_omega2=vKv,
                             mass_chk=bool(np.isclose(vMv_n, 1.0))))
    out.sort(key=lambda m: m.fn)
    return out


def process_sensitivity(sensitivity: float, natural_frequency: float) -> float:
    """d lambda -> d f_n in Hz (parity: ``Elasticity/utils.py:123``)."""
    return sensitivity / (8 * math.pi**2 * natural_frequency)


def compute_density_sensitivity_analytical(eigenvalue: float, *, v=None, M1=None) -> float:
    """For a uniform density perturbation and mass-normalized v:
    d lambda/d rho = -lambda v^T M_(rho=1) v = -lambda/rho
    (parity: ``Elasticity/utils.py:128``)."""
    if v is not None and M1 is not None:
        v = _real_vector(v, M1.device)
        return float(-eigenvalue * torch.dot(v, spmv(M1, v)))
    raise ValueError("Provide v and the unit-density mass matrix M1.")


def compute_density_sensitivity_fd(make_eigenvalue: Callable[[float], float], rho0: float,
                                   step: float = 10.0) -> float:
    """Central finite difference of lambda(rho) (parity:
    ``Elasticity/utils.py:158``)."""
    return (make_eigenvalue(rho0 + step) - make_eigenvalue(rho0 - step)) / (2 * step)
