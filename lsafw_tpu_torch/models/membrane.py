"""Vibrating-membrane benchmark: the Laplacian Dirichlet eigenproblem.

K v = lambda M v on a rectangle with homogeneous Dirichlet BCs, held to
lambda_mn = pi^2 (m^2/a^2 + n^2/b^2).  Counterpart of the reference's
``models/membrane.py``: (K, M) are assembled on the device from the
port's :class:`~lsafw_tpu_torch.fem.assembly.SpaceContext` and scalar
element kernels.  Its eigenproblem has a real shift, so the port's
shift-invert eigensolve factors one real band and carries the complex
Krylov vectors through it as two real columns.
"""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch.fem.assembly import (
    SpaceContext,
    dirichlet_matrix_data,
    mass_scalar,
    stiffness_scalar,
)
from lsafw_tpu_torch.fem.elements import ElementFamily
from lsafw_tpu_torch.fem.spaces import make_scalar_space
from lsafw_tpu_torch.meshing.mesh import Mesh
from lsafw_tpu_torch.ops.sparse import CSRMatrix


def assemble_membrane_evp(
    mesh: Mesh, family: ElementFamily | str = ElementFamily.P2, *, device="cuda"
) -> tuple[CSRMatrix, CSRMatrix, np.ndarray]:
    """Assemble (K, M, bc_mask) for the membrane EVP on ``device``.

    Dirichlet rows get diag 1 in K and diag 0 in M, so spurious boundary
    modes sit at infinity instead of at lambda = 1."""
    space = make_scalar_space(mesh, family)
    ctx = SpaceContext.build(space, device=device)
    mask = np.zeros(space.num_dofs, dtype=bool)
    mask[space.nodes_on_facets(mesh.boundary_facets)] = True
    mask_t = torch.as_tensor(mask, device=ctx.device)
    K = CSRMatrix(ctx.pattern, dirichlet_matrix_data(
        ctx.pattern, ctx.scatter(stiffness_scalar(ctx)).data, mask_t, 1.0))
    M = CSRMatrix(ctx.pattern, dirichlet_matrix_data(
        ctx.pattern, ctx.scatter(mass_scalar(ctx)).data, mask_t, 0.0))
    return K, M, mask


def analytic_eigenvalues(a: float, b: float, count: int) -> np.ndarray:
    """First ``count`` analytic membrane eigenvalues of the (a, b)
    rectangle, ascending."""
    kmax = int(np.ceil(np.sqrt(count) * 4)) + 4
    m, n = np.meshgrid(np.arange(1, kmax), np.arange(1, kmax), indexing="ij")
    return np.sort((np.pi**2 * (m**2 / a**2 + n**2 / b**2)).ravel())[:count]


def analytic_eigenvalues_3d(a: float, b: float, c: float, count: int) -> np.ndarray:
    """First ``count`` analytic Dirichlet-Laplacian eigenvalues of the
    (a, b, c) box, ascending: pi^2 (l^2/a^2 + m^2/b^2 + n^2/c^2)."""
    kmax = int(np.ceil(count ** (1 / 3) * 4)) + 4
    l, m, n = np.meshgrid(*(np.arange(1, kmax),) * 3, indexing="ij")
    return np.sort((np.pi**2 * (l**2 / a**2 + m**2 / b**2 + n**2 / c**2)).ravel())[:count]
