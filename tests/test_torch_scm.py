"""Parity of the port's self-consistent model, harmonic balance and
Hill's method (``scm.py``, ``hill.py``) with the JAX package.

The small case is the tiny cylinder of ``tests/unit/test_scm_coupled.py``
(453 Taylor-Hood DOFs), built by both packages from the same TOML-free
configuration.  Its baseflow's leading pair crosses the axis near
Re = 165.5 (sigma = -0.0007+0.9132j at 165, +0.0066+0.9198j at 170; the
mesh is too coarse for a steady Newton past about 175), so the slice runs
at RE = 170, on the JAX package's host-LU baseflow, which both packages
start from.

Compared on the same seeded states (rel 1e-12, f64 in another summation
order): ``convective_linearization_data``, ``unit_load``, the HB1 and HB2
residuals and bordered Jacobians (the port's (K0, c, r) on its block
pattern against the reference's ``sp.bmat``).  The port's banded
bordered solve (its real band factor preconditioning GCR on the full
system, the kernels' plain versions) against the host ``splu``: rel
1e-7 and full-system residual 1e-9, as
``test_device_bordered_solve_matches_splu``.  ``hill_floquet`` (the real
Hill pair on the banded shift-invert) against the JAX package's (scipy
``eigs`` on the complex pair) on test_hill.py's periodic base (the
Re = 40 baseflow, 0.6 times its unit mode near 0.6j, omega = 0.9) with a
seeded second harmonic, so that every block of the Hill matrix is
exercised: four exponents within 1e-8.  The slice: ``solve`` (from A0 =
0.6, tol_sigma 5e-3, one sweep an amplitude: one outer iteration) then
``solve_coupled`` with harmonics 1 and 2 in both packages; the coupled
roots' A and omega within 1e-6.  Band plans are unpadded (``chunk=1``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu import config as jconfig
from lsafw_tpu.fem.assembly import AssemblyContext as JContext
from lsafw_tpu.fem.bcs import define_bcs as jdefine_bcs
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.hill import hill_floquet as jhill_floquet
from lsafw_tpu.meshing.geometries import cylinder_flow_mesh as jcylinder
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.models.navier_stokes import convective_linearization_data as jconv
from lsafw_tpu.scm import SelfConsistentModel as JModel
from lsafw_tpu.solver.baseflow import BaseFlowSolver as JBaseFlow
from lsafw_tpu_torch import config as tconfig
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import define_bcs
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.hill import hill_floquet
from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.models.navier_stokes import (
    LinearizedNavierStokesAssembler,
    convective_linearization_data,
)
from lsafw_tpu_torch.scm import SelfConsistentModel
from lsafw_tpu_torch.solver import band as tband
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REL = 1e-12
RE = 170.0  # the tiny cylinder's baseflow is unstable past Re = 165.5
INLET, OUTLET, BOTTOM, TOP, CYL = 1, 2, 3, 4, 5


@pytest.fixture(scope="module", autouse=True)
def small_plans():
    """Band plans of the small systems unpadded (chunk 1)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
    yield
    mp.undo()


def _tiny(cfg, mesh_fn, mark, spaces_fn, bcs_fn, ctx_fn):
    """tests/unit/test_scm_coupled.py's tiny cylinder through one package."""
    C = cfg.BoundaryConditionsConfig
    geo = cfg.CylinderFlowGeometryConfig(
        dim=2, cylinder_radius=0.5, cylinder_center=(0.0, 0.0), x_range=(-3.0, 6.0),
        y_range=(-3.0, 3.0), resolution=1.1, resolution_around_cylinder=0.45,
        influence_radius=1.8)
    mesh = mesh_fn(geo, max_iter=60)

    def marker(x):
        out = np.full(x.shape[0], -1)
        out[np.isclose(x[:, 0], geo.x_range[0])] = INLET
        out[np.isclose(x[:, 0], geo.x_range[1])] = OUTLET
        out[np.isclose(x[:, 1], geo.y_range[0])] = BOTTOM
        out[np.isclose(x[:, 1], geo.y_range[1])] = TOP
        out[np.hypot(x[:, 0], x[:, 1]) < geo.cylinder_radius * 1.5] = CYL
        return out

    mark(mesh, marker)
    spaces = spaces_fn(mesh)
    bcs = bcs_fn(mesh, spaces, [C(marker=m, type="dirichlet_velocity", value=v) for m, v in (
        (INLET, (1.0, 0.0)), (BOTTOM, (1.0, 0.0)), (TOP, (1.0, 0.0)), (CYL, (0.0, 0.0)))])
    bcs_pert = bcs_fn(mesh, spaces, [
        C(marker=m, type="dirichlet_velocity", value=(0.0, 0.0)) for m in (INLET, BOTTOM, TOP, CYL)
    ] + [C(marker=OUTLET, type="dirichlet_pressure", value=0.0)])
    return mesh, spaces, bcs, bcs_pert, ctx_fn(spaces)


@pytest.fixture(scope="module")
def models():
    """Both packages' model at RE on the tiny cylinder, the JAX package's
    host-LU baseflow there, and a seeded state obeying the masks."""
    jm, _, jb, jbp, jctx = _tiny(jconfig, jcylinder, jmark, jdefine_spaces, jdefine_bcs,
                                 JContext.build)
    tm, tsp, tb, tbp, tctx = _tiny(tconfig, cylinder_flow_mesh, mark_boundary_facets,
                                   define_spaces, define_bcs,
                                   lambda s: AssemblyContext.build(s, device="cpu"))
    assert np.array_equal(tm.cells, jm.cells)
    jmodel = JModel(jctx, jm, jb, jbp, RE, linear_solver="lu")
    tmodel = SelfConsistentModel(tctx, tm, tb, tbp, RE, device="cpu")
    w = np.asarray(JBaseFlow(jctx, jm, jb, re=RE).solve(ramp=True, steps=4, tol=1e-10,
                                                        max_it=40))
    n = tsp.num_dofs
    rng = np.random.default_rng(7)
    mask_m = np.asarray(jb.dirichlet_mask, bool)
    mask_p = np.asarray(jbp.dirichlet_mask, bool)
    U = np.where(mask_m, np.asarray(jb.dirichlet_values), 0.3 * rng.standard_normal(n))
    q1 = np.where(mask_p, 0.0, rng.standard_normal(n) + 1j * rng.standard_normal(n))
    q2 = np.where(mask_p, 0.0, rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return dict(j=jmodel, t=tmodel, w=w, U=U, q1=q1, q2=q2, mask_m=mask_m, mask_p=mask_p,
                jctx=jctx, tctx=tctx, jm=jm, tm=tm, jb=jb, tb=tb)


def _rel(got, ref) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _bordered(K0, c, r) -> sp.csc_matrix:
    """The full bordered matrix of the port's (K0, c, r)."""
    return sp.bmat([[K0.to_scipy(), sp.csr_matrix(c.numpy()[:, None])],
                    [sp.csr_matrix(r.numpy()[None, :]), None]], format="csc")


def test_convective_linearization_and_unit_load_match_jax(models):
    q = models["q1"]
    for part in (q.real, q.imag):
        assert _rel(convective_linearization_data(models["tctx"], torch.as_tensor(part)),
                    jconv(models["jctx"], jnp.asarray(part))) <= REL
    assert _rel(models["t"].unit_load(q), models["j"].unit_load(q)) <= REL


@pytest.mark.parametrize("order", [1, 2])
def test_coupled_residual_and_matrix_match_jax(models, order):
    """HB1's (U, q_r, q_i, omega) and HB2's (U, q1, q2, omega) residuals and
    bordered Jacobians on one seeded state (tests/unit/test_scm_coupled.py's
    masking convention)."""
    jm, tm = models["j"], models["t"]
    U, q1, q2 = models["U"], models["q1"], models["q2"]
    mask_m, mask_p = models["mask_m"], models["mask_p"]
    om = 0.73
    avec, bvec = jm._Ms.T @ q1.real, jm._Ms.T @ q1.imag
    jA = jm._linearized_scipy(U)
    tA = LinearizedNavierStokesAssembler(U, models["tctx"], RE, tm.bcs_pert,
                                         models["tm"]).assemble_linear_operator()
    zm, zp = sp.diags(np.where(mask_m, 0.0, 1.0)), sp.diags(np.where(mask_p, 0.0, 1.0))
    if order == 1:
        ref_F = jm._coupled_residual(U, q1.real, q1.imag, om, jA, avec, bvec, mask_m, mask_p)
        ref_K = jm._coupled_matrix(U, q1.real, q1.imag, om, jA, avec, bvec, zm, zp)
        got_F = tm._coupled_residual(U, q1.real, q1.imag, om, tA, avec, bvec, mask_m, mask_p)
        got_K = tm._coupled_matrix(U, q1.real, q1.imag, om, tA, avec, bvec, mask_m, mask_p)
    else:
        ref_F = jm._hb2_residual(U, q1, q2, om, jA, avec, bvec, mask_m, mask_p)
        ref_K = jm._hb2_matrix(U, q1, q2, om, jA, avec, bvec, zm, zp)
        got_F = tm._hb2_residual(U, q1, q2, om, tA, avec, bvec, mask_m, mask_p)
        got_K = tm._hb2_matrix(U, q1, q2, om, tA, avec, bvec, mask_m, mask_p)
    assert _rel(got_F, ref_F) <= REL
    K = _bordered(*got_K)
    assert K.shape == ref_K.shape == ((2 * order + 1) * len(U) + 1,) * 2
    assert abs(K - ref_K).max() <= REL * abs(ref_K).max()


def test_bordered_solve_matches_splu(models):
    """The banded bordered solve against the host splu of the same system
    (tests/unit/test_scm_coupled.py's device check)."""
    tm = models["t"]
    U, q1 = models["U"], models["q1"]
    avec = tm._Ms.T @ q1.real
    bvec = tm._Ms.T @ q1.imag
    tA = tm._linearized(U)
    K0, c, r = tm._coupled_matrix(U, q1.real, q1.imag, 0.73, tA, avec, bvec, models["mask_m"],
                                  models["mask_p"])
    F = np.random.default_rng(3).standard_normal(3 * len(U) + 1)
    its = len(tm.stats["gcr_its"])
    dz = tm._bordered_solve(K0, c, r, torch.as_tensor(F)).numpy()
    K = _bordered(K0, c, r)
    ref = spla.splu(K).solve(F)
    assert np.linalg.norm(dz - ref) <= 1e-7 * np.linalg.norm(ref)
    assert np.linalg.norm(K @ dz - F) <= 1e-9 * np.linalg.norm(F)
    assert len(tm.stats["gcr_its"]) == its + 1


def test_hill_matches_jax(models):
    """test_hill.py's periodic base with a seeded second harmonic: the
    port's real Hill pair on the banded shift-invert against the JAX
    package's host eigs.  The base's mode comes from the port's banded
    eigensolve (an input here, carried to both packages)."""
    U = np.asarray(JBaseFlow(models["jctx"], models["jm"], models["jb"], re=40.0).solve(
        ramp=False, tol=1e-10, max_it=30))
    tmod = models["t"]
    tmod.re = 40.0
    try:
        sigma, mode = tmod._eig_about(U, 0.0 + 0.6j)
    finally:
        tmod.re = RE
    q1 = 0.6 * tmod._normalize(mode)
    q2 = 0.2 * models["q2"]
    mask = models["mask_m"]
    JA, JM = (m.to_scipy() for m in JLinearized(jnp.asarray(U), models["jctx"], 40.0,
                                                models["jb"], models["jm"]).assemble_eigensystem())
    A, M = LinearizedNavierStokesAssembler(U, models["tctx"], 40.0, models["tb"],
                                           models["tm"]).assemble_eigensystem()
    kw = dict(n_blocks=1, num=4, bc_mask=mask)
    ref = jhill_floquet(models["jctx"], JA, JM, [q1, q2], 0.9, **kw)
    got = hill_floquet(models["tctx"], A, M, [q1, q2], 0.9, device="cpu", **kw)
    assert len(got.raw) == len(ref.raw) == 4
    assert max(np.abs(ref.raw - z).min() for z in got.raw) <= 1e-8
    assert max(np.abs(ref.exponents - z).min() for z in got.exponents) <= 1e-8
    assert np.abs(np.sort(got.centroids) - np.sort(ref.centroids)).max() <= 1e-6


def test_scm_slice_matches_jax(models):
    """``solve`` then ``solve_coupled`` (HB1, then HB2 from HB1) in both
    packages from the JAX baseflow at RE; the coupled roots agree."""
    out = {}
    for name in ("j", "t"):
        model = models[name]
        alt = model.solve(models["w"], A0=0.6, tol_sigma=5e-3, inner=1)
        assert alt.converged and len(alt.history) == 2 and alt.history[0][1] > 5e-3
        hb1 = model.solve_coupled(alt.mean, alt.amplitude * alt.mode, abs(alt.sigma.imag))
        hb2 = model.solve_coupled(hb1.mean, hb1.amplitude * hb1.mode, hb1.sigma.imag,
                                  harmonics=2)
        assert hb1.converged and hb2.converged
        out[name] = (alt, hb1, hb2)
    (jalt, jhb1, jhb2), (talt, thb1, thb2) = out["j"], out["t"]
    assert abs(talt.history[0][1] - jalt.history[0][1]) <= 1e-8
    for ref, got in ((jhb1, thb1), (jhb2, thb2)):
        assert abs(got.amplitude - ref.amplitude) <= 1e-6 * ref.amplitude
        assert abs(got.sigma.imag - ref.sigma.imag) <= 1e-6 * ref.sigma.imag
    assert np.abs(thb2.q2 - jhb2.q2).max() <= 1e-6 * np.abs(jhb2.q2).max()
    assert models["t"].stats["bordered"] >= 2
