"""Parity of the port's 3D and step-flow half of the mesh, FEM and
Navier-Stokes layers with the JAX package.

Host generators (structured boxes, distmesh3d, the step and the 3D
cylinder) are the same numpy code on both sides, so one seed gives the
same points (1e-12) and cells (exact).  The device layers are held on
small cases built from numpy seeds: 3D facet contexts and their loads on
a 2x2x2 box whose x = 1 face is a pressure outlet, and the lid-driven
cube of ``tests/benchmark/test_cavity3d.py`` on ``box_mesh(3, 3, 3)``
(1,093 DOFs) at Re = 100, one pressure DOF pinned (the enclosed flow's
constant pressure is otherwise in the kernel of J and of A - sigma M;
unpinned, the banded refinement needs about 60 GCR iterations a solve
there, against one).  The port runs its banded path on the kernels'
plain versions, the JAX package its host LU.  Tolerances: assembled
data and facet quantities rel 1e-12 (f64 in another summation order);
baseflows 1e-10; eigenvalues 1e-8; ``tests/benchmark/test_nonmodal3d.py``'s
resolvent and transient gains against the dense answers rel 1e-6 (the
JAX package's 3D transient gate fails, so the dense answer is the
reference).  The 3D step from ``config_files/3D/step`` at resolution 0.3
(1,835 DOFs): its three pressure DOFs coupled to Dirichlet DOFs alone
(``decoupled_pressure_dofs``; ``define_bcs`` names them and leaves its
values as the JAX package's), and its pivot-free real factor at sigma = 0
refused once its refinement misses.  Band plans are unpadded
(``chunk=1``).
"""

import dataclasses
import logging
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp
from lsafw_tpu import config as jconfig
from lsafw_tpu.config import BoundaryConditionsConfig as JBC
from lsafw_tpu.fem import facets as jfacets
from lsafw_tpu.fem.assembly import AssemblyContext as JContext
from lsafw_tpu.fem.bcs import define_bcs as jdefine_bcs, pin_dofs as jpin_dofs
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.meshing import geometries as jgeo
from lsafw_tpu.meshing import mesh as jmesh
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.models import membrane as jmembrane
from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.solver import baseflow as jbaseflow
from lsafw_tpu.solver.eigen import EigenSolver as JEigenSolver
from lsafw_tpu.solver.eigen import EigensolverConfig as JConfig
from lsafw_tpu.solver.eigen import STType as JSTType
from lsafw_tpu_torch import config as tconfig
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem import facets as tfacets
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import decoupled_pressure_dofs, define_bcs, pin_dofs
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.meshing import geometries as tgeo
from lsafw_tpu_torch.meshing import mesh as tmesh
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.models import membrane
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.resolvent import ResolventSolver
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import baseflow as tbaseflow
from lsafw_tpu_torch.solver.eigen import (
    EigenSolver,
    EigensolverConfig,
    FactorUnusable,
    ShiftInvertOperator,
    STType,
    eigen_residuals,
)
from lsafw_tpu_torch.solver.timestepping import UnsteadySolver
from lsafw_tpu_torch.transient import TransientGrowthSolver
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REL = 1e-12
RE = 100.0
LID, WALL = 1, 2
TARGET = -0.2 + 0.3j
CONFIGS = Path(__file__).resolve().parents[1] / "config_files"


@pytest.fixture(scope="module", autouse=True)
def small_plans():
    """Band plans of the small systems unpadded (chunk 1)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
    yield
    mp.undo()


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_mesh(m, j) -> None:
    assert m.cell_type.value == j.cell_type.value
    assert np.abs(m.vertices - j.vertices).max() <= 1e-12
    assert np.array_equal(m.cells, j.cells)


# ---------------------------------------------------------------------------
# Host meshes and configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["box_tet", "box_hex", "unit_cube", "unit_interval",
                                  "generate_box", "generate_cube", "generate_interval"])
def test_structured_meshes_match_jax(case):
    make = {
        "box_tet": lambda m: m.box_mesh((0.0, -1.0, 0.5), (2.0, 1.0, 1.5), 2, 3, 2),
        "box_hex": lambda m: m.box_mesh((0, 0, 0), (1, 2, 3), 2, 2, 3,
                                        m.CellType.HEXAHEDRON),
        "unit_cube": lambda m: m.unit_cube(3, 2, 4),
        "unit_interval": lambda m: m.unit_interval(7),
        "generate_box": lambda m: m.generate_mesh(m.Shape.BOX, p0=(0, 0, 0), p1=(1, 1, 2),
                                                  nx=2, ny=2, nz=3),
        "generate_cube": lambda m: m.generate_mesh("unit_cube", nx=2),
        "generate_interval": lambda m: m.generate_mesh("unit_interval", n=5),
    }[case]
    t, j = make(tmesh), make(jmesh)
    _same_mesh(t, j)
    assert np.array_equal(t.facets, j.facets)
    if t.tdim > 1:
        assert np.array_equal(t.edges, j.edges)
    assert t.summary() == j.summary()
    assert (t.hmin, t.hmax) == (j.hmin, j.hmax)
    if t.cell_type is not tmesh.CellType.HEXAHEDRON:
        assert np.array_equal(t.cell_volumes, j.cell_volumes)
        assert abs(t.cell_volumes.sum() - np.prod(np.ptp(t.vertices, axis=0))) <= 1e-12


def _cyl3d(root):
    return root.CylinderFlowGeometryConfig(
        dim=3, cylinder_radius=0.5, cylinder_center=(0.0, 0.0), x_range=(-2.0, 4.0),
        y_range=(-2.0, 2.0), z_range=(0.0, 1.0), resolution=0.9,
        resolution_around_cylinder=0.45, influence_radius=1.5)


def _step(root, dim):
    return root.StepFlowGeometryConfig(
        dim=dim, inlet_length=1.0, step_height=0.5, outlet_length=3.0, channel_height=0.5,
        resolution=0.3, width=0.6 if dim == 3 else None, refinement_factor=1.5)


@pytest.mark.parametrize("case", ["distmesh3d", "step_2d", "step_3d", "cylinder_3d"])
def test_distmesh_geometries_match_jax(case):
    """One seed, a few smoothing iterations: the same points and cells."""
    def build(geo, cfg):
        if case == "distmesh3d":
            def fd(p):
                return geo.d_union(geo.d_box(p, 0, 1, 0, 1, 0, 0.6),
                                   geo.d_extrude(geo.d_circle(p[:, :2], 1.0, 0.5, 0.35),
                                                 p, 0.0, 0.6))
            corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 0.6)])
            return geo.distmesh3d(fd, lambda p: 0.3 + 0.1 * p[:, 0], 0.3, (0, 1.4, 0, 1, 0, 0.6),
                                  corners, max_iter=8, seed=3)
        if case == "cylinder_3d":
            m = geo.cylinder_flow_mesh(_cyl3d(cfg), max_iter=6, seed=1)
        else:
            m = geo.step_flow_mesh(_step(cfg, 2 if case == "step_2d" else 3), max_iter=8, seed=2)
        return m.vertices, m.cells

    (tp, tc), (jp, jc) = build(tgeo, tconfig), build(jgeo, jconfig)
    assert tp.shape == jp.shape and tp.shape[1] == (2 if case == "step_2d" else 3)
    assert np.abs(tp - jp).max() <= 1e-12
    assert np.array_equal(tc, jc)
    if tc.shape[1] == 4:
        assert np.array_equal(tgeo._unique_edges_tet(tc), jgeo._unique_edges_tet(jc))
        assert np.array_equal(tgeo.d_cylinder_z(tp, 0.1, 0.2, 0.3),
                              jgeo.d_cylinder_z(jp, 0.1, 0.2, 0.3))


@pytest.mark.parametrize("case", ["2D/step", "3D/step", "3D/unit_cube"])
def test_step_and_cube_configs_load_equal(case):
    d = CONFIGS / case
    for name in ("bcs.toml", "bcs_perturbation.toml"):
        if (d / name).exists():
            t, j = tconfig.load_bc_config(d / name), jconfig.load_bc_config(d / name)
            assert [vars(c) for c in t] == [vars(c) for c in j]
    if (d / "geometry.toml").exists():
        t = tconfig.load_step_flow_config(d / "geometry.toml")
        assert vars(t) == vars(jconfig.load_step_flow_config(d / "geometry.toml"))
    # points on the faces the rules name: a coordinate snapped to a bound
    rng = np.random.default_rng(4)
    bounds = {"2D/step": (-10.0, 30.0), "3D/step": (-3.0, 5.5), "3D/unit_cube": (0.0, 1.0)}[case]
    pts = rng.uniform(*bounds, (600, 3))
    axis = rng.integers(0, 3, 600) if case == "3D/unit_cube" else np.zeros(600, int)
    pts[np.arange(600), axis] = np.asarray(bounds)[rng.integers(0, 2, 600)]
    assert np.array_equal(tconfig.load_facet_config(d / "facets.toml")(pts),
                          jconfig.load_facet_config(d / "facets.toml")(pts))


# ---------------------------------------------------------------------------
# 3D facets: a 2x2x2 box, x = 1 a pressure outlet, the other faces walls
# ---------------------------------------------------------------------------


def _faces(x):
    """Markers 1..6 for x = 0, x = 1, y = 0, y = 1, z = 0, z = 1."""
    out = np.zeros(x.shape[0], np.int32)
    for m, (axis, v) in enumerate(((0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0), (2, 0.0), (2, 1.0)),
                                  start=1):
        out[np.isclose(x[:, axis], v)] = m
    return out


def _box_case(mesh_mod, spaces_fn, bcs_fn, C, ctx_fn):
    mesh = mesh_mod.box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    (jmark if mesh_mod is jmesh else mark_boundary_facets)(mesh, _faces)
    spaces = spaces_fn(mesh)
    walls = [C(marker=m, type="dirichlet_velocity", value=(0.0, 0.0, 0.0)) for m in (1, 3, 4, 5, 6)]
    bcs = bcs_fn(mesh, spaces, walls + [C(marker=2, type="dirichlet_pressure", value=0.0)])
    return mesh, spaces, bcs, ctx_fn(spaces)


@pytest.fixture(scope="module")
def box():
    t = _box_case(tmesh, define_spaces, define_bcs, BoundaryConditionsConfig,
                  lambda s: AssemblyContext.build(s, device="cpu"))
    j = _box_case(jmesh, jdefine_spaces, jdefine_bcs, JBC, JContext.build)
    w = np.random.default_rng(7).standard_normal(t[1].num_dofs)
    return dict(t=t, j=j, w=w)


def test_facet_contexts_3d_match_jax(box):
    """Every face's context (area, outward normal, tabulations, slots); the
    loads and the traction on the outlet (x = 1) and one wall (z = 0): the
    JAX package compiles its facet kernels once per marker."""
    (tm, _, _, tctx), (jm, _, _, jctx) = box["t"], box["j"]
    for marker in range(1, 7):
        fc, jf = tfacets.build_facet_context(tctx, tm, marker), \
            jfacets.build_facet_context(jctx, jm, marker)
        assert abs(float((fc.w[None, :] * fc.detJf[:, None]).sum()) - 1.0) <= 1e-12  # the face
        assert np.array_equal(fc.parent_cells, np.asarray(jf.parent_cells))
        for name in ("w", "detJf", "normals", "phi_u", "gphi_u", "phi_p"):
            assert _rel(_np(getattr(fc, name)), np.asarray(getattr(jf, name))) <= REL, name
        assert np.array_equal(_np(fc.cell_dofs), np.asarray(jf.cell_dofs))
        assert np.array_equal(_np(fc.slots), np.asarray(jf.slots))
        axis = (marker - 1) // 2
        outward = np.zeros(3)
        outward[axis] = 1.0 if marker % 2 == 0 else -1.0
        assert np.abs(_np(fc.normals) - outward).max() <= 1e-12
        if marker not in (2, 5):
            continue
        g = (0.3, -0.2, 0.5)
        assert _rel(_np(tfacets.neumann_velocity_load(fc, tctx, g)),
                    jfacets.neumann_velocity_load(jf, jctx, g)) <= REL
        assert _rel(_np(tfacets.neumann_pressure_load(fc, tctx, 0.7)),
                    jfacets.neumann_pressure_load(jf, jctx, 0.7)) <= REL
        assert _rel(_np(tfacets.robin_matrix_data(fc, tctx, 2.5)),
                    jfacets.robin_matrix_data(jf, jctx, 2.5)) <= REL
        assert _rel(_np(tfacets.viscous_outlet_matrix_data(fc, tctx, 40.0)),
                    jfacets.viscous_outlet_matrix_data(jf, jctx, 40.0)) <= REL
        assert _rel(_np(tfacets.viscous_outlet_element_blocks(fc, tctx, 40.0)),
                    jfacets.viscous_outlet_element_blocks(jf, jctx, 40.0)) <= REL
        for d in range(3):
            got = float(tfacets.traction_force(fc, tctx, torch.as_tensor(box["w"]), 40.0, d))
            ref = float(jfacets.traction_force(jf, jctx, jnp.asarray(box["w"]), 40.0, d))
            assert abs(got - ref) <= REL * max(abs(ref), 1.0)
    got = tbaseflow.compute_drag(tctx, tm, box["w"], re=40.0, cylinder_marker=2)
    ref = jbaseflow.compute_drag(jctx, jm, box["w"], re=40.0, cylinder_marker=2)
    assert abs(got - ref) <= REL * ref


def test_ns_element_matrices_match_jax(box):
    """``element_matrices`` (with the outlet's facet blocks) and
    ``pressure_nullspace_vector`` on the box."""
    (tm, _, tbcs, tctx), (jm, _, jbcs, jctx) = box["t"], box["j"]
    t = LinearizedNavierStokesAssembler(box["w"], tctx, 40.0, tbcs, tm)
    j = JLinearized(jnp.asarray(box["w"]), jctx, 40.0, jbcs, jm)
    (tA, tM, td), (jA, jM, jd) = t.element_matrices(), j.element_matrices()
    assert tA.shape[0] == tctx.mixed_cell_dofs.shape[0] + len(t._outlets[0].parent_cells)
    assert _rel(_np(tA), jA) <= REL and _rel(_np(tM), jM) <= REL
    assert np.array_equal(_np(td), np.asarray(jd))
    assert np.array_equal(t.pressure_nullspace_vector(), j.pressure_nullspace_vector())


def test_interpolation_matches_jax(box):
    """A state of a 2x2x2 box onto the 3x3x3 cube's spaces, and P."""
    (_, tcoarse, _, _), (_, jcoarse, _, _) = box["t"], box["j"]
    tfine = define_spaces(tmesh.box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3))
    jfine = jdefine_spaces(jmesh.box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3))
    w = box["w"]
    got = tbaseflow.interpolate_state(torch.as_tensor(w), tcoarse, tfine)
    assert _rel(got, jbaseflow.interpolate_state(w, jcoarse, jfine)) <= REL
    P, JP = tbaseflow.interpolation_matrix(tcoarse, tfine), \
        jbaseflow.interpolation_matrix(jcoarse, jfine)
    assert P.shape == JP.shape == (tfine.num_dofs, tcoarse.num_dofs)
    assert abs(P - JP).max() <= 1e-13
    assert _rel(P @ w, got) <= REL
    pts = np.random.default_rng(2).uniform(-0.1, 1.1, (40, 3))
    Pq = tbaseflow.point_interpolation_matrix(tfine.pressure.node_coords, pts)
    assert abs(Pq - jbaseflow.point_interpolation_matrix(jfine.pressure.node_coords, pts)
               ).max() <= 1e-13


# ---------------------------------------------------------------------------
# The lid-driven cube on box_mesh(3, 3, 3), Re = 100
# ---------------------------------------------------------------------------


def _cube(mesh_mod, spaces_fn, bcs_fn, pin, C, ctx_fn):
    mesh = mesh_mod.box_mesh((0, 0, 0), (1.0, 1.0, 1.0), 3, 3, 3)

    def marker(x):
        out = np.full(x.shape[0], WALL, dtype=np.int32)
        out[np.isclose(x[:, 2], 1.0)] = LID
        return out

    (jmark if mesh_mod is jmesh else mark_boundary_facets)(mesh, marker)
    spaces = spaces_fn(mesh)
    out = []
    for lid in (1.0, 0.0):
        bcs = bcs_fn(mesh, spaces, [
            C(marker=LID, type="dirichlet_velocity", value=(lid, 0.0, 0.0)),
            C(marker=WALL, type="dirichlet_velocity", value=(0.0, 0.0, 0.0))])
        pin(bcs, spaces.dofs_p[0])
        out.append(bcs)
    return mesh, spaces, out[0], out[1], ctx_fn(spaces)


@pytest.fixture(scope="module")
def cube():
    """Both packages' cube, baseflow and (A, M): the JAX package's on its
    host LU, the port's banded (plain kernels); each (A, M) assembled
    around the JAX baseflow."""
    jm, jsp, jb, jbp, jctx = _cube(jmesh, jdefine_spaces, jdefine_bcs, jpin_dofs, JBC,
                                   JContext.build)
    jw = np.asarray(jbaseflow.BaseFlowSolver(jctx, jm, jb, re=RE).solve(
        ramp=True, steps=3, tol=1e-10))
    tm, tsp, tb, tbp, tctx = _cube(tmesh, define_spaces, define_bcs, pin_dofs,
                                   BoundaryConditionsConfig,
                                   lambda s: AssemblyContext.build(s, device="cpu"))
    solver = tbaseflow.BaseFlowSolver(tctx, tm, tb, re=RE)
    tw = solver.solve(ramp=True, steps=3, tol=1e-10, linear_solver="banded")
    JA, JM = JLinearized(jnp.asarray(jw), jctx, RE, jbp, jm).assemble_eigensystem()
    A, M = LinearizedNavierStokesAssembler(jw, tctx, RE, tbp, tm).assemble_eigensystem()
    return dict(jm=jm, jctx=jctx, jbp=jbp, jw=jw, JA=JA, JM=JM, tm=tm, tsp=tsp, tb=tb, tbp=tbp,
                tctx=tctx, tw=tw, solver=solver, A=A, M=M)


def test_pin_dofs_matches_jax(cube):
    tb, jb = cube["tb"], _cube(jmesh, jdefine_spaces, jdefine_bcs, jpin_dofs, JBC,
                               lambda s: None)[2]
    p = cube["tsp"].dofs_p[0]
    assert tb.dirichlet_mask[p] and tb.dirichlet_values[p] == 0.0
    assert np.array_equal(tb.dirichlet_mask, np.asarray(jb.dirichlet_mask))
    assert np.array_equal(tb.dirichlet_values, np.asarray(jb.dirichlet_values))
    tcopy, jcopy = tb.homogeneous(), jb.homogeneous()
    pin_dofs(tcopy, [p + 1, p + 2], np.array([2.5, -1.0]))
    jpin_dofs(jcopy, [p + 1, p + 2], np.array([2.5, -1.0]))
    assert tcopy.dirichlet_mask[p + 1] and tcopy.dirichlet_values[p + 2] == -1.0
    assert np.array_equal(tcopy.dirichlet_mask, np.asarray(jcopy.dirichlet_mask))
    assert np.array_equal(tcopy.dirichlet_values, np.asarray(jcopy.dirichlet_values))


def test_cube_baseflow_matches_jax(cube):
    w, jw = cube["tw"], cube["jw"]
    assert w.shape == jw.shape == (1093,)
    assert np.abs(w - jw).max() <= 1e-10 * np.abs(jw).max()
    st = cube["solver"].stats
    assert st["factors"] == st["pivoted"] > 0 and st["gcr_its"] <= 2 * st["factors"]
    tctx, jctx = cube["tctx"], cube["jctx"]
    for centre in (False, True):
        kw = dict(restrict_to_centreline=centre, centreline_tol=0.51)
        assert tbaseflow.compute_recirculation_length(tctx, w, **kw) == \
            jbaseflow.compute_recirculation_length(jctx, jw, **kw)


def test_cube_eigensystem_matches_jax(cube):
    """(A, M) and their (vv, vp, pv, pp) blocks (``extract_subblocks``)."""
    t = LinearizedNavierStokesAssembler(cube["jw"], cube["tctx"], RE, cube["tbp"], cube["tm"])
    j = JLinearized(jnp.asarray(cube["jw"]), cube["jctx"], RE, cube["jbp"], cube["jm"])
    for P, J in ((cube["A"], cube["JA"]), (cube["M"], cube["JM"])):
        Ps, Js = P.to_scipy(), J.to_scipy()
        assert np.array_equal(Ps.indptr, Js.indptr) and np.array_equal(Ps.indices, Js.indices)
        assert _rel(Ps.data, Js.data) <= REL
        tb, jb = t.extract_subblocks(P), j.extract_subblocks(J)
        for k in ("vv", "vp", "pv", "pp"):
            assert tb[k].shape == jb[k].shape
            assert _rel(tb[k].toarray(), jb[k].toarray()) <= REL


def test_cube_eigenpairs_match_jax(cube):
    """Four pairs nearest -0.2+0.3j: the port's banded shift-invert (plain
    kernels) against the JAX package's host LU, and test_cavity3d.py's
    gates."""
    A, M = cube["A"], cube["M"]
    es = EigenSolver(A, M, EigensolverConfig(num_eig=4, atol=1e-9, ncv=24))
    es.set_st_type(STType.SINVERT)
    es.set_target(TARGET)
    pairs = es.solve()
    jes = JEigenSolver(cube["JA"], cube["JM"], JConfig(num_eig=4, atol=1e-9, ncv=24))
    jes.set_st_type(JSTType.SINVERT)
    jes.set_target(TARGET)
    ref = np.array([p[0] for p in jes.solve()])
    got = np.array([p[0] for p in pairs])
    assert len(got) == 4 and (got.real < 0).all()
    assert max(np.abs(ref - z).min() for z in got) <= 1e-8
    assert (eigen_residuals(A, M, pairs) <= 1e-8).all()
    cplx = got[np.abs(got.imag) > 1e-8]
    assert sum(np.abs(cplx - np.conj(z)).min() < 1e-6 for z in cplx) >= 2
    assert type(es.operator.device_op.blu).__name__ == "PivotedBandedLU"


def _dense(cube):
    A, M = cube["A"].to_scipy().toarray(), cube["M"].to_scipy().toarray()
    nu = cube["tsp"].num_velocity_dofs
    fmask = np.zeros(A.shape[0], bool)
    fmask[:nu] = True
    fmask &= ~np.asarray(cube["tbp"].dirichlet_mask)
    return A, M, nu, np.nonzero(fmask)[0]


def test_cube_resolvent_matches_dense(cube):
    """tests/benchmark/test_nonmodal3d.py's resolvent check on the port."""
    Ad, Md, nu, fd = _dense(cube)
    omega, k = 0.5, 2
    Q = np.linalg.solve(1j * omega * Md - Ad, Md[:, fd])
    gam = sla.eigh(Q.conj().T @ Md @ Q, Md[np.ix_(fd, fd)], eigvals_only=True)
    ref = np.sqrt(np.maximum(gam[::-1][:k], 0.0))
    rs = ResolventSolver(cube["A"], cube["M"], nu, cube["tbp"].dirichlet_mask, method="lu",
                         device="cpu")
    assert np.allclose(rs.solve(omega, k=k).gains, ref, rtol=1e-6)


def test_cube_transient_matches_dense(cube):
    """tests/benchmark/test_nonmodal3d.py's transient check on the port,
    held to the dense Crank-Nicolson propagator."""
    Ad, Md, nu, fd = _dense(cube)
    horizon, n_steps, k = 2.0, 8, 2
    dt = horizon / n_steps
    S = np.linalg.solve(Md - 0.5 * dt * Ad, Md + 0.5 * dt * Ad)
    B = np.linalg.matrix_power(S, n_steps)[:, fd]
    gam = sla.eigh(B.T @ Md @ B, Md[np.ix_(fd, fd)], eigvals_only=True)
    ref = np.maximum(gam[::-1][:k], 0.0)
    ts = TransientGrowthSolver(cube["A"], cube["M"], nu, cube["tbp"].dirichlet_mask,
                               method="lu", device="cpu")
    assert np.allclose(ts.solve(horizon, n_steps, k=k).gains, ref, rtol=1e-6)


def test_cube_unsteady_holds_the_fixed_point(cube):
    """tests/benchmark/test_nonmodal3d.py's three theta steps from the
    steady state (the port's banded chord Newton)."""
    us = UnsteadySolver(cube["tctx"], cube["tm"], cube["tb"], RE, newton_tol=1e-12,
                        device="cpu")
    w = torch.as_tensor(cube["tw"])
    q = w
    for _ in range(3):
        q, st = us.step(q, dt=0.3)
        assert st.newton_iters <= 3
    assert float(torch.linalg.vector_norm(q - w)) < 1e-7 * (1.0 + float(torch.linalg.norm(w)))


def test_membrane_on_tets_matches_jax_and_dense():
    """``assemble_membrane_evp`` on ``unit_cube(3)`` tetrahedra (P2): (K, M)
    against the JAX package's, and the port's banded shift-invert (a real
    shift: one real factor) against the dense pencil and near 3 pi^2."""
    K, M, mask = membrane.assemble_membrane_evp(tmesh.unit_cube(3), device="cpu")
    jK, jM, jmask = jmembrane.assemble_membrane_evp(jmesh.unit_cube(3))
    assert np.array_equal(mask, np.asarray(jmask))
    for P, J in ((K, jK), (M, jM)):
        assert _rel(P.to_scipy().toarray(), J.to_scipy().toarray()) <= REL
    es = EigenSolver(K, M, EigensolverConfig(num_eig=2, atol=1e-10, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(25.0)
    got = np.sort(np.array([p[0] for p in es.solve()]).real)
    free = ~mask
    dense = sla.eigh(K.to_scipy().toarray()[np.ix_(free, free)],
                     M.to_scipy().toarray()[np.ix_(free, free)], eigvals_only=True)
    ref = np.sort(dense[np.argsort(np.abs(dense - 25.0))[:2]])
    assert _rel(got, ref) <= 1e-8
    assert abs(ref[0] - 3 * np.pi**2) <= 0.05 * 3 * np.pi**2
    assert type(es.operator.device_op.blu).__name__ == "RealPivotedBandedLU"


# ---------------------------------------------------------------------------
# The 3D step from config_files/3D/step at resolution 0.3 (1,835 DOFs)
# ---------------------------------------------------------------------------


def _step3d(cfg, mesh_fn, mark, spaces_fn, bcs_fn):
    d = CONFIGS / "3D" / "step"
    geo = dataclasses.replace(cfg.load_step_flow_config(d / "geometry.toml"), resolution=0.3)
    mesh = mesh_fn(geo)
    mark(mesh, cfg.load_facet_config(d / "facets.toml"))
    spaces = spaces_fn(mesh)
    return mesh, spaces, bcs_fn(mesh, spaces, cfg.load_bc_config(d / "bcs.toml"))


@pytest.fixture(scope="module")
def step3d():
    """The coarse 3D step through both packages (host meshes and BCs) and
    the port's context, the port's ``define_bcs`` warnings captured."""
    handler = logging.Handler()
    records: list = []
    handler.emit = records.append
    logger = logging.getLogger("lsafw_tpu_torch.fem.bcs")
    logger.addHandler(handler)
    try:
        tm, tsp, tb = _step3d(tconfig, tgeo.step_flow_mesh, mark_boundary_facets, define_spaces,
                              define_bcs)
    finally:
        logger.removeHandler(handler)
    jm, jsp, jb = _step3d(jconfig, jgeo.step_flow_mesh, jmark, jdefine_spaces, jdefine_bcs)
    return dict(tm=tm, tsp=tsp, tb=tb, jm=jm, jsp=jsp, jb=jb, records=records,
                tctx=AssemblyContext.build(tsp, device="cpu"))


def test_step3d_decoupled_pressure_dofs(step3d):
    """The pressure DOFs whose every coupling is to a Dirichlet velocity DOF
    (corner tetrahedra of the distmesh3d step): ``define_bcs`` names them
    in a warning and leaves its mask and values as the JAX package's; each
    one's row of the mixed pattern reaches Dirichlet velocity DOFs alone."""
    tb, jb, tsp = step3d["tb"], step3d["jb"], step3d["tsp"]
    _same_mesh(step3d["tm"], step3d["jm"])
    assert np.array_equal(tb.dirichlet_mask, np.asarray(jb.dirichlet_mask))
    assert np.array_equal(tb.dirichlet_values, np.asarray(jb.dirichlet_values))
    free = decoupled_pressure_dofs(tsp, tb)
    assert free.size == 3 and (free >= tsp.num_velocity_dofs).all()
    assert any(str(free.tolist()) in r.getMessage() for r in step3d["records"])
    pat, nu, mask = step3d["tctx"].pattern, tsp.num_velocity_dofs, tb.dirichlet_mask
    rows, cols = pat.row_ids.astype(np.int64), pat.indices.astype(np.int64)
    live = (rows >= nu) & (cols < nu) & ~mask[cols]
    p = np.arange(nu, tsp.num_dofs)
    assert np.array_equal(free, p[~np.isin(p, rows[live]) & ~mask[p]])


def test_step3d_pivot_free_factor_refuses_a_missed_refinement(step3d, monkeypatch):
    """The 3D step's pivot-free real factor at sigma = 0 (the saddle
    regularization's; on a finer step its refinement missed and the
    eigenvalues came back wrong, residual 1e-4): with its refinement capped
    below what it needs, the eigensolve raises ``FactorUnusable`` at the
    target and again at the offset shift, and returns no pairs."""
    tm, tsp, tb = step3d["tm"], step3d["tsp"], step3d["tb"]
    bcs = dataclasses.replace(tb, dirichlet_mask=tb.dirichlet_mask.copy(),
                              dirichlet_values=tb.dirichlet_values.copy())
    pin_dofs(bcs, decoupled_pressure_dofs(tsp, tb))
    w = np.where(bcs.dirichlet_mask, bcs.dirichlet_values, 0.0)
    A, M = LinearizedNavierStokesAssembler(w, step3d["tctx"], 50.0, bcs.homogeneous(),
                                           tm).assemble_eigensystem()
    monkeypatch.setenv("LSAFW_PIVOT_MEM_GB", "0")
    monkeypatch.setattr(ShiftInvertOperator, "_CAP", 2)
    es = EigenSolver(A, M, EigensolverConfig(num_eig=4, atol=1e-9, ncv=20))
    es.set_st_type(STType.SINVERT)
    es.set_target(0.0)
    with pytest.raises(FactorUnusable, match="refinement reached"):
        es.solve()
