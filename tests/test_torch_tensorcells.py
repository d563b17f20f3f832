"""Parity of the port's tensor-product cells, periodic pairs, SIPG DG,
mesh adaptation and ``from_complex_csr`` with the JAX package.

Small cases built by both packages from the same numpy input: the
distorted unit square of ``tests/unit/test_nonaffine.py`` (interior
vertices moved by a smooth field that vanishes on the boundary), a
3 x 2 x 2 hex box, the 4 x 8 Q2 membrane of ``test_q2_quads.py``'s
rectangle, the Q2/Q1 Poiseuille channel at 4 x 4, the unit square with
x = 0 paired to x = 1, and DG on a 3 x 3 square and a 2^3 cube.
Tolerances: host geometry and the non-affine kernels rel 1e-13 (the
same f64 formulas), assembled data rel 1e-12 (another summation
order), eigenvalues 1e-8, the periodic fold 1e-15, DG 1e-14, adaptation
points 1e-12 and cells exact at one seed, band solves at the f32
factor's tolerance and, refined, 1e-10 from scipy's solve.  Band plans
at nb = 32, unpadded.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp
from lsafw_tpu.config import BoundaryConditionsConfig as JBC
from lsafw_tpu.fem import assembly as ja
from lsafw_tpu.fem import bcs as jbcs
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.fem.spaces import make_scalar_space as jscalar
from lsafw_tpu.meshing import adapt as jadapt
from lsafw_tpu.meshing import mesh as jmesh
from lsafw_tpu.meshing.tags import facets_with_marker as jfacets
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.models import dg as jdg
from lsafw_tpu.models.membrane import assemble_membrane_evp as jmembrane
from lsafw_tpu.models.navier_stokes import StokesAssembler as JStokes
from lsafw_tpu.ops.sparse import CSRMatrix as JCSR
from lsafw_tpu.solver import band as jband
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem import assembly as ta
from lsafw_tpu_torch.fem import bcs as tbcs
from lsafw_tpu_torch.fem.quadrature import quadrature_rule
from lsafw_tpu_torch.fem.spaces import define_spaces, make_scalar_space
from lsafw_tpu_torch.meshing import adapt as tadapt
from lsafw_tpu_torch.meshing import mesh as tmesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker, mark_boundary_facets
from lsafw_tpu_torch.models import dg as tdg
from lsafw_tpu_torch.models.membrane import analytic_eigenvalues, assemble_membrane_evp
from lsafw_tpu_torch.models.navier_stokes import StokesAssembler
from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver.eigen import (
    BandedSIOp,
    EigenSolver,
    EigensolverConfig,
    STType,
    banded_solve_raw,
)
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def nb32():
    """Band plans at nb = 32, unpadded (chunk 1), as in the other port
    tests: the CPU's plain substitution loops run a step per block row."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LSAFW_BAND_NB", "32")
        mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
        yield


def _distorted(mod, n: int):
    """``test_nonaffine.py``'s unit square of n x n quads with smoothly
    distorted interior vertices."""
    mesh = mod.rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, cell_type=mod.CellType.QUADRILATERAL)
    v = mesh.vertices.copy()
    x, y = v[:, 0], v[:, 1]
    v[:, 0] = x + 0.06 * np.sin(np.pi * x) * np.sin(np.pi * y)
    v[:, 1] = y - 0.05 * np.sin(np.pi * x) * np.sin(np.pi * y)
    return mod.Mesh(v, mesh.cells, mod.CellType.QUADRILATERAL)


def _sheared(mod):
    """A 3 x 2 parallelogram mesh: the unit rectangle sheared by x += 0.4 y."""
    mesh = mod.rectangle_mesh((0.0, 0.0), (1.0, 1.0), 3, 2, cell_type=mod.CellType.QUADRILATERAL)
    v = mesh.vertices.copy()
    v[:, 0] += 0.4 * v[:, 1]
    return mod.Mesh(v, mesh.cells, mod.CellType.QUADRILATERAL)


def _hex(mod):
    return mod.box_mesh((0, 0, 0), (1.0, 2.0, 0.5), 3, 2, 2, cell_type=mod.CellType.HEXAHEDRON)


MESHES = {"distorted": lambda mod: _distorted(mod, 4), "sheared": _sheared, "hex": _hex}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _sp_rel(a: sp.spmatrix, b: sp.spmatrix) -> float:
    return float(abs(a - b).max() / max(abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", list(MESHES))
def test_tensor_geometry_matches_jax(name):
    """``affine_geometry`` (on parallelogram cells), ``is_parallelogram_cells``
    and ``nonaffine_geometry`` at the quadrature points: host numpy, rel 1e-13."""
    jm, tm = MESHES[name](jmesh), MESHES[name](tmesh)
    assert ta.is_parallelogram_cells(tm) == ja.is_parallelogram_cells(jm) == (name != "distorted")
    if name != "distorted":
        for got, want in zip(ta.affine_geometry(tm), ja.affine_geometry(jm)):
            assert _rel(got, want) <= 1e-13
    pts = quadrature_rule(tm.cell_type, 4).points
    for got, want in zip(ta.nonaffine_geometry(tm, pts), ja.nonaffine_geometry(jm, pts)):
        assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("name,family", [("distorted", "q1"), ("distorted", "q2"),
                                         ("hex", "q1")])
def test_nonaffine_mass_and_stiffness_match_jax(name, family):
    """The per-point element kernels of a SpaceContext on quads and hexes,
    element by element, rel 1e-13."""
    jm, tm = MESHES[name](jmesh), MESHES[name](tmesh)
    jctx = ja.SpaceContext.build(jscalar(jm, family))
    tctx = ta.SpaceContext.build(make_scalar_space(tm, family), device=CPU)
    assert not tctx.is_affine and tctx.metric.shape == np.asarray(jctx.metric).shape
    for tk, jk in ((ta.mass_scalar, ja.mass_scalar), (ta.stiffness_scalar, ja.stiffness_scalar)):
        assert _rel(tk(tctx).numpy(), np.asarray(jk(jctx))) <= 1e-13


@pytest.fixture(scope="module")
def q2_membrane():
    """The Q2 membrane on the 2 x 4 rectangle at 4 x 8 quads, both packages."""
    out = {}
    for key, mod, asm, kw in (("jax", jmesh, jmembrane, {}),
                              ("port", tmesh, assemble_membrane_evp, {"device": CPU})):
        mesh = mod.rectangle_mesh((0, 0), (2.0, 4.0), 4, 8, cell_type=mod.CellType.QUADRILATERAL)
        out[key] = asm(mesh, family="q2", **kw)
    return out


def test_q2_membrane_matrices_match_jax(q2_membrane):
    (Kj, Mj, mj), (Kt, Mt, mt) = q2_membrane["jax"], q2_membrane["port"]
    assert np.array_equal(mj, mt)
    assert _sp_rel(Kt.to_scipy(), Kj.to_scipy()) <= 1e-12
    assert _sp_rel(Mt.to_scipy(), Mj.to_scipy()) <= 1e-12


def test_q2_membrane_eigenvalues_match_jax(q2_membrane):
    """The port's banded shift-invert (real factor at the real target 2,
    test_q2_quads.py's) against scipy's on the JAX package's pencil, 1e-8;
    the four lowest are the rectangle's to the Q2 error of this coarse mesh."""
    Kj, Mj, _ = q2_membrane["jax"]
    Kt, Mt, _ = q2_membrane["port"]
    want = np.sort(spla.eigsh(Kj.to_scipy().tocsc(), k=4, M=Mj.to_scipy().tocsc(), sigma=2.0,
                              return_eigenvectors=False))
    es = EigenSolver(Kt, Mt, EigensolverConfig(num_eig=4, atol=1e-10, ncv=24))
    es.set_st_type(STType.SINVERT)
    es.set_target(2.0)
    got = np.sort([p[0].real for p in es.solve()])
    assert _rel(got, want) <= 1e-8
    assert _rel(got, analytic_eigenvalues(2.0, 4.0, 4)) <= 1e-2


def _channel(mod, mark, n: int = 4):
    mesh = mod.rectangle_mesh((0, 0), (1.0, 1.0), n, n, cell_type=mod.CellType.QUADRILATERAL)

    def marker(x):
        out = np.full(x.shape[0], 2, dtype=np.int32)
        out[np.isclose(x[:, 1], 0.0) | np.isclose(x[:, 1], 1.0)] = 4
        out[np.isclose(x[:, 0], 0.0)] = 1
        return out

    mark(mesh, marker)
    return mesh


def _poiseuille_bcs(mesh, spaces, define, BC, facets):
    bcs = define(mesh, spaces, [BC(marker=4, type="dirichlet_velocity", value=(0.0, 0.0))])
    inlet = spaces.velocity.dofs_on_facets(facets(mesh, 1))
    y = spaces.velocity.dof_coords[inlet][:, 1]
    bcs.dirichlet_mask[inlet] = True
    bcs.dirichlet_values[inlet] = np.where(inlet % 2 == 0, 4.0 * y * (1.0 - y), 0.0)
    return bcs


def test_q2q1_stokes_channel_matches_jax():
    """``test_q2_quads.py``'s Q2/Q1 Poiseuille channel at 4 x 4: (A, b) rel
    1e-12; the port's direct solve is the exact Poiseuille flow; on
    curvilinear quads both packages refuse the mixed context."""
    jm, tm = _channel(jmesh, jmark), _channel(tmesh, mark_boundary_facets)
    jsp, tsp = jdefine_spaces(jm), define_spaces(tm)
    jb = _poiseuille_bcs(jm, jsp, jbcs.define_bcs, JBC, jfacets)
    tb = _poiseuille_bcs(tm, tsp, tbcs.define_bcs, BoundaryConditionsConfig, facets_with_marker)
    Aj, bj = JStokes(ja.AssemblyContext.build(jsp), jm, jb, re=1.0).get_matrix_forms()
    At, bt = StokesAssembler(ta.AssemblyContext.build(tsp, device=CPU), tm, tb,
                             re=1.0).get_matrix_forms()
    assert _sp_rel(At.to_scipy(), Aj.to_scipy()) <= 1e-12
    assert _rel(bt.numpy(), np.asarray(bj)) <= 1e-12
    u, p = tsp.split(spla.spsolve(At.to_scipy().tocsc(), bt.numpy()))
    yv = tsp.velocity.node_coords[:, 1]
    assert np.abs(u - np.stack([4 * yv * (1 - yv), 0 * yv], 1)).max() <= 1e-8
    assert abs(np.polyfit(tsp.pressure.node_coords[:, 0], p, 1)[0] + 8.0) <= 8e-6
    for mod, ctx, spaces, kw in ((jmesh, ja.AssemblyContext, jdefine_spaces, {}),
                                 (tmesh, ta.AssemblyContext, define_spaces, {"device": CPU})):
        with pytest.raises(NotImplementedError, match="curvilinear"):
            ctx.build(spaces(_distorted(mod, 3)), **kw)


def _periodic_square(mod, mark):
    mesh = mod.unit_square(4)

    def marker(x):
        out = np.full(x.shape[0], 5, dtype=np.int32)
        out[np.isclose(x[:, 0], 0.0)] = 1
        out[np.isclose(x[:, 0], 1.0)] = 2
        return out

    mark(mesh, marker)
    return mesh


def test_periodic_pairs_and_fold_match_jax():
    """``define_bcs``' PERIODIC branch on the unit square's Taylor-Hood
    space (x = 0 paired to x = 1): velocity and pressure pairs exact; the
    fold of the port's Stokes matrix, handed to both packages (its 'to'
    rows and columns into the 'from' ones, the 'to' DOFs pinned to 1), and
    of a vector from a seed, rel 1e-15."""
    jm, tm = _periodic_square(jmesh, jmark), _periodic_square(tmesh, mark_boundary_facets)
    jsp, tsp = jdefine_spaces(jm), define_spaces(tm)
    cfg = [(1, "periodic", (1, 2)), (5, "dirichlet_velocity", (0.0, 0.0))]
    jb = jbcs.define_bcs(jm, jsp, [JBC(marker=m, type=t, value=v) for m, t, v in cfg])
    tb = tbcs.define_bcs(tm, tsp, [BoundaryConditionsConfig(marker=m, type=t, value=v)
                                   for m, t, v in cfg])
    assert len(tb.periodic_pairs) == len(jb.periodic_pairs) == 2
    for (tt, tf), (jt, jf) in zip(tb.periodic_pairs, jb.periodic_pairs):
        assert np.array_equal(tt, jt) and np.array_equal(tf, jf)
    assert tb.homogeneous().velocity_periodic[0][0] is tb.velocity_periodic[0][0]
    At, _ = StokesAssembler(ta.AssemblyContext.build(tsp, device=CPU), tm, tb.homogeneous(),
                            re=1.0).get_matrix_forms()
    pairs = tb.velocity_periodic[0]
    Fj = jbcs.apply_periodic_constraints_matrix(JCSR.from_scipy(At.to_scipy()),
                                                jb.velocity_periodic[0])
    Ft = tbcs.apply_periodic_constraints_matrix(At, pairs)
    assert isinstance(Ft, CSRMatrix) and Ft.device == torch.device(CPU)
    assert _sp_rel(Ft.to_scipy(), Fj.to_scipy()) <= 1e-15
    assert np.all(Ft.to_scipy().diagonal()[pairs[0]] == 1.0)
    v = np.random.default_rng(15).standard_normal(tsp.num_dofs)
    assert _rel(tbcs.apply_periodic_constraints_vector(v, pairs),
                jbcs.apply_periodic_constraints_vector(v, jb.velocity_periodic[0])) <= 1e-15


@pytest.mark.parametrize("dim", [2, 3])
def test_dg_poisson_matches_jax(dim):
    """SIPG stiffness (Nitsche boundary terms, eta = 12) and block-diagonal
    mass on a 3 x 3 square and a 2^3 cube, rel 1e-14."""
    mk = (lambda mod: mod.unit_square(3)) if dim == 2 else (lambda mod: mod.unit_cube(2))
    Kj, Mj = jdg.assemble_dg_poisson(mk(jmesh), eta=12.0)
    Kt, Mt = tdg.assemble_dg_poisson(mk(tmesh), eta=12.0, device=CPU)
    assert Kt.device == torch.device(CPU)
    assert _sp_rel(Kt.to_scipy(), Kj.to_scipy()) <= 1e-14
    assert _sp_rel(Mt.to_scipy(), Mj.to_scipy()) <= 1e-14
    with pytest.raises(NotImplementedError):
        tdg.assemble_dg_poisson(tmesh.unit_square(2, cell_type=tmesh.CellType.QUADRILATERAL),
                                device=CPU)


def test_adapt_mesh_matches_jax():
    """``test_plot_adapt.py``'s shear flow on the 2 x 1 rectangle: |u| at the
    vertices, the size field, the boundary SDF and corners, and the
    adapted mesh at one seed and 15 distmesh iterations (points 1e-12,
    cells exact); the port reads the baseflow from a tensor."""
    out = {}
    for key, mod, mark, spaces in (("jax", jmesh, jmark, jdefine_spaces),
                                   ("port", tmesh, mark_boundary_facets, define_spaces)):
        mesh = mod.rectangle_mesh((0.0, 0.0), (2.0, 1.0), 10, 5)
        mark(mesh, lambda x: np.ones(x.shape[0], dtype=np.int32))
        sps = spaces(mesh)
        u = sps.velocity.interpolate(lambda p: np.stack([p[:, 1], np.zeros(p.shape[0])], axis=1))
        out[key] = (mesh, sps, np.concatenate([u, np.zeros(sps.num_pressure_dofs)]))
    (jm, jsp, w), (tm, tsp, _) = out["jax"], out["port"]
    wt = torch.as_tensor(w)
    mag = tadapt.velocity_magnitude_p1(tsp, wt)
    assert np.array_equal(mag, jadapt.velocity_magnitude_p1(jsp, w))
    assert np.array_equal(tadapt.scale_and_clamp(mag, 0.05, 0.3),
                          jadapt.scale_and_clamp(mag, 0.05, 0.3))
    assert np.array_equal(tadapt.boundary_corners_2d(tm), jadapt.boundary_corners_2d(jm))
    probe = np.random.default_rng(15).uniform(-0.5, 2.5, (50, 2))
    assert np.array_equal(tadapt.boundary_sdf(tm)(probe), jadapt.boundary_sdf(jm)(probe))
    new_t = tadapt.adapt_mesh(tm, tsp, wt, min_size=0.08, max_size=0.35, max_iter=15, seed=3)
    new_j = jadapt.adapt_mesh(jm, jsp, w, min_size=0.08, max_size=0.35, max_iter=15, seed=3)
    assert np.array_equal(new_t.cells, new_j.cells)
    assert np.abs(new_t.vertices - new_j.vertices).max() <= 1e-12


@pytest.fixture(scope="module")
def complex_system(q2_membrane):
    """C = K - sigma M of the JAX package's 4 x 8 Q2 membrane at sigma = 20
    + 3j (its Dirichlet rows 1 - 0), a right-hand side from a seed, and
    scipy's solve."""
    K, M, _ = q2_membrane["jax"]
    C = (K.to_scipy() - (20.0 + 3.0j) * M.to_scipy()).tocsr()
    rng = np.random.default_rng(15)
    b = rng.standard_normal(C.shape[0]) + 1j * rng.standard_normal(C.shape[0])
    return C, b, spla.spsolve(C.tocsc(), b)


@pytest.mark.parametrize("cls", ["PivotedBandedLU", "BandedLU"])
def test_from_complex_csr_matches_jax(complex_system, cls):
    """``from_complex_csr`` (plan on the host, factor on the device) at nb =
    32, chunk 2, on one RCM ordering: the JAX package's plan (its order,
    padding and B); the port's band solve within the f32 factor's
    tolerance (rel 1e-4) of scipy's solve (the JAX package's jitted factor
    and solve would add two compiles to a parity that bound already
    covers); and the refined solve (GCR on S's shifted mode: C = A - 1j M
    with A = Re C, M = -Im C) within 1e-10 of scipy's."""
    C, b, x = complex_system
    perm = jband.rcm_permutation(sp.csr_matrix((np.ones(C.nnz), C.indices, C.indptr),
                                               shape=C.shape))
    plan = jband.BandPlan.build(C, nb=32, chunk=2, perm=perm)
    lu = getattr(tband, cls).from_complex_csr(C, nb=32, chunk=2, perm=perm, device=CPU)
    assert (lu.n, lu.nb, lu.B) == (plan.n, plan.nb, plan.B)
    tplan = tband.BandPlan.build(C, nb=32, chunk=2, perm=perm)
    assert np.array_equal(tplan.perm, plan.perm) and tplan.nblk_pad == plan.nblk_pad
    xt = lu.solve(torch.as_tensor(b)).numpy()
    assert _rel(xt, x) <= 1e-4
    Cs = C.copy()
    Cs.sort_indices()
    A = CSRMatrix.from_scipy(sp.csr_matrix((Cs.data.real, Cs.indices, Cs.indptr), shape=C.shape),
                             device=CPU)
    Mneg = CSRMatrix(A.pattern, torch.as_tensor(-Cs.data.imag))
    op = BandedSIOp(A, Mneg, lu, 1j, BCSRShiftedOp.from_csr(A, Mneg, 1j))
    xr = banded_solve_raw(op, torch.as_tensor(b), tol=1e-12, max_its=30)
    assert _rel(xr.numpy(), x) <= 1e-10
    assert _rel(spmv(A, xr) - 1j * spmv(Mneg, xr), b) <= 1e-10
