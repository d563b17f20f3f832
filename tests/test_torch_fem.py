"""Parity of the PyTorch port's mesh, spaces and Navier-Stokes assembly
with the JAX package on a small cylinder mesh.

Both packages build the case from the same geometry and seed; the
assembled data are f64 on both sides and differ only in summation
order, hence rel 1e-12.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from lsafw_tpu_torch import interop
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.ops.sparse import spmv

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread while a port test module runs (each port test
    module imports this fixture).  The tests share the machine with other
    pytest workers, and OpenBLAS's idle worker threads busy-wait between
    the small dense products these tests make."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield

RE = 47.0
X0, X1, Y0, Y1 = -5.0, 15.0, -5.0, 5.0
INLET, OUTLET, BOTTOM, TOP, CYL = 1, 2, 3, 4, 5
REL = 1e-12


def _marker(x):
    out = np.full(x.shape[0], CYL, dtype=np.int32)
    out[np.isclose(x[:, 1], Y0, atol=1e-6)] = BOTTOM
    out[np.isclose(x[:, 1], Y1, atol=1e-6)] = TOP
    out[np.isclose(x[:, 0], X0, atol=1e-6)] = INLET
    out[np.isclose(x[:, 0], X1, atol=1e-6)] = OUTLET
    return out


def cylinder_case(root: str, **ctx_kw) -> dict:
    """The small cylinder set-up through package ``root`` (both packages
    share module names and signatures up to ``AssemblyContext.build``'s
    device argument)."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    C = mod("config").BoundaryConditionsConfig
    geo = mod("config").CylinderFlowGeometryConfig(
        dim=2, cylinder_radius=0.5, cylinder_center=(0.0, 0.0),
        x_range=(X0, X1), y_range=(Y0, Y1), resolution=1.0,
        resolution_around_cylinder=0.3, influence_radius=4.0,
    )
    mesh = mod("meshing.geometries").cylinder_flow_mesh(geo, max_iter=40, seed=0)
    mod("meshing.tags").mark_boundary_facets(mesh, _marker)
    spaces = mod("fem.spaces").define_spaces(mesh)
    define_bcs = mod("fem.bcs").define_bcs
    bcs_base = define_bcs(mesh, spaces, [
        C(marker=INLET, type="dirichlet_velocity", value=(1.0, 0.0)),
        C(marker=BOTTOM, type="neumann_velocity", value=(0.0, 0.0)),
        C(marker=TOP, type="neumann_velocity", value=(0.0, 0.0)),
        C(marker=OUTLET, type="dirichlet_pressure", value=0.0),
        C(marker=CYL, type="dirichlet_velocity", value=(0.0, 0.0)),
    ])
    bcs_pert = define_bcs(mesh, spaces, [
        C(marker=INLET, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=CYL, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=OUTLET, type="dirichlet_pressure", value=0.0),
    ])
    ctx = mod("fem.assembly").AssemblyContext.build(spaces, **ctx_kw)
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                ns=mod("models.navier_stokes"))


@pytest.fixture(scope="module")
def cases():
    return cylinder_case("lsafw_tpu"), cylinder_case("lsafw_tpu_torch", device="cpu")


@pytest.fixture(scope="module")
def w_state(cases):
    """A fixed mixed state: the Dirichlet data plus seeded noise."""
    _, tc = cases
    bcs = tc["bcs_base"]
    rng = np.random.default_rng(3)
    w = 0.1 * rng.standard_normal(tc["spaces"].num_dofs)
    return np.where(bcs.dirichlet_mask, bcs.dirichlet_values, w + 1.0)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rel, f"relative max error {err:.3e} > {rel:.0e}"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_mesh_and_tags_identical(cases):
    jm, tm = cases[0]["mesh"], cases[1]["mesh"]
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(tm.facets, jm.facets)
    np.testing.assert_array_equal(tm.facet_tags, jm.facet_tags)


def test_dofmaps_tabulations_and_pattern_identical(cases):
    jc, tc = cases[0]["ctx"], cases[1]["ctx"]
    js, ts = cases[0]["spaces"], cases[1]["spaces"]
    assert ts.num_dofs == js.num_dofs
    np.testing.assert_array_equal(ts.mixed_cell_dofs, js.mixed_cell_dofs)
    np.testing.assert_array_equal(ts.velocity.cell_nodes, js.velocity.cell_nodes)
    np.testing.assert_array_equal(ts.pressure.cell_nodes, js.pressure.cell_nodes)
    np.testing.assert_array_equal(cases[1]["bcs_base"].dirichlet_mask,
                                  cases[0]["bcs_base"].dirichlet_mask)
    for name in ("w", "phi_u", "dphi_u", "phi_p", "detJ", "Jinv"):
        np.testing.assert_array_equal(_np(getattr(tc, name)), _np(getattr(jc, name)), err_msg=name)
    np.testing.assert_array_equal(tc.pattern.indptr, jc.pattern.indptr)
    np.testing.assert_array_equal(tc.pattern.indices, jc.pattern.indices)


def test_stokes_system_matches(cases):
    out = []
    for c in cases:
        A, b = c["ns"].StokesAssembler(c["ctx"], c["mesh"], c["bcs_base"], re=RE).get_matrix_forms()
        out.append((_np(A.data), _np(b)))
    _close(out[1][0], out[0][0])
    _close(out[1][1], out[0][1])


def test_ns_residual_and_jacobian_match(cases, w_state):
    res, jac = [], []
    for c in cases:
        asm = c["ns"].StationaryNavierStokesAssembler(c["ctx"], c["mesh"], c["bcs_base"])
        w = w_state if c is cases[0] else torch.as_tensor(w_state)
        res.append(_np(asm.residual(w, RE)))
        jac.append(_np(asm.jacobian_data(w, RE)))
    _close(res[1], res[0])
    _close(jac[1], jac[0])


def test_eigensystem_matches(cases, w_state):
    mats = []
    for c in cases:
        A, M = c["ns"].LinearizedNavierStokesAssembler(
            w_state, c["ctx"], RE, c["bcs_pert"], c["mesh"]).assemble_eigensystem()
        mats.append((_np(A.data), _np(M.data)))
    _close(mats[1][0], mats[0][0])
    _close(mats[1][1], mats[0][1])


def test_interop_carries_mesh_state_and_matrices(cases, w_state):
    """JAX-side state handed over as numpy builds the same port objects."""
    jc = cases[0]
    jm = jc["mesh"]
    mesh = interop.mesh_from_numpy(jm.vertices, jm.cells, jm.cell_type.value, jm.facet_tags)
    np.testing.assert_array_equal(mesh.facets, jm.facets)
    np.testing.assert_array_equal(define_spaces(mesh).mixed_cell_dofs, jc["spaces"].mixed_cell_dofs)
    w = interop.state_from_numpy(w_state, device="cpu")
    assert w.dtype == torch.float64 and w.shape == w_state.shape
    A, _ = jc["ns"].LinearizedNavierStokesAssembler(
        w_state, jc["ctx"], RE, jc["bcs_pert"], jm).assemble_eigensystem()
    data = np.asarray(A.data)
    At = interop.csr_from_numpy(A.pattern.indptr, A.pattern.indices, data, A.shape, device="cpu")
    x = np.random.default_rng(4).standard_normal(A.shape[0]) * (1 + 1j)
    ref = sp.csr_matrix((data, A.pattern.indices, A.pattern.indptr), shape=A.shape) @ x
    _close(spmv(At, torch.as_tensor(x)).numpy(), ref, rel=1e-14)
