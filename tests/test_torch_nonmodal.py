"""The port's non-modal toolbox against the JAX package and dense linear
algebra on the small linearized Navier-Stokes system of
``tests/unit/test_resolvent.py`` (6x6 rectangle, P2/P1, a shear
baseflow at Re = 30; 387 DOFs), and the membrane eigenproblem.

The JAX package builds (A, M) once; ``interop`` carries them into the
port on one pattern.  The port also assembles its own (A, M) from the
same baseflow, for the slice as a whole.  Dense references: the
resolvent gains of the dense T (``test_resolvent.py:51-63``) and the
transient gains of the dense Crank-Nicolson propagator
(``test_transient.py:16-33``), which the port's transient is held to
first.  (Here every transient gain is 1 to 1e-12: pressure-gradient
components of a velocity state sit at the pencil's infinite
eigenvalues, where a Crank-Nicolson step multiplies by -1, so the
marches are also held to the dense propagator vector by vector.)

Tolerances: gains rel 1e-6 (Lanczos to 1e-8); mode energies 1e-8, the
response residual 1e-8, the raw response's energy norm and the final
energy rel 1e-6 (``test_resolvent.py:93-94``, ``test_transient.py:60``);
resolvent norms rel 1e-5; shift-invert, raw and Cayley solves rel 1e-9
(refinement to 1e-10 against SuperLU); marches rel 1e-9; eigenvalues
1e-8; assembled matrices rel 1e-12 (f64 in another summation order).
Band plans are unpadded (``chunk=1``), as in ``test_torch_slice.py``.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp
from lsafw_tpu.config import BoundaryConditionsConfig as JBC
from lsafw_tpu.fem.assembly import AssemblyContext as JContext
from lsafw_tpu.fem.bcs import define_bcs as jdefine_bcs
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.meshing.mesh import rectangle_mesh as jrectangle_mesh
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.models import membrane as jmembrane
from lsafw_tpu.models.navier_stokes import LinearizedNavierStokesAssembler as JLinearized
from lsafw_tpu.resolvent import ResolventSolver as JResolvent
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu.solver import eigen2 as jeigen2
from lsafw_tpu.transient import TransientGrowthSolver as JTransient
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import define_bcs
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.models import membrane
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.resolvent import ResolventSolver
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver.eigen2 import ArpackEigenSolver, ShiftInvertConfig
from lsafw_tpu_torch.transient import TransientGrowthSolver
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

RE_LNS = 30.0
OMEGA, K = 0.8, 2
HORIZON, STEPS = 1.0, 4
Z_POINTS = (-0.5 + 0.8j, 0.2 - 0.3j)
A_SIDE, B_SIDE = 2.0, 4.0
# (method, matrices): the host LU on the JAX package's (A, M), the banded
# device path on the port's own assembly of them (equal to rel 1e-12)
RUNS = [("lu", "jax"), ("banded", "port")]


@pytest.fixture(scope="module", autouse=True)
def small_plans():
    """Band plans of the small systems unpadded (chunk 1) on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
    yield
    mp.undo()


def _marker(x):
    out = np.ones(x.shape[0], np.int32)
    out[np.isclose(x[:, 0], 1.0)] = 2
    return out


def _shear(spaces) -> np.ndarray:
    coords = spaces.velocity.dof_coords
    nu = spaces.num_velocity_dofs
    w = np.zeros(spaces.num_dofs)
    w[0:nu:2] = coords[0:nu:2, 1] * (1.0 - coords[0:nu:2, 1]) * 4.0
    return w


@pytest.fixture(scope="module")
def lns():
    """The JAX package's (A, M) of ``test_resolvent.py``'s case, carried
    into the port on one pattern, and the port's own assembly of the same
    case and baseflow."""
    mesh = jrectangle_mesh((0.0, 0.0), (1.0, 1.0), 6, 6)
    jmark(mesh, _marker)
    spaces = jdefine_spaces(mesh)
    bcs = jdefine_bcs(mesh, spaces, [
        JBC(marker=1, type="dirichlet_velocity", value=(0.0, 0.0)),
        JBC(marker=2, type="dirichlet_pressure", value=0.0)])
    w = _shear(spaces)
    JA, JM = JLinearized(jnp.asarray(w), JContext.build(spaces), RE_LNS, bcs,
                         mesh).assemble_eigensystem()
    As, Ms = JA.to_scipy(), JM.to_scipy()
    A = interop.csr_from_numpy(As.indptr, As.indices, As.data, As.shape, device="cpu")
    M = CSRMatrix(A.pattern, torch.as_tensor(Ms.data, dtype=torch.float64))

    tmesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), 6, 6)
    mark_boundary_facets(tmesh, _marker)
    tspaces = define_spaces(tmesh)
    tbcs = define_bcs(tmesh, tspaces, [
        BoundaryConditionsConfig(marker=1, type="dirichlet_velocity", value=(0.0, 0.0)),
        BoundaryConditionsConfig(marker=2, type="dirichlet_pressure", value=0.0)])
    PA, PM = LinearizedNavierStokesAssembler(w, AssemblyContext.build(tspaces, device="cpu"),
                                             RE_LNS, tbcs, tmesh).assemble_eigensystem()
    return dict(JA=JA, JM=JM, A=A, M=M, As=As, Ms=Ms, PA=PA, PM=PM, nu=spaces.num_velocity_dofs,
                mask=np.asarray(bcs.dirichlet_mask), port_mask=np.asarray(tbcs.dirichlet_mask))


def _fdofs(lns):
    fmask = np.zeros(lns["As"].shape[0], dtype=bool)
    fmask[:lns["nu"]] = True
    fmask &= ~lns["mask"]
    return np.nonzero(fmask)[0]


def _dense_gains(lns, z, k):
    """sqrt of the W-generalized eigenvalues of the dense T at C = z M - A."""
    Ad, Md = lns["As"].toarray(), lns["Ms"].toarray()
    fd = _fdofs(lns)
    Q = np.linalg.solve(z * Md - Ad, Md[:, fd])
    gam = sla.eigh(Q.conj().T @ Md @ Q, Md[np.ix_(fd, fd)], eigvals_only=True)
    return np.sqrt(np.maximum(gam[::-1][:k], 0.0))


def _dense_step(lns, dt):
    """The dense Crank-Nicolson step S = (M - dt/2 A)^-1 (M + dt/2 A)."""
    Ad, Md = lns["As"].toarray(), lns["Ms"].toarray()
    return np.linalg.solve(Md - 0.5 * dt * Ad, Md + 0.5 * dt * Ad)


def _dense_growth(lns, k):
    Md = lns["Ms"].toarray()
    fd = _fdofs(lns)
    B = np.linalg.matrix_power(_dense_step(lns, HORIZON / STEPS), STEPS)[:, fd]
    gam = sla.eigh(B.T @ Md @ B, Md[np.ix_(fd, fd)], eigvals_only=True)
    return np.maximum(gam[::-1][:k], 0.0)


@pytest.fixture(scope="module")
def reference(lns):
    """Dense gains, and the JAX package's host-LU gains, once."""
    JA, JM, nu, mask = lns["JA"], lns["JM"], lns["nu"], lns["mask"]
    return dict(
        resolvent=_dense_gains(lns, 1j * OMEGA, K), growth=_dense_growth(lns, K),
        norms=[_dense_gains(lns, z, 1)[0] for z in Z_POINTS],
        jax_resolvent=JResolvent(JA, JM, nu, mask, method="lu").solve(OMEGA, k=K).gains,
        jax_growth=JTransient(JA, JM, nu, mask, method="lu").solve(HORIZON, STEPS, k=1).gains)


def _pair(lns, source):
    if source == "jax":
        return lns["A"], lns["M"], lns["mask"]
    return lns["PA"], lns["PM"], lns["port_mask"]


@pytest.fixture(scope="module")
def resolvent_runs(lns):
    out = {}
    for method, source in RUNS:
        A, M, mask = _pair(lns, source)
        rs = ResolventSolver(A, M, lns["nu"], mask, method=method, device="cpu")
        out[(method, source)] = (rs, rs.solve(OMEGA, k=K))
    return out


@pytest.fixture(scope="module")
def growth_runs(lns):
    out = {}
    for method, source in RUNS:
        A, M, mask = _pair(lns, source)
        ts = TransientGrowthSolver(A, M, lns["nu"], mask, method=method, device="cpu")
        out[(method, source)] = (ts, ts.solve(HORIZON, STEPS, k=K))
    return out


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_port_assembly_matches_jax(lns):
    """The slice's own (A, M): the port's assembly of the same case."""
    assert np.array_equal(lns["port_mask"], lns["mask"])
    for port, ref in ((lns["PA"], lns["As"]), (lns["PM"], lns["Ms"])):
        assert abs(port.to_scipy() - ref).max() <= 1e-12 * abs(ref).max()


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_resolvent_gains_match_dense_and_jax(resolvent_runs, reference, run):
    rs, modes = resolvent_runs[run]
    assert _rel(modes.gains, reference["resolvent"]) <= 1e-6, (modes.gains, reference)
    assert _rel(modes.gains, reference["jax_resolvent"]) <= 1e-6
    op = rs.operators["direct"]
    assert op["fused"] == op["pivoted"] == (run[0] == "banded")


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_resolvent_modes_identities(lns, resolvent_runs, run):
    """Unit energies; the response solves (i omega M - A)(g q) = M f; the
    raw response C^-1 M f has the gain for its energy norm; the forcing
    is zero on pressure and Dirichlet DOFs."""
    _, modes = resolvent_runs[run]
    Ms = lns["Ms"]
    C = 1j * OMEGA * Ms - lns["As"]
    for f, q, g in zip(modes.forcings, modes.responses, modes.gains):
        assert abs(np.vdot(f, Ms @ f).real - 1.0) < 1e-8
        assert abs(np.vdot(q, Ms @ q).real - 1.0) < 1e-8
        assert np.linalg.norm(C @ (g * q) - Ms @ f) <= 1e-8 * np.linalg.norm(Ms @ f)
        q_raw = spla.spsolve(C.tocsc(), Ms @ f)
        assert abs(np.sqrt(np.vdot(q_raw, Ms @ q_raw).real) - g) < 1e-6 * g
        assert not f[lns["nu"]:].any() and not f[lns["mask"]].any()


@pytest.mark.parametrize("method", ["lu", "banded"])
def test_resolvent_norm_matches_dense(lns, reference, method):
    """||R(z)||_E at two complex points, the second through a one-point
    pseudospectrum grid."""
    rs = ResolventSolver(lns["A"], lns["M"], lns["nu"], lns["mask"], method=method, device="cpu")
    (z0, z1), (ref0, ref1) = Z_POINTS, reference["norms"]
    got = rs.resolvent_norm(z0, tol=1e-9)
    assert abs(got - ref0) < 1e-5 * ref0, (z0, got, ref0)
    G = rs.pseudospectrum([z1.real], [z1.imag], tol=1e-9)
    assert G.shape == (1, 1) and abs(G[0, 0] - ref1) < 1e-5 * ref1, (z1, G, ref1)


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_transient_gains_match_dense_and_jax(lns, growth_runs, reference, run):
    """Gains against the dense Crank-Nicolson propagator, then the JAX
    package's; the marches of one state against the dense propagator and
    its transpose; unit initial energy and the final energy equal to the
    gain."""
    ts, res = growth_runs[run]
    assert _rel(res.gains, reference["growth"]) <= 1e-6, (res.gains, reference["growth"])
    assert abs(res.gains[0] - reference["jax_growth"][0]) <= 1e-6 * reference["jax_growth"][0]
    Ms = lns["Ms"]
    for q0, qT, g in zip(res.initials, res.finals, res.gains):
        assert abs(q0 @ (Ms @ q0) - 1.0) < 1e-8
        assert abs(qT @ (Ms @ qT) - g) < 1e-6 * max(g, 1.0)
        assert not q0[lns["nu"]:].any() and not q0[lns["mask"]].any()
    S = _dense_step(lns, HORIZON / STEPS)
    fw, ad, s = ts._propagators(HORIZON / STEPS)
    x = np.random.default_rng(3).standard_normal(S.shape[0])
    xt = torch.as_tensor(x)
    assert _rel(ts._march(fw, xt, STEPS).numpy(), np.linalg.matrix_power(S, STEPS) @ x) <= 1e-9
    assert _rel(ts._march_adjoint(ad, s, xt, STEPS).numpy(),
                np.linalg.matrix_power(S.T, STEPS) @ x) <= 1e-9
    assert ts.operators["forward"]["fused"] == (run[0] == "banded")


SHIFTS = {"complex": (0.3 + 0.8j, -0.2 + 0.5j), "real": (8.0, 8.0)}


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_shift_invert_operators_match_jax(lns, shift):
    """apply, solve_raw and the Cayley apply of ``"lu"`` and ``"banded"``
    against the JAX package's ``"lu"``; at a real shift an f64 vector
    stays f64 through the real factor."""
    sigma, nu = SHIFTS[shift]
    rng = np.random.default_rng(5)
    n = lns["As"].shape[0]
    v = rng.standard_normal(n) + (1j * rng.standard_normal(n) if shift == "complex" else 0)
    jv = (jnp.asarray(v.real), jnp.asarray(np.imag(v) * 1.0))
    ref = {}
    for name, anti in (("apply", None), ("cayley", nu)):
        jop = jeigen.ShiftInvertOperator(lns["JA"], lns["JM"], sigma, method="lu", antishift=anti)
        yr, yi = jop.apply(jv)
        ref[name] = np.asarray(yr) + 1j * np.asarray(yi)
        if anti is None:
            rr, ri = jop.solve_raw(jv)
            ref["solve_raw"] = np.asarray(rr) + 1j * np.asarray(ri)
    vt = torch.as_tensor(v)
    for method in ("lu", "banded"):
        op = teigen.ShiftInvertOperator(lns["A"], lns["M"], sigma, method=method)
        cay = teigen.ShiftInvertOperator(lns["A"], lns["M"], sigma, method=method, antishift=nu)
        got = dict(apply=op.apply(vt), solve_raw=op.solve_raw(vt), cayley=cay.apply(vt))
        for name, y in got.items():
            assert y.dtype == vt.dtype, (method, name, y.dtype)
            assert _rel(y.numpy(), ref[name]) <= 1e-9, (method, name)
        lam = cay.back_transform(np.asarray([2.0 + 1j]))
        assert abs(lam[0] - (sigma * (2.0 + 1j) + nu) / (1.0 + 1j)) <= 1e-14


@pytest.fixture(scope="module")
def membrane_case():
    """The membrane at n = 4 (P2) through both packages, the JAX pair's
    dense spectrum, and the port's SINVERT eigenpairs at 1.5."""
    jK, jM, jmask = jmembrane.assemble_membrane_evp(jrectangle_mesh((0, 0), (A_SIDE, B_SIDE), 4, 4))
    K, M, mask = membrane.assemble_membrane_evp(rectangle_mesh((0, 0), (A_SIDE, B_SIDE), 4, 4),
                                                device="cpu")
    Kd, Md = jK.to_scipy().toarray(), jM.to_scipy().toarray()
    free = ~np.asarray(jmask)
    dense = np.sort(sla.eigh(Kd[np.ix_(free, free)], Md[np.ix_(free, free)], eigvals_only=True))
    return dict(jK=jK, jM=jM, jmask=np.asarray(jmask), K=K, M=M, mask=mask, dense=dense[:4],
                sinvert=_membrane_eigs(K, M, teigen.STType.SINVERT))


def _membrane_eigs(K, M, st, method="banded"):
    es = teigen.EigenSolver(K, M, teigen.EigensolverConfig(num_eig=4, atol=1e-10, ncv=24))
    es.set_st_type(st)
    es.set_target(1.5)
    es.set_st_pc_type(method)
    pairs = es.solve()
    return np.sort([p[0].real for p in pairs]), es


def test_membrane_matches_analytic_and_jax(membrane_case):
    """(K, M) equal the JAX package's; the first four eigenvalues (the
    real-shift banded solve: a real factor, complex Krylov vectors) equal
    the JAX pair's discrete spectrum and are no farther from the analytic
    values than the JAX package's discretization is at n = 4."""
    mc = membrane_case
    assert np.array_equal(mc["mask"], mc["jmask"])
    for port, ref in ((mc["K"], mc["jK"]), (mc["M"], mc["jM"])):
        assert abs(port.to_scipy() - ref.to_scipy()).max() <= 1e-12 * abs(ref.to_scipy()).max()
    got, es = mc["sinvert"]
    assert np.abs(got - mc["dense"]).max() <= 1e-8 * mc["dense"].max()
    exact = membrane.analytic_eigenvalues(A_SIDE, B_SIDE, 4)
    assert np.array_equal(exact, jmembrane.analytic_eigenvalues(A_SIDE, B_SIDE, 4))
    assert np.array_equal(membrane.analytic_eigenvalues_3d(1.0, 2.0, 3.0, 5),
                          jmembrane.analytic_eigenvalues_3d(1.0, 2.0, 3.0, 5))
    jax_err = np.abs(mc["dense"] - exact) / exact
    assert (np.abs(got - exact) / exact <= jax_err * (1 + 1e-6) + 1e-12).all()
    assert es.operator.pivoted and es.operator.device_op.blu.band.dtype == torch.float32


@pytest.mark.parametrize("method", ["banded", "lu"])
def test_eigensolver_cayley_matches_sinvert(membrane_case, method):
    """CAYLEY (antishift defaulting to the target) and SINVERT give the
    same eigenvalues; so does the host ``"lu"`` when asked for."""
    mc = membrane_case
    got, es = _membrane_eigs(mc["K"], mc["M"], teigen.STType.CAYLEY, method)
    assert np.abs(got - mc["sinvert"][0]).max() <= 1e-8
    assert es.operator.antishift == 1.5 and es.operator.method == method


def test_arpack_matches_jax(membrane_case):
    mc = membrane_case
    cfg = dict(sigma=1.5, num_eig=4, tol=1e-12)
    got = np.sort([p[0].real for p in ArpackEigenSolver(mc["K"], mc["M"],
                                                        ShiftInvertConfig(**cfg)).solve()])
    ref = np.sort([p[0].real for p in jeigen2.ArpackEigenSolver(
        mc["jK"], mc["jM"], jeigen2.ShiftInvertConfig(**cfg)).solve()])
    assert np.allclose(got, ref, rtol=1e-9, atol=0) and np.allclose(got, mc["dense"], rtol=1e-9)
