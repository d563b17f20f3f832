"""The nested (two-grid) eigen refinement and the element-operator
refinement matvecs of the port, on the CPU at small sizes.

* ``nested_eigenpair`` on tests/unit/test_eigen.py's 12 x 12 membrane
  from a noisy guess with 1e-2 correction solves; ``TwoGridSIPC`` on its
  10 x 10 / 26 x 26 membranes at sigma = 19 + 0.3j in the designs of
  test_eigen.py:347-503 (a hard-truncated band with the additive coarse
  term; ``DiagSIPC`` multiplicative, smooth_steps 2, omega 0.7) and the ``galerkin_pair`` coarse as a bare
  band factor with the Galerkin sandwich apply; the truncated band alone
  as the control.  Each theta is held to the pencil's eigenvalue from
  scipy's ``eigsh`` at 1e-9 (the gate test_eigen.py holds the JAX
  package's nested theta to, against its own solve) and its true residual
  to test_eigen.py's gates; the control as test_eigen.py holds it.  The
  JAX package's own runs of these cost about 50 s of CPU each (its band
  factor and GCR programs compile per shape), so its numbers enter
  through the outer step: ``_nested_prepare`` (the normalisation, the
  gated Rayleigh update and the residual the outer loop judges) against
  the JAX package's on the same vectors, 1e-12, and the two-grid
  transfers (``_restrict``, ``_prolong``, ``coarse_deflation``) against
  its, 1e-14.
* ``set_elements`` on test_torch_fem.py's small cylinder (a seeded base
  state): with ``LSAFW_BCSR_MEM_GB=0`` the refinement matvecs are the
  element operators (no S operator), and sigma agrees with the S path's
  within 1e-10; ``ResolventSolver`` and ``TransientGrowthSolver`` pass
  ``elements=`` to the direct operator.

Band plans at nb = 32 (``LSAFW_BAND_NB``): the plain substitution loops
of the CPU cost per block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.ops import sparse as jsparse
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu_torch.fem.spaces import make_scalar_space
from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver.baseflow import point_interpolation_matrix
from lsafw_tpu_torch.solver.eigen import (BandedSIOp, DiagSIPC, EigenSolver, EigensolverConfig,
                                          ShiftInvertOperator, STType, TwoGridSIPC, ell_of_csr,
                                          galerkin_pair, nested_eigenpair)
from tests.test_torch_fem import cylinder_case, one_blas_thread  # noqa: F401

torch.set_num_threads(1)

SIGMA = 19.0 + 0.3j  # test_eigen.py:370


@pytest.fixture(scope="module", autouse=True)
def nb32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LSAFW_BAND_NB", "32")
        yield


def _membrane(nx: int) -> dict:
    mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), nx, nx)
    K, M, mask = assemble_membrane_evp(mesh, device="cpu")
    lam = spla.eigsh(K.to_scipy(), k=1, M=M.to_scipy(), sigma=19.0, return_eigenvectors=False)
    return dict(K=K, M=M, mask=mask, space=make_scalar_space(mesh, "p2"), lam=float(lam[0]))


def _true(m: dict, th: complex, v: np.ndarray) -> float:
    Ks, Ms = m["K"].to_scipy(), m["M"].to_scipy()
    return float(np.linalg.norm(Ks @ v - th * (Ms @ v)) / np.linalg.norm(Ks @ v))


def _jop(m: dict, sigma: complex) -> jeigen.BandedSIOp:
    """The JAX package's shift-invert state of the same CSR pair (no band
    factor: its outer step needs none)."""
    pat = m["K"].pattern
    jp = jsparse.SparsityPattern(shape=pat.shape, indptr=pat.indptr, indices=pat.indices,
                                 slots=pat.slots)
    return jeigen.BandedSIOp(jsparse.CSRMatrix(jp, jnp.asarray(m["K"].data.numpy())),
                             jsparse.CSRMatrix(jp, jnp.asarray(m["M"].data.numpy())), None,
                             jnp.asarray(sigma.real), jnp.asarray(sigma.imag))


def test_nested_eigenpair_inexact_refinement():
    """test_eigen.py:310's case: an interpolation-grade guess (the pair
    plus 5% noise) refined with 1e-2 correction solves on a factor at
    lambda + 0.4; and the outer step against the JAX package's."""
    m = _membrane(12)
    es = EigenSolver(m["K"], m["M"], EigensolverConfig(num_eig=1, atol=1e-10, ncv=12))
    es.set_st_type(STType.SINVERT)
    es.set_target(19.0)
    lam, x = es.solve()[0]
    sio = ShiftInvertOperator(m["K"], m["M"], complex(lam) + 0.4, method="banded")
    rng = np.random.default_rng(0)
    v0 = x + 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    th, v, rel, it = nested_eigenpair(sio.device_op, v0, complex(lam) + 0.3, tol=1e-10,
                                      inner_tol=1e-2, inner_its=40, max_outer=25,
                                      bc_mask=m["mask"])
    assert abs(th - m["lam"]) / m["lam"] < 1e-9 and abs(th - lam) / abs(lam) < 1e-9
    assert _true(m, th, v) < 1e-9 and it <= 20
    # the outer step (M-normalise, Rayleigh update gated at rel 0.1, residual)
    # on the guess at the shifted start and on the converged pair
    for vec, theta in ((np.where(m["mask"], 0.0, v0), complex(lam) + 0.3), (v, th)):
        got = teigen._nested_prepare(sio.device_op, torch.as_tensor(vec), theta)
        jv = jeigen._nested_prepare(_jop(m, complex(lam) + 0.4), jnp.asarray(vec.real),
                                    jnp.asarray(vec.imag), jnp.asarray(theta.real),
                                    jnp.asarray(theta.imag))
        want = np.asarray(jv[0]) + 1j * np.asarray(jv[1])
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
        # the residual and its rel to 1e-10 relative, over the 1e-13 floor of
        # an f64 residual's evaluation (|A v| ~ |theta| |M v|)
        rw = np.asarray(jv[4]) + 1j * np.asarray(jv[5])
        scale = abs(theta) * np.linalg.norm(got[1].numpy())
        assert np.linalg.norm(got[2].numpy() - rw) <= 1e-10 * np.linalg.norm(rw) + 1e-13 * scale
        assert abs(got[3] - complex(float(jv[6]), float(jv[7]))) <= 1e-12 * abs(got[3])
        assert abs(got[4] - float(jv[8])) <= 1e-10 * float(jv[8]) + 1e-13


@pytest.fixture(scope="module")
def grids(nb32):
    """test_eigen.py:347's pair: the 10 x 10 coarse membrane (its exact band
    shift-invert at sigma, its eigenpair near 19), the 26 x 26 fine one, P
    and the guess P x_c, the fine C through S, a band truncated to B nb <
    100 (nb 16, test_eigen.py's budget) and the Galerkin pair's factor."""
    c, f = _membrane(10), _membrane(26)
    sio_c = ShiftInvertOperator(c["K"], c["M"], SIGMA, method="banded")
    es = EigenSolver(c["K"], c["M"], EigensolverConfig(num_eig=1, atol=1e-10, ncv=12))
    es.set_st_type(STType.SINVERT)
    es.set_target(19.0)
    lam_c, x_c = es.solve()[0]
    P = point_interpolation_matrix(c["space"].node_coords, f["space"].node_coords)
    K, M = f["K"], f["M"]
    Cre = CSRMatrix(K.pattern, K.data - SIGMA.real * M.data)
    plan = tband.plan_for_csr(Cre, max_bytes=600_000, nb=16, chunk=8)
    assert plan.B * plan.nb < 100  # genuinely truncated
    trunc = tband.factor_auto(plan, Cre.data, (-SIGMA.imag) * M.data,
                              diag_slots=K.pattern.diag_slots)[0]
    A_g, M_g = galerkin_pair(P, K, M)
    blu_g = tband.factor_auto(tband.plan_for_csr(A_g), A_g.data - SIGMA.real * M_g.data,
                              (-SIGMA.imag) * M_g.data, diag_slots=A_g.pattern.diag_slots)[0]
    Pd, Pc = ell_of_csr(P, device="cpu")
    return dict(c=c, f=f, sio_c=sio_c, lam_c=lam_c, x_c=x_c, P=P, v0=P @ x_c, Pd=Pd, Pc=Pc,
                Cop=BCSRShiftedOp.from_csr(K, M, SIGMA), trunc=trunc, blu_g=blu_g,
                jac=DiagSIPC.from_pair(K, M, SIGMA))


def _design(g: dict, name: str):
    """(op, resid_op) of a two-grid design or of the control."""
    f, kw = g["f"], dict(nc=g["P"].shape[1], coarse_tol=1e-8, coarse_its=25)
    K, M, Cop = f["K"], f["M"], g["Cop"]
    rop = BandedSIOp(K, M, None, SIGMA, Cop)
    coarse = g["sio_c"].device_op
    if name == "truncated band, additive":
        return BandedSIOp(K, M, TwoGridSIPC(coarse, g["trunc"], g["Pd"], g["Pc"], **kw), SIGMA,
                          Cop), None
    if name == "DiagSIPC, multiplicative":
        return BandedSIOp(K, M, TwoGridSIPC(coarse, g["jac"], g["Pd"], g["Pc"], Cop=Cop,
                                            smooth_steps=2, omega=0.7, **kw), SIGMA), rop
    if name == "Galerkin bare band":
        return BandedSIOp(K, M, TwoGridSIPC(g["blu_g"], g["jac"], g["Pd"], g["Pc"], Cop=Cop,
                                            sig0=SIGMA, smooth_steps=2, omega=0.7, **kw),
                          SIGMA), rop
    return BandedSIOp(K, M, g["trunc"], SIGMA, Cop), None  # the control


def _run(g: dict, name: str):
    """test_eigen.py's nested run (15 outer steps; the control, which
    stalls, 6)."""
    op, rop = _design(g, name)
    return nested_eigenpair(op, g["v0"], g["lam_c"], tol=1e-9, inner_tol=1e-4, inner_its=60,
                            max_outer=6 if name == "control" else 15, bc_mask=g["f"]["mask"],
                            resid_op=rop)


@pytest.mark.parametrize("name", ["truncated band, additive", "DiagSIPC, multiplicative",
                                  "Galerkin bare band"])
def test_two_grid_designs(grids, name):
    """Each design reaches the fine eigenvalue (1e-9) with a true residual
    below 1e-8 and reports that residual; the truncated design beats the
    control as test_eigen.py requires."""
    th, v, rel, it = _run(grids, name)
    f = grids["f"]
    true = _true(f, th, v)
    assert abs(th - f["lam"]) / f["lam"] < 1e-9 and true < 1e-8, (th, true)
    if name == "truncated band, additive":
        th1, v1, rel1, it1 = _run(grids, "control")
        true1 = _true(f, th1, v1)
        assert true < 1e-2 * max(true1, 1e-30) or true1 < 1e-8


def test_two_grid_transfers_match_jax(grids):
    """P's restriction (a segmented sum over the sorted coarse targets),
    prolongation and the coarse deflation against the JAX package's."""
    g = grids
    pc = TwoGridSIPC(g["sio_c"].device_op, None, g["Pd"], g["Pc"], nc=g["P"].shape[1])
    jPd, jPc = jeigen.ell_of_csr(g["P"])
    jpc = jeigen.TwoGridSIPC(None, None, jPd, jPc, nc=g["P"].shape[1])
    rng = np.random.default_rng(8)
    b = rng.standard_normal(g["P"].shape[0]) + 1j * rng.standard_normal(g["P"].shape[0])
    r = pc._restrict(torch.as_tensor(b)).numpy()
    jr = np.asarray(jpc._restrict(jnp.asarray(b.real))) + 1j * np.asarray(
        jpc._restrict(jnp.asarray(b.imag)))
    np.testing.assert_allclose(r, g["P"].T @ b, rtol=0, atol=1e-14 * np.abs(r).max())
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-14 * np.abs(r).max())
    assert torch.equal(pc._restrict(torch.as_tensor(b)), pc._restrict(torch.as_tensor(b)))
    z = r[: g["P"].shape[1]]
    p = pc._prolong(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(p, g["P"] @ z, rtol=0, atol=1e-14 * np.abs(p).max())
    xc, Mxc = TwoGridSIPC.coarse_deflation(g["x_c"], g["c"]["M"])
    jx = jeigen.TwoGridSIPC.coarse_deflation(g["x_c"], CSRMatrix(g["c"]["M"].pattern,
                                                                 g["c"]["M"].data))
    np.testing.assert_allclose(xc.numpy(), np.asarray(jx[0]) + 1j * np.asarray(jx[1]),
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(Mxc.numpy(), np.asarray(jx[2]) + 1j * np.asarray(jx[3]),
                               rtol=1e-14, atol=0)


@pytest.fixture(scope="module")
def cylinder():
    """The small cylinder's eigensystem around a seeded base state and its
    element matrices (both through the port)."""
    case = cylinder_case("lsafw_tpu_torch", device="cpu")
    n = case["spaces"].num_dofs
    w = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal(n))
    asm = case["ns"].LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                                     case["mesh"])
    A, M = asm.assemble_eigensystem()
    return case, A, M, asm.element_matrices()


def _sigma(case, A, M, elements=None) -> tuple[complex, object]:
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-10, ncv=12))
    es.set_st_type(STType.SINVERT)
    es.set_target(-0.02 + 0.15j)  # near the seeded base's pair at -0.0257+0.1431j
    if elements is not None:
        A_el, M_el, dofs = elements
        es.set_elements(case["ctx"], A_el, M_el, case["bcs_pert"].dirichlet_mask, dofs=dofs)
    return es.solve()[0][0], es.operator


def test_set_elements_carries_the_refinement(cylinder, monkeypatch):
    case, A, M, elements = cylinder
    sig_s, op_s = _sigma(case, A, M)
    assert op_s.device_op.Cop is not None and op_s.device_op.Mop is None
    monkeypatch.setenv("LSAFW_BCSR_MEM_GB", "0")
    sig_e, op_e = _sigma(case, A, M, elements)
    d = op_e.device_op
    assert type(d.Cop).__name__ == "CElementOperator" and d.Mop is not None
    assert op_e.figures()["elements"]
    assert abs(sig_e - sig_s) <= 1e-10 * max(abs(sig_s), 1.0), (sig_e, sig_s)
    # the shift cannot be retargeted into element values: dropped for the CSR pair
    d2 = teigen._with_sigma(d, sig_e)
    assert d2.Cop is None and d2.Mop is d.Mop and d2.sigma == sig_e


def test_nonmodal_solvers_pass_elements(cylinder, monkeypatch):
    """``ResolventSolver`` and ``TransientGrowthSolver`` give the direct
    operator the element matrices (the adjoint has none)."""
    from lsafw_tpu_torch.resolvent import ResolventSolver
    from lsafw_tpu_torch.transient import TransientGrowthSolver

    case, A, M, (A_el, M_el, dofs) = cylinder
    monkeypatch.setenv("LSAFW_BCSR_MEM_GB", "0")
    els = (dofs, A_el, M_el, case["bcs_pert"].dirichlet_mask)
    args = (A, M, case["spaces"].num_velocity_dofs, case["bcs_pert"].dirichlet_mask)
    rs = ResolventSolver(*args, elements=els, device="cpu")
    si1, si2 = rs._si_pair(0.5j)
    assert si1.device_op.Mop is not None and si2.device_op.Mop is None
    tg = TransientGrowthSolver(*args, elements=els, device="cpu")
    fw, ad, _ = tg._propagators(0.25)
    assert fw.device_op.Mop is not None and fw.device_op.Cop.El_im is None
    assert ad.device_op.Mop is None
