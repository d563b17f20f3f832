"""Outer residual histories of both packages' two-grid nested refinement on
Navier-Stokes, on the CPU, from identical inputs.

    JAX_PLATFORMS=cpu python scripts/torch_two_grid_histories.py [MAX_OUTER]

The fine grid is the small cylinder of ``tests/test_torch_fem.py``
(resolution 1.0, 0.3 around the cylinder), the coarse one the same
domain at resolution 1.6 / 0.5, both at Re = 47 with the JAX package's
host-LU baseflows and (A, M).  From the JAX side's arrays (A, M, the
prolongation P, the coarse eigenpair by scipy's shift-invert ``eigs`` at
0.74j and the guess P x_c) both packages run ``nested_eigenpair`` with
the multiplicative ``TwoGridSIPC`` of ``DiagSIPC`` as ``chip_smoke.py``
phase 13c runs it at 43k (coarse tol 1e-2 in 12 GCR steps, inner tol
1e-4 in 30, m = 16, the fine C at 0.74j); each prints its outer and
inner residuals per step.  Band plans at nb = 32 (``LSAFW_BAND_NB``).
About 80 s of CPU.
"""

import importlib
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse.linalg as spla

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("LSAFW_BAND_NB", "32")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import tests.test_torch_fem as tf  # noqa: E402

TARGET = 0.74j


def case(root: str, res: float, around: float) -> dict:
    """The cylinder at one resolution through the JAX package ``root``."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    C = mod("config").BoundaryConditionsConfig
    geo = mod("config").CylinderFlowGeometryConfig(
        dim=2, cylinder_radius=0.5, cylinder_center=(0.0, 0.0), x_range=(tf.X0, tf.X1),
        y_range=(tf.Y0, tf.Y1), resolution=res, resolution_around_cylinder=around,
        influence_radius=4.0)
    mesh = mod("meshing.geometries").cylinder_flow_mesh(geo, max_iter=40, seed=0)
    mod("meshing.tags").mark_boundary_facets(mesh, tf._marker)
    spaces = mod("fem.spaces").define_spaces(mesh)
    db = mod("fem.bcs").define_bcs
    zero = (0.0, 0.0)
    bb = db(mesh, spaces, [
        C(marker=tf.INLET, type="dirichlet_velocity", value=(1.0, 0.0)),
        C(marker=tf.BOTTOM, type="neumann_velocity", value=zero),
        C(marker=tf.TOP, type="neumann_velocity", value=zero),
        C(marker=tf.OUTLET, type="dirichlet_pressure", value=0.0),
        C(marker=tf.CYL, type="dirichlet_velocity", value=zero)])
    bp = db(mesh, spaces, [
        C(marker=tf.INLET, type="dirichlet_velocity", value=zero),
        C(marker=tf.CYL, type="dirichlet_velocity", value=zero),
        C(marker=tf.OUTLET, type="dirichlet_pressure", value=0.0)])
    ctx = mod("fem.assembly").AssemblyContext.build(spaces)
    w = np.asarray(mod("solver.baseflow").BaseFlowSolver(ctx, mesh, bb, re=47.0).solve(
        ramp=True, steps=3, tol=1e-10))
    A, M = mod("models.navier_stokes").LinearizedNavierStokesAssembler(
        w, ctx, 47.0, bp, mesh).assemble_eigensystem()
    return dict(spaces=spaces, A=A, M=M, mask=np.asarray(bp.dirichlet_mask))


class History(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if "nested_eigenpair" in record.getMessage():
            self.lines.append(record.getMessage())


def run(root: str, fn) -> tuple:
    h = History()
    log = logging.getLogger(root)
    log.addHandler(h)
    log.setLevel(logging.INFO)
    t0 = time.time()
    try:
        th, _, rel, it = fn()
    finally:
        log.removeHandler(h)
    return th, rel, it, h.lines, time.time() - t0


def main(max_outer: int) -> None:
    import jax.numpy as jnp
    import torch

    from lsafw_tpu.ops.bcsr import BCSRShiftedOp as JCop
    from lsafw_tpu.solver import baseflow as jb
    from lsafw_tpu.solver import eigen as je
    from lsafw_tpu_torch import interop
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver import eigen as te

    f, c = case("lsafw_tpu", 1.0, 0.3), case("lsafw_tpu", 1.6, 0.5)
    Af, Mf, Ac, Mc = (x.to_scipy().tocsr() for x in (f["A"], f["M"], c["A"], c["M"]))
    wc, vc = spla.eigs(Ac.tocsc(), k=1, M=Mc.tocsc(), sigma=TARGET)
    sig_c, x_c = complex(wc[0]), vc[:, 0]
    wf, _ = spla.eigs(Af.tocsc(), k=1, M=Mf.tocsc(), sigma=TARGET)
    sig_f = complex(wf[0])
    P = jb.interpolation_matrix(c["spaces"], f["spaces"]).tocsr()
    v0 = P @ x_c
    print(f"fine {Af.shape[0]} DOFs, sigma_f {sig_f:.10f}; coarse {Ac.shape[0]} DOFs, sigma_c "
          f"{sig_c:.10f}; P {P.shape} ({P.nnz} entries)")
    kw = dict(tol=1e-10, inner_tol=1e-4, inner_its=30, m=16, max_outer=max_outer,
              bc_mask=f["mask"])
    tg = dict(nc=P.shape[1], coarse_tol=1e-2, coarse_its=12)

    sr, si = jnp.asarray(TARGET.real), jnp.asarray(TARGET.imag)
    Pd, Pc = je.ell_of_csr(P)
    jpc = je.TwoGridSIPC(
        je.ShiftInvertOperator(c["A"], c["M"], TARGET, method="banded",
                               skip_calibration=True).device_op,
        je.DiagSIPC.from_pair(f["A"], f["M"], TARGET), Pd, Pc,
        Cop=JCop.from_csr(f["A"], f["M"], TARGET, br=16, bc=16),
        cproj=je.TwoGridSIPC.coarse_deflation(x_c, c["M"]), **tg)
    out = {"jax": run("lsafw_tpu", lambda: je.nested_eigenpair(
        je.BandedSIOp(f["A"], f["M"], jpc, sr, si, None, None), v0, sig_c,
        resid_op=je.BandedSIOp(f["A"], f["M"], None, sr, si, None, None), **kw))}

    def pair(A, M):
        tA = interop.csr_from_numpy(A.indptr, A.indices, A.data, A.shape, device="cpu")
        return tA, CSRMatrix(tA.pattern, torch.as_tensor(M.data.copy()))

    assert all((X.indptr == Y.indptr).all() and (X.indices == Y.indices).all()
               for X, Y in ((Af, Mf), (Ac, Mc))), "A and M on one pattern"
    tAf, tMf = pair(Af, Mf)
    tAc, tMc = pair(Ac, Mc)
    tPd, tPc = te.ell_of_csr(P, device="cpu")
    tCop = BCSRShiftedOp.from_csr(tAf, tMf, TARGET)
    tpc = te.TwoGridSIPC(te.ShiftInvertOperator(tAc, tMc, TARGET, method="banded").device_op,
                         te.DiagSIPC.from_pair(tAf, tMf, TARGET), tPd, tPc, Cop=tCop,
                         cproj=te.TwoGridSIPC.coarse_deflation(x_c, tMc), **tg)
    out["port"] = run("lsafw_tpu_torch", lambda: te.nested_eigenpair(
        te.BandedSIOp(tAf, tMf, tpc, TARGET), v0, sig_c,
        resid_op=te.BandedSIOp(tAf, tMf, None, TARGET, tCop), **kw))
    for k, (th, rel, it, lines, sec) in out.items():
        print(f"{k}: theta {th:.10f}, rel {rel:.3e} after {it} outer steps ({sec:.1f} s), "
              f"|theta - sigma_f| {abs(th - sig_f):.2e}")
        for line in lines:
            print("   ", line)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
