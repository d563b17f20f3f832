"""The command line of the port: ``python -m lsafw_tpu_torch <subcommand>``.

Counterpart of the reference's ``cli``, with its eleven subcommands and
their flags:

  mesh        generate or import a mesh, tag its boundary, cache or export it
  benchmark   generate a predefined benchmark geometry (cylinder, step)
  baseflow    steady Navier-Stokes solve, export of the baseflow
  assemble    baseflow + linearized eigensystem -> A.mtx, M.mtx
  eigen       shift-invert eigensolve of (A, M) read from A.mtx, M.mtx
  sensitivity adjoint d sigma / d Re and the wavemaker
  resolvent   optimal harmonic forcing gains sigma_1(omega)
  transient   optimal transient energy growth G(T)
  span        quasi-3D stability sigma(beta) of a 2D baseflow
  scm         self-consistent mean-flow model (and its Re-continuation)
  wnl         weakly nonlinear Stuart-Landau expansion at the Hopf point

Differences from the reference, by design:

* ``--platform`` is ``cuda`` (the default) or ``cpu``.  Without a CUDA
  device and without ``--platform cpu`` a command exits 1 with a message
  naming the missing device; it never falls back to the CPU.
* The solvers take the card's methods: every Newton solve (baseflow,
  the SCM's mean) runs on the band factor, and ``--si-method`` (``lu``,
  ``banded``, ``gmres``) defaults to ``banded``; the host ``lu`` runs only
  when named.
* ``--distributed`` joins the process group of a ``torch.distributed``
  launch (``torchrun``'s environment; ``parallel.initialize_distributed``),
  after the device check.  No subcommand calls a sharded solver, so rank 0
  runs the subcommand alone and the other ranks return 0 once they have
  joined: replicated on every rank, it would compute the same result N
  times and N writers would race on its output files and cache.

Every other error exits 1 with the error logged, as the reference's
commands do.  ``--plot`` (matplotlib) and ``.xdmf`` exports (h5py) import
their modules only when asked for.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from lsafw_tpu_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def _build_case(args):
    """Mesh, spaces, BCs and assembly context of a solver command, the
    context on ``args.device``."""
    from lsafw_tpu_torch.config import (
        load_bc_config,
        load_cylinder_flow_config,
        load_facet_config,
        load_step_flow_config,
    )
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.mesh import Shape, generate_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    if getattr(args, "from_file", None):
        from lsafw_tpu_torch.meshing.io import from_file

        mesh = from_file(args.from_file)
    else:
        shape = Shape.from_string(args.shape)
        kw = {}
        if args.geometry_config:
            if shape is Shape.CYLINDER_FLOW:
                kw["config"] = load_cylinder_flow_config(args.geometry_config)
            elif shape is Shape.STEP_FLOW:
                kw["config"] = load_step_flow_config(args.geometry_config)
        if args.n:
            kw.update(dict(zip(("nx", "ny", "nz"), args.n)))
            if shape is Shape.UNIT_INTERVAL:
                kw = {"n": args.n[0]}
        mesh = generate_mesh(shape, **kw)
    if args.facet_config:
        mark_boundary_facets(mesh, load_facet_config(args.facet_config))
    spaces = define_spaces(mesh, args.space_type)
    bcs = None
    if args.bc_config:
        bcs = define_bcs(mesh, spaces, load_bc_config(args.bc_config))
    ctx = AssemblyContext.build(spaces, device=args.device)
    return mesh, spaces, bcs, ctx


def _pert_bcs(args, mesh, spaces, bcs):
    """The perturbation BCs: ``--perturbation-bc-config``, else the base
    BCs made homogeneous."""
    from lsafw_tpu_torch.config import load_bc_config
    from lsafw_tpu_torch.fem.bcs import define_bcs

    if getattr(args, "perturbation_bc_config", None):
        return define_bcs(mesh, spaces, load_bc_config(args.perturbation_bc_config))
    return bcs.homogeneous()


def _baseflow(args, ctx, mesh, bcs, re=None):
    """The banded Newton baseflow of a solver command at ``re`` (default
    ``--re``)."""
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    return BaseFlowSolver(ctx, mesh, bcs, re=args.re if re is None else re).solve(
        ramp=args.ramp, steps=args.steps, tol=args.tol, max_it=args.max_it,
        damping_factor=args.damping, linear_solver="banded")


def _add_case_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shape", default="cylinder_flow")
    p.add_argument("--n", type=int, nargs="*", default=None, help="structured mesh divisions")
    p.add_argument("--geometry-config", type=Path, default=None)
    p.add_argument("--facet-config", type=Path, default=None)
    p.add_argument("--bc-config", type=Path, default=None)
    p.add_argument("--space-type", default="taylor_hood")


def _export_mesh_file(mesh, path: Path) -> None:
    """Write a mesh to ``.msh`` or ``.xdmf`` by extension."""
    path = Path(path)
    if path.suffix == ".msh":
        from lsafw_tpu_torch.meshing.io import write_msh

        write_msh(mesh, path)
    elif path.suffix == ".xdmf":
        from lsafw_tpu_torch.io.xdmf import write_xdmf

        write_xdmf(path, mesh)
    else:
        raise SystemExit(f"unsupported mesh export format: {path.suffix}")
    logger.info("Mesh exported to %s", path)


def _show_mesh(mesh, args) -> None:
    print(mesh.summary())
    if args.export:
        _export_mesh_file(mesh, args.export)
    if args.plot:
        from lsafw_tpu_torch.plot import plot_mesh

        plot_mesh(mesh, path=args.plot)


def _cmd_mesh(args) -> int:
    from lsafw_tpu_torch.utils.cache import CacheStore

    mesh, _, _, _ = _build_case(args)
    if args.outdir:
        CacheStore(args.outdir).save_mesh(args.key or "mesh", mesh)
    _show_mesh(mesh, args)
    return 0


def _cmd_benchmark(args) -> int:
    from lsafw_tpu_torch.config import (
        load_cylinder_flow_config,
        load_facet_config,
        load_step_flow_config,
    )
    from lsafw_tpu_torch.meshing.mesh import Shape, generate_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    shape = Shape.from_string(args.geometry)
    load = {Shape.CYLINDER_FLOW: load_cylinder_flow_config,
            Shape.STEP_FLOW: load_step_flow_config}.get(shape)
    if load is None:
        raise SystemExit(f"unsupported benchmark geometry: {args.geometry}")
    mesh = generate_mesh(shape, config=load(args.config))
    if args.facet_config:
        mark_boundary_facets(mesh, load_facet_config(args.facet_config))
    _show_mesh(mesh, args)
    return 0


def _require_bcs(bcs, command: str) -> None:
    if bcs is None:
        raise SystemExit(f"{command} requires --bc-config")


def _cmd_baseflow(args) -> int:
    from lsafw_tpu_torch.io import export_function
    from lsafw_tpu_torch.solver.baseflow import compute_recirculation_length

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, "baseflow")
    w = _baseflow(args, ctx, mesh, bcs)
    try:
        logger.info("Recirculation length: %.4f", compute_recirculation_length(ctx, w))
    except RuntimeError:
        pass
    if args.outdir:
        export_function(w, spaces, args.outdir, name=args.key or "baseflow")
    return 0


def _eigensystem(args, command: str):
    """(spaces, perturbation BCs, baseflow, A, M) of a solver command."""
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, command)
    w = _baseflow(args, ctx, mesh, bcs)
    pert = _pert_bcs(args, mesh, spaces, bcs)
    A, M = LinearizedNavierStokesAssembler(w, ctx, args.re, pert, mesh).assemble_eigensystem()
    return spaces, pert, w, A, M


def _cmd_assemble(args) -> int:
    from lsafw_tpu_torch.io import export_function, export_matrix

    spaces, _, w, A, M = _eigensystem(args, "assemble")
    out = Path(args.outdir or ".")
    export_matrix(A, out / "A.mtx")
    export_matrix(M, out / "M.mtx")
    export_function(w, spaces, out, name="baseflow")
    logger.info("Assembled eigensystem exported to %s (n=%d)", out, A.shape[0])
    return 0


def _cmd_eigen(args) -> int:
    from lsafw_tpu_torch.io import export_eigenvector, import_matrix
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType

    A = import_matrix(Path(args.matdir) / "A.mtx", device=args.device)
    M = import_matrix(Path(args.matdir) / "M.mtx", device=args.device)
    es = EigenSolver(A, M, EigensolverConfig(num_eig=args.num_eig, atol=args.atol, ncv=args.ncv),
                     check_hermitian=args.check_hermitian)
    if args.target is not None:
        es.set_st_type(STType.SINVERT)
        es.set_target(complex(args.target))
        es.set_st_pc_type(args.si_method)
    pairs = es.solve()
    for i, (lam, vec) in enumerate(pairs):
        logger.info("sigma[%d] = %.6e %+.6e j", i, lam.real, lam.imag)
        if args.outdir:
            export_eigenvector(vec, Path(args.outdir) / f"eigvec_{i}.npz")
    if args.outdir:
        (Path(args.outdir) / "eigenvalues.json").write_text(
            json.dumps([[p[0].real, p[0].imag] for p in pairs]))
    return 0


def _cmd_sensitivity(args) -> int:
    from lsafw_tpu_torch.io import export_function
    from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, "sensitivity")
    w = _baseflow(args, ctx, mesh, bcs)
    sens = EigenSensitivitySolver(ctx, mesh, bcs, w, args.re,
                                  target=complex(args.target) if args.target else None,
                                  si_method=args.si_method, device=args.device)
    d_sigma = sens.evaluate()
    logger.info("d sigma / d Re = %.6e %+.6e j", d_sigma.real, d_sigma.imag)
    if args.wavemaker and args.outdir:
        export_function(sens.compute_wavemaker(), spaces, args.outdir, name="wavemaker")
    return 0


def _write_json(args, name: str, rows) -> None:
    if args.outdir:
        Path(args.outdir).mkdir(parents=True, exist_ok=True)
        (Path(args.outdir) / name).write_text(json.dumps(rows, indent=1))


def _cmd_resolvent(args) -> int:
    from lsafw_tpu_torch.resolvent import ResolventSolver

    spaces, pert, _, A, M = _eigensystem(args, "resolvent")
    rs = ResolventSolver(A, M, spaces.num_velocity_dofs, pert.dirichlet_mask,
                         method=args.si_method, device=args.device)
    rows = []
    for m in rs.gain_curve(args.omega, k=args.k):
        rows.append({"omega": m.omega, "gains": m.gains.tolist()})
        logger.info("omega=%.4f: sigma_1 = %.4e", m.omega, m.gains[0])
    _write_json(args, "resolvent_gains.json", rows)
    return 0


def _cmd_transient(args) -> int:
    from lsafw_tpu_torch.transient import TransientGrowthSolver

    spaces, pert, _, A, M = _eigensystem(args, "transient")
    ts = TransientGrowthSolver(A, M, spaces.num_velocity_dofs, pert.dirichlet_mask,
                               method=args.si_method, device=args.device)
    rows = []
    for r in ts.growth_curve(args.horizons, args.n_steps, k=args.k):
        rows.append({"T": r.horizon, "gains": r.gains.tolist()})
        logger.info("T=%.3f: G = %.4e", r.horizon, r.gains[0])
    _write_json(args, "transient_gains.json", rows)
    return 0


def _cmd_span(args) -> int:
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
    from lsafw_tpu_torch.span import SpanwiseStability

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, "span")
    w = _baseflow(args, ctx, mesh, bcs)
    span = SpanwiseStability(ctx, w, args.re, _pert_bcs(args, mesh, spaces, bcs), mesh,
                             device=args.device)
    target = complex(args.target) if args.target else 0.05 + 0.75j
    v0 = None
    rows = []
    for beta in args.betas:
        A, M = span.assemble_eigensystem(beta)
        es = EigenSolver(A, M, EigensolverConfig(num_eig=2, atol=1e-8, ncv=30))
        es.set_st_type(STType.SINVERT)
        es.set_target(target)
        if v0 is not None:
            es.set_initial_vector(v0)
        lam, vec = max(es.solve(), key=lambda p: p[0].real)
        v0, target = vec, lam  # the branch continues in beta from here
        rows.append({"beta": beta, "sigma": [lam.real, lam.imag]})
        logger.info("beta = %.3f: sigma = %+.5e %+.5e j", beta, lam.real, lam.imag)
    _write_json(args, "span_sigma.json", rows)
    return 0


def _cmd_wnl(args) -> int:
    from lsafw_tpu_torch.wnl import find_critical_re, weakly_nonlinear

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, "wnl")
    pert = _pert_bcs(args, mesh, spaces, bcs)
    re_c, w_c, sigma_c = find_critical_re(ctx, mesh, bcs, pert, args.re_lo, args.re_hi,
                                          device=args.device)
    res = weakly_nonlinear(ctx, mesh, bcs, pert, re_c, w_c, device=args.device)
    rows = [{"re": re, "amplitude": res.amplitude(re), "frequency": res.frequency(re)}
            for re in (args.res or [])]
    logger.info("WNL: Re_c = %.4f, omega_c = %.5f, lambda' = %+.4e %+.4e j, mu = %+.4e %+.4e j",
                re_c, res.omega_c, res.lambda_p.real, res.lambda_p.imag, res.mu.real,
                res.mu.imag)
    for row in rows:
        logger.info("WNL Re=%g: A = %.5f, omega = %.5f", row["re"], row["amplitude"],
                    row["frequency"])
    _write_json(args, "wnl.json", {
        "re_c": re_c, "omega_c": res.omega_c, "sigma_at_re_c": [sigma_c.real, sigma_c.imag],
        "lambda_prime": [res.lambda_p.real, res.lambda_p.imag],
        "mu": [res.mu.real, res.mu.imag], "supercritical": bool(res.mu.real > 0),
        "points": rows})
    return 0


def _cmd_scm(args) -> int:
    from lsafw_tpu_torch.scm import SelfConsistentModel, scm_continuation

    mesh, spaces, bcs, ctx = _build_case(args)
    _require_bcs(bcs, "scm")
    pert = _pert_bcs(args, mesh, spaces, bcs)

    if args.res:  # Re-continuation up the amplitude curve
        results = scm_continuation(
            ctx, mesh, bcs, pert, list(args.res),
            lambda re: _baseflow(args, ctx, mesh, bcs, re), tol_sigma=args.tol_sigma,
            device=args.device)
        rows = []
        for re, r in results:
            rows.append({"re": re, "amplitude": r.amplitude,
                         "sigma": [r.sigma.real, r.sigma.imag], "converged": r.converged})
            logger.info("SCM Re=%g: A = %.5f, sigma = %+.5e %+.5e j (converged=%s)", re,
                        r.amplitude, r.sigma.real, r.sigma.imag, r.converged)
        _write_json(args, "scm_curve.json", rows)
        return 0 if all(r["converged"] for r in rows) else 1

    scm = SelfConsistentModel(ctx, mesh, bcs, pert, args.re, device=args.device)
    res = scm.solve(_baseflow(args, ctx, mesh, bcs), A0=args.a0, tol_sigma=args.tol_sigma)
    if not res.converged and res.amplitude > 0:
        # a wall-limited alternation: the coupled Newton finishes it
        cres = scm.solve_coupled(res.mean, (res.amplitude_sl or res.amplitude) * res.mode,
                                 abs(res.sigma.imag))
        if cres.converged:
            res = cres
    logger.info("SCM: A = %.5f, sigma = %+.5e %+.5e j (converged=%s)", res.amplitude,
                res.sigma.real, res.sigma.imag, res.converged)
    _write_json(args, "scm.json", {"amplitude": res.amplitude,
                                   "sigma": [res.sigma.real, res.sigma.imag],
                                   "converged": res.converged, "history": res.history})
    return 0 if res.converged else 1


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lsafw_tpu_torch",
        description="global linear stability analysis on an NVIDIA GPU (PyTorch / CUDA)")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                        help="the device the solvers run on (default: cuda; no fallback)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the torch.distributed process group of a multi-process "
                        "launch (torchrun)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mesh", help="generate or import and tag a mesh")
    _add_case_args(p)
    p.add_argument("--from-file", type=Path, default=None,
                   help="import a .msh/.xdmf/.npz mesh instead of generating one")
    p.add_argument("--export", type=Path, default=None, help="write the mesh to .msh or .xdmf")
    p.add_argument("--plot", type=Path, default=None, help="save a mesh plot image")
    p.add_argument("--outdir", type=Path, default=None, help="cache the mesh here")
    p.add_argument("--key", default=None)
    p.set_defaults(fn=_cmd_mesh)

    p = sub.add_parser("benchmark", help="generate a predefined CFD benchmark geometry")
    p.add_argument("--geometry", default="cylinder_flow", choices=("cylinder_flow", "step_flow"))
    p.add_argument("--config", type=Path, required=True)
    p.add_argument("--facet-config", type=Path, default=None)
    p.add_argument("--export", type=Path, default=None)
    p.add_argument("--plot", type=Path, default=None)
    p.set_defaults(fn=_cmd_benchmark)

    def solver(name: str, help: str, fn, *, pert: bool = True):
        p = sub.add_parser(name, help=help)
        _add_case_args(p)
        p.add_argument("--from-file", type=Path, default=None,
                       help="import a .msh/.xdmf/.npz mesh instead of generating one")
        p.add_argument("--re", type=float, required=True)
        p.add_argument("--ramp", action="store_true")
        p.add_argument("--steps", type=int, default=3)
        p.add_argument("--tol", type=float, default=1e-8)
        p.add_argument("--max-it", type=int, default=50)
        p.add_argument("--damping", type=float, default=1.0)
        p.add_argument("--outdir", type=Path, default=None)
        p.add_argument("--key", default=None)
        if pert:
            p.add_argument("--perturbation-bc-config", type=Path, default=None)
        p.set_defaults(fn=fn)
        return p

    def si_method(p, choices=("lu", "banded", "gmres")):
        p.add_argument("--si-method", choices=choices, default="banded",
                       help="shift-invert inner solve: the device band factor with f64 "
                       "refinement (default), GMRES preconditioned by it, or the host LU")

    solver("baseflow", "steady Navier-Stokes solve", _cmd_baseflow, pert=False)
    solver("assemble", "baseflow + linearized eigensystem -> .mtx", _cmd_assemble)

    p = sub.add_parser("eigen", help="solve the eigenproblem of A.mtx, M.mtx")
    p.add_argument("--matdir", type=Path, required=True)
    p.add_argument("--target", default=None)
    p.add_argument("--num-eig", type=int, default=5)
    p.add_argument("--atol", type=float, default=1e-8)
    p.add_argument("--ncv", type=int, default=80)
    p.add_argument("--check-hermitian", action="store_true")
    si_method(p)
    p.add_argument("--outdir", type=Path, default=None)
    p.set_defaults(fn=_cmd_eigen)

    p = solver("sensitivity", "adjoint eigenvalue sensitivity", _cmd_sensitivity, pert=False)
    p.add_argument("--target", default=None)
    p.add_argument("--wavemaker", action="store_true")
    si_method(p)

    p = solver("resolvent", "optimal harmonic forcing gains sigma_1(omega)", _cmd_resolvent)
    p.add_argument("--omega", nargs="+", type=float, required=True)
    p.add_argument("--k", type=int, default=1)
    si_method(p, ("lu", "banded"))

    p = solver("transient", "optimal transient energy growth G(T)", _cmd_transient)
    p.add_argument("--horizons", nargs="+", type=float, required=True)
    p.add_argument("--n-steps", type=int, default=32)
    p.add_argument("--k", type=int, default=1)
    si_method(p, ("lu", "banded"))

    p = solver("span", "quasi-3D spanwise-Fourier stability of a 2D baseflow", _cmd_span)
    p.add_argument("--betas", nargs="+", type=float, required=True)
    p.add_argument("--target", default=None)

    p = solver("scm", "self-consistent mean-flow model (limit cycle without DNS)", _cmd_scm)
    p.add_argument("--a0", type=float, default=0.1)
    p.add_argument("--tol-sigma", type=float, default=2e-4)
    p.add_argument("--res", nargs="+", type=float, default=None,
                   help="Re-continuation: solve at each Re ascending, warm-starting from the "
                   "previous converged state (--re is ignored)")

    p = solver("wnl", "weakly nonlinear Stuart-Landau expansion at the Hopf point", _cmd_wnl)
    p.add_argument("--re-lo", type=float, default=40.0, help="lower bracket of the onset")
    p.add_argument("--re-hi", type=float, default=55.0, help="upper bracket of the onset")
    p.add_argument("--res", nargs="+", type=float, default=None,
                   help="Reynolds numbers to tabulate amplitude/frequency predictions at")
    return parser


def main(argv: list[str] | None = None) -> int:
    import torch

    args = _parser().parse_args(argv)
    setup_logging(verbose=args.verbose)
    if args.platform == "cuda" and not torch.cuda.is_available():
        logger.error("--platform cuda: no CUDA device (torch.cuda.is_available() is False); "
                     "pass --platform cpu to run on the CPU")
        return 1
    args.device = torch.device(args.platform)
    if args.distributed:
        from lsafw_tpu_torch.parallel import initialize_distributed, is_rank0

        initialize_distributed(device=args.device)
        if not is_rank0():  # rank 0 runs the subcommand and writes its files alone
            return 0
    try:
        return args.fn(args)
    except Exception as exc:  # fail fast with exit 1, as the reference does
        logger.error("%s", exc, exc_info=args.verbose)  # the traceback with -v
        return 1


if __name__ == "__main__":
    sys.exit(main())
