#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1 and 2 only, no result lines
    python3 chip_smoke.py --phase13  # phases 1, 3 and 13 only, no result lines
    python3 chip_smoke.py --phase15  # phases 1 and 15 only, no result lines
    python3 chip_smoke.py --phase16  # phases 1, 3 and 16 only, no result lines

Phases, one or more lines each (a failure raises and the exit code is
non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build:
     ``csrc/band_subst.cu`` at nb = 128 and at nb = 256 and
     ``csrc/spmv_gather.cu``, one nvcc each, started together; after phase
     2 one worker process (terminated at exit) makes the host meshes of
     phases 6 and 10c (distmesh, numpy alone; the same seeds, so the same
     meshes) while the card runs the phases before them; a second one (the
     check worker, terminated at exit) runs the host-LU cross-checks of
     phases 7, 8, 14c and 15b on the host CPU while the card goes on, each
     gated when it is collected (those of 7 and 8 after phase 9, 15b's at
     the end of phase 15, 14c's before the kernels line);
  2. kernels against their plain PyTorch versions on the card, relative
     error <= 1e-5: the band substitution K1/K2 in both modes and every
     type (complex64; float32 with one and two columns) on random factors
     (``PHASE2_SHAPES``): at nb = 128 at the 43k cylinder shapes (B = 7,
     384 block rows) and at a wider B = 26 with 32 block rows; the
     pivot-free modes on a bf16 band at B = 7 and at the 175k production
     mesh's B = 17; every mode, f32 and bf16, at nb = 256 at B = 4 and
     B = 9 (the two meshes' B at that nb).  Pivot-free on a random band
     scaled by 2e-3, pivoted on a random band that needs pivoting within
     and across block rows, factored on the card by the port's
     ``_pfactor``, each drawn by the card's generator (6 s; drawn on the
     host, 71 s; each pair is timed once); the gather G against
     ``x[idx]`` at the probes' shapes (``run_a``: x 2^17 f32, idx
     (1024, 16); ``pallas_two_pass``: x (4096, 128) f32, 2^18 x 128
     lane-unique indices), exact; G's permute-in and permute-out in every
     type pair (f64 / complex128 into complex64, float32 x1 and x2, and
     back) on a random padded permutation at nb = 128 and at nb = 256,
     exact; S in every mode (real,
     complex, shifted, shifted with M x, and shifted with and without M x
     on an f64 x at a real shift) and both orders against its plain
     version, relative error <= 1e-12 (``SPMV_REL_TOL``), on a random
     matrix with empty rows, tiles of the most rows a tile holds and a row
     longer than a tile, with 2D row lengths (0 to 59) and with the 3D
     cube's (60 to 130, 95 on average); and K1/K2 at the lid cube's widths
     (``PHASE2_WIDE``: B = 86 at nb = 128 and B = 43 at nb = 256, factors
     drawn on the card) in every mode and type, with the cluster size, ring
     tiles and shared memory each launch chose beside the library's room
     query (``band_room``: the launch's choice made without a launch) and
     the pure formula the CPU uses (``band_cuda.room``), which must agree on
     what fits; K1 pivoted complex64 at nb = 256, B = 43 must raise (its two
     windows leave no room for a ring tile at any cluster size) at the
     launch, in the room query and in the plan-time check
     (``band_cuda.require_room``, which ``factor_auto`` runs before any
     factor work);
  3. this slice's main path, the reference's device path
     (``bench.py`` ``_pipeline``): the reduced cylinder (43,671
     Taylor-Hood DOFs) at Re = 47, ramped Newton baseflow on the banded
     inner solve (real pivoted band factors, GCR refinement whose
     matvecs run through S), eigensystem, and the shift-invert
     Krylov-Schur at 0.74j on the default pivoted complex factor with the
     fused (A, M) refinement matvecs (S).  Host LU and the torch
     substitution loops are patched to raise (the loops on a CUDA
     tensor).  Launch counts are zeroed just before and read after each
     stage: the leading eigenvalue must be within 1e-4 of +0.0050+0.7526j
     and within 5e-7 of the card's recorded +0.004991+0.752636j, with
     residual <= 1e-8; in each stage K1/K2 once per band solve (pivoted
     f32 with one column in the baseflow, pivoted complex64 in the eigen
     stage), G's permute-in and permute-out once each per band solve in
     the factor's type, no flat-form complex128 G, and exactly one S
     launch, in the original order, per original-order matvec
     (``matvecs()`` counts them);
  3b. the pivot-free path on the same (A, M): ``LSAFW_PIVOT_MEM_GB=0``
     takes the pivot-free factor, whose substitution runs through K1/K2
     pivot-free (counts zeroed just before, read after): sigma within
     1e-8 of phase 3's, the residual gate, the launch gates of phase 3,
     and the card's factor contracting within 3x of the same factor
     built in f32 on the host CPU;
  3c. the bf16 band on the same (A, M): ``LSAFW_PIVOT_MEM_GB=0`` and
     ``LSAFW_BAND_MEM_GB=0.5`` (0.77 GB in f32 over it, 0.38 GB in bf16
     under it: bf16 at full width), K1/K2 pivot-free bf16 complex64 once
     per band solve, sigma within 1e-8 of phase 3's, the residual gate,
     its contraction printed beside phase 3b's; and one banded real solve
     of phase 3's last Jacobian with ``LSAFW_BAND_MEM_GB=0.3`` (a bf16
     band, K1/K2 pivot-free bf16 float32 with one column), GCR to 1e-10;
  4. S against its plain version on phase 3's (A, M) at sigma = 0.74j
     (the real-shift modes at CN_SHIFT = 16, phase 7's) in each mode and
     order (relative error <= 1e-12); G against its
     plain versions on the main path's own inputs, exact: the f64 CSR
     value refill (nnz indices), the complex128 flat gather, and the
     permute forms on the eigen stage's complex plan and the baseflow's
     real plan; K1/K2 in each mode and type against their plain versions
     on the main path's own factors (the eigen stage's pivoted factor,
     phase 3b's pivot-free one, a real pivoted and pivot-free factor
     on the baseflow's plan, phase 3c's bf16 factors, after phase 6
     the 175k factors of phases 6, 6b and 6c, and after phase 7b the 175k
     transient's real pivoted factor), and the times (medians of CUDA-event
     timings: K1/K2 one call at a time, each band being larger than L2;
     G and S with the L2 cache evicted before each call, as the main
     path's band solves leave it) of every kernel beside its plain
     version, bound and library call (for the permute forms also the op
     sequence they replace); one pivoted solve against the torch loops,
     the panel LU backends, and the device operations, wall time and
     busy share of one pivoted shift-invert apply and of eight GCR
     iterations of a real banded solve under ``torch.profiler``;
  5. adjoint sensitivity at full width on phase 3's baseflow and (A, M):
     ``EigenSensitivitySolver(..., target=sigma_3, si_method="banded")``,
     ``evaluate()`` (direct mode, nev 5 and ncv 80; adjoint mode on the
     transposed pair; du/dRe on the banded real solve) and
     ``compute_wavemaker()``, with host LU and the torch substitution
     loops patched to raise.  Counts are zeroed just before and read
     after each stage (direct, adjoint, du/dRe, integrals, wavemaker):
     K1/K2 once per band solve (pivoted complex64 in the direct and
     adjoint stages, pivoted f32 with one column in du/dRe), G's
     permute-in and permute-out once each per band solve in the stage's
     types, one original-order S launch per original-order matvec, no
     flat complex128 G, and no plan built for any pattern (the adjoint
     shares the pattern's plans).  Gates: the direct sigma within 1e-8 of
     phase 3's, sigma_adj within 1e-7 of conj(sigma_3), the adjoint
     residual ||A^T a - sigma_adj M^T a|| / ||a|| <= 1e-8,
     |a^H M v - 1| <= 1e-10, the du/dRe residual ||J s - r|| / ||r|| <=
     1e-9, the reference's finite-difference check (banded Newton
     baseflows at Re = 46 and 48 started from phase 3's, their
     eigenvalues near sigma_3: |d sigma/dRe - FD| <= 0.15 |FD| and
     Re(d sigma/dRe) > 0), and the wavemaker's peak at 0.5 < x < 5,
     |y| < 2, its velocity slots 0 and its CG converged;
  6. the repository's production cylinder, built from
     ``config_files/2D/cylinder/*.toml`` (175,491 DOFs): ramped banded
     Newton (3 steps, tol 1e-8) on real pivoted f32 factors, the
     eigensystem, and the shift-invert eigenpair at 0.74j on the default
     plan (the pivot-free complex64 band, B = 17 at nb = 128), with host
     LU and the torch substitution loops on CUDA tensors raising; each
     stage read on its own: residual <= 1e-8, |Re sigma - 0.0004| <= 1e-3
     and |sigma - (0.0008+0.7354j)| <= 3e-3, K1/K2 pivot-free complex64
     once per band solve in the eigen stage and pivoted float32 x1 in the
     baseflow, whose band stays f32; stage times, launches, peak memory;
  6b. phase 6's eigen stage with ``LSAFW_BAND_NB=256``: sigma within 1e-8
     of phase 6's, K1/K2 pivot-free complex64 at nb = 256 once per band
     solve; the factor and band-solve times beside nb = 128's;
  6c. phase 6's eigen stage with ``LSAFW_BAND_MEM_GB=4`` (a bf16 band):
     sigma within 1e-8 of phase 6's, K1/K2 pivot-free bf16 complex64 once
     per band solve, and the stage's peak device memory above its start
     at most 0.6 of phase 6's eigen stage.  Phase 4's K1/K2 checks and
     times then run on the factors of phases 6, 6b and 6c;
  7. (after phase 5, on phase 3's mesh) the non-modal toolbox of
     ``examples/resolvent_gains.py`` and ``examples/transient_growth.py``:
     the Re = 40 baseflow (ramped banded Newton, 4 steps, tol 1e-9) and
     its (A, M) with the perturbation BCs; ``ResolventSolver(method=
     "banded")``: the gain curve at omega = 0.3 and 1.2 (k = 1) and 0.75
     (k = 2, whose leading gain is the curve's), ``resolvent_norm(
     -0.05+0.75j)``;
     ``TransientGrowthSolver(method="banded").solve(4, 32)``; each a
     stage (counts zeroed before, read after): K1/K2 once per band solve
     (pivoted complex64 in the resolvent stages; pivoted float32 x1
     alone in the transient stage, no complex64 and no two-column
     launch), G's permute-in and permute-out once each per band solve,
     one original-order S launch per original-order matvec (the Cayley
     right-hand side and each adjoint step's (A^T + s M^T) y included),
     no flat complex128 G, no plan built but the direct operator's where
     none was cached, and host LU raising; forcing and response energies
     1 within 1e-8, the response residual ||(i omega M - A)(g q) - M f||
     / ||M f|| <= 1e-8, each raw response C^-1 M f of energy norm the gain
     within 1e-6, q(T)^T M q(T) = G within 1e-6 max(G, 1), forcings and
     initial states zero on pressure and Dirichlet DOFs; then, with
     ``method="lu"`` (asked for; six host LU factors, counted), the same
     k = 2 solve and norm (gains within 1e-6, the norm within 1e-5 of the
     banded answers) and, in place of a full host-LU gain solve (2,752
     sequential host solves), the host-LU propagators on the banded
     optimum q0: its energy at T (the host-LU gain operator's Rayleigh
     quotient) within 1e-6 of G, its state at T and its gain-operator
     image within 1e-6 of the banded ones;
  7b. (after 6c, on phase 6's mesh, 175,491 DOFs) phase 7 at full width
     without the sweep, the norm and the host LU: the Re = 40 baseflow
     (one banded Newton from phase 6's Re = 47 baseflow, a cut in depth
     from the ramp), the resolvent at omega = 0.75 (k = 1; the default plan's pivot-free
     complex64 band) and, cut in depth, G(2) with 16 steps (phase 7's dt),
     with phase 7's gates; then
     phase 4's K1/K2 checks and times on the transient's real pivoted
     factor (B = 17, 1,408 block rows);
  8. (after phase 7, on phase 3's mesh, baseflow and (A, M), Re = 47)
     quasi-3D spanwise stability (``span.SpanwiseStability``: its
     pattern and outlet slots once, a stage, the band reckoned from the
     pattern's RCM ordering) at beta = 0 (nearest 0.74j) and 1.5 (nearest
     phase 3's sigma), each a stage on the band factor: sigma(0) within
     1e-8 of phase 3's sigma, the (u, v, p) block of A(0) and M(0) equal
     to phase 3's (A, M) within 1e-13 relative (the card's f64
     ``index_add_`` sums a slot's contributions in atomic order) and the
     couplings exactly zero, sigma_r(1.5) < sigma_r(0) - 1e-3, residuals
     <= 1e-8, the launch gates of ``gate_stage`` in the factor's mode, one
     band plan over the two beta, and beta = 1.5 on the host LU (asked
     for, one factor counted) within 1e-8; then the weakly nonlinear
     expansion: ``wnl.find_critical_re(..., 40, 55, tol=1e-3)`` (each
     baseflow, warm Newton and eigensolve a stage) and
     ``wnl.weakly_nonlinear`` at the Re_c it returns (direct, adjoint,
     du/dRe and the two forced solves each a stage) with
     ``tests/benchmark/test_wnl.py``'s gates (42 < Re_c < 52, |sigma_r| <
     1e-3, 0.6 < omega_c < 0.9, Re mu > 0, Re lambda' > 0, 0 < A(Re_c + 2)
     < A(Re_c + 6), the frequency growing, q20 and q22 nonzero), the
     forced solves' residuals on the card's CSR <= 1e-8, a^H M q1 = 1
     within 1e-10, the sigma = 0 solve real (K1/K2 pivoted float32 x1
     alone) and the 2 i omega solve complex, and both forced solves again
     on the host LU (asked for, two factors counted) within 1e-8;
  8b. (after 7b, on phase 6's mesh, baseflow and (A, M)) phase 8 at full
     width without the host LU: the quasi-3D band's complex64 storage is
     over the default ``LSAFW_BAND_MEM_GB`` of 12, so the beta stages set
     it to that storage plus 1 GB (printed with the reckoning), and
     ``find_critical_re`` brackets (46, 48) with 46 < Re_c < 48 (its first
     baseflow one banded Newton from phase 6's, a cut in depth from the
     ramp); phase
     4's K1/K2 checks and times run on the beta = 1.5 factor;
  9. (after phase 8, on phase 3's mesh, with the nonlinear problem's BCs)
     nonlinear time stepping (``solver.timestepping.UnsteadySolver``, the
     banded chord Newton), the shedding cycle and its Floquet multipliers
     (``floquet.FloquetSolver``, ``span.spanwise_floquet``), each stage
     read on its own (``unsteady_path``): 9a the forced DNS closure of
     ``tests/benchmark/test_resolvent_dns.py`` on phase 7's Re = 40
     baseflow and optimal forcing at omega = 0.75 (2.25 forcing periods at
     64 steps a period; amplitude within 5% of the gain, correlation >
     0.99); 9b ``tests/benchmark/test_unsteady.py`` at Re = 60 (ramped
     banded baseflow, the leading pair near 0.05+0.75j, 360 steps of 0.25
     from w + 1e-5 v; the probe's frequency within 3% of sigma_i, its
     growth rate within 10% + 2e-3 of sigma_r, the envelope's growth, a
     finite state); 9c ``examples/floquet_cycle.py``'s saturated cycle
     (steps of 0.2 from 9b's state, its perturbation scaled to a 2-norm of
     5: at least 625, until saturated, 1,750 at most; the last quarter's
     amplitude within 5%
     of the one before, omega_sat > sigma_i, then 40 snapshots of T/40,
     the orbit closure <= 1e-2) and the device operations of one step
     under the profiler; 9d the Floquet multipliers on 40 prestored real
     factors (k = 5: the second-largest |mu| < 1 + 1e-3, the trivial error
     <= 1e-3), one inexact trip (the cycle-mean factor) within 1e-8 of the
     prestored one, one step within 1e-9 of a host SuperLU of its implicit
     matrix (asked for, one factor counted); 9e the spanwise multipliers at
     beta = 1.6 on the cycle-mean factor (k = 3): every one of a mode that
     carries velocity below 1, at least one such, and the pure-pressure
     modes' (``split_modes``) (-1)^40 = 1 within ARPACK's 1e-8 (the theta
     step maps a pure-pressure vector to its negative), as in 9d.  K1/K2
     pivoted f32 x1 once per band solve in 9a-9c, pivoted f32 x2 (a complex
     vector through a real factor, one launch) in 9d and 9e, with no other
     band launch; G's permute forms and S as in phase 3; no plan built but
     each pattern's first.  Then phase 4's K1/K2 checks and times run on a
     9d factor.

  10. (after phase 8b) the lid-driven cube of ``tests/benchmark/test_cavity3d.py``
     on ``unit_cube(16)`` (112,724 DOFs; a cut in scale from the reference's
     20^3, 216,024 DOFs and B = 86 at nb = 128, whose widths phase 2's wide
     factors keep; one pressure DOF pinned, as ``examples/cube.py`` pins
     it), under its own budgets (``CUBE_ENV``, sized for the 20^3 factors:
     the real pivoted Newton factor, 31.71 GB, and the pivoted complex64
     eigen factor, 63.33 GB): the banded Newton baseflow at Re = 100 (ramped,
     2 steps, a depth cut from the test's 3; tol 1e-9), the eigensystem
     and four pairs nearest -0.2+0.3j
     (ncv 24), each a stage, with the test's gates (four pairs, every
     sigma_r < 0, residuals <= 1e-8, at least two complex modes paired with
     their conjugates within 1e-6) and phase 3's launch gates in the
     stage's mode; the band reckoned and the peaks logged; then K1/K2 on
     the last Newton factor and on the eigen factor, and S (real, shifted,
     mass) on the cube's (A, M), held to their plain versions and timed;
  10b. test_step_spectrum.py's backward-facing step (resolution 0.22,
     refinement 2, the parabolic inlet, Re = 150): the banded baseflow,
     1 < L_r < 12; twenty pairs nearest 0 at ncv 45 on the real factor of
     the real shift: every sigma_r < 0, conjugates within 1e-4 max(1,
     |sigma|) (the edge rule of 10c), residuals <= 1e-6, the Krylov-Schur
     cycles logged; and,
     after phase 9 on phase 7's Re = 40 43k baseflow,
     test_cylinder_stability.py's diagnostics: 1.5 < L_r < 4 and
     1.2 < C_d = 2 F_x < 2 (the traction integral on the card);
  10c. the 3D step from ``config_files/3D/step/*.toml`` (distmesh3d on the
     host; the pressure DOFs that the Dirichlet walls decouple, found by
     ``fem.bcs.decoupled_pressure_dofs``, pinned): the
     banded baseflow at Re = 50 (ramped, 3 steps, tol 1e-9), a
     recirculation behind the step, six pairs nearest 0 (ncv 30) on the
     default real pivoted factor (residuals <= 1e-8, conjugates as 10b; an
     edge mode whose conjugate ties it at the cut is held by that
     conjugate's true residual), and the pivot-free factor
     (``LSAFW_PIVOT_MEM_GB=0``): refused by its calibration, or its sigma
     within 1e-8 of the default's; then K1/K2 and S timed on its factors
     and (A, M);
  11. (after 10c) ``examples/scm_limit_cycle.py`` then ``examples/scm_hb2.py
     --hill`` at full width: the examples' cylinder from
     ``config_files/2D/cylinder/{geometry,facets}_small.toml``, ``bcs.toml``
     and ``bcs_perturbation.toml`` (11,323 DOFs, the records' count), Re =
     60: 11a the ramped banded baseflow and ``SelfConsistentModel.solve(w,
     A0=0.1, tol_sigma=2e-4)`` (every mean Newton and eigensolve a stage;
     history[0] sigma_r > 5e-3, converged with |sigma_r| <= 2e-3, 1.005 <
     omega / omega_Hopf < 1.3, omega within 1% of the DNS 0.85289, A within
     5% of 2.9142); 11b HB1 and 11c HB2 (``solve_coupled``; every bordered
     GCR solve and the q2 seed a stage; A, omega and A2 within 1e-4 of
     ``doc/scm_hb2_re60.json``, HB2's omega within 0.5% of the DNS
     0.862225); 11d ``hill_floquet`` (n_blocks 3, num 12) on HB2's cycle
     (the trivial exponent within 1e-2 omega, every other exponent stable,
     the leading |mu| beside the DNS monodromy's 0.802) and the card's pairs
     in the reference's complex pencil built on the host (true residuals
     1e-8); the launch gates of
     ``gate_class`` in each stage (K1/K2 pivoted f32 x1 in the Newton and
     bordered stages, complex64 in the eigen, seed and Hill stages; G's
     permutes; S per matvec; no plan built beyond each pattern's first);
     then the repair of the silent refinement miss: the 11k baseflow's
     pivot-free factor with its refinement cap forced to 1 must make the
     eigensolve raise ``FactorUnusable``; then K1/K2 and S on HB1's and
     HB2's K0 and on the Hill pair.
  12. (after phase 5, on phase 3's objects; ``krylov_path``) the solver
     menu, each solve a stage: 12a the inexact shift-invert on phase 3's
     (A, M) at 0.74j, ``set_st_pc_type("gmres")`` then STPRECOND (GMRES(40)
     on complex128 vectors, preconditioned by the pivoted complex64 band
     factor of C): sigma within 1e-8 of phase 3's, residual 1e-8, no host
     LU, K1/K2 pivoted c64 once per preconditioner apply (the GMRES steps,
     cycles and solves of the operator's figures), G and S as in phase 3;
     12b the velocity block of phase 3's last Jacobian (38,764 rows) with
     GMRES, FGMRES, LGMRES, GCR, BiCG, BiCGStab, CGS and LSQR, each with
     ILU(0) (on the converged Chow-Patel sweep count; GMRES and BiCGStab at
     the reference's 8 sweeps logged first; the 8 sweeps bit-identical on
     a second run) and block-Jacobi(64), their products through S: the
     true residual <= 1e-8 wherever a solver reports convergence, GMRES +
     ILU and BiCGStab + ILU converged; 12c the P2 membrane stiffness of
     bench.py's 240 x 240 grid and of 120 x 120, its products through S:
     CG with none, Jacobi, block-Jacobi, SSOR, ILU, ICC (CG + ILU at the
     reference's 8 sweeps logged first, within 2,000 iterations), SA-AMG
     and p-MG, MINRES + Jacobi,
     Chebyshev on power-iteration bounds (the lower one by inverse power
     iteration through p-MG CG solves): true residuals <= 1e-8, AMG x 4
     under plain CG and p-MG x 3 under Jacobi at both sizes, AMG's count
     at 240 at most twice its count at 120, p-MG's within +6, p-MG one
     K1/K2 pivoted f32 x1 pair per V-cycle; 12d the reference's 32 x 32
     P2 membrane of the 2 x 4 rectangle: FILTER on K alone against
     SINVERT's three smallest (rel 1e-8), SHIFT on (K, M) restricted to
     the free DOFs (M^-1 a real band factor on the card; residuals <=
     1e-8 (|lambda| + 1)), SHELL wrapping the SINVERT apply at 1.0 (its
     five pairs equal SINVERT's within 1e-10); stage times logged,
     phase 12's budget 60 s; then G's permutes and K1/K2 on p-MG's coarse
     P1 factor at 240 x 240 and on 12d's SINVERT / SHELL and SHIFT M
     factors, held to their plain versions and timed.
  13. (after phase 12; ``structured_path``) the structured stencil /
     multigrid / LOBPCG path, the nested refinement and the element
     operator, each solve a stage, phase 13's budget 60 s: 13a at
     bench.py's 240 x 240 Taylor-Hood rectangle (520,803 DOFs, random
     values on its pattern from default_rng(0)), the stencil product in
     f64 and f32 and the element operator on random (nc, 15, 15)
     matrices, each against S's original-order product of the same CSR
     (f64 rel 1e-12, f32 against f64 1e-5), S and G against their plain
     versions, the times beside S's, cuSPARSE's and the byte bounds; 13b
     LOBPCG with ``build_multigrid_pc`` and with phase 12's p-MG on the
     240 x 240 membrane (lambda_1 within 1e-9 of the banded SINVERT
     eigenvalue, residual <= tol, < 60 iterations), ``shift_invert_power``
     at ``POWER_NX`` (test_power_stencil.py's gates), the 24^3 unit cube
     with ``build_multigrid_nd_pc`` (3 pi^2 within the 16^3 P2 error of
     scripts/torch_cube_p2_error.py, < 60 iterations; blocked m = 4: the
     6 pi^2 triple); 13c on the 43k cylinder from the examples' 11k
     cylinder at Re = 47: ``nested_eigenpair`` on the exact fine factor
     at the coarse sigma (sigma within 1e-8 of phase 3's, residual 1e-8),
     the multiplicative ``TwoGridSIPC`` with ``DiagSIPC`` and with a
     truncated band (logged; their reported residual equal to the true
     one), ``set_elements`` with ``LSAFW_BCSR_MEM_GB=0`` (sigma within
     1e-8 of phase 3's, no S launch); on the 240^2 / 60^2 membranes at
     19 + 0.3j the three designs of test_eigen.py (true residual 1e-8,
     thetas within 1e-7, the control 100x worse or converged); then G's
     permutes and K1/K2 on the phase's own factors (the truncated 43k
     band's K2 by its backward error: ``check_kernels``).
  14. (after phase 6c; ``cli_path``) the port's command line, run in this
     process through ``lsafw_tpu_torch.cli.main`` with host LU and the
     torch substitution loops raising, its files in a temporary directory
     removed at the end: 14a phase 6's production mesh written by
     ``write_msh`` and read by ``mesh --from-file --outdir --key``, the
     cached mesh's cells and facet tags equal to phase 6's and its
     vertices within 6.2e-16 relative (16 significant digits); 14b
     ``assemble --from-file`` with ``config_files/2D/cylinder``'s
     ``bcs.toml`` and ``bcs_perturbation.toml`` at phase 6's Newton
     parameters (Re = 47, ramp, 3 steps, tol 1e-8, 40 iterations), then
     ``eigen --target=0.74j --si-method banded`` on its A.mtx and M.mtx:
     both exit 0, (A, M) read back by scipy equal to phase 6's in structure
     and within 1e-12 relative in values, sigma within 1e-8 of phase 6's,
     the exported eigenvector's residual on the host from the files <=
     1e-8, K1/K2 once per band solve in phase 6's modes (pivoted float32 x1
     in the Newton, pivot-free complex64 in the eigen stage), one band plan
     in the eigen stage with M taken on A's pattern (its log line); 14c
     ``EigenSolver(A, None)`` on phase 3's A at 0.74j (the pencil (A, I)):
     residual <= 1e-8, sigma within 1e-8 of scipy's ``eigs`` (from a
     seeded random start) on one counted host LU, K1/K2 pivoted complex64
     once per band solve, S once per matvec; 14d ``python -m
     lsafw_tpu_torch.diagnose`` in a subprocess: exit 0, the card
     ``nvidia-smi`` names, f64 and complex128 ok.  Phase 14's budget is 60
     s.
  15. (after phase 11; ``phase15_path``) tensor-product cells, periodic
     pairs, elasticity, SIPG DG and the band plan's host entry, host LU
     and the torch substitution loops raising, each stage's launches read
     on its own: 15a the NAFEMS FV52 plate of
     tests/benchmark/test_elasticity.py on P2 tetrahedra at the study's
     rungs (8, 2), (12, 3), (16, 4) (4,335 / 13,125 / 29,403 DOFs), the
     banded shift-invert at (2 pi 40)^2 with its solve_modes settings: the
     seven frequencies within rel 1e-7 of scripts/data/nafems_study.json's,
     their Richardson limit within 1e-6 of its f_inf, at 16 x 4 every
     NAFEMS error under 5%, relative residuals ||K x - lambda M x|| /
     (|lambda| ||M x||) <= 1e-8, mass normalisation, Rayleigh quotients
     1e-6, the 109.44 Hz pair within 2%, and the (8, 2) plate's density
     sensitivity against -lambda/rho (1e-3) and the centred difference at
     rho +- 40 (2e-3); 15b the reference's 32 x 32 x 6 Q1 hexahedra
     (22,869 DOFs): the same gates, the frequencies within 1e-8 of scipy's
     shift-invert on one counted host LU from a seeded start, the NAFEMS
     errors logged; 15c the Q2 membrane on test_nonaffine.py's distorted
     unit square at 32 and 64 (the error at 64 at least 8x smaller), the
     Q2/Q1 Poiseuille channel of test_q2_quads.py at 64 x 64 (37,507
     DOFs; the banded Stokes solve, then the ramped banded Newton to Re =
     100: velocity within 1e-8 of 4y(1 - y), the pressure slope -8/Re
     within 1e-6), and the P2 membrane on the unit square at 128^2 with x
     = 0 paired to x = 1 (K and M folded on the host): the six eigenvalues
     nearest 45 within 1e-6 of pi^2 (1, 4, 5, 5, 8, 8); 15d SIPG DG on
     unit_cube(8) and (12) at sigma = 25 (the two lowest within 5e-2 of 3
     pi^2 and 6 pi^2, the finer closer) and scripts/data/C43k_sig074.npz
     through ``PivotedBandedLU`` and ``BandedLU.from_complex_csr``, a
     seeded right-hand side refined to a true relative residual <= 1e-10.
     Every eigen stage: K1/K2 once per band solve in the mode
     ``factor_auto`` picked at the real shift (logged), S once per matvec.
     Then K1/K2 on the 16 x 4 plate's, the Q1-hex plate's and the
     channel's factors and S at their shapes.  Phase 15's budget is 60 s.
  16. (after phase 13, on phase 3's (A, M) and sigma; ``phase16_path``)
     scale-out on torch.distributed: 16a a world of one over NCCL (a
     ``file://`` store in a temporary folder): ``shard_csr`` of A against
     S's own matvec (rel <= 1e-12), one all_reduce and one all_gather on
     CUDA tensors, ``is_rank0``; then two ranks spawned on this card over
     gloo (NCCL takes one rank a device), (A, M) handed over in a
     temporary ``.npz``, each rank with host LU and the torch loops on
     CUDA tensors raising: 16b ``sharded_si_eigensolve`` at 0.74j, nev 1,
     ncv 16, tol 1e-10, exact SPIKE over two segments at the port's nb,
     sigma within 1e-8 of phase 3's and a backward error <= 1e-8 from the
     returned vector; 16c the truncated-SPIKE FGMRES path, sigma within
     1e-8 of 16b's.  In each rank and path K1/K2 once per segment solve in
     the mode ``factor_auto`` logged, G's permutes once each, S once per
     local matvec.  Which gloo collectives take CUDA tensors is logged, as
     is the distance to ``scripts/data/sharded_pipeline_43k.json``.
     Phase 16's budget is 45 s.  Then K1/K2 and G's permutes on rank 0's
     segment factor and S on its rows of the pencil (x the whole padded
     vector), rebuilt in this process by the ranks' own builders, each
     against its plain version at those shapes (``rank_kernels``).

Phase 4's K1 timings of the pivot-free factors on f32 storage (the
complex64 ones of phases 3b and 6, and the real one of A - Re(sigma) M
with one and two float32 columns) also time one library call that
computes K1: ``torch.triangular_solve`` with the unit lower factor as a
sparse CSR tensor (cuSPARSE), held to K1 within 1e-4 (``k1_library``),
as do the pivot-free factors of phase 8b (175k quasi-3D), of phase 13c
(the truncated 43k and 240^2 bands) and phase 2's random nb = 256 factors
at B = 9.

The last lines are the card's name and power limit, one JSON object of
kernel numbers, one entry per kernel, mode, storage and type and per
main-path factor (``launches``: phases 3, 3b, 3c, 6, 6b and 6c;
``launches_phase5``: the stages of phase 5; ``launches_phase6``: phases
6 to 6c; ``launches_phase7``: the stages of phases 7 and 7b;
``launches_phase8``: the stages of phases 8 and 8b; ``launches_phase9``:
the stages of phase 9; ``launches_phase10``: the stages of phases 10 to
10c; ``launches_phase11``: the stages of phase 11; ``launches_phase12``:
the stages of phase 12; ``launches_phase13``: the stages of phase 13;
``launches_phase14``: the stages of phase 14; ``launches_phase15``: the
stages of phase 15; ``launches_phase16``: phase 16, both ranks summed;
modes no main path
runs carry phase 2's random factors, and the wide
random factors have entries of their own), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SIGMA_REF = 0.0050 + 0.7526j  # reduced cylinder at Re = 47, recorded to 4 digits
SIGMA_175K_RE = 0.0004  # the production mesh's Re sigma at Re = 47 (VALIDATION.md), 4 digits
SIGMA_167K = 0.0008 + 0.7354j  # sigma of the older 167k production mesh (README.md)
PRODUCTION_CONFIG = Path(__file__).resolve().parent / "config_files" / "2D" / "cylinder"
SIGMA_CARD = 0.004991 + 0.752636j  # the port's sigma on the H100, as printed to 6 digits
TARGET = 0.74j
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
REL_TOL = 1e-5
DEVICE = "cuda"
# phase 2's random factors, (B, block rows) per (nb, storage): every mode and
# type at nb = 128 (the 43k cylinder's B and a wider one), the bf16
# pivot-free modes at the 43k's and the 175k production mesh's B, and every
# mode at nb = 256 at the B of both meshes at that nb
PHASE2_SHAPES = {(128, "f32"): ((7, 384), (26, 32)), (128, "bf16"): ((7, 384), (17, 64)),
                 (256, "f32"): ((4, 192), (9, 96)), (256, "bf16"): ((4, 192), (9, 96))}
SPMV_REL_TOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


_MARKS: list = []  # (phase, time.time() at its start), for the closing breakdown


def mark(phase: str) -> None:
    """Note that ``phase`` starts now, in the log too (so that a run cut
    short still shows where its time went); ``phase_seconds`` splits the
    run by these marks."""
    _MARKS.append((phase, time.time()))
    log(f"chip_smoke: phase {phase} starts at {_MARKS[-1][1] - _MARKS[0][1]:.1f} s")


def phase_seconds(t_end: float) -> dict:
    """Seconds from each mark to the next (the last to ``t_end``), in order."""
    ends = [t for _, t in _MARKS[1:]] + [t_end]
    return {p: round(e - t, 1) for (p, t), e in zip(_MARKS, ends)}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median device time of one call of ``fn``: ``calls`` calls captured
    in one CUDA graph (so no host launch overhead between them), replayed
    ``reps`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


_FLUSH: list = []


def cold_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with the L2 cache cold: the graph
    time of ``calls`` x (a 128 MB write, which evicts the 50 MB L2, then
    ``fn``) less that of the writes alone.  Warm replays of one call keep
    a working set under 50 MB in L2, where it can beat the HBM bound; on
    the main path the band solves between two calls evict it."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    flush = _FLUSH[0]
    return graph_ms(lambda: (flush.zero_(), fn()), calls, reps) - graph_ms(flush.zero_, calls, reps)


def device_busy(fn) -> tuple[float, float, int]:
    """(wall ms, device-busy ms, device operations) of one synchronised call
    of ``fn`` under ``torch.profiler``: the kernels' summed self time, and
    the count of kernels, copies and fills the card ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) / 1e3
    ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy, ops


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def bound(nbytes: float, ops: float, flops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) from the bytes moved and the operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def build_all() -> None:
    """nvcc on every library at once: the band kernels at each nb, and G/S."""
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda
    from lsafw_tpu_torch.utils.cuda_build import BUILD_LOGS

    t0 = time.time()
    jobs = [lambda nb=nb: band_cuda.build(nb) for nb in band_cuda.NBS] + [spmv_cuda.build]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda job: job(), jobs))
    log(f"phase 1: built {', '.join(p.name for p in libs)} in {time.time() - t0:.1f} s")
    for src, text in BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


# ---------------------------------------------------------------------------
# K1/K2
# ---------------------------------------------------------------------------


def kinds(factor) -> tuple[str, ...]:
    """The right-hand-side types a factor takes: one complex64 column, or
    one or two float32 columns."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    return ("c64",) if bc.band_is_complex(factor.band) else ("f32x1", "f32x2")


def mode_of(factor) -> str:
    return "pivoted" if hasattr(factor, "perms") else "pivot_free"


def key_of(k: str, f, kind: str) -> str:
    """The ``band_cuda.LAUNCHES`` key of kernel ``k`` on factor ``f``."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    return bc.launch_key(k, mode_of(f), kind, f.band.dtype == torch.bfloat16, f.band.shape[2])


def mode_name(f, kind: str) -> str:
    """A factor's mode, storage, type and nb, as the log and the kernels
    line name them ("pivot-free bf16 c64 nb=256", ...)."""
    import torch

    bf16 = " bf16" if f.band.dtype == torch.bfloat16 else ""
    return f"{mode_of(f).replace('_', '-')}{bf16} {kind} nb={f.band.shape[2]}"


def rhs(kind: str, nblk: int, nb: int, device, seed: int):
    """(nblk, nb) complex64 or (nblk, nb, m) float32 blocks from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "c64":
        return torch.randn((nblk, nb), dtype=torch.complex64, generator=g, device=device)
    return torch.randn((nblk, nb, int(kind[-1])), generator=g, device=device)


def substitutions(f) -> tuple:
    """(K1, K1 plain, K2, K2 plain) of a factor in its mode: K1 takes b,
    K2 takes K1's result."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    if mode_of(f) == "pivoted":
        return (lambda b: bc.fwd_substitute_pivoted(f.L2, f.L1inv, f.perms, b),
                lambda b: bc.fwd_substitute_pivoted_plain(f.L2, f.L1inv, f.perms, b),
                lambda y: bc.bwd_substitute_pivoted(f.band, f.Uinv, y),
                lambda y: bc.bwd_substitute_pivoted_plain(f.band, f.Uinv, y))
    return (lambda b: bc.fwd_substitute(f.band, b),
            lambda b: bc.fwd_substitute_plain(f.band, b),
            lambda y: bc.bwd_substitute(f.band, f.dinv, y),
            lambda y: bc.bwd_substitute_plain(f.band, f.dinv, y))


def check_kernels(f, b, what: str, tol: float = REL_TOL, backward: bool = False) -> dict:
    """K1 and K2 of the factor's mode against their plain versions on the
    same inputs (K2 takes the plain forward result for both).  With
    ``backward`` (a pivot-free factor too ill-conditioned for two f32
    substitutions to agree in their solutions), K2 is held by its backward
    error instead: within 10x of the plain loop's (:func:`bwd_residual`)."""
    import torch

    fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
    y_ref = fwd_plain(b)
    y = fwd(b)
    x_ref = bwd_plain(y_ref)
    x = bwd(y_ref)
    torch.cuda.synchronize()
    out = {"K1": rel_err(y, y_ref), "K2": rel_err(x, x_ref)}
    for k, (a, r) in out.items():
        log(f"  {what}: {k} {mode_name(f, kind_name(b))}: max abs err {a:.3e}, rel {r:.3e} "
            f"(limit {tol:.0e})")
        if k == "K2" and backward:
            res, res_ref = bwd_residual(f, y_ref, x), bwd_residual(f, y_ref, x_ref)
            log(f"  {what}: K2 backward error {res:.3e}, the plain loop's {res_ref:.3e} (limit "
                f"10x the plain loop's + 1e-6)")
            if not res <= 10 * res_ref + 1e-6:
                raise RuntimeError(f"{what}: K2's backward error {res:.3e} against the plain "
                                   f"loop's {res_ref:.3e}")
            continue
        if not np.isfinite(r) or r > tol:
            raise RuntimeError(f"{what}: {k} ({mode_name(f, kind_name(b))}) disagrees with its "
                               f"plain version (rel {r:.3e})")
    return out


def bwd_residual(f, y, x) -> float:
    """The backward error |D^-1 y - (I + D^-1 U) x| / |D^-1 y| of a
    pivot-free K2 solve in complex128, over the block rows whose window
    lies inside the returned blocks: a backward-stable substitution keeps
    it at rounding level however ill-conditioned U is."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    B, nblk = f.B, f.dinv.shape[0]
    K = min(nblk, x.shape[0]) - B
    cplx = bc.band_is_complex(f.band)
    c128 = torch.complex128
    x3, y3 = bc._cols(x).to(c128), bc._cols(y).to(c128)
    dy = torch.bmm(bc.widen(f.dinv[:K], cplx).to(c128), y3[:K])
    acc = x3[:K].clone()
    for t in range(B):
        acc += torch.bmm(bc.widen(f.band[:K, B + 1 + t], cplx).to(c128), x3[1 + t:K + 1 + t])
    return float(torch.linalg.vector_norm(dy - acc) / torch.linalg.vector_norm(dy))


def kind_name(b) -> str:
    return "c64" if b.is_complex() else f"f32x{b.shape[2]}"


def random_band(B: int, nb: int, rows_total: int, nblk: int, device, real: bool = False,
                bf16: bool = False):
    """A random factored pivot-free band and Dinv (scaled by 2e-3 so the
    recursion stays bounded), drawn by the device's generator (a wide
    band's gigabytes); ``bf16``: the band rounded to bf16 storage."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    g = torch.Generator(device=device).manual_seed(0)
    dtype = torch.float32 if real else torch.complex64

    def rand(shape, scale):
        return torch.randn(shape, generator=g, device=device, dtype=dtype) * scale

    eye = torch.eye(nb, dtype=dtype, device=device)
    band = rand((rows_total, 2 * B + 1, nb, nb), 2e-3)
    return SimpleNamespace(band=bc.narrow(band) if bf16 else band,
                           dinv=(rand((nblk, nb, nb), 2e-3) + eye).contiguous())


def random_pivoted(B: int, nb: int, nblk: int, device, real: bool = False,
                   scale: float = 0.005):
    """A random band that needs pivoting, drawn by the device's generator
    and factored on it by the port's ``_pfactor``.  The matrix is a row
    permutation of I + s N (N standard normal, zero in the band's two
    outermost slots; s = ``scale``): half the rows of each even block row
    trade places with rows of the next block row, and the rows inside each
    diagonal block are shuffled.  So the panel LU pivots within and across
    block rows, and the factor is well conditioned: f32 solves agree with
    f64 to about 3e-7 (a CPU run at B = 7, 24 block rows)."""
    import torch
    from lsafw_tpu_torch.solver import band as tband

    g = torch.Generator(device=device).manual_seed(0)
    rows_total, R = nblk + B, 2 * B + 1

    def noise():
        return torch.randn((rows_total, R, nb, nb), generator=g, device=device) * scale

    band = noise() if real else torch.complex(noise(), noise())
    band[:, 0] = 0
    band[:, 2 * B] = 0
    band[:, B] += torch.eye(nb, device=device)
    for K in range(0, nblk - 1, 2):
        a, a2 = (torch.randperm(nb, generator=g, device=device)[:nb // 2] for _ in range(2))
        row_a, row_b = band[K, :, a].clone(), band[K + 1, :, a2].clone()
        band[K, :, a] = torch.cat([torch.zeros_like(row_b[:1]), row_b[:-1]])  # one slot right
        band[K + 1, :, a2] = torch.cat([row_a[1:], torch.zeros_like(row_a[:1])])  # one slot left
    for K in range(nblk):
        band[K] = band[K][:, torch.randperm(nb, generator=g, device=device)]
    L2, L1inv, Uinv, perms = tband._pfactor(band, nblk, 0.0)
    return SimpleNamespace(band=band, L2=L2, L1inv=L1inv, Uinv=Uinv, perms=perms)


def subst_bounds(f, kind: str) -> dict:
    """Least time of K1 and K2 of a factor in its mode from the bytes they
    must move (each factor input read once, right-hand side and result
    once each: a bf16 band's entries at 2 bytes a value, Dinv's at 4) and
    their float32 operations (a complex multiply-add is 8 flops, a real
    one 2 per column)."""
    v = 8 if kind == "c64" else 4 * int(kind[-1])
    per_entry = 8 if kind == "c64" else 2 * int(kind[-1])
    e = 8 if kind == "c64" else 4  # an entry of Dinv, L2, L1inv, Uinv, and of an f32 band
    eb = e // 2 if f.band.element_size() == 2 else e  # an entry of the band
    nb = f.band.shape[2]
    B = (f.band.shape[1] - 1) // 2
    if mode_of(f) == "pivoted":
        nblk = f.L1inv.shape[0]
        fwd_entries = nblk * (B + 1) * nb * nb  # L2 and L1inv
        fwd_bytes = fwd_entries * e + f.perms.numel() * 8 + 2 * nblk * nb * v
        bwd_entries = nblk * (2 * B + 1) * nb * nb  # 2B U slots and Uinv
        bwd_bytes = bwd_entries * e + 2 * nblk * nb * v
    else:
        rows_total, nblk = f.band.shape[0], f.dinv.shape[0]
        fwd_entries = rows_total * B * nb * nb
        fwd_bytes = fwd_entries * eb + (nblk + rows_total) * nb * v
        bwd_entries = fwd_entries + nblk * nb * nb
        bwd_bytes = fwd_entries * eb + nblk * nb * nb * e + (rows_total + nblk) * nb * v
    return {"K1": bound(fwd_bytes, fwd_entries * per_entry, FP32_FLOPS_PER_S),
            "K2": bound(bwd_bytes, bwd_entries * per_entry, FP32_FLOPS_PER_S)}


PLAIN_LOOPS = ("fwd_substitute_plain", "bwd_substitute_plain", "fwd_substitute_pivoted_plain",
               "bwd_substitute_pivoted_plain")


@contextmanager
def plain_loops_forbidden():
    """While the block runs, the torch substitution loops raise on a CUDA
    tensor: the card path must run the kernels.  (The host-f32 factor of
    phase 3b takes them on CPU tensors.)"""
    from lsafw_tpu_torch.solver import band_cuda as bc

    saved = {name: getattr(bc, name) for name in PLAIN_LOOPS}

    def guard(name, plain):
        def no_loop_on_card(*args):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise RuntimeError(f"band_cuda.{name} ran on a CUDA tensor")
            return plain(*args)

        return no_loop_on_card

    for name, plain in saved.items():
        setattr(bc, name, guard(name, plain))
    try:
        yield
    finally:
        for name, plain in saved.items():
            setattr(bc, name, plain)


@contextmanager
def band_solves():
    """Count band solves (``solve`` of any band factor) per factor class
    while the block runs."""
    from lsafw_tpu_torch.solver import band as tband

    seen: dict = {}
    solve = tband._PermutedSolve.solve

    def counted(self, b):
        seen[type(self).__name__] = seen.get(type(self).__name__, 0) + 1
        return solve(self, b)

    tband._PermutedSolve.solve = counted
    try:
        yield seen
    finally:
        tband._PermutedSolve.solve = solve


@contextmanager
def matvecs():
    """Count the original-order matvecs of the refinement operators
    (``BCSROperator.matvec``, which ``matvec_pair`` calls, and
    ``BCSRShiftedOp.matvec_pair`` / ``mass_pair``) while the block runs."""
    from lsafw_tpu_torch.ops import bcsr

    seen = {"matvecs": 0}
    methods = [(bcsr.BCSROperator, "matvec"), (bcsr.BCSRShiftedOp, "matvec_pair"),
               (bcsr.BCSRShiftedOp, "mass_pair")]
    saved = [getattr(cls, name) for cls, name in methods]

    def counted(fn):
        def call(*args, **kw):
            seen["matvecs"] += 1
            return fn(*args, **kw)

        return call

    for (cls, name), fn in zip(methods, saved):
        setattr(cls, name, counted(fn))
    try:
        yield seen
    finally:
        for (cls, name), fn in zip(methods, saved):
            setattr(cls, name, fn)


def gate_permutes_and_spmv(what: str, launches: dict, types: str, solves: int,
                           n_matvecs: int) -> None:
    """G's permute-in and permute-out once each per band solve, in the
    stage's types (``"f64.f32x1"``: an f64 vector into one float32
    column and back); no flat-form complex128 G; and exactly one S launch,
    in the original order, per original-order matvec."""
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    src, kind = types.split(".")
    pin = {t: launches[f"permute_in.{t}"] for t in sc.PERMUTES["in"]}
    pout = {t: launches[f"permute_out.{t}"] for t in sc.PERMUTES["out"]}
    s_orig = sum(launches[m + ".original"] for m in sc.SPMV_KEYS)
    s_perm = sum(launches[m] for m in sc.SPMV_KEYS)
    if not (pin[types] == pout[f"{kind}.{src}"] == sum(pin.values()) == sum(pout.values())
            == solves > 0):
        raise RuntimeError(f"{what}: permute-in {pin} and permute-out {pout} for {solves} band "
                           f"solves of types {types}")
    if launches["gather_c128"]:
        raise RuntimeError(f"{what}: {launches['gather_c128']} flat-form complex128 G launches")
    if not (s_orig == n_matvecs > 0) or s_perm:
        raise RuntimeError(f"{what}: {s_orig} original-order and {s_perm} permuted S launches for "
                           f"{n_matvecs} original-order matvecs")


def gate_band_launches(what: str, launches: dict, key: str, solves: int) -> None:
    """K1 and K2 in one mode and type launched once per band solve, and no
    other band substitution launched."""
    from lsafw_tpu_torch.solver import band_cuda as bc

    k1, k2 = launches[f"K1.{key}"], launches[f"K2.{key}"]
    others = {k: launches[k] for k in bc.LAUNCHES if k not in (f"K1.{key}", f"K2.{key}")
              and launches[k]}
    if not (k1 == k2 == solves > 0) or others:
        raise RuntimeError(f"{what}: K1/K2 {key} launched {k1}/{k2} times for {solves} band "
                           f"solves (other band launches {others})")


# ---------------------------------------------------------------------------
# G
# ---------------------------------------------------------------------------


def gather_inputs(device, *, Na: int = 1 << 17, R: int = 1024, W: int = 16, N: int = 1 << 19,
                  M: int = 1 << 18) -> dict:
    """The probes' inputs from seeds: ``run_a`` (flat) and
    ``pallas_two_pass`` (lane-unique rows of 128, as the probe builds them),
    at the probes' sizes by default."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    xa = torch.randn(Na, generator=g, device=device)
    idx = torch.randint(0, Na, (R, W), generator=g, device=device, dtype=torch.int32)
    x = torch.randn(N, generator=g, device=device)
    rows = torch.randint(0, N // 128, (M, 128), generator=g, device=device, dtype=torch.int32)
    perm = torch.argsort(torch.rand((M, 128), generator=g, device=device), dim=1)
    lanes = perm.to(torch.int32)  # a shuffle of 0..127 per row
    rowsel = torch.gather(rows, 1, torch.argsort(perm, dim=1)).contiguous()
    flat = (rows.long() * 128 + lanes).to(torch.int32)
    return dict(xa=xa, idx=idx, x=x, x2d=x.view(N // 128, 128), rowsel=rowsel, lanesel=lanes,
                flat=flat)


def check_gather(gi: dict) -> dict:
    """G against ``x[idx]`` in both forms: exact."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    out = {}
    ya = sc.gather(gi["xa"], gi["idx"])
    y2 = sc.gather_two_pass(gi["x2d"], gi["rowsel"], gi["lanesel"])
    torch.cuda.synchronize()
    for name, got, refs in (
        ("flat", ya, (sc.gather_plain(gi["xa"], gi["idx"]),)),
        ("two_pass", y2, (sc.gather_two_pass_plain(gi["x2d"], gi["rowsel"], gi["lanesel"]),
                          gi["x"][gi["flat"]])),
    ):
        err = max(float((got - r).abs().max()) for r in refs)
        log(f"  G {name}: {got.numel()} values, max abs err {err:.1e}")
        if err != 0.0:
            raise RuntimeError(f"G ({name}) disagrees with x[idx]: max abs err {err}")
        out[name] = err
    return out


def permute_cases(b_real, b_cplx, perm, iperm, nb: int, keys=None) -> dict:
    """G's permutation forms in every type pair of ``spmv_cuda.PERMUTES``
    (or those of ``keys``), as ``(form, "<from>.<to>")`` -> (kernel call,
    plain call): into the band's order from an f64 or complex128 b
    (complex64, or float32 with one or two columns) and out of it (to f64
    or complex128; a complex64 x to f64 keeps its real part), on
    band-order blocks made from the b's."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    b_of = {"f64": b_real, "c128": b_cplx}
    dt_of = {"c64": torch.complex64, "f32x1": torch.float32, "f32x2": torch.float32}
    out = {}
    for src, kind in (t.split(".") for t in sc.PERMUTES["in"]):
        b, dt = b_of[src], dt_of[kind]
        if keys is None or ("in", f"{src}.{kind}") in keys:
            out[("in", f"{src}.{kind}")] = (lambda b=b, dt=dt: sc.permute_in(b, perm, nb, dt),
                                            lambda b=b, dt=dt: sc.permute_in_plain(b, perm, nb, dt))
        if keys is None or ("out", f"{kind}.{src}") in keys:
            x = sc.permute_in_plain(b, perm, nb, dt)
            out[("out", f"{kind}.{src}")] = (
                lambda x=x, to=b.dtype: sc.permute_out(x, iperm, to),
                lambda x=x, to=b.dtype: sc.permute_out_plain(x, iperm, to))
    return out


def check_permutes(cases: dict, what: str) -> None:
    """Each permute form against its plain version: equal, bit for bit."""
    import torch

    for (form, types), (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        same = got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)
        log(f"  G permute-{form} {types} {what}: {tuple(got.shape)} {got.dtype}, "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"G permute-{form} ({types}) disagrees with its plain version "
                               f"{what}")


def random_permutation(n: int, nb: int, device, seed: int):
    """A padded band permutation from a seed: n vector entries and their
    padding up to whole blocks of nb (plus one), shuffled together; the
    inverse gives each entry's slot.  Returns (f64 b, complex128 b, perm,
    iperm)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    npad = (n // nb + 2) * nb
    perm = torch.randperm(npad, generator=g, device=device)
    iperm = torch.argsort(perm)[:n].to(torch.int32)
    br = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    bc = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                       torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return br, bc, perm.to(torch.int32), iperm


def gather_bound(elem: int, x_touched: int, index_bytes: int, count: int) -> tuple[float, str]:
    """The x elements this run's indices touch, the indices, the output
    (``elem`` bytes per value)."""
    return bound(elem * x_touched + index_bytes + elem * count, 0, FP32_FLOPS_PER_S)


def main_path_gathers(A, cop, device) -> dict:
    """G at the main path's own types and shapes: the flat form as (x, idx)
    pairs, the f64 CSR value refill (A's values through the permuted CSR's
    slot map, nnz indices, padded) and a complex128 band permutation (not
    on the main path since the permute forms); the permute forms on the
    eigen stage's complex plan (complex128 b) and the baseflow's real
    plan (f64 b), on vectors from a seed."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.solver.band import plan_for_csr

    ix = plan_for_csr(A).on(device)  # the eigen stage's cached complex plan
    rx = plan_for_csr(A, real=True).on(device)  # the baseflow's real plan of the same pattern
    g = torch.Generator(device=device).manual_seed(3)
    n = A.shape[0]
    npad = ix["perm_pad"].numel()
    xc = torch.complex(torch.randn(npad, generator=g, device=device, dtype=torch.float64),
                       torch.randn(npad, generator=g, device=device, dtype=torch.float64))
    br = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    bc = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                       torch.randn(n, generator=g, device=device, dtype=torch.float64))
    nb = 128
    cplx = {(f, t) for f in ("in", "out") for t in sc.PERMUTES[f] if "c64" in t}
    real = {(f, t) for f in ("in", "out") for t in sc.PERMUTES[f] if "f32" in t}
    permutes = {**permute_cases(br, bc, ix["perm_pad"], ix["iperm"], nb, cplx),
                **permute_cases(br, bc, rx["perm_pad"], rx["iperm"], nb, real)}
    return {"f64": [(A.data.contiguous(), cop.plan.on(device).src)],
            "c128": [(xc, ix["perm_pad"])], "permutes": permutes,
            "plans": {"c64": (ix, bc, br), "f32": (rx, bc, br)}}


def check_main_gathers(pairs: dict) -> dict:
    """G's flat form against ``x[idx]`` and the permute forms against
    their plain versions on the main path's inputs: exact."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    out = {}
    for kind in ("f64", "c128"):
        errs = []
        for x, idx in pairs[kind]:
            got = sc.gather(x, idx)
            ref = sc.gather_plain(x, idx)
            torch.cuda.synchronize()
            errs.append(float((got - ref).abs().max()))
            log(f"  G {kind} at the main path's shape: {idx.numel()} of {x.numel()} values, "
                f"max abs err {errs[-1]:.1e}")
        if max(errs) != 0.0:
            raise RuntimeError(f"G ({kind}) disagrees with x[idx] on the main path's inputs: {errs}")
        out[kind] = max(errs)
    check_permutes(pairs["permutes"], "on the main path's plans")
    return out


def op_sequence_in(b, perm, n: int, nb: int, dtype):
    """The op sequence the permute-in form replaces (zeros, copy, the flat
    G gather, the cast, and the stack into columns), as a yardstick."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    cols = [b] if dtype.is_complex else ([b.real, b.imag] if b.is_complex() else [b])
    outs = []
    for c in cols:
        bp = torch.zeros(perm.numel(), dtype=c.dtype, device=c.device)
        bp[:n] = c
        outs.append(sc.gather(bp, perm).to(dtype).reshape(-1, nb))
    return outs[0] if dtype.is_complex else torch.stack(outs, dim=2)


def op_sequence_out(x, iperm, dtype):
    """The op sequence the permute-out form replaces (the cast up and the
    flat G gather, per column)."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    if x.is_complex():
        return sc.gather(x.reshape(-1).to(torch.complex128), iperm)
    return sc.gather(x[:, :, 0].reshape(-1).to(torch.float64), iperm)


# ---------------------------------------------------------------------------
# The cylinder
# ---------------------------------------------------------------------------


def cylinder_case(device) -> dict:
    """bench.py's reduced cylinder: mesh, spaces, BCs, assembly context."""
    import torch
    from lsafw_tpu_torch.config import BoundaryConditionsConfig, CylinderFlowGeometryConfig
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    geo = CylinderFlowGeometryConfig(
        dim=2, cylinder_radius=0.5, cylinder_center=(0.0, 0.0),
        x_range=(-10.0, 30.0), y_range=(-10.0, 10.0), resolution=0.5,
        resolution_around_cylinder=0.15, influence_radius=8.0,
    )
    mesh = cylinder_flow_mesh(geo, max_iter=80, seed=0)
    INLET, OUTLET, BOTTOM, TOP, CYL = 1, 2, 3, 4, 5

    def marker(x):
        out = np.full(x.shape[0], CYL, dtype=np.int32)
        out[np.isclose(x[:, 1], -10.0, atol=1e-6)] = BOTTOM
        out[np.isclose(x[:, 1], 10.0, atol=1e-6)] = TOP
        out[np.isclose(x[:, 0], -10.0, atol=1e-6)] = INLET
        out[np.isclose(x[:, 0], 30.0, atol=1e-6)] = OUTLET
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    C = BoundaryConditionsConfig
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
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0)


_HOST_LU: dict = {}  # the port's host LU class, kept while forbid_host_lu() stubs it out


def forbid_host_lu() -> None:
    """Make every host LU of the port raise: the device path must not use it."""
    from lsafw_tpu_torch import floquet, sensitivity
    from lsafw_tpu_torch.solver import baseflow, direct, eigen, newton, precond, timestepping

    def no_host_lu(*args, **kw):
        raise RuntimeError("host LU called on the device path")

    _HOST_LU.setdefault("SparseLU", direct.SparseLU)
    for mod, name in ((direct, "SparseLU"), (direct, "direct_solve"), (newton, "SparseLU"),
                      (baseflow, "direct_solve"), (eigen, "SparseLU"), (sensitivity, "SparseLU"),
                      (timestepping, "SparseLU"), (floquet, "SparseLU"), (precond, "SparseLU")):
        setattr(mod, name, no_host_lu)


@contextmanager
def host_lu_counted(module=None):
    """The host LU of ``module`` (default: the shift-invert operator's
    ``"lu"`` method), asked for explicitly, while the block runs, counting
    its factorizations; it raises again after the block."""
    from lsafw_tpu_torch.solver import eigen

    module = module or eigen
    seen = {"host_lu": 0}
    lock = threading.Lock()  # the factors may be made in several threads

    class Counted(_HOST_LU.get("SparseLU") or module.SparseLU):  # the check worker: unstubbed
        def __init__(self, *args, **kw):
            with lock:
                seen["host_lu"] += 1
            super().__init__(*args, **kw)

    saved = module.SparseLU
    module.SparseLU = Counted
    try:
        yield seen
    finally:
        module.SparseLU = saved


_CHECKS: list = []  # (what, AsyncResult, gate) of the cross-checks in the check worker
_CHECK_POOL: list = []


def start_host_check(what: str, fn, args: tuple, gate) -> None:
    """Run the host cross-check ``fn(*args)`` (host arrays in and out, its
    host LU counted where it runs) in the check worker, one spawned
    process on the host CPU, while the card goes on; :func:`finish_host_checks`
    waits for it and calls ``gate(out)``.  The worker is terminated when
    the script exits."""
    if not _CHECK_POOL:
        _CHECK_POOL.append(multiprocessing.get_context("spawn").Pool(1))
        atexit.register(_CHECK_POOL[0].terminate)
    _CHECKS.append((what, _CHECK_POOL[0].apply_async(fn, args), gate))


def finish_host_checks(prefix: str = "") -> None:
    """Wait for the check worker's cross-checks of the phases named
    ``prefix``... and gate each."""
    for item in [c for c in _CHECKS if c[0].startswith(prefix)]:
        _CHECKS.remove(item)
        what, job, gate = item
        t0 = time.time()
        out = job.get()
        log(f"{what}: its host cross-check collected from the check worker after a wait of "
            f"{time.time() - t0:.2f} s")
        gate(out)


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def counts() -> dict:
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda

    return {**band_cuda.LAUNCHES, **spmv_cuda.LAUNCHES}


def reset_counts() -> None:
    from lsafw_tpu_torch.ops import spmv_cuda
    from lsafw_tpu_torch.solver import band_cuda

    band_cuda.reset_launches()
    spmv_cuda.reset_launches()


def leading_pair(A, M, target: complex = TARGET, method: str = "banded"):
    import torch
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    t0 = time.time()
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    es.set_st_pc_type(method)
    pairs = es.solve()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    ACCEPTANCE.update(acceptance(es))
    return pairs[0][0], float(eigen_residuals(A, M, pairs)[0]), es.operator, seconds


ACCEPTANCE: dict = {}  # leading_pair's last acceptance(), for the phase's log


def acceptance(es) -> dict:
    """How ``EigenSolver`` judged its last solve, both ways, at its limit of
    10 atol: the largest backward error of the pairs it returned (the
    port's test), and the largest residual relative to |lambda| + 1 over
    every Ritz pair (the reference's).  A pollution fails both."""
    from lsafw_tpu_torch.solver.eigen import eigen_residuals

    lam = es.operator.back_transform(es.result.eigenvalues)
    ritz = list(zip([complex(v) for v in lam], es.result.eigenvectors))
    return dict(backward=float(es._worst_residual(lam, es.result)),
                reference=float((eigen_residuals(es.A, es.M, ritz) / (np.abs(lam) + 1.0)).max()),
                limit=10.0 * max(es.config.atol, 1e-12))


def acceptance_text(acc: dict) -> str:
    return (f"acceptance: backward error {acc['backward']:.2e}, the reference's residual / "
            f"(|lambda| + 1) {acc['reference']:.2e} (limit {acc['limit']:.0e})")


def gate_sigma(what: str, sigma: complex, resid: float) -> None:
    if abs(sigma - SIGMA_REF) > 1e-4:
        raise RuntimeError(f"{what}: sigma {sigma} is not within 1e-4 of {SIGMA_REF}")
    if abs(sigma - SIGMA_CARD) > 5e-7:
        raise RuntimeError(f"{what}: sigma {sigma} is not within 5e-7 of {SIGMA_CARD}")
    if not resid <= 1e-8:
        raise RuntimeError(f"{what}: eigen residual {resid:.2e} > 1e-8")


def main_path(case) -> dict:
    """Phase 3: banded baseflow, eigensystem, pivoted shift-invert."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    reset_counts()
    t0 = time.time()
    with band_solves() as base_solves, matvecs() as base_mv:
        solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=47.0)
        w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
        torch.cuda.synchronize()
    t_base = time.time() - t0
    base_counts = counts()
    t0 = time.time()
    A, M = LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                           case["mesh"]).assemble_eigensystem()
    torch.cuda.synchronize()
    t_asm = time.time() - t0
    reset_counts()
    with band_solves() as eig_solves, matvecs() as eig_mv:
        sigma, resid, op, t_eig = leading_pair(A, M)
    eig_counts = counts()
    st = solver.stats
    log(f"phase 3: {case['spaces'].num_dofs} DOFs; stages mesh {case['seconds']:.2f} s, "
        f"baseflow {t_base:.2f} s (factor {st['factor_s']:.2f} s in {st['factors']}, "
        f"band solves {st['solve_s']:.2f} s in {st['solves']}, SpMV {st['spmv_s']:.2f} s in "
        f"{st['spmvs']}), assemble {t_asm:.2f} s, eigen {t_eig:.2f} s (factor "
        f"{op.factor_seconds:.2f} s)")
    log(f"phase 3: Newton iterations {[r.iterations for r in solver.newton_results]}, "
        f"GCR iterations {st['gcr_its']}, real pivoted factors {st['pivoted']}/{st['factors']}")
    log(f"phase 3: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; "
        f"pivoted factor {op.pivoted}, contraction {op.rho:.2e}, refinement cap "
        f"{op.refine_its}, {op.applies} shift-invert applies; {acceptance_text(ACCEPTANCE)}")
    log(f"phase 3: band solves in baseflow {base_solves}, in eigen {eig_solves}; original-order "
        f"matvecs in baseflow {base_mv['matvecs']}, in eigen {eig_mv['matvecs']}")
    log(f"phase 3: launches in baseflow {nonzero(base_counts)}; in eigen {nonzero(eig_counts)}")
    ours = sum(base_counts.values())
    log(f"phase 3: baseflow: {ours} launches of the port's kernels in {st['gcr_its']} GCR "
        f"iterations and {st['solves']} band solves: {ours / max(st['gcr_its'], 1):.2f} per GCR "
        f"iteration")
    gate_sigma("phase 3", sigma, resid)
    gate_band_launches("phase 3 baseflow", base_counts, "pivoted.f32x1",
                       base_solves.get("RealPivotedBandedLU", 0))
    if base_solves.get("RealPivotedBandedLU", 0) != st["solves"]:
        raise RuntimeError(f"baseflow band solves {base_solves} against its count {st['solves']}")
    gate_band_launches("phase 3 eigen", eig_counts, "pivoted.c64",
                       eig_solves.get("PivotedBandedLU", 0))
    if not op.pivoted or op.device_op.Cop is None:
        raise RuntimeError("phase 3 did not take the pivoted factor with the fused matvecs")
    if st["pivoted"] != st["factors"] or st["factors"] == 0:
        raise RuntimeError(f"the baseflow did not factor pivoted on the card: {st}")
    gate_permutes_and_spmv("phase 3 baseflow", base_counts, "f64.f32x1",
                           base_solves.get("RealPivotedBandedLU", 0), base_mv["matvecs"])
    gate_permutes_and_spmv("phase 3 eigen", eig_counts, "c128.c64",
                           eig_solves.get("PivotedBandedLU", 0), eig_mv["matvecs"])
    if min(base_counts["spmv_real.original"], base_counts["gather_f64"]) <= 0:
        raise RuntimeError(f"S or G never launched in the baseflow: {nonzero(base_counts)}")
    if min(eig_counts["spmv_shifted.original"], eig_counts["spmv_complex.original"],
           eig_counts["gather_f64"]) <= 0:
        raise RuntimeError(f"S or G never launched in the eigen stage: {nonzero(eig_counts)}")
    launches = {k: base_counts[k] + eig_counts[k] for k in base_counts}
    stages = dict(mesh=case["seconds"], baseflow=t_base, assemble=t_asm, eigen=t_eig,
                  factor=op.factor_seconds)
    return dict(A=A, M=M, w=w, op=op, launches=launches, stages=stages, newton=st,
                sigma=sigma, resid=resid, per_gcr=ours / max(st["gcr_its"], 1))


def host_contraction(op) -> float:
    """Calibration contraction of the pivot-free shift-invert operator with
    its band factored on the host CPU (true f32 products): the yardstick
    for the card's factor precision."""
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    def cpu(m):
        return CSRMatrix(m.pattern, m.data.cpu())

    return ShiftInvertOperator(cpu(op.A), cpu(op.M), op.sigma).rho


def pivot_free_path(A, M, sigma_main: complex) -> dict:
    """Phase 3b: the pivot-free factor, its substitution through K1/K2."""
    with env(LSAFW_PIVOT_MEM_GB="0"):
        reset_counts()
        with band_solves() as solves, matvecs() as mv, plain_loops_forbidden():
            sigma, resid, op, t_eig = leading_pair(A, M)
        launches = counts()
        log(f"phase 3b: pivot-free: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual "
            f"{resid:.2e}, eigen {t_eig:.2f} s (factor {op.factor_seconds:.2f} s), contraction "
            f"{op.rho:.2e}, {op.applies} applies, band solves {solves}, original-order matvecs "
            f"{mv['matvecs']}; launches {nonzero(launches)}")
        gate_sigma("phase 3b", sigma, resid)
        if abs(sigma - sigma_main) > 1e-8:
            raise RuntimeError(f"phase 3b: sigma {sigma} is not within 1e-8 of phase 3's "
                               f"{sigma_main}")
        if op.pivoted:
            raise RuntimeError("phase 3b did not take the pivot-free factor")
        gate_band_launches("phase 3b", launches, "pivot_free.c64", solves.get("BandedLU", 0))
        gate_permutes_and_spmv("phase 3b", launches, "c128.c64", solves.get("BandedLU", 0),
                               mv["matvecs"])
        t0 = time.time()
        rho_host = host_contraction(op)
    log(f"phase 3b: the same factor built in f32 on the host CPU contracts by {rho_host:.2e} "
        f"(card {op.rho:.2e}; {time.time() - t0:.1f} s)")
    if not op.rho <= 3 * rho_host:
        raise RuntimeError("the card's factor contracts far worse than the host's f32 factor: "
                           "check the matmul precision (TF32)")
    return dict(op=op, launches=launches)


@contextmanager
def env(**values: str):
    """The environment variables ``values`` set while the block runs."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def bf16_path(case, mp: dict, pf: dict) -> dict:
    """Phase 3c: the complex band over its budget on phase 3's (A, M)
    (``LSAFW_BAND_MEM_GB=0.5``: 0.77 GB in f32, 0.38 GB in bf16, so bf16
    at full width; pivot-free), its substitution through K1/K2 pivot-free
    bf16 complex64; then one banded real solve of phase 3's last Jacobian
    on a bf16 band (``LSAFW_BAND_MEM_GB=0.3``), K1/K2 pivot-free bf16
    float32 with one column, GCR to 1e-10."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.newton import banded_solve

    A, M = mp["A"], mp["M"]
    with env(LSAFW_PIVOT_MEM_GB="0", LSAFW_BAND_MEM_GB="0.5"):
        reset_counts()
        with band_solves() as solves, matvecs() as mv, plain_loops_forbidden():
            sigma, resid, op, t_eig = leading_pair(A, M)
        launches = counts()
        plan = tband.plan_for_csr(A)
    full = tband.plan_for_csr(A)  # the default budget's plan: f32, full width
    blu = op.device_op.blu
    log(f"phase 3c: bf16 band: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual "
        f"{resid:.2e}, eigen {t_eig:.2f} s (factor {op.factor_seconds:.2f} s), contraction "
        f"{op.rho:.2e} (phase 3b's f32 band: {pf['op'].rho:.2e}), trial GCR solve {op.trial_its} "
        f"iterations, refinement cap {op.refine_its}, "
        f"{op.applies} applies; plan B = {plan.B} ({plan.band_dtype}; f32 plan B = {full.B}), "
        f"band {blu.band.numel() * blu.band.element_size() / 1e9:.3f} GB; band solves {solves}, "
        f"original-order matvecs {mv['matvecs']}; launches {nonzero(launches)}")
    gate_sigma("phase 3c", sigma, resid)
    if abs(sigma - mp["sigma"]) > 1e-8:
        raise RuntimeError(f"phase 3c: sigma {sigma} is not within 1e-8 of phase 3's {mp['sigma']}")
    if op.pivoted or blu.band.dtype != torch.bfloat16 or plan.B != full.B:
        raise RuntimeError(f"phase 3c did not take the pivot-free bf16 band at full width: pivoted "
                           f"{op.pivoted}, {blu.band.dtype}, B {plan.B} of {full.B}")
    gate_band_launches("phase 3c", launches, "pivot_free.bf16.c64", solves.get("BandedLU", 0))
    gate_permutes_and_spmv("phase 3c", launches, "c128.c64", solves.get("BandedLU", 0),
                           mv["matvecs"])

    J = StationaryNavierStokesAssembler(case["ctx"], case["mesh"], case["bcs_base"]).jacobian(
        mp["w"], 47.0)
    g = torch.Generator(device=J.data.device).manual_seed(7)
    b = torch.randn(J.shape[0], generator=g, device=J.data.device, dtype=torch.float64)
    with env(LSAFW_PIVOT_MEM_GB="0", LSAFW_BAND_MEM_GB="0.3"):
        rplan = tband.plan_for_csr(J, real=True)
        reset_counts()
        with band_solves() as rsolves, plain_loops_forbidden():
            t0 = time.time()
            res = banded_solve(J, b, rplan, tol=1e-10)
            torch.cuda.synchronize()
            t_real = time.time() - t0
        rlaunches = counts()
    log(f"phase 3c: banded real solve of the last Jacobian on a {rplan.band_dtype} band (B = "
        f"{rplan.B}): {res.iterations} GCR iterations to {res.residual:.2e} in {t_real:.2f} s; "
        f"band solves {rsolves}; launches {nonzero(rlaunches)}")
    if rplan.band_dtype != "bf16" or not res.converged or not res.residual <= 1e-10:
        raise RuntimeError(f"phase 3c: the bf16 real solve: band {rplan.band_dtype}, converged "
                           f"{res.converged}, residual {res.residual:.2e}")
    gate_band_launches("phase 3c real", rlaunches, "pivot_free.bf16.f32x1",
                       rsolves.get("RealBandedLU", 0))
    launches = {k: launches[k] + rlaunches[k] for k in launches}
    return dict(op=op, launches=launches, J=J, rplan=rplan)


# ---------------------------------------------------------------------------
# S
# ---------------------------------------------------------------------------


S_KEYS = {"real": "spmv_real", "shifted": "spmv_shifted", "shifted_mass": "spmv_shifted",
          "mass": "spmv_complex", "shifted_real": "spmv_shifted_real",
          "shifted_real_mass": "spmv_shifted_real"}
CN_SHIFT = 16.0  # the Crank-Nicolson shift 2/dt of phase 7's horizon (T = 4, 32 steps)


def spmv_cases(cop, device, csrs: dict | None = None, s_real: float = CN_SHIFT) -> dict:
    """S's modes in both orders on a shifted operator's storage, as
    ``(mode, order)`` -> (kernel call, plain call), on vectors made from a
    seed: real (A x, f64 x), shifted ((A - sigma M) x), shifted_mass (the
    same and M x), mass (M x, complex128 x), shifted_real and
    shifted_real_mass ((A - s M) x on an f64 x at the real shift
    ``s_real``, and M x).  ``csrs`` replaces the plan's operands in either
    order."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    csrs = csrs or {o: cop.plan.on(device, o) for o in ("permuted", "original")}
    g = torch.Generator(device=device).manual_seed(2)
    n = cop.plan.n
    xr = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    xc = torch.complex(xr, torch.randn(n, generator=g, device=device, dtype=torch.float64))
    s = cop.sigma
    out = {}
    for order in ("permuted", "original"):
        c = csrs[order]
        out[("real", order)] = (lambda c=c: sc.csr_spmv(c, cop.vA, xr),
                                lambda c=c: sc.csr_spmv_plain(c, cop.vA, xr))
        out[("shifted", order)] = (lambda c=c: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xc, s),
                                   lambda c=c: sc.csr_spmv_plain(c, cop.vA, xc, cop.vM, s))
        out[("shifted_mass", order)] = (
            lambda c=c: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xc, s, mass=True),
            lambda c=c: sc.csr_spmv_plain(c, cop.vA, xc, cop.vM, s, mass=True))
        out[("mass", order)] = (lambda c=c: sc.csr_spmv(c, cop.vM, xc),
                                lambda c=c: sc.csr_spmv_plain(c, cop.vM, xc))
        for mode, mass in (("shifted_real", False), ("shifted_real_mass", True)):
            out[(mode, order)] = (
                lambda c=c, mass=mass: sc.csr_shifted_spmv(c, cop.vA, cop.vM, xr, s_real,
                                                           mass=mass),
                lambda c=c, mass=mass: sc.csr_spmv_plain(c, cop.vA, xr, cop.vM, s_real, mass))
    return out


def spmv_library(A, M, sigma, device, s_real: float = CN_SHIFT) -> dict:
    """The cuSPARSE yardstick of each mode (the CSR pair in the original
    order, which is each original-order apply's own function), on the
    vectors of :func:`spmv_cases`."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    g = torch.Generator(device=device).manual_seed(2)
    n = A.shape[0]
    xr = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    xc = torch.complex(xr, torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return {"real": lambda: spmv(A, xr),
            "shifted": lambda: spmv(A, xc) - sigma * spmv(M, xc),
            "shifted_mass": lambda: (lambda m: (spmv(A, xc) - sigma * m, m))(spmv(M, xc)),
            "mass": lambda: spmv(M, xc),
            "shifted_real": lambda: spmv(A, xr) - s_real * spmv(M, xr),
            "shifted_real_mass": lambda: (lambda m: (spmv(A, xr) - s_real * m, m))(spmv(M, xr))}


def spmv_work(mode: str, order: str, n: int, nnz: int, ntiles: int,
              nx: int | None = None) -> tuple[float, float]:
    """(bytes, f64 operations) S must move and do: columns and values,
    row pointers, S's tiles, x once (``nx`` entries of it, default n),
    the permutation in the original order, the outputs (complex
    multiply-add of a real value 4 flops)."""
    nx = n if nx is None else nx
    structure = (n + 1) * 8 + nnz * 4 + (ntiles + 1) * 12 + (n * 4 if order == "original" else 0)
    return {"real": (structure + nnz * 8 + (n + nx) * 8, 2 * nnz),
            "shifted": (structure + 2 * nnz * 8 + (n + nx) * 16, 8 * nnz + 8 * n),
            "shifted_mass": (structure + 2 * nnz * 8 + (2 * n + nx) * 16, 8 * nnz + 8 * n),
            "mass": (structure + nnz * 8 + (n + nx) * 16, 4 * nnz),
            "shifted_real": (structure + 2 * nnz * 8 + (n + nx) * 8, 4 * nnz + 2 * n),
            "shifted_real_mass": (structure + 2 * nnz * 8 + (2 * n + nx) * 8,
                                  4 * nnz + 2 * n)}[mode]


def check_spmv(cases: dict, what: str) -> dict:
    """S against its plain version in every mode and order: rel <= 1e-12
    (and one call's time with its host overhead, CUDA events)."""
    import torch

    out = {}
    for (mode, order), (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        a, r = (max(v) for v in zip(*(rel_err(g_, r_) for g_, r_ in pairs)))
        log(f"  S {mode} {order} {what}: max abs err {a:.3e}, rel {r:.3e}; one call "
            f"{cuda_ms(kern, 3):.4f} ms")
        if not np.isfinite(r) or r > SPMV_REL_TOL:
            raise RuntimeError(f"S ({mode}, {order}) {what} disagrees with its plain version "
                               f"(rel {r:.3e})")
        out[(mode, order)] = a
    return out


def random_shifted_op(n: int, device, seed: int, row_lens: tuple[int, int] = (0, 60)):
    """A shifted operator on a random pattern from a seed: ``row_lens``
    (low, high) nonzeros a row, by default 0 to 59 (2D Taylor-Hood rows
    average 29; (60, 131) averages the 95 of the 3D cube's), every 97th row
    empty, row 5 of 5,000 nonzeros (longer than a tile), under a random
    permutation that puts rows of one nonzero at 1,000 to 1,599 (tiles of
    the most rows a tile holds)."""
    import torch
    import scipy.sparse as sp
    from lsafw_tpu_torch.ops import bcsr

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    lens = rng.integers(*row_lens, n)
    lens[perm[1000:1600]] = 1
    lens[::97] = 0
    lens[5] = 5000
    rows = [np.unique(rng.integers(0, n, k)) for k in lens]
    cols = np.concatenate(rows)
    indptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    A = sp.csr_matrix((rng.standard_normal(cols.size), cols, indptr), shape=(n, n))
    plan = bcsr.BCSRPlan.build(A, perm=perm)

    def vals():
        return bcsr._values(plan, torch.as_tensor(rng.standard_normal(A.nnz), device=device))

    return bcsr.BCSRShiftedOp(vals(), vals(), 0.3 + 0.74j, plan)


def main_path_factors(mp: dict, pf: dict) -> list:
    """The band factors of the main path's operators, one per mode and
    type: the eigen stage's pivoted complex factor (phase 3), phase 3b's
    pivot-free complex factor, and a real pivoted and a real pivot-free
    factor of A - Re(sigma) M on the baseflow's real plan (the Newton
    Jacobians' pattern and geometry)."""
    import torch
    from lsafw_tpu_torch.solver import band as tband

    A, M, s = mp["A"], mp["M"], mp["op"].sigma
    dre = A.data - s.real * M.data
    plan = tband.plan_for_csr(A, real=True)
    torch.cuda.synchronize()
    t0 = time.time()
    real_pivoted = tband.factor_auto(plan, dre)[0]
    torch.cuda.synchronize()
    t_factor = time.time() - t0
    with env(LSAFW_PIVOT_MEM_GB="0"):
        real_pivot_free = tband.factor_auto(plan, dre, diag_slots=A.pattern.diag_slots)[0]
    log(f"phase 4: {type(real_pivoted).__name__}: factor {t_factor:.3f} s (host clock, "
        f"synchronised); the eigen stage's complex factor took {mp['op'].factor_seconds:.3f} s")
    return [mp["op"].device_op.blu, pf["op"].device_op.blu, real_pivoted, real_pivot_free]


def k1_library(f, b, y) -> float | None:
    """The time of one PyTorch call that computes pivot-free K1 on the
    same inputs, or None where it fails: ``torch.triangular_solve`` with
    the band's unit block-lower factor L (the ``band[:, :B]`` blocks; the
    diagonal blocks are I) as a sparse CSR tensor of the band's type
    (complex64, or float32 with b's one or two columns), which runs
    cuSPARSE's triangular solve, analysis included.  Its result is held to
    K1's ``y`` (rel 1e-4: two f32 substitutions in another order).  The other
    modes have no such call: the pivoted ones permute rows within each
    panel between block steps, and K2 applies the folded block-diagonal
    D^-1, whose blocks are dense, before its block-upper solve."""
    import torch

    nblk, nb = b.shape[:2]
    B = (f.band.shape[1] - 1) // 2
    dev = b.device
    try:
        J = torch.arange(nblk, device=dev)[:, None] - B + torch.arange(B, device=dev)[None, :]
        ok = J >= 0  # block (K, t) of L multiplies y_{K-B+t}
        mask = ok[:, None, :, None].expand(nblk, nb, B, nb)
        values = f.band[:nblk, :B].permute(0, 2, 1, 3)[mask]  # rows (K, i), columns ascending
        cols = (J[:, None, :, None] * nb + torch.arange(nb, device=dev)).expand(
            nblk, nb, B, nb)[mask]
        del mask
        per_row = (ok.sum(1) * nb).repeat_interleave(nb)
        crow = torch.cat([per_row.new_zeros(1), per_row.cumsum(0)])
        L = torch.sparse_csr_tensor(crow, cols, values, size=(nblk * nb, nblk * nb))
        rhs = b.reshape(nblk * nb, -1)  # c64 (nblk, nb): one column; f32 (nblk, nb, m): m

        def call():
            return torch.triangular_solve(rhs, L, upper=False, unitriangular=True).solution

        got = call().reshape(b.shape)
        torch.cuda.synchronize()
        err = rel_err(got, y[:nblk])[1]  # K1 also returns the band's padding rows
        ms = cuda_ms(call, 1 if values.numel() > 1e8 else 3)  # one call of a 175k L: 0.3-1 s
    except Exception as exc:  # the library call is a yardstick, not a gate
        log(f"phase 4: K1's library call (torch.triangular_solve, sparse CSR L, {kind_name(b)}) "
            f"failed: {type(exc).__name__}: {exc}")
        return None
    log(f"phase 4: K1's library call, {kind_name(b)}: torch.triangular_solve on the unit lower "
        f"factor as sparse CSR ({values.numel()} entries) {ms:.4f} ms, rel {err:.2e} from K1")
    return ms if err <= 1e-4 else None


def band_entry(k: str, f, kind: str, label: str, err: float, ms: float, plain_ms: float,
               library_ms: float | None = None) -> dict:
    """A kernels-line entry of K1 or K2 on factor ``f`` (``launches`` and
    ``launches_phase5`` are filled in from ``_key`` at the end)."""
    if mode_of(f) == "pivoted":  # the XLA scans of the reference's pivoted factors
        line = "lsafw_tpu/solver/band.py:" + ("1035" if kind == "c64" else "839")
    else:
        line = "lsafw_tpu/solver/band_pallas.py:" + ("92" if k == "K1" else "191")
    bound_ms, bound_by = subst_bounds(f, kind)[k]
    name = {"K1": "band_fwd_kernel (K1)", "K2": "band_bwd_kernel (K2)"}[k]
    return dict(name=f"{name}, {mode_name(f, kind)}{label}", route="cuda",
                source="lsafw_tpu_torch/csrc/band_subst.cu", replaces=line, launches=0,
                _key=key_of(k, f, kind), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def band_kernels(factors: list, errs: dict, device, *, only: tuple | None = None,
                 plain_reps: int = 3, backward: tuple = (), library: bool = False) -> list:
    """K1/K2 in each mode and type (or the types in ``only``) on the main
    path's own factors, given as (label, factor) pairs: held against their
    plain versions, then timed one call at a time with CUDA events (each
    band exceeds the 50 MB L2, so every call is cold) beside the plain
    loops (``plain_reps`` calls) and the bounds; with ``library``, pivot-free
    K1 on f32 storage (complex64, float32 x 1 and x 2) beside its library
    call (:func:`k1_library`).
    Returns the kernels-line entries."""
    import torch

    out = []
    for label, f in factors:
        fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
        md, nb = mode_of(f), f.band.shape[2]
        nblk = f.L1inv.shape[0] if md == "pivoted" else f.dinv.shape[0]
        for seed, kind in enumerate(kinds(f)):
            if only and kind not in only:
                continue
            b = rhs(kind, nblk, nb, device, 10 + seed)
            res = check_kernels(f, b, f"phase 4 {type(f).__name__}{label}",
                                backward=label in backward)
            for k, (a, _) in res.items():
                errs[key_of(k, f, kind)] = max(errs.get(key_of(k, f, kind), 0.0), a)
            y = fwd_plain(b)
            times = {"K1": (cuda_ms(lambda: fwd(b), 20), cuda_ms(lambda: fwd_plain(b), plain_reps)),
                     "K2": (cuda_ms(lambda: bwd(y), 20), cuda_ms(lambda: bwd_plain(y), plain_reps))}
            lib = {"K1": k1_library(f, b, fwd(b)) if library and md == "pivot_free"
                   and f.band.dtype in (torch.complex64, torch.float32) else None}
            for k, (ms, plain_ms) in times.items():
                out.append(band_entry(k, f, kind, label, errs[key_of(k, f, kind)], ms, plain_ms,
                                      lib.get(k)))
            if kind in ("c64", "f32x1"):
                bounds = subst_bounds(f, kind)
                plain_solve = cuda_ms(lambda: bwd_plain(fwd_plain(b)), plain_reps)
                solve = cuda_ms(lambda: bwd(fwd(b)), 10)
                log(f"phase 4: one {mode_name(f, kind)}{label} solve (K1 + K2) {solve:.4f} ms, "
                    f"the torch loops {plain_solve:.3f} ms: {plain_solve / solve:.1f}x; bound "
                    f"{bounds['K1'][0] + bounds['K2'][0]:.4f} ms")
    return out


def gcr_iterations(mp: dict, device, its: int = 8) -> tuple[float, float, int, int]:
    """(wall ms, busy ms, device operations, iterations) of ``its`` GCR
    iterations of ``_banded_mr`` (the baseflow's refinement) on the real
    pivoted factor of A - Re(sigma) M, under the profiler (after one warm
    run)."""
    import torch
    from lsafw_tpu_torch.ops.bcsr import operator_for_budget
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.newton import _banded_mr

    A, M = mp["A"], mp["M"]
    J = CSRMatrix(A.pattern, A.data - mp["op"].sigma.real * M.data)
    blu = tband.factor_auto(tband.plan_for_csr(J, real=True), J.data)[0]
    Jop = operator_for_budget(J)
    b = torch.randn(J.shape[0], dtype=torch.float64, device=device)

    def run():
        return _banded_mr(J, blu, b, Jop, tol=0.0, max_its=its)

    run()
    wall, busy, ops = device_busy(run)
    return wall, busy, ops, its


# ---------------------------------------------------------------------------
# Phase 5: adjoint sensitivity
# ---------------------------------------------------------------------------


@contextmanager
def stage(name: str, out: dict):
    """Counts zeroed just before the block and read just after it: kernel
    launches, band solves per factor class, original-order matvecs, plan
    builds of the per-pattern cache, seconds, and the device memory
    allocated at its start and at its peak."""
    import torch
    from lsafw_tpu_torch.ops import sparse

    reset_counts()
    builds = dict(sparse.PLAN_BUILDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    with band_solves() as solves, matvecs() as mv:
        yield
        torch.cuda.synchronize()
    out[name] = dict(seconds=time.time() - t0, launches=counts(), solves=dict(solves),
                     matvecs=mv["matvecs"], resident_gb=resident / 1e9,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     builds={k: v - builds.get(k, 0) for k, v in sparse.PLAN_BUILDS.items()
                             if v != builds.get(k, 0)})


def staged(solver, attr: str, name: str, out: dict) -> None:
    """Make ``solver.<attr>`` run as a stage of :func:`stage`, so that
    ``evaluate()`` reads each of its stages on its own."""
    fn = getattr(solver, attr)

    def run(*args, **kw):
        with stage(name, out):
            return fn(*args, **kw)

    setattr(solver, attr, run)


def eigenvalue_near(case, w, re: float, target: complex) -> complex:
    """The eigenvalue nearest ``target`` of the eigensystem around ``w``."""
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType

    A, M = LinearizedNavierStokesAssembler(w, case["ctx"], re, case["bcs_pert"],
                                           case["mesh"]).assemble_eigensystem()
    es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    es.set_st_pc_type("banded")
    return es.solve()[0][0]


def finite_difference(case, w, sigma: complex, dre: float = 1.0) -> tuple[complex, dict]:
    """The reference's validation of d sigma/dRe: banded Newton baseflows at
    Re = 47 -/+ dre started from w, their eigenvalues near sigma, and the
    centred difference."""
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    sig = {}
    for re in (47.0 - dre, 47.0 + dre):
        solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=re)
        solver._initial_guess = w
        wr = solver.solve(tol=1e-8, max_it=40, linear_solver="banded")
        if not solver.newton_results[-1].converged:
            raise RuntimeError(f"phase 5: the Newton baseflow at Re = {re} did not converge")
        sig[re] = eigenvalue_near(case, wr, re, sigma)
    return (sig[47.0 + dre] - sig[47.0 - dre]) / (2 * dre), sig


def sensitivity_path(case, mp: dict) -> dict:
    """Phase 5: ``EigenSensitivitySolver`` at full width on phase 3's
    baseflow and (A, M), target phase 3's sigma: ``evaluate()`` (direct
    mode, adjoint mode on the transposed pair, du/dRe) and
    ``compute_wavemaker()`` with host LU and the torch substitution loops
    on CUDA tensors raising; each stage's launches, band solves, matvecs
    and plan builds read on their own; the answers held to phase 3, to the
    residuals and to the reference's own check, finite differences."""
    import torch
    from lsafw_tpu_torch.ops import sparse
    from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver
    from lsafw_tpu_torch.solver.eigen import eigen_residuals

    sigma3, A, M = mp["sigma"], mp["A"], mp["M"]
    stages: dict = {}
    solver = EigenSensitivitySolver(case["ctx"], case["mesh"], case["bcs_base"], mp["w"], 47.0,
                                    A=A, M=M, perturbation_bcs=case["bcs_pert"], target=sigma3,
                                    si_method="banded", device=DEVICE)
    for attr, name in (("solve_direct_mode", "direct"), ("solve_adjoint_mode", "adjoint"),
                       ("compute_baseflow_sensitivity", "du/dRe"),
                       ("evaluate_sensitivity", "integrals")):
        staged(solver, attr, name, stages)
    with plain_loops_forbidden():
        d_sigma = solver.evaluate()
        with stage("wavemaker", stages):
            sw = solver.compute_wavemaker()
        t0 = time.time()
        fd, sig_fd = finite_difference(case, mp["w"], sigma3)
        t_fd = time.time() - t0
    sigma, v, a, s = solver._sigma, solver._v, solver._a, solver._baseflow_sens
    A_T, M_T = sparse.transpose_pair(A, M)
    adj_res = float(eigen_residuals(A_T, M_T, [(solver.sigma_adjoint, a.cpu().numpy())])[0])
    biorth = complex(torch.vdot(a, sparse.spmv(M, v)))
    J, r = solver.baseflow_sensitivity_system()
    s_res = float(torch.linalg.vector_norm(sparse.spmv(J, s) - r) / torch.linalg.vector_norm(r))
    spaces = case["spaces"]
    p = sw[torch.as_tensor(spaces.dofs_p, device=sw.device)].abs()
    peak = spaces.pressure.node_coords[int(torch.argmax(p))]
    vel_max = float(sw[torch.as_tensor(spaces.dofs_u, device=sw.device)].abs().max())
    for name, st in stages.items():
        log(f"phase 5: {name}: {st['seconds']:.3f} s, device memory {st['resident_gb']:.3f} GB at "
            f"its start, {st['peak_gb']:.3f} GB at its peak, "
            f"band solves {st['solves']}, original-order matvecs {st['matvecs']}, plan builds "
            f"{st['builds']}; launches {nonzero(st['launches'])}")
    for name, op in solver.operators.items():
        log(f"phase 5: {name} shift-invert: factor {op['factor_s']:.3f} s, contraction "
            f"{op['rho']:.2e}, {op['applies']} applies, pivoted {op['pivoted']}, fused matvecs "
            f"{op['fused']}")
    log(f"phase 5: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j (phase 3 "
        f"{sigma3.real:+.12f}{sigma3.imag:+.12f}j), sigma_adj = "
        f"{solver.sigma_adjoint.real:+.12f}{solver.sigma_adjoint.imag:+.12f}j, adjoint residual "
        f"{adj_res:.2e}, |a^H M v - 1| = {abs(biorth - 1):.2e}")
    ds = solver.stats
    log(f"phase 5: du/dRe: {solver.baseflow_solve.iterations} GCR iterations, relative residual "
        f"{s_res:.2e} (GCR's {solver.baseflow_solve.residual:.2e}), factor {ds['factor_s']:.3f} "
        f"s, band solves {ds['solve_s']:.3f} s in {ds['solves']}, SpMV {ds['spmv_s']:.3f} s in "
        f"{ds['spmvs']}")
    log(f"phase 5: d sigma/dRe = {d_sigma.real:+.8e}{d_sigma.imag:+.8e}j; finite difference "
        f"{fd.real:+.8e}{fd.imag:+.8e}j from sigma(46) = {sig_fd[46.0]:.10f}, sigma(48) = "
        f"{sig_fd[48.0]:.10f} ({t_fd:.2f} s); |adjoint - FD| / |FD| = "
        f"{abs(d_sigma - fd) / abs(fd):.3e}")
    log(f"phase 5: wavemaker peak at ({peak[0]:.3f}, {peak[1]:.3f}), CG "
        f"{solver.wavemaker_cg.iterations} iterations to {solver.wavemaker_cg.residual:.1e}, "
        f"largest velocity slot {vel_max}; live per-pattern plans {len(sparse._PER_PATTERN)}")
    log(f"phase 5: stages " + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in stages.items())
        + f", finite difference {t_fd:.2f} s")

    checks = [
        (abs(sigma - sigma3) <= 1e-8, f"direct sigma {sigma} not within 1e-8 of phase 3's"),
        (abs(solver.sigma_adjoint - np.conj(sigma3)) <= 1e-7,
         f"sigma_adj {solver.sigma_adjoint} not within 1e-7 of conj(sigma_3)"),
        (adj_res <= 1e-8, f"adjoint residual {adj_res:.2e} > 1e-8"),
        (abs(biorth - 1) <= 1e-10, f"|a^H M v - 1| = {abs(biorth - 1):.2e} > 1e-10"),
        (s_res <= 1e-9, f"du/dRe residual {s_res:.2e} > 1e-9"),
        (abs(d_sigma - fd) <= 0.15 * abs(fd), f"d sigma/dRe {d_sigma} not within 15% of FD {fd}"),
        (d_sigma.real > 0, f"Re(d sigma/dRe) = {d_sigma.real} is not positive"),
        (0.5 < peak[0] < 5.0 and abs(peak[1]) < 2.0, f"wavemaker peak at {peak}"),
        (vel_max == 0.0, f"wavemaker velocity slots not 0 ({vel_max})"),
        (solver.wavemaker_cg.converged, "the wavemaker's CG did not converge"),
        (all(op["pivoted"] and op["fused"] for op in solver.operators.values()),
         f"a shift-invert stage did not take the pivoted factor with fused matvecs: "
         f"{solver.operators}"),
    ]
    for ok, what in checks:
        if not ok:
            raise RuntimeError(f"phase 5: {what}")
    for name, key, cls, types in (("direct", "pivoted.c64", "PivotedBandedLU", "c128.c64"),
                                  ("adjoint", "pivoted.c64", "PivotedBandedLU", "c128.c64"),
                                  ("du/dRe", "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1")):
        st = stages[name]
        n = st["solves"].get(cls, 0)
        if set(st["solves"]) != {cls}:
            raise RuntimeError(f"phase 5 {name}: band solves {st['solves']}, expected {cls} alone")
        gate_band_launches(f"phase 5 {name}", st["launches"], key, n)
        gate_permutes_and_spmv(f"phase 5 {name}", st["launches"], types, n, st["matvecs"])
        if st["builds"]:
            raise RuntimeError(f"phase 5 {name} re-planned a pattern: {st['builds']}")
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in counts()}
    return dict(launches=launches, stages=stages, d_sigma=d_sigma, fd=fd)


# ---------------------------------------------------------------------------
# Phase 6: the production cylinder
# ---------------------------------------------------------------------------


_MESHES: dict = {}  # kind -> AsyncResult of (mesh, seconds) from the mesh worker


def _host_mesh(kind: str):
    """The host mesh (numpy on the host alone) of a later phase,
    ``"production"`` (phase 6, distmesh), ``"step3d"`` (phase 10c,
    distmesh), ``"scm"`` (13c's coarse cylinder, distmesh; phase 11 makes
    its own), ``"structured"`` (13a's 240 x 240 rectangle) or ``"cube"``
    (13b's unit cube), the last two with their facet and edge tables made:
    (mesh, seconds).  The body of the mesh worker's tasks."""
    from lsafw_tpu_torch.config import load_cylinder_flow_config, load_step_flow_config
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh, step_flow_mesh
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh, unit_cube

    t0 = time.time()
    if kind == "production":
        mesh = cylinder_flow_mesh(load_cylinder_flow_config(PRODUCTION_CONFIG / "geometry.toml"))
    elif kind == "step3d":
        mesh = step_flow_mesh(load_step_flow_config(STEP3D_CONFIG / "geometry.toml"))
    elif kind == "scm":
        mesh = cylinder_flow_mesh(load_cylinder_flow_config(SCM_CONFIG / "geometry_small.toml"))
    else:
        mesh = (unit_cube(MG_CUBE_N) if kind == "cube" else
                rectangle_mesh((0.0, 0.0), (1.0, 1.0), STRUCT_NX, STRUCT_NX))
        mesh.boundary_facets, mesh.cell_to_edges  # the cached tables travel with the mesh
    return mesh, time.time() - t0


def start_mesh_worker() -> None:
    """One worker process that makes the host meshes of phases 6, 10c and
    13 while the card runs the phases before them (the same seeded numpy,
    so the same meshes); it is terminated when the script exits."""
    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    for kind in ("structured", "cube", "scm", "production", "step3d"):
        _MESHES[kind] = pool.apply_async(_host_mesh, (kind,))


def host_mesh(kind: str):
    """(mesh, seconds of making it): from the mesh worker where it runs,
    else made here."""
    job = _MESHES.get(kind)
    return job.get() if job is not None else _host_mesh(kind)


def production_case(device) -> dict:
    """The repo's production configuration, from its TOML files
    (``config_files/2D/cylinder``: domain [-40, 120] x [-40, 40],
    resolution 1.25 / 0.115), built as ``scripts/dev_167k.py`` builds it."""
    import torch
    from lsafw_tpu_torch.config import load_bc_config, load_facet_config
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    cfg = PRODUCTION_CONFIG
    mesh, mesh_s = host_mesh("production")
    t_wait = time.time() - t0
    mark_boundary_facets(mesh, load_facet_config(cfg / "facets.toml"))
    spaces = define_spaces(mesh)
    bcs_base = define_bcs(mesh, spaces, load_bc_config(cfg / "bcs.toml"))
    bcs_pert = define_bcs(mesh, spaces, load_bc_config(cfg / "bcs_perturbation.toml"))
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0, mesh_seconds=mesh_s, mesh_wait=t_wait)


def log_stage(what: str, st: dict) -> None:
    log(f"{what}: {st['seconds']:.2f} s, device memory {st['resident_gb']:.3f} GB at its start, "
        f"{st['peak_gb']:.3f} GB at its peak ({st['peak_gb'] - st['resident_gb']:.3f} GB above), "
        f"band solves {st['solves']}, original-order matvecs {st['matvecs']}; launches "
        f"{nonzero(st['launches'])}")


def one_band_solve_ms(blu, device) -> float:
    """CUDA-event time of one band solve (permute-in, K1, K2, permute-out)
    of a factor on a complex128 vector from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(12)
    n = blu.n
    b = torch.complex(torch.randn(n, generator=g, device=device, dtype=torch.float64),
                      torch.randn(n, generator=g, device=device, dtype=torch.float64))
    return cuda_ms(lambda: blu.solve(b), 10)


def production_path(dev) -> dict:
    """Phase 6: the production cylinder at Re = 47, banded Newton baseflow
    (ramped, 3 steps, tol 1e-8; real pivoted f32 factors), eigensystem,
    and the shift-invert eigenpair nearest 0.74j on the default plan (the
    pivot-free complex64 band, B = 17 at nb = 128: the pivoted factor's
    extras do not fit its 8 GB budget), with host LU and the torch
    substitution loops on CUDA tensors raising; each stage read on its
    own."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    case = production_case(dev)
    stages: dict = {}
    with plain_loops_forbidden():
        with stage("baseflow", stages):
            solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"], re=47.0)
            w = solver.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, case["ctx"], 47.0, case["bcs_pert"],
                                                   case["mesh"]).assemble_eigensystem()
        with stage("eigen", stages):
            sigma, resid, op, t_eig = leading_pair(A, M)
    st, plan, rplan = solver.stats, tband.plan_for_csr(A), tband.plan_for_csr(A, real=True)
    log(f"phase 6: production cylinder: {case['spaces'].num_dofs} DOFs, case {case['seconds']:.2f} "
        f"s (the mesh {case['mesh_seconds']:.2f} s in the mesh worker, waited for "
        f"{case['mesh_wait']:.2f} s); complex plan nb = {plan.nb}, B = {plan.B}, nblk_pad = {plan.nblk_pad}, "
        f"{plan.band_dtype}; real plan B = {rplan.B}, {rplan.band_dtype}")
    for name, s_ in stages.items():
        log_stage(f"phase 6: {name}", s_)
    log(f"phase 6: baseflow: factor {st['factor_s']:.2f} s in {st['factors']} ({st['pivoted']} "
        f"pivoted), band solves {st['solve_s']:.2f} s in {st['solves']}, SpMV {st['spmv_s']:.2f} s "
        f"in {st['spmvs']}; Newton iterations {[r.iterations for r in solver.newton_results]}, GCR "
        f"iterations {st['gcr_its']}")
    log(f"phase 6: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; factor "
        f"{op.factor_seconds:.2f} s, pivoted {op.pivoted}, contraction {op.rho:.2e}, refinement "
        f"cap {op.refine_its}, {op.applies} shift-invert applies; {acceptance_text(ACCEPTANCE)}")
    if not resid <= 1e-8:
        raise RuntimeError(f"phase 6: eigen residual {resid:.2e} > 1e-8")
    if abs(sigma.real - SIGMA_175K_RE) > 1e-3 or abs(sigma - SIGMA_167K) > 3e-3:
        raise RuntimeError(f"phase 6: sigma {sigma} is not within 1e-3 of Re {SIGMA_175K_RE} and "
                           f"3e-3 of {SIGMA_167K}")
    if not all(r.converged for r in solver.newton_results):
        raise RuntimeError("phase 6: a Newton solve of the ramp did not converge")
    if rplan.band_dtype != "f32" or tband.bf16_unstable(A.pattern):
        raise RuntimeError("phase 6: the baseflow's band left f32 (the bf16 rung fired)")
    if st["pivoted"] != st["factors"] or op.pivoted or op.device_op.Cop is None:
        raise RuntimeError(f"phase 6: baseflow factors {st}, eigen pivoted {op.pivoted}; expected "
                           f"real pivoted factors and the pivot-free complex one with fused matvecs")
    base, eig = stages["baseflow"], stages["eigen"]
    for what, s_, key, cls, types in (
            ("phase 6 baseflow", base, "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1"),
            ("phase 6 eigen", eig, "pivot_free.c64", "BandedLU", "c128.c64")):
        n = s_["solves"].get(cls, 0)
        if set(s_["solves"]) != {cls}:
            raise RuntimeError(f"{what}: band solves {s_['solves']}, expected {cls} alone")
        gate_band_launches(what, s_["launches"], key, n)
        gate_permutes_and_spmv(what, s_["launches"], types, n, s_["matvecs"])
    if base["solves"]["RealPivotedBandedLU"] != st["solves"]:
        raise RuntimeError(f"phase 6: baseflow band solves {base['solves']} against {st['solves']}")
    return dict(case=case, w=w, A=A, M=M, op=op, sigma=sigma, stages=stages,
                launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})


def production_rerun(p6: dict, phase: str, key: str, **switches: str) -> dict:
    """Phase 6b / 6c: phase 6's eigen stage again under ``switches`` (a
    plan switch), read as a stage: sigma within 1e-8 of phase 6's, the
    residual gate, and K1/K2 in mode ``key`` once per band solve."""
    with env(**switches), plain_loops_forbidden():
        stages: dict = {}
        with stage("eigen", stages):
            sigma, resid, op, t_eig = leading_pair(p6["A"], p6["M"])
    st = stages["eigen"]
    blu = op.device_op.blu
    log(f"phase {phase}: {' '.join(f'{k}={v}' for k, v in switches.items())}: sigma = "
        f"{sigma.real:+.12f}{sigma.imag:+.12f}j, residual {resid:.2e}; factor "
        f"{op.factor_seconds:.2f} s (phase 6: {p6['op'].factor_seconds:.2f} s), nb = {blu.nb}, "
        f"B = {blu.B}, band {blu.band.dtype} {blu.band.numel() * blu.band.element_size() / 1e9:.3f} "
        f"GB, contraction {op.rho:.2e} (phase 6: {p6['op'].rho:.2e}), trial GCR solve "
        f"{op.trial_its} iterations, refinement cap {op.refine_its}, {op.applies} applies")
    log_stage(f"phase {phase}: eigen", st)
    if not resid <= 1e-8:
        raise RuntimeError(f"phase {phase}: eigen residual {resid:.2e} > 1e-8")
    if abs(sigma - p6["sigma"]) > 1e-8:
        raise RuntimeError(f"phase {phase}: sigma {sigma} is not within 1e-8 of phase 6's "
                           f"{p6['sigma']}")
    n = st["solves"].get("BandedLU", 0)
    if set(st["solves"]) != {"BandedLU"}:
        raise RuntimeError(f"phase {phase}: band solves {st['solves']}, expected BandedLU alone")
    gate_band_launches(f"phase {phase}", st["launches"], key, n)
    gate_permutes_and_spmv(f"phase {phase}", st["launches"], "c128.c64", n, st["matvecs"])
    return dict(op=op, sigma=sigma, stage=st, launches=st["launches"])


# ---------------------------------------------------------------------------
# Phase 7: the non-modal toolbox (resolvent gains, transient growth)
# ---------------------------------------------------------------------------

NONMODAL_RE = 40.0  # examples/resolvent_gains.py, examples/transient_growth.py
OMEGAS = (0.3, 1.2)  # with OMEGA_CHECK's solve, the gain curve at 0.3, 0.75, 1.2
OMEGA_CHECK, Z_CHECK = 0.75, -0.05 + 0.75j
HORIZON, CN_STEPS = 4.0, 32  # dt = 1/8: the real shift 2/dt = CN_SHIFT


def gate_stage(what: str, st: dict, key: str, cls: str, types: str, builds: int = 0) -> None:
    """One stage's band solves all of factor class ``cls``, K1/K2 in mode
    ``key`` once per band solve and nothing else, G's permute forms in
    ``types`` once each per band solve, one original-order S launch per
    original-order matvec, no flat complex128 G, and at most ``builds``
    plans built of each kind (the direct operator's, where the pattern had
    none cached: the adjoint operator shares it)."""
    n = st["solves"].get(cls, 0)
    if set(st["solves"]) != {cls}:
        raise RuntimeError(f"{what}: band solves {st['solves']}, expected {cls} alone")
    gate_band_launches(what, st["launches"], key, n)
    gate_permutes_and_spmv(what, st["launches"], types, n, st["matvecs"])
    if any(v > builds for v in st["builds"].values()):
        raise RuntimeError(f"{what} planned a pattern again: {st['builds']} (at most {builds} "
                           f"each)")


def log_operators(what: str, operators: dict) -> None:
    for name, f in operators.items():
        log(f"{what}: {name} factor {f['factor_s']:.3f} s, contraction "
            f"{f['rho'] if f['rho'] is None else format(f['rho'], '.2e')}, trial GCR solve "
            f"{f['trial_its']} iterations, refinement cap {f['refine_its']}, {f['applies']} "
            f"applies, pivoted {f['pivoted']}, fused matvecs {f['fused']}")


def recorded_responses(rs) -> list:
    """Wrap the solver's raw response so that each raw response's energy
    norm sqrt(q^H M q) is recorded (before ``solve`` normalises it)."""
    raw: list = []
    response = rs._response

    def run(si1, f):
        q = response(si1, f)
        raw.append(float(np.sqrt(rs._energy(q))))
        return q

    rs._response = run
    return raw


def gate_resolvent_modes(what: str, modes, raw: list, A, M, mask, nu: int) -> None:
    """Unit forcing and response energies (1e-8); the response solves
    (i omega M - A)(g q) = M f (1e-8 relative); the raw response
    C^-1 M f has the gain for its energy norm (1e-6 relative); the forcing
    is zero on pressure and Dirichlet DOFs."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    dev = A.device
    bad = torch.as_tensor(np.asarray(mask) | (np.arange(A.shape[0]) >= nu), device=dev)
    for j, (f, q, g) in enumerate(zip(modes.forcings, modes.responses, modes.gains)):
        f, q = (torch.as_tensor(v, device=dev) for v in (f, q))
        Mf, Mq = spmv(M, f), spmv(M, q)
        ef, eq = float(torch.vdot(f, Mf).real), float(torch.vdot(q, Mq).real)
        res = float(torch.linalg.vector_norm(1j * modes.omega * g * Mq - g * spmv(A, q) - Mf)
                    / torch.linalg.vector_norm(Mf))
        graw = raw[j]
        log(f"{what}: mode {j}: gain {g:.10f}, energies f {ef:.12f} q {eq:.12f}, response "
            f"residual {res:.2e}, raw response energy norm {graw:.10f} (rel {abs(graw - g) / g:.1e})")
        checks = [(abs(ef - 1) <= 1e-8 and abs(eq - 1) <= 1e-8, "energies not 1 within 1e-8"),
                  (res <= 1e-8, f"response residual {res:.2e} > 1e-8"),
                  (abs(graw - g) <= 1e-6 * g, f"raw response norm {graw} is not the gain {g}"),
                  (not bool(f[bad].abs().max() > 0), "forcing on pressure or Dirichlet DOFs")]
        for ok, msg in checks:
            if not ok:
                raise RuntimeError(f"{what}: mode {j}: {msg}")


def gate_growth_modes(what: str, res, M, mask, nu: int) -> None:
    """Unit initial energy (1e-8), q(T)^T M q(T) = G within 1e-6 max(G, 1),
    the initial state zero on pressure and Dirichlet DOFs."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv

    dev = M.device
    bad = np.asarray(mask) | (np.arange(M.shape[0]) >= nu)
    for j, (q0, qT, g) in enumerate(zip(res.initials, res.finals, res.gains)):
        q0t, qTt = (torch.as_tensor(v, device=dev) for v in (q0, qT))
        e0, eT = float(q0t @ spmv(M, q0t)), float(qTt @ spmv(M, qTt))
        log(f"{what}: mode {j}: G = {g:.10f}, initial energy {e0:.12f}, final energy {eT:.10f} "
            f"(rel {abs(eT - g) / max(g, 1):.1e})")
        if not (abs(e0 - 1) <= 1e-8 and abs(eT - g) <= 1e-6 * max(g, 1.0)
                and not np.abs(q0[bad]).max() > 0):
            raise RuntimeError(f"{what}: mode {j}: energies {e0}, {eT} against G = {g}, or an "
                               f"initial state on pressure or Dirichlet DOFs")


def _nonmodal_host_check(As, Ms, nu: int, mask, q0, T_end: float, n_steps: int) -> dict:
    """Phase 7's cross-check, in the check worker on the CPU: the
    resolvent's gains and norm are solved again on the host LU.  The
    transient's full gain solve on it would take 2,752 sequential host
    solves: instead the host-LU propagators march the banded optimum q0,
    whose energy at T is the Rayleigh quotient of the host-LU gain operator
    (equal to G to second order in q0's error), and apply the gain
    operator to q0, held vector by vector."""
    import torch
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.resolvent import ResolventSolver
    from lsafw_tpu_torch.transient import TransientGrowthSolver

    t0 = time.time()
    A, M = (CSRMatrix.from_scipy(X, device="cpu") for X in (As, Ms))
    q0 = torch.as_tensor(q0)

    def resolvent_lu():
        return ResolventSolver(A, M, nu, mask, method="lu", device="cpu")

    def transient_lu():
        ts_lu = TransientGrowthSolver(A, M, nu, mask, method="lu", device="cpu")
        fw_lu, ad_lu, s = ts_lu._propagators(T_end / n_steps)
        qT = ts_lu._march(fw_lu, q0, n_steps)
        z_lu = ts_lu._march_adjoint(ad_lu, s, ts_lu._mass(qT), n_steps)
        return qT, z_lu, float(qT @ ts_lu._mass(qT))

    job_s: list = [0.0] * 3

    def timed(i, fn):
        t_job = time.time()
        out = fn()
        job_s[i] = time.time() - t_job
        return out

    # the three host-LU checks side by side: SuperLU releases the GIL
    with host_lu_counted() as hl, ThreadPoolExecutor(max_workers=3) as pool:
        jobs = (pool.submit(timed, 0, lambda: resolvent_lu().solve(OMEGA_CHECK, k=2).gains),
                pool.submit(timed, 1, lambda: resolvent_lu().resolvent_norm(Z_CHECK, tol=1e-9)),
                pool.submit(timed, 2, transient_lu))
        g_lu, n_lu, (qT, z_lu, G_lu) = (job.result() for job in jobs)
    return dict(gains=np.asarray(g_lu), norm=float(n_lu), qT=qT.numpy(), z=z_lu.numpy(),
                G=G_lu, host_lu=hl["host_lu"], job_s=job_s, seconds=time.time() - t0)


def nonmodal_path(case, phase: str, dev, *, sweep=(), k: int = 1, norm: bool = False,
                  cross_check: bool = False, time_factors: list | None = None,
                  horizon: tuple = (HORIZON, CN_STEPS), w0=None) -> dict:
    """Phase 7 / 7b: the Re = 40 baseflow (ramped banded Newton, 4 steps,
    tol 1e-9; with ``w0``, the baseflow of another Re on the same mesh, one
    banded Newton from it instead, warm-started along the branch as
    ``find_critical_re`` does) and (A, M) on ``case``; ``ResolventSolver(method="banded")``
    over ``sweep`` (k = 1), at OMEGA_CHECK with ``k`` gains and, with
    ``norm``, its ``resolvent_norm`` at Z_CHECK;
    ``TransientGrowthSolver(method="banded").solve(*horizon)`` (default
    (HORIZON, CN_STEPS); phase 7b, cut in depth, half of it at the same dt);
    each a stage, gated; with ``cross_check`` the same (k = 2 and the norm)
    on the host LU (asked for, counted), held to the banded answers.
    ``time_factors`` receives the transient's forward factor."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import (LinearizedNavierStokesAssembler,
                                                      StationaryNavierStokesAssembler)
    from lsafw_tpu_torch.resolvent import ResolventSolver
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.newton import NewtonSolver
    from lsafw_tpu_torch.transient import TransientGrowthSolver

    what = f"phase {phase}"
    t_phase = time.time()
    stages: dict = {}
    spaces = case["spaces"]
    nu, mask = spaces.num_velocity_dofs, np.asarray(case["bcs_pert"].dirichlet_mask)
    with plain_loops_forbidden():
        with stage("baseflow", stages):
            if w0 is None:
                solver = BaseFlowSolver(case["ctx"], case["mesh"], case["bcs_base"],
                                        re=NONMODAL_RE)
                w = solver.solve(ramp=True, steps=4, tol=1e-9, max_it=40, linear_solver="banded")
            else:
                res = NewtonSolver(StationaryNavierStokesAssembler(
                    case["ctx"], case["mesh"], case["bcs_base"]), linear_solver="banded").solve(
                    torch.as_tensor(w0, device=dev), NONMODAL_RE, tol=1e-9, max_it=40)
                w, solver = res.w, SimpleNamespace(newton_results=[res])
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, case["ctx"], NONMODAL_RE, case["bcs_pert"],
                                                   case["mesh"]).assemble_eigensystem()
        if not all(r.converged for r in solver.newton_results):
            raise RuntimeError(f"{what}: a Newton solve of the Re = 40 ramp did not converge")
        rs = ResolventSolver(A, M, nu, mask, method="banded", device=dev)
        figures: dict = {}
        curve = []
        for om in sweep:
            with stage(f"resolvent omega={om}", stages):
                curve.append(rs.solve(om, k=1))
            figures[f"resolvent omega={om}"] = (rs.operators, rs.applies)
        raw = recorded_responses(rs)
        with stage(f"resolvent omega={OMEGA_CHECK} k={k}", stages):
            modes = rs.solve(OMEGA_CHECK, k=k)
        figures[f"resolvent omega={OMEGA_CHECK} k={k}"] = (rs.operators, rs.applies)
        rnorm = None
        if norm:
            with stage(f"resolvent norm z={Z_CHECK}", stages):
                rnorm = rs.resolvent_norm(Z_CHECK, tol=1e-9)
            figures[f"resolvent norm z={Z_CHECK}"] = (rs.operators, rs.applies)
        T_end, n_steps = horizon
        ts = TransientGrowthSolver(A, M, nu, mask, method="banded", device=dev)
        with stage(f"transient T={T_end:g}", stages):
            growth = ts.solve(T_end, n_steps)
        figures[f"transient T={T_end:g}"] = (ts.operators, ts.applies)
        fw, ad, s = ts._propagators(T_end / n_steps)
        if time_factors is not None:
            time_factors.append(fw.device_op.blu)
        if cross_check:  # one T apply of the optimal initial state, for the host LU's
            q0 = torch.as_tensor(growth.initials[0], device=A.device)
            z_bd = ts._march_adjoint(ad, s, ts._mass(ts._march(fw, q0, n_steps)), n_steps)
    del ts, fw, ad  # the transient's two factors
    for name, st in stages.items():
        log_stage(f"{what}: {name}", st)
        if name in figures:
            ops, applies = figures[name]
            log(f"{what}: {name}: {applies} T applies")
            log_operators(f"{what}: {name}", ops)
    curve = sorted(curve + [modes], key=lambda m: m.omega)
    log(f"{what}: {spaces.num_dofs} DOFs, Re = {NONMODAL_RE:g}: Newton iterations "
        f"{[r.iterations for r in solver.newton_results]}; gain curve " + ", ".join(
            f"sigma_1({m.omega:g}) = {m.gains[0]:.10f}" for m in curve))
    log(f"{what}: omega = {OMEGA_CHECK}: gains {modes.gains.tolist()}; ||R({Z_CHECK})||_E = "
        f"{rnorm}; transient G({T_end:g}) = {growth.gains[0]:.10f} ({n_steps} CN steps)")
    gate_resolvent_modes(f"{what} resolvent", modes, raw, A, M, mask, nu)
    gate_growth_modes(f"{what} transient", growth, M, mask, nu)
    first = True
    for name, st in stages.items():
        if name.startswith("resolvent"):
            ops = figures[name][0]
            pivoted = ops["direct"]["pivoted"]
            if ops["adjoint"]["pivoted"] != pivoted or not all(o["fused"] for o in ops.values()):
                raise RuntimeError(f"{what} {name}: operators {ops}")
            gate_stage(f"{what} {name}", st, "pivoted.c64" if pivoted else "pivot_free.c64",
                       "PivotedBandedLU" if pivoted else "BandedLU", "c128.c64", int(first))
            first = False
        elif name.startswith("transient"):
            ops = figures[name][0]
            if not all(o["pivoted"] and o["fused"] for o in ops.values()):
                raise RuntimeError(f"{what} {name}: the factors are not real pivoted with fused "
                                   f"matvecs: {ops}")
            gate_stage(f"{what} {name}", st, "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1")
            if not st["launches"]["spmv_shifted_real.original"]:
                raise RuntimeError(f"{what} {name}: no real-shift S launch")
    out = dict(curve=curve, modes=modes, rnorm=rnorm, growth=growth, stages=stages, w=w, M=M,
               launches={k: sum(st["launches"][k] for st in stages.values()) for k in counts()})
    if cross_check:  # needs k = 2 and the norm; in the check worker, gated after phase 9
        qT_bd, G_bd, z_bd = growth.finals[0], growth.gains[0], z_bd.cpu().numpy()

        def gate(hc: dict) -> None:
            g_lu, n_lu, G_lu = hc["gains"], hc["norm"], hc["G"]
            rel_g = float(np.abs(modes.gains - g_lu).max() / np.abs(g_lu).max())
            rel_n, rel_G = abs(rnorm - n_lu) / n_lu, abs(G_bd - G_lu) / G_lu
            rel_z = float(np.linalg.norm(hc["z"] - z_bd) / np.linalg.norm(z_bd))
            rel_q = float(np.abs(hc["qT"] - qT_bd).max() / np.abs(qT_bd).max())
            log(f"{what}: the host LU, asked for ({hc['host_lu']} host LU factors in the check "
                f"worker, {hc['seconds']:.2f} s; the gains, the norm and the transient "
                f"{', '.join(f'{x:.2f}' for x in hc['job_s'])} s side by side): gains "
                f"{g_lu.tolist()} (rel {rel_g:.1e}), norm {n_lu:.10f} (rel {rel_n:.1e}); the "
                f"banded optimum's energy at T under the host-LU propagator {G_lu:.10f} (rel "
                f"{rel_G:.1e}), its state at T rel {rel_q:.1e}, the gain operator's image rel "
                f"{rel_z:.1e}")
            if hc["host_lu"] != 6 or not (rel_g <= 1e-6 and rel_n <= 1e-5 and rel_G <= 1e-6
                                          and rel_q <= 1e-6 and rel_z <= 1e-6):
                raise RuntimeError(f"{what}: banded against host LU: gains rel {rel_g:.1e} "
                                   f"(1e-6), norm rel {rel_n:.1e} (1e-5), G rel {rel_G:.1e}, "
                                   f"q(T) rel {rel_q:.1e}, T q0 rel {rel_z:.1e} (1e-6 each), "
                                   f"{hc['host_lu']} host LU factors (6)")

        start_host_check(what, _nonmodal_host_check,
                         (A.to_scipy(), M.to_scipy(), nu, mask, q0.cpu().numpy(), T_end, n_steps),
                         gate)
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


# ---------------------------------------------------------------------------
# Phase 8: quasi-3D spanwise stability and the weakly nonlinear expansion
# ---------------------------------------------------------------------------

SPAN_BETA = 1.5  # tests/benchmark/test_span_cylinder.py's wavenumber
# the eigenvalue that test's gate takes at beta > 0 (its _leading): the
# largest real part of SPAN_NEV eigenpairs nearest the 2D sigma, here at
# EigensolverConfig's default ncv, 80, not the test's 30.  At 175k the
# eigenvalues there form a dense cluster, and which members converge
# depends on ncv and on the run (on an H100: ncv 30 took 366 applies to
# two 0.248 from the target, ncv 80 one cycle of 80 applies to pairs 0.219
# to 0.227 from it), so every converged pair is held to the gate
SPAN_NEV, SPAN_NCV = 2, 80
# find_critical_re's brackets: tests/benchmark/test_wnl.py's at 43k; at 175k
# around phase 6's sigma_r(47) = +0.00039 with d sigma_r/dRe about 4.2e-3
WNL_BRACKETS = {"8": (40.0, 55.0), "8b": (46.0, 48.0)}
WNL_RE_C = {"8": (42.0, 52.0), "8b": (46.0, 48.0)}  # test_wnl.py's window; the bracket
RE_C_175K = 46.9  # the production mesh's Re_c as VALIDATION.md records it
# the K1/K2 mode and G's types of each band factor class
CLASS_KEYS = {"PivotedBandedLU": ("pivoted.c64", "c128.c64"),
              "BandedLU": ("pivot_free.c64", "c128.c64"),
              "RealPivotedBandedLU": ("pivoted.f32x1", "f64.f32x1"),
              "RealBandedLU": ("pivot_free.f32x1", "f64.f32x1")}
COMPLEX_CLASSES = ("PivotedBandedLU", "BandedLU")
REAL_CLASSES = ("RealPivotedBandedLU", "RealBandedLU")  # a real shift's factors (phases 10b, 10c)


def gate_class(what: str, st: dict, classes: tuple, builds: int = 0) -> str:
    """:func:`gate_stage` in the mode of the stage's one band factor class,
    which must be one of ``classes``; returns the class."""
    if len(st["solves"]) != 1 or next(iter(st["solves"])) not in classes:
        raise RuntimeError(f"{what}: band solves {st['solves']}, expected one class of {classes}")
    cls = next(iter(st["solves"]))
    key, types = CLASS_KEYS[cls]
    gate_stage(what, st, key, cls, types, builds)
    return cls


def stage_line(what: str, st: dict, figures: dict | None = None) -> None:
    """One line per stage: seconds, band solves, peak memory above its
    start, plan builds, and the factor's seconds and contraction."""
    f = figures or {}
    extra = "" if not f else (f", factor {f['factor_s']:.3f} s, contraction {f['rho']:.2e}, "
                              f"pivoted {f['pivoted']}, {f['applies']} applies")
    log(f"{what}: {st['seconds']:.2f} s, band solves {st['solves']}, peak "
        f"{st['peak_gb'] - st['resident_gb']:.3f} GB above its start, plans built "
        f"{st['builds']}{extra}")


def q3_block_check(A, A2, n2: int) -> tuple[float, int, float]:
    """The (u, v, p) block of the quasi-3D ``A`` against the 2D ``A2`` (the
    same structure; the values on the card): (max |difference| over max
    |A2|, entries not bitwise equal, max |coupling|)."""
    import torch

    pat, pat2 = A.pattern, A2.pattern
    inner_h = (pat.row_ids < n2) & (pat.indices < n2)
    if not (np.array_equal(pat.indices[inner_h], pat2.indices)
            and np.array_equal(np.bincount(pat.row_ids[inner_h], minlength=n2),
                               np.diff(pat2.indptr))):
        raise RuntimeError("the quasi-3D pattern's (u, v, p) block is not the 2D pattern")
    ix = pat.on(A.device)
    inner = (ix["row_ids"] < n2) & (ix["col"] < n2)
    cross = (ix["row_ids"] < n2) ^ (ix["col"] < n2)
    d = A.data[inner] - A2.data
    rel = float(d.abs().max() / A2.data.abs().max())
    return rel, int((d != 0).sum()), float(A.data[cross].abs().max())


def span_leading(A, M, target: complex) -> dict:
    """The beta > 0 eigenvalue as tests/benchmark/test_span_cylinder.py's
    gate takes it: the SPAN_NEV eigenpairs nearest ``target`` on the band
    factor at ncv SPAN_NCV, the one of largest real part (in the upper
    half-plane), its index among the pairs (nearest first), every pair's
    residual and the operator."""
    import torch
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    es = EigenSolver(A, M, EigensolverConfig(num_eig=SPAN_NEV, atol=1e-8, ncv=SPAN_NCV))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    pairs = es.solve()
    torch.cuda.synchronize()
    lead = max(range(len(pairs)), key=lambda i: pairs[i][0].real)
    sigma = pairs[lead][0]
    return dict(sigma=sigma if sigma.imag >= 0 else sigma.conjugate(), pairs=pairs, lead=lead,
                resids=eigen_residuals(A, M, pairs), op=es.operator)


def _span_host_check(As, Ms, shift: complex, vecs: list) -> dict:
    """Phase 8's cross-check, in the check worker on the CPU: tau + 1 /
    theta of each banded eigenvector x, theta its Rayleigh quotient under
    the host LU's shift-invert at tau."""
    import torch
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator

    t0 = time.time()
    with host_lu_counted() as hl:
        hop = ShiftInvertOperator(CSRMatrix.from_scipy(As, device="cpu"),
                                  CSRMatrix.from_scipy(Ms, device="cpu"), shift, method="lu")
        sigma_lu = []
        for x in vecs:
            xt = torch.as_tensor(x)
            theta = complex(torch.vdot(xt, hop.apply(xt)) / torch.vdot(xt, xt))
            sigma_lu.append(shift + 1.0 / theta)
    return dict(sigma_lu=sigma_lu, host_lu=hl["host_lu"], factor_s=hop.factor_seconds,
                seconds=time.time() - t0)


def span_path(case, p2d: dict, phase: str, dev, *, cross_check: bool = False,
              keep: list | None = None) -> dict:
    """Phase 8 / 8b, span stage: ``SpanwiseStability`` on ``p2d``'s baseflow
    at Re = 47 (its pattern and outlet slots once, a stage), then at beta =
    0 and SPAN_BETA (each a stage) the eigensystem and its eigenvalue on
    the band factor: at beta = 0 the one nearest 0.74j (``leading_pair``),
    at SPAN_BETA the one the reference's gate takes (``span_leading``).
    The band is reckoned from the pattern's RCM ordering before the beta
    stages; where its complex64 storage is over ``band_mem_budget()`` (the
    plan would take a bf16 band), the beta stages set
    ``LSAFW_BAND_MEM_GB`` to that storage rounded up, plus 1 GB.  With
    ``cross_check`` the host LU (asked for, counted) is held against the
    band factor on the banded eigenvectors: one host factor at the banded
    shift tau, and for each converged pair (sigma, x) at SPAN_BETA the
    host-LU eigenvalue tau + 1 / theta, theta = x^H T x / x^H x with T the
    host-LU shift-invert apply, within 1e-8 of the banded sigma (a second
    eigensolve on the host LU took 20.6 s at 43k on an H100 machine).
    ``keep`` receives the SPAN_BETA factor."""
    import torch
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.span import SpanwiseStability

    what = f"phase {phase} span"
    t_phase = time.time()
    stages: dict = {}
    with plain_loops_forbidden():
        with stage("setup", stages):
            span = SpanwiseStability(case["ctx"], p2d["w"], 47.0, case["bcs_pert"], case["mesh"],
                                     device=dev)
            tband.pattern_permutation(span.pattern)  # the RCM ordering, reckoned here
        pat = span.pattern
        rk = reckon_band(pat, span.num_dofs)
        bw, nb, B, c64_gb = rk["bw"], rk["nb"], rk["B"], rk["c64"]
        budget_gb = tband.band_mem_budget() / 1e9
        band_gb = float(np.ceil(c64_gb) + 1) if c64_gb > budget_gb else None
        log(f"{what}: {span.n2} mixed + {span.ns} spanwise = {span.num_dofs} DOFs, {pat.nnz} nnz; "
            f"RCM bandwidth {bw}: B = {B} at nb = {nb}, a complex64 band of {c64_gb:.2f} GB "
            f"(bf16 {c64_gb / 2:.2f} GB) against LSAFW_BAND_MEM_GB = {budget_gb:g}"
            + ("" if band_gb is None else f", which would take the bf16 band: the beta stages set "
                                          f"it to {band_gb:g}"))
        switches = {} if band_gb is None else {"LSAFW_BAND_MEM_GB": f"{band_gb:g}"}
        res: dict = {}
        with env(**switches):
            for beta in (0.0, SPAN_BETA):
                with stage(f"beta={beta:g}", stages):
                    A, M = span.assemble_eigensystem(beta)
                    if beta == 0:
                        sigma, resid, op, _ = leading_pair(A, M, TARGET)
                        r = dict(sigma=sigma, resids=[resid])
                    else:
                        r = span_leading(A, M, p2d["sigma"])
                        op = r.pop("op")
                r.update(figures=op.figures(), cls=type(op.device_op.blu).__name__,
                         plan=tband.plan_for_csr(A), shift=op.sigma)
                res[beta] = r
                if beta == 0:
                    blk = q3_block_check(A, p2d["A"], span.n2)
                    mblk = q3_block_check(M, p2d["M"], span.n2)
                    del A, M
                elif keep is not None:
                    keep.append(op.device_op.blu)
                del op
                torch.cuda.empty_cache()
        if cross_check:  # in the check worker, gated after phase 9
            def gate(hc: dict, r: dict = res[SPAN_BETA]) -> None:
                r["sigma_lu"] = hc["sigma_lu"]
                gap = max(abs(a - b) for a, (b, _) in zip(r["sigma_lu"], r["pairs"]))
                log(f"{what}: beta = {SPAN_BETA:g} on the host LU, asked for ({hc['host_lu']} "
                    f"host LU factor in the check worker, {hc['seconds']:.2f} s, factor "
                    f"{hc['factor_s']:.2f} s): tau + 1 / theta on the {len(r['pairs'])} banded "
                    f"eigenvectors "
                    + ", ".join(f"{z.real:+.12f}{z.imag:+.12f}j" for z in r["sigma_lu"])
                    + f", {gap:.1e} from the banded ones")
                if hc["host_lu"] != 1 or not gap <= 1e-8:
                    raise RuntimeError(f"{what}: the host LU's eigenvalues {r['sigma_lu']} "
                                       f"against the banded {[p[0] for p in r['pairs']]} (1e-8), "
                                       f"{hc['host_lu']} host LU factors (1)")

            r = res[SPAN_BETA]
            start_host_check(what, _span_host_check,
                             (A.to_scipy(), M.to_scipy(), r["shift"],
                              [np.asarray(x) for _, x in r["pairs"]]), gate)
        del A, M
    s0, s1 = res[0.0]["sigma"], res[SPAN_BETA]["sigma"]
    for beta, r in res.items():
        p, f = r["plan"], r["figures"]
        storage = "pivoted" if f["pivoted"] else f"pivot-free {p.band_dtype}"
        log(f"{what}: beta = {beta:g}: sigma = {r['sigma'].real:+.12f}{r['sigma'].imag:+.12f}j, "
            f"residual {max(r['resids']):.2e}; plan B = {p.B}, nblk_pad = {p.nblk_pad}, {storage} "
            f"({r['cls']}), contraction {f['rho']:.2e}, factor {f['factor_s']:.2f} s, "
            f"{f['applies']} applies")
    r = res[SPAN_BETA]
    log(f"{what}: beta = {SPAN_BETA:g}: the {len(r['pairs'])} eigenpairs nearest "
        f"{p2d['sigma'].real:+.6f}{p2d['sigma'].imag:+.6f}j at ncv {SPAN_NCV}: "
        + ", ".join(f"{lam.real:+.12f}{lam.imag:+.12f}j ({abs(lam - p2d['sigma']):.6f} from it, "
                    f"residual {rr:.1e})" for (lam, _), rr in zip(r["pairs"], r["resids"]))
        + f"; the largest real part is pair {r['lead']}")
    for name, st in stages.items():
        stage_line(f"{what}: {name}", st)
    log(f"{what}: beta = 0 against phase {'3' if phase == '8' else '6'}'s 2D sigma "
        f"{p2d['sigma'].real:+.12f}{p2d['sigma'].imag:+.12f}j: {abs(s0 - p2d['sigma']):.1e}; the "
        f"(u, v, p) block of A(0) rel {blk[0]:.1e} ({blk[1]} entries not bitwise equal), of M "
        f"rel {mblk[0]:.1e} ({mblk[1]}), couplings max {max(blk[2], mblk[2])}; sigma_r "
        f"{s1.real:+.6f} at beta = {SPAN_BETA:g} against {s0.real:+.6f} at 0")
    checks = [
        (abs(s0 - p2d["sigma"]) <= 1e-8, f"sigma(0) {s0} is not within 1e-8 of {p2d['sigma']}"),
        # the card's f64 index_add_ sums each slot's contributions in atomic
        # order, so two assemblies agree to rounding, not bit for bit
        (blk[0] <= 1e-13 and mblk[0] <= 1e-13, f"the (u, v, p) block rel {blk[0]:.1e} / "
                                                 f"{mblk[0]:.1e} (1e-13)"),
        (blk[2] == 0.0 and mblk[2] == 0.0, "the couplings at beta = 0 are not exactly zero"),
        (s1.real < s0.real - 1e-3, f"sigma_r({SPAN_BETA:g}) {s1.real} is not below sigma_r(0) "
                                   f"{s0.real} - 1e-3"),
        (len(res[SPAN_BETA]["pairs"]) == SPAN_NEV, f"{len(res[SPAN_BETA]['pairs'])} pairs "
                                                   f"converged at beta = {SPAN_BETA:g} "
                                                   f"({SPAN_NEV} asked for)"),
        (all(lam.real < s0.real - 1e-3 for lam, _ in res[SPAN_BETA]["pairs"]),
         f"a converged sigma_r({SPAN_BETA:g}) is not below sigma_r(0) - 1e-3"),
        (all(max(r["resids"]) <= 1e-8 for r in res.values()), "an eigen residual over 1e-8"),
    ]
    for ok, msg in checks:
        if not ok:
            raise RuntimeError(f"{what}: {msg}")
    for i, beta in enumerate((0.0, SPAN_BETA)):
        gate_class(f"{what} beta={beta:g}", stages[f"beta={beta:g}"], COMPLEX_CLASSES,
                   builds=1 - i)
    plans = {k: stages["beta=0"]["builds"].get(k, 0) + stages[f"beta={SPAN_BETA:g}"][
        "builds"].get(k, 0) for k in ("band", "csr", "rcm")}
    if plans["band"] != 1:
        raise RuntimeError(f"{what}: {plans['band']} band plans built over the two beta")
    out = dict(sigma=res, stages=stages, seconds=time.time() - t_phase,
               launches={k: sum(st["launches"][k] for st in stages.values()) for k in counts()})
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


def _forced_host_check(As, Ms, forced: dict) -> dict:
    """Phase 8 WNL's cross-check, in the check worker on the CPU: each
    forced solve (A - shift M) x = b again on the host LU, the two side by
    side (SuperLU releases the GIL)."""
    import torch
    from lsafw_tpu_torch import wnl
    from lsafw_tpu_torch.ops.sparse import CSRMatrix

    t0 = time.time()
    A, M = (CSRMatrix.from_scipy(X, device="cpu") for X in (As, Ms))

    def host_x(item) -> np.ndarray:
        shift, b = item
        return wnl._forced_solve(A, M, shift, torch.as_tensor(b), method="lu").numpy()

    with host_lu_counted() as hl, ThreadPoolExecutor(max_workers=len(forced)) as pool:
        x = dict(zip(forced, pool.map(host_x, forced.values())))
    return dict(x=x, host_lu=hl["host_lu"], seconds=time.time() - t0)


def wnl_path(case, phase: str, dev, *, cross_check: bool = False, w0=None) -> dict:
    """Phase 8 / 8b, WNL stage: ``find_critical_re`` over the phase's
    bracket (tol 1e-3; each baseflow, Newton and eigensolve a stage), then
    ``weakly_nonlinear`` at the Re_c it returns (the sensitivity solver's
    direct, adjoint and du/dRe solves and the two forced solves, each a
    stage), with test_wnl.py's gates, the forced solves' residuals on the
    card's CSR and a^H M q1 = 1; with ``cross_check`` the two forced solves
    again on the host LU (asked for, counted), in two threads.  With ``w0``
    (the baseflow of another Re on the same mesh), the bracket's first
    baseflow is one banded Newton from it instead of the ramp, as
    ``find_critical_re`` warm-starts its later ones."""
    import torch
    from lsafw_tpu_torch import wnl
    from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
    from lsafw_tpu_torch.ops.sparse import spmv

    what = f"phase {phase} WNL"
    t_phase = time.time()
    stages: dict = {}
    figures: dict = {}
    state = {"re": None, "n": 0}
    saved = {k: getattr(wnl, k) for k in ("BaseFlowSolver", "NewtonSolver", "EigenSolver",
                                          "EigenSensitivitySolver", "_forced_solve",
                                          "ShiftInvertOperator")}
    sens_made: list = []
    forced: dict = {}

    class Baseflow(saved["BaseFlowSolver"]):
        def solve(self, **kw):
            state["re"] = self._re
            with stage(f"baseflow Re={self._re:.4f}", stages):
                if w0 is None:
                    return super().solve(**kw)
                res = saved["NewtonSolver"](
                    StationaryNavierStokesAssembler(case["ctx"], case["mesh"], case["bcs_base"]),
                    linear_solver=kw["linear_solver"]).solve(
                    torch.as_tensor(w0, device=dev), self._re, tol=kw["tol"], max_it=kw["max_it"])
            if not res.converged:
                raise RuntimeError(f"{what}: the Newton from w0 to Re = {self._re:g} did not "
                                   f"converge ({res.residual_norm:.2e})")
            return res.w

    class Newton(saved["NewtonSolver"]):
        def solve(self, w0, re, **kw):
            state["re"] = re
            with stage(f"Newton Re={re:.4f}", stages):
                return super().solve(w0, re, **kw)

    class Eigen(saved["EigenSolver"]):
        def solve(self):
            name = f"eigen Re={state['re']:.4f}"
            with stage(name, stages):
                out = super().solve()
            figures[name] = self.operator.figures()
            return out

    class Sensitivity(saved["EigenSensitivitySolver"]):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            sens_made.append(self)
            for attr, name in (("solve_direct_mode", "direct"), ("solve_adjoint_mode", "adjoint"),
                               ("compute_baseflow_sensitivity", "du/dRe")):
                staged(self, attr, name, stages)

    made: list = []  # the figures of each forced solve's operator (not the operator)

    class Operator(saved["ShiftInvertOperator"]):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self.figures())

    def forced_solve(A, M, shift, b, **kw):
        name = "forced sigma=0" if shift == 0 else "forced 2i omega"
        with stage(name, stages):
            x = saved["_forced_solve"](A, M, shift, b, **kw)
        forced[name] = (shift, b, x)
        figures[name] = made[-1]
        return x

    for k, v in (("BaseFlowSolver", Baseflow), ("NewtonSolver", Newton), ("EigenSolver", Eigen),
                 ("EigenSensitivitySolver", Sensitivity), ("_forced_solve", forced_solve),
                 ("ShiftInvertOperator", Operator)):
        setattr(wnl, k, v)
    try:
        with plain_loops_forbidden():
            lo, hi = WNL_BRACKETS[phase]
            re_c, w_c, sigma_c = wnl.find_critical_re(case["ctx"], case["mesh"], case["bcs_base"],
                                                      case["bcs_pert"], lo, hi, tol=1e-3,
                                                      device=dev)
            t_crit = time.time() - t_phase
            res = wnl.weakly_nonlinear(case["ctx"], case["mesh"], case["bcs_base"],
                                       case["bcs_pert"], re_c, w_c, device=dev)
    finally:
        for k, v in saved.items():
            setattr(wnl, k, v)
    sens = sens_made[-1]
    A, M, a = sens._A, sens._M, sens._a
    aMq = complex(torch.vdot(a, spmv(M, res.q1)))
    resid = {}
    for name, (shift, b, x) in forced.items():
        r = spmv(A, x) - (shift if x.is_complex() else float(shift.real)) * spmv(M, x) - b
        resid[name] = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    for name, st in stages.items():
        f = figures.get(name) or sens.operators.get(name)
        stage_line(f"{what}: {name}", st, f)
    st = sens.stats
    log(f"{what}: du/dRe: factor {st['factor_s']:.3f} s, {st['gcr_its']} GCR iterations")
    A1, A2 = res.amplitude(re_c + 2.0), res.amplitude(re_c + 6.0)
    log(f"{what}: {case['spaces'].num_dofs} DOFs; find_critical_re({lo:g}, {hi:g}) {t_crit:.1f} s, "
        f"Re iterates {[float(k.split('=')[1]) for k in stages if k.startswith('eigen')]}: Re_c = "
        f"{re_c:.6f}" + (f" (VALIDATION.md records {RE_C_175K} for the production mesh)"
                         if phase == "8b" else "")
        + f", sigma_c = {sigma_c.real:+.3e}{sigma_c.imag:+.10f}j")
    log(f"{what}: omega_c = {res.omega_c:.10f}, lambda' = {res.lambda_p.real:+.6e}"
        f"{res.lambda_p.imag:+.6e}j, mu = {res.mu.real:+.6e}{res.mu.imag:+.6e}j; A(Re_c + 2) = "
        f"{A1:.6f}, A(Re_c + 6) = {A2:.6f}, frequency(Re_c + 6) = {res.frequency(re_c + 6.0):.6f}; "
        f"|q20| = {float(torch.linalg.vector_norm(res.q20)):.4e}, |q22| = "
        f"{float(torch.linalg.vector_norm(res.q22)):.4e}; forced residuals "
        + ", ".join(f"{k} {v:.2e}" for k, v in resid.items())
        + f"; a^H M q1 = {aMq.real:+.12f}{aMq.imag:+.1e}j")
    lo_c, hi_c = WNL_RE_C[phase]
    checks = [
        (lo_c < re_c < hi_c, f"Re_c {re_c} outside ({lo_c}, {hi_c})"),
        (abs(sigma_c.real) < 1e-3, f"|sigma_r(Re_c)| = {abs(sigma_c.real):.1e} >= 1e-3"),
        (0.6 < res.omega_c < 0.9, f"omega_c {res.omega_c} outside (0.6, 0.9)"),
        (res.mu.real > 0 and res.lambda_p.real > 0, f"mu {res.mu}, lambda' {res.lambda_p}"),
        (0 < A1 < A2, f"amplitudes {A1}, {A2}"),
        (res.frequency(re_c + 6.0) > res.omega_c, "the frequency does not grow"),
        (float(torch.linalg.vector_norm(res.q20)) > 0 and float(torch.linalg.vector_norm(res.q22))
         > 0, "q20 or q22 is zero"),
        (len(resid) == 2 and all(v <= 1e-8 for v in resid.values()), f"forced residuals {resid}"),
        (abs(aMq - 1) <= 1e-10, f"a^H M q1 = {aMq}"),
        (not res.q20.is_complex() and res.q22.is_complex(), "q20 complex or q22 real"),
    ]
    for ok, msg in checks:
        if not ok:
            raise RuntimeError(f"{what}: {msg}")
    planned: set = set()  # the first baseflow and eigen stages may plan (a real, a complex band)
    for name, st in stages.items():
        kind = name.split(" ")[0]
        real = kind in ("baseflow", "Newton", "du/dRe") or name == "forced sigma=0"
        builds = int(kind in ("baseflow", "eigen") and kind not in planned)
        planned.add(kind)
        gate_class(f"{what} {name}", st, ("RealPivotedBandedLU",) if real else COMPLEX_CLASSES,
                   builds)
    out = dict(re_c=re_c, res=res, stages=stages,
               launches={k: sum(st["launches"][k] for st in stages.values()) for k in counts()})
    if cross_check:  # in the check worker, gated after phase 9
        def gate(hc: dict) -> None:
            rel = {k: float(np.linalg.norm(hc["x"][k] - x.cpu().numpy()) / np.linalg.norm(hc["x"][k]))
                   for k, (_, _, x) in forced.items()}
            log(f"{what}: the forced solves on the host LU, asked for ({hc['host_lu']} host LU "
                f"factors in the check worker, {hc['seconds']:.2f} s): "
                + ", ".join(f"{k} rel {v:.1e}" for k, v in rel.items()))
            if hc["host_lu"] != 2 or not all(v <= 1e-8 for v in rel.values()):
                raise RuntimeError(f"{what}: banded against host LU: {rel} (1e-8), "
                                   f"{hc['host_lu']} host LU factors (2)")

        start_host_check(what, _forced_host_check,
                         (A.to_scipy(), M.to_scipy(),
                          {k: (shift, b.cpu().numpy()) for k, (shift, b, _) in forced.items()}),
                         gate)
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


# ---------------------------------------------------------------------------
# Phase 9: nonlinear time stepping, the shedding cycle and its Floquet multipliers
# ---------------------------------------------------------------------------

UNSTEADY_RE = 60.0  # tests/benchmark/test_unsteady.py:29, examples/floquet_cycle.py:37
DNS_TARGET, DNS_EPS, DNS_DT, DNS_STEPS = 0.05 + 0.75j, 1e-5, 0.25, 360  # test_unsteady.py
SAT_DT, SAT_STEPS = 0.2, 1750  # examples/floquet_cycle.py: dt 0.2, t_sat = 350
# 9c's cut in depth: the march starts from 9b's last state with its
# perturbation scaled to a 2-norm of SAT_NORM (9b leaves it near 1e-3, where
# the example starts, and the example spends about 200 of its 350 time
# units growing to the cycle's 2-norm of about 30; from 5 the growth takes
# about 40) and runs in chunks of SAT_CHUNK steps, stopping after at least
# SAT_MIN steps (t = 200: about the 150 time units the example marches on
# the cycle; on an H100 the saturated frequency came 1.0% above that of
# the example's march after 625 steps, 0.65% after 1,000, the orbit closing
# to 4.8e-4 against the example's 2.9e-3; cut to 625 for the script's
# time) once the last quarter's amplitude is within SAT_SETTLED of the
# quarter before (the gate allows 5%), at SAT_STEPS at most
SAT_NORM, SAT_CHUNK, SAT_MIN, SAT_SETTLED = 5.0, 125, 625, 0.01
N_SNAPS, FLOQUET_K = 40, 5  # examples/floquet_cycle.py
SPAN_FLOQUET_BETA, SPAN_FLOQUET_K = 1.6, 3  # mode A's wavenumber; secondary_instability.py's k
FORCED_EPS, FORCED_PER = 1e-6, 64  # tests/benchmark/test_resolvent_dns.py
# K1/K2 mode, band factor class and G's types: the march's real vectors and
# the Floquet trips' complex ones, both on real factors
MARCH_KEY = ("pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1")
TRIP_KEY = ("pivoted.f32x2", "RealPivotedBandedLU", "c128.f32x2")
# the stages that may build a plan: the first on the 2D pattern's real and
# complex plans (cached since phase 3 unless evicted) and on the quasi-3D one
P9_BUILDS = {"9a forced DNS": 1, "9b eigen": 1, "9e spanwise floquet": 1}


def quarters(sig: np.ndarray) -> tuple[float, float, float]:
    """The peak |signal| over its last quarter and over the quarter before,
    and their difference relative to the first: 9c's saturation measure."""
    q4 = len(sig) // 4
    a_last, a_prev = float(np.abs(sig[-q4:]).max()), float(np.abs(sig[-2 * q4:-q4]).max())
    return a_last, a_prev, abs(a_last - a_prev) / a_last


def saturate(us, q0, probe: int, wp: float, t0: float):
    """9c's march from ``q0`` at ``t0`` in chunks of ``SAT_CHUNK`` steps of
    ``SAT_DT``, until the probe's signal (less ``wp``) is saturated to
    ``SAT_SETTLED`` after ``SAT_MIN`` steps, or ``SAT_STEPS``: the chunks'
    ``UnsteadyResult`` joined.  ``us`` keeps its chord factor across chunks,
    and a theta step reads only the state, so the chunks march as one run."""
    import torch
    from lsafw_tpu_torch.solver.timestepping import UnsteadyResult

    q, t, ts, probes, stats = q0, t0, [], [], []
    while len(stats) < SAT_STEPS:
        r = us.run(q, SAT_DT, min(SAT_CHUNK, SAT_STEPS - len(stats)), probe_dofs=[probe], t0=t)
        q, t = r.q, float(r.t[-1])
        ts.append(r.t)
        probes.append(r.probes)
        stats += r.stats
        if not bool(torch.isfinite(q).all()) or (len(stats) >= SAT_MIN and quarters(
                np.concatenate(probes)[:, 0] - wp)[2] < SAT_SETTLED):
            break
    return UnsteadyResult(np.concatenate(ts), np.concatenate(probes), q, stats)


def probe_dof(spaces) -> int:
    """The v-velocity DOF nearest (2.5, 0), the reference's wake probe."""
    coords, nu = spaces.velocity.dof_coords, spaces.num_velocity_dofs
    d2 = (coords[1:nu:2, 0] - 2.5) ** 2 + coords[1:nu:2, 1] ** 2
    return 2 * int(np.argmin(d2)) + 1


def p9_line(what: str, st: dict, stats: dict | None = None) -> None:
    """One line per phase-9 stage: seconds, band solves, GCR iterations,
    factors and their seconds, ARPACK applies (monodromy applies), peak
    memory above the stage's start, plans built."""
    s = stats or {}
    log(f"{what}: {st['seconds']:.2f} s, band solves {st['solves']}, GCR iterations "
        f"{s.get('gcr_its', 0)}, factors {s.get('factors', 0)} in {s.get('factor_s', 0.0):.2f} s, "
        f"monodromy applies {s.get('applies', 0)}, original-order matvecs {st['matvecs']}, peak "
        f"{st['peak_gb'] - st['resident_gb']:.3f} GB above its start ({st['peak_gb']:.3f} GB in "
        f"all), plans built {st['builds']}")


def split_modes(res, velocity: np.ndarray) -> tuple[list, list]:
    """(multipliers of modes that carry velocity, multipliers of
    pure-pressure modes): a mode whose velocity rows (``velocity``, a
    boolean row mask) hold at most 1e-8 of its norm is pure pressure.  The
    theta step maps a pure-pressure vector (0, p0) to (0, -p0) (u1 = 0
    solves the momentum rows with G p1 = -G p0, and the continuity and
    Dirichlet rows), so such modes carry mu = (-1)^N exactly: no state of
    the flow, and a cluster of |mu| = 1 that ARPACK meets."""
    flow, pressure = [], []
    for mu, x in zip(res.multipliers, res.modes):
        vel = np.linalg.norm(x[velocity]) <= 1e-8 * np.linalg.norm(x)
        (pressure if vel else flow).append(complex(mu))
    return flow, pressure


def forced_dns(case, p7: dict, dev) -> dict:
    """Phase 9a (``tests/benchmark/test_resolvent_dns.py``): the stable
    Re = 40 flow forced with eps Re(M f e^{i omega t}), f the optimal
    forcing at omega = 0.75 of phase 7, started on the predicted harmonic
    orbit w + eps Re(gain q), marched 2.25 forcing periods at 64 steps a
    period; the response amplitude reconstructed from t = 2 and 2.25
    periods against the gain, its shape against the resolvent mode."""
    import torch
    from lsafw_tpu_torch.ops.sparse import spmv
    from lsafw_tpu_torch.solver.timestepping import UnsteadySolver

    modes, M = p7["modes"], p7["M"]
    w = torch.as_tensor(p7["w"], device=dev)
    gain, om = float(modes.gains[0]), float(modes.omega)
    f = torch.as_tensor(modes.forcings[0], device=dev)
    qhat = gain * torch.as_tensor(modes.responses[0], device=dev)
    Mf = spmv(M, f)
    a, b = Mf.real.contiguous(), Mf.imag.contiguous()

    def load_fn(t):
        return FORCED_EPS * (a * np.cos(om * t) - b * np.sin(om * t))

    dt = 2 * np.pi / om / FORCED_PER
    us = UnsteadySolver(case["ctx"], case["mesh"], case["bcs_base"], NONMODAL_RE,
                        newton_tol=1e-11, refactor_every=100, device=dev)
    full = us.run(w + FORCED_EPS * qhat.real, dt, 2 * FORCED_PER, load_fn=load_fn)
    quarter = us.run(full.q, dt, FORCED_PER // 4, t0=float(full.t[-1]), load_fn=load_fn)
    est = (full.q - w) / FORCED_EPS - 1j * (quarter.q - w) / FORCED_EPS
    amp = float(torch.sqrt(torch.vdot(est, spmv(M, est)).real))
    corr = float(torch.vdot(est, spmv(M, qhat)).abs()
                 / (amp * torch.sqrt(torch.vdot(qhat, spmv(M, qhat)).real)))
    return dict(gain=gain, amp=amp, corr=corr, dt=dt, steps=2 * FORCED_PER + FORCED_PER // 4,
                solver=us, newton=[s.newton_iters for s in full.stats + quarter.stats])


def unsteady_path(case, p7: dict, dev, keep: list | None = None) -> dict:
    """Phase 9, on phase 3's 43k mesh with the nonlinear problem's BCs:
    9a the forced DNS closure at Re = 40 (:func:`forced_dns`); 9b the DNS
    against linear theory at Re = 60 (``tests/benchmark/test_unsteady.py``:
    ramped banded baseflow, 4 steps, tol 1e-10; the leading pair near
    0.05+0.75j, num_eig 2, ncv 30, atol 1e-9; the march from w + 1e-5 v,
    v = Re(v_hat) normalised, dt 0.25, 360 steps, refactor every 50,
    Newton to 1e-10; the probe v at (2.5, 0)); 9c the saturated cycle
    (``examples/floquet_cycle.py``: at dt 0.2, refactor every 10, Newton
    to 1e-9, t_sat = 350 at most; from 9b's state with its perturbation
    scaled to ``SAT_NORM``, until saturated, :func:`saturate`; then N = 40
    steps of T/40,
    refactoring every step, stored as the snapshots); 9d the 2D Floquet
    multipliers on the prestored factors (k = 5), one inexact trip against
    the prestored one and one step against a host SuperLU (asked for, one
    factor counted); 9e the spanwise Floquet multipliers at beta = 1.6 on
    the cycle-mean factor (k = 3).  Each a stage, gated.  ``keep``
    receives one of 9d's factors."""
    import torch
    from scipy.signal import hilbert
    from lsafw_tpu_torch import floquet as tfloquet
    from lsafw_tpu_torch.floquet import FloquetSolver
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, _si_apply_C, eigen_residuals)
    from lsafw_tpu_torch.solver.timestepping import UnsteadySolver, dominant_frequency
    from lsafw_tpu_torch.span import SpanwiseStability, spanwise_floquet

    what = "phase 9"
    t_phase = time.time()
    stages: dict = {}
    stats: dict = {}
    ctx, mesh, bcs, spaces = case["ctx"], case["mesh"], case["bcs_base"], case["spaces"]
    nu, n = spaces.num_velocity_dofs, spaces.num_dofs
    probe = probe_dof(spaces)
    rng = np.random.default_rng(9)
    out: dict = {}

    def done(name: str) -> None:
        p9_line(f"{what}: {name}", stages[name], stats[name])

    with plain_loops_forbidden():
        with stage("9a forced DNS", stages):
            fa = forced_dns(case, p7, dev)
        stats["9a forced DNS"] = fa.pop("solver").stats
        done("9a forced DNS")

        with stage("9b baseflow", stages):
            bf = BaseFlowSolver(ctx, mesh, bcs, re=UNSTEADY_RE)
            w = torch.as_tensor(bf.solve(ramp=True, steps=4, tol=1e-10, max_it=40,
                                         linear_solver="banded"), device=dev)
        stats["9b baseflow"] = dict(factors=bf.stats["factors"], factor_s=bf.stats["factor_s"],
                                    gcr_its=bf.stats["gcr_its"])
        done("9b baseflow")
        with stage("9b eigen", stages):
            A, M = LinearizedNavierStokesAssembler(w, ctx, UNSTEADY_RE, case["bcs_pert"],
                                                   mesh).assemble_eigensystem()
            es = EigenSolver(A, M, EigensolverConfig(num_eig=2, atol=1e-9, ncv=30))
            es.set_st_type(STType.SINVERT)
            es.set_target(DNS_TARGET)
            es.set_st_pc_type("banded")
            pairs = es.solve()
        sigma, vhat = max(pairs, key=lambda p: p[0].real)
        e_res = float(eigen_residuals(A, M, [(sigma, vhat)])[0])
        fig = es.operator.figures()
        stats["9b eigen"] = dict(factors=1, factor_s=fig["factor_s"], applies=fig["applies"])
        done("9b eigen")
        del A, M, es
        v = np.real(vhat)
        v = torch.as_tensor(v / np.linalg.norm(v), device=dev)
        with stage("9b march", stages):
            us = UnsteadySolver(ctx, mesh, bcs, UNSTEADY_RE, newton_tol=1e-10, refactor_every=50,
                                device=dev)
            dns = us.run(w + DNS_EPS * v, DNS_DT, DNS_STEPS, probe_dofs=[probe])
        stats["9b march"] = us.stats
        done("9b march")
        del us
        wp = float(w[probe])
        sig, t = dns.probes[:, 0] - wp, dns.t
        m = len(t)
        omega_fit = dominant_frequency(t[m // 3:], sig[m // 3:])
        env = np.abs(hilbert(sig - sig.mean()))
        half = slice(m // 2, 5 * m // 6)
        sigma_r_fit = float(np.polyfit(t[half], np.log(env[half]), 1)[0])
        grow = env[half][-1] / (np.exp(sigma.real * (t[half][-1] - t[half][0])) * env[half][0])

        pert = dns.q - w
        norm9b = float(torch.linalg.vector_norm(pert))
        with stage("9c saturation", stages):
            us = UnsteadySolver(ctx, mesh, bcs, UNSTEADY_RE, newton_tol=1e-9, refactor_every=10,
                                device=dev)
            sat = saturate(us, w + (SAT_NORM / norm9b) * pert, probe, wp, float(t[-1]))
        stats["9c saturation"] = us.stats
        sat_steps = len(sat.stats)
        done("9c saturation")
        newton_sat = [s.newton_iters for s in sat.stats]
        q, _ = us.step(sat.q, SAT_DT)  # a refactoring step; the next reuses its factor
        step_wall, step_busy, step_ops = device_busy(lambda: us.step(q, SAT_DT))
        del us
        ssig = sat.probes[:, 0] - wp
        q4 = len(ssig) // 4
        a_last, a_prev, _ = quarters(ssig)
        omega_sat = dominant_frequency(sat.t[-2 * q4:], ssig[-2 * q4:])
        period = 2 * np.pi / omega_sat
        dt_f = period / N_SNAPS
        with stage("9c snapshots", stages):
            us = UnsteadySolver(ctx, mesh, bcs, UNSTEADY_RE, newton_tol=1e-10, refactor_every=1,
                                device=dev)
            snaps = torch.empty((N_SNAPS, n), dtype=torch.float64, device=dev)
            q = sat.q
            for k in range(N_SNAPS):
                snaps[k] = q
                q, _ = us.step(q, dt_f)
        stats["9c snapshots"] = us.stats
        done("9c snapshots")
        del us
        closure = float(torch.linalg.vector_norm(q - snaps[0]) / torch.linalg.vector_norm(snaps[0]))

        with stage("9d floquet", stages):
            fs = FloquetSolver(ctx, mesh, bcs, UNSTEADY_RE, snaps, dt_f, device=dev)
            fr = fs.solve(k=FLOQUET_K)
        stats["9d floquet"] = dict(fs.stats)
        done("9d floquet")
        vseed = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        with stage("9d inexact", stages):
            x_pre = fs.monodromy_apply(vseed)
            fi = FloquetSolver(ctx, mesh, bcs, UNSTEADY_RE, snaps, dt_f, inexact=True, device=dev)
            x_in = fi.monodromy_apply(vseed)
        stats["9d inexact"] = dict(fi.stats)
        done("9d inexact")
        in_rel = float(np.linalg.norm(x_in - x_pre) / np.linalg.norm(x_pre))
        in_gcr = fi.stats["gcr_its"] / max(fi.stats["steps"], 1)
        del fi
        t0 = time.time()
        with host_lu_counted(tfloquet) as hl:
            x_dev = fs._step_lin(0, vseed)
            b = fs._rhs(0, torch.as_tensor(vseed, device=dev)).cpu().numpy()
            lu = tfloquet.SparseLU(CSRMatrix(fs._pattern, fs._imp_data(0)))
            xs = lu.solve(np.stack([b.real, b.imag], axis=1))
        x_lu = xs[:, 0] + 1j * xs[:, 1]
        lu_rel = float(np.linalg.norm(x_dev - x_lu) / np.linalg.norm(x_lu))
        t_lu = time.time() - t0
        storage_gb = fs.factor_bytes / 1e9
        if keep is not None:
            keep.append(fs._facs[0][0])
        del fs, lu
        torch.cuda.empty_cache()

        with stage("9e spanwise floquet", stages):
            span = SpanwiseStability(ctx, snaps[0], UNSTEADY_RE, case["bcs_pert"], mesh,
                                     device=dev)
            sfs = spanwise_floquet(span, snaps, dt_f, SPAN_FLOQUET_BETA, device=dev)
            sr = sfs.solve(k=SPAN_FLOQUET_K)
        stats["9e spanwise floquet"] = dict(sfs.stats)
        done("9e spanwise floquet")
        rhos = []
        for k in (0, N_SNAPS // 2):  # one refinement step on a unit vector
            op = sfs._imp_op(k)
            b0 = torch.as_tensor(rng.standard_normal(span.num_dofs)
                                 + 1j * rng.standard_normal(span.num_dofs), device=dev)
            b0 = b0 / torch.linalg.vector_norm(b0)
            rhos.append(float(torch.linalg.vector_norm(b0 - _si_apply_C(op, op.blu.solve(b0)))))
        span_gcr = sfs.stats["gcr_its"] / max(sfs.stats["steps"], 1)
        span_dofs, span_n2 = span.num_dofs, span.n2
        del sfs, span, op
        torch.cuda.empty_cache()

    log(f"{what}a: Re = {NONMODAL_RE:g}, omega = {p7['modes'].omega:g}: {fa['steps']} steps of "
        f"dt {fa['dt']:.6f}; amplitude {fa['amp']:.6f} against the gain {fa['gain']:.6f} "
        f"(rel {abs(fa['amp'] - fa['gain']) / fa['gain']:.2e}, limit 0.05), correlation "
        f"{fa['corr']:.8f} (limit 0.99); Newton corrections a step {np.mean(fa['newton']):.2f}")
    log(f"{what}b: Re = {UNSTEADY_RE:g}: sigma = {sigma.real:+.10f}{sigma.imag:+.10f}j (residual "
        f"{e_res:.1e}; the pair of {len(pairs)} with the largest real part); probe DOF {probe}; "
        f"DNS fit omega {omega_fit:.6f} (rel {abs(omega_fit - sigma.imag) / sigma.imag:.2e}, "
        f"limit 0.03), sigma_r {sigma_r_fit:+.6f} (off {abs(sigma_r_fit - sigma.real):.2e}, limit "
        f"{0.1 * abs(sigma.real) + 2e-3:.2e}); envelope growth over the fit window "
        f"{grow:.3f} of e^(sigma_r t) (limit 0.5); Newton corrections a step "
        f"{np.mean([s.newton_iters for s in dns.stats]):.2f}")
    log(f"{what}c: {sat_steps} steps of dt {SAT_DT} (at most {SAT_STEPS}; from 9b's state, its "
        f"perturbation's 2-norm {norm9b:.3e} scaled to {SAT_NORM:g}; stopped at {SAT_SETTLED:g} "
        f"after {SAT_MIN} steps): amplitude of the last quarter {a_last:.6f}, "
        f"the quarter before {a_prev:.6f} (rel {abs(a_last - a_prev) / a_last:.2e}, limit 0.05); "
        f"omega_sat {omega_sat:.6f} (sigma_i {sigma.imag:.6f}), period {period:.6f}; Newton "
        f"corrections a step {np.mean(newton_sat):.2f}; orbit closure over {N_SNAPS} steps of "
        f"{dt_f:.6f}: {closure:.3e} (limit 1e-2)")
    per_step = stages["9c saturation"]["seconds"] / sat_steps * 1e3
    log(f"{what}c: one saturated step on a chord factor under the profiler: {step_ops} device "
        f"operations, {step_wall:.2f} ms wall, the card busy {step_busy:.2f} ms "
        f"({100 * step_busy / step_wall:.1f}%); the march {per_step:.2f} ms a step")
    velocity2 = np.arange(n) < nu
    flow2, pres2 = split_modes(fr, velocity2)
    # the phase mode is the orbit's tangent at q_0: each mode's alignment with it
    tangent = (snaps[1] - snaps[-1]).cpu().numpy()
    align = [float(abs(np.vdot(x, tangent)) / (np.linalg.norm(x) * np.linalg.norm(tangent)))
             for x in fr.modes]
    absmu = np.sort(np.abs(fr.multipliers))
    log(f"{what}d: multipliers "
        + ", ".join(f"{z.real:+.13f}{z.imag:+.2e}j" for z in fr.multipliers)
        + f"; |mu| {np.abs(fr.multipliers).tolist()}; trivial error {fr.trivial_error:.2e}; "
        f"{len(pres2)} pure-pressure modes, {len(flow2)} carrying velocity; each mode's "
        f"alignment with the orbit's tangent at q_0 {np.round(align, 6).tolist()}")
    log(f"{what}d: factor storage {storage_gb:.2f} GB ({N_SNAPS} real pivoted factors, reckoned "
        f"from BandPlan.band_bytes and pivoted_extra_bytes); peak "
        f"{stages['9d floquet']['peak_gb']:.2f} GB; inexact trip against the prestored one rel "
        f"{in_rel:.2e} (limit 1e-8), {in_gcr:.2f} GCR iterations a step; one step against the host "
        f"SuperLU rel {lu_rel:.2e} (limit 1e-9; {hl['host_lu']} host factor, {t_lu:.2f} s)")
    velocity3 = (np.arange(span_dofs) < nu) | (np.arange(span_dofs) >= span_n2)
    flow3, pres3 = split_modes(sr, velocity3)
    log(f"{what}e: beta = {SPAN_FLOQUET_BETA:g}, {span_dofs} DOFs: multipliers "
        + ", ".join(f"{z.real:+.13f}{z.imag:+.2e}j" for z in sr.multipliers)
        + f"; |mu| {np.abs(sr.multipliers).tolist()}; {len(pres3)} pure-pressure modes, "
        f"{len(flow3)} carrying velocity; {span_gcr:.2f} GCR iterations a step; the mean factor's "
        f"contraction on steps 0 and {N_SNAPS // 2}: {rhos}")
    for name, st in stages.items():
        builds = P9_BUILDS.get(name, 0)
        if name == "9b eigen":
            gate_class(f"{what} {name}", st, COMPLEX_CLASSES, builds)
            continue
        trip = name[:2] in ("9d", "9e")
        key, cls, types = TRIP_KEY if trip else MARCH_KEY
        gate_stage(f"{what} {name}", st, key, cls, types, builds)
        for s_key in (("spmv_shifted.original", "spmv_complex.original") if trip
                      else ("spmv_real.original",)):
            if not st["launches"][s_key]:
                raise RuntimeError(f"{what} {name}: no {s_key} launch")
    sign = (-1.0) ** N_SNAPS
    checks = [
        (abs(fa["amp"] - fa["gain"]) < 0.05 * fa["gain"], f"9a amplitude {fa['amp']} against "
                                                          f"the gain {fa['gain']}"),
        (fa["corr"] > 0.99, f"9a correlation {fa['corr']}"),
        (sigma.real > 0 and e_res <= 1e-8, f"9b sigma {sigma} (residual {e_res:.1e})"),
        (abs(omega_fit - sigma.imag) < 0.03 * sigma.imag, f"9b omega {omega_fit} against {sigma}"),
        (abs(sigma_r_fit - sigma.real) < 0.1 * abs(sigma.real) + 2e-3,
         f"9b sigma_r {sigma_r_fit} against {sigma}"),
        (grow > 0.5, f"9b envelope growth {grow}"),
        (bool(torch.isfinite(dns.q).all()) and bool(torch.isfinite(sat.q).all()),
         "a state is not finite"),
        (abs(a_last - a_prev) < 0.05 * a_last, f"9c not saturated: {a_last} against {a_prev}"),
        (omega_sat > sigma.imag, f"9c omega_sat {omega_sat} <= sigma_i {sigma.imag}"),
        (closure <= 1e-2, f"9c orbit closure {closure:.2e}"),
        (absmu[-2] < 1.0 + 1e-3, f"9d the second-largest |mu| {absmu[-2]} (stable_cycle)"),
        (fr.trivial_error <= 1e-3, f"9d trivial error {fr.trivial_error:.2e}"),
        (in_rel <= 1e-8, f"9d inexact against prestored rel {in_rel:.2e}"),
        (lu_rel <= 1e-9 and hl["host_lu"] == 1, f"9d one step against the host LU rel "
                                                f"{lu_rel:.2e} ({hl['host_lu']} host factors)"),
        (all(abs(mu - sign) <= 1e-8 for mu in pres2 + pres3),
         f"9d/9e pure-pressure multipliers {pres2 + pres3} are not (-1)^N"),
        (len(flow3) >= 1 and all(abs(mu) < 1.0 for mu in flow3),
         f"9e multipliers of modes carrying velocity {flow3}: none, or one not below 1"),
    ]
    for ok, msg in checks:
        if not ok:
            raise RuntimeError(f"{what}: {msg}")
    out.update(stages=stages, seconds=time.time() - t_phase, sigma=sigma, omega_sat=omega_sat,
               saturation=(sat.t, ssig),
               multipliers=fr.multipliers, span_multipliers=sr.multipliers,
               launches={k: sum(st["launches"][k] for st in stages.values()) for k in counts()})
    log(f"{what}: {out['seconds']:.1f} s in all (budget 200 s)")
    return out


# ---------------------------------------------------------------------------
# Phase 10: 3D flows and the backward-facing step
# ---------------------------------------------------------------------------

# phase 2's wide bands, (B, block rows) per nb: the lid-driven cube's B at
# unit_cube(20) (216,024 DOFs), at nb = 128 and 256, in the modes phases 10
# and 10c run
PHASE2_WIDE = {128: (86, 96), 256: (43, 48)}
# (mode, real) of the wide factors, each in every type it takes: the cube's
# Newton (pivoted f32 x1) and eigen (pivot-free c64) factors, the real
# factors of a real shift (phases 10b and 10c: a complex vector as two f32
# columns) and the main path's pivoted c64
WIDE_MODES = (("pivot_free", False), ("pivot_free", True), ("pivoted", False), ("pivoted", True))
S3D_ROW_LENS = (60, 131)  # nonzeros a row: 95 on average, as the cube's 20,448,316 / 216,024
# tests/benchmark/test_cavity3d.py on unit_cube(16): a cut in scale for the
# script's budget from examples/cube.py's 20^3 (BASELINE.md:20), whose
# factors took 130 s of the phase's 150 (an H100 at 700 W); B = 86 at 20^3
# stays in phase 2's wide factors (PHASE2_WIDE)
CUBE_N, CUBE_RE, CUBE_TARGET, CUBE_NEV, CUBE_NCV = 16, 100.0, -0.2 + 0.3j, 4, 24
# the baseflow's ramp: 2 steps (examples/cube.py's), a depth cut from
# test_cavity3d.py's 3 for the script's budget
CUBE_RAMP = 2
# the phase's own budgets, sized for the cube at 20^3: the real pivoted Newton
# factor (21.29 GB band and 10.41 GB of pivoted extras, 31.71 GB) and the
# pivoted complex64 eigen factor (42.58 GB band and 20.75 GB of extras, 63.33
# GB), each band at full width in f32.  At 20^3 the pivot-free complex64
# factor (42.58 GB alone) contracts by 0.243
# at B = 86 on an H100: 36 GCR iterations an apply, residuals 5.6e-7, the
# eigenvectors polluted at the target and at the offset shift (290 s)
CUBE_ENV = {"LSAFW_PIVOT_MEM_GB": "70", "LSAFW_BAND_MEM_GB": "45"}
LID, WALL = 1, 2
# tests/benchmark/test_step_spectrum.py: geometry, inlet, Re, spectrum
STEP_GEOMETRY = dict(dim=2, inlet_length=5.0, step_height=1.0, outlet_length=15.0,
                     channel_height=1.0, resolution=0.22, refinement_factor=2.0)
STEP_RE, STEP_NEV, STEP_NCV = 150.0, 20, 45
STEP_INLET, STEP_OUTLET, STEP_WALL = 1, 2, 3
CYL_MARKER = 5  # cylinder_case's cylinder
STEP3D_CONFIG = Path(__file__).resolve().parent / "config_files" / "3D" / "step"
STEP3D_RE, STEP3D_NEV, STEP3D_NCV = 50.0, 6, 30


def wide_kernels(dev, errs: dict) -> list:
    """Phase 2 at the cube's widths: K1/K2 in each mode of ``WIDE_MODES``
    on random factors at ``PHASE2_WIDE`` (drawn on the card), held against
    their plain versions, the cluster and ring tiles each launch chose, and
    one time each.  Returns the kernels-line entries."""
    import torch
    from lsafw_tpu_torch.solver import band_cuda as bc

    out = []
    for nb2, (B, nblk) in PHASE2_WIDE.items():
        for mode, real in WIDE_MODES:
            f = (random_pivoted(B, nb2, nblk, dev, real, scale=0.005 * (7 / B) ** 0.5)
                 if mode == "pivoted" else random_band(B, nb2, nblk + B, nblk, dev, real))
            for seed, kind in enumerate(kinds(f)):
                b = rhs(kind, nblk, nb2, dev, 3 + seed)
                what = f"phase 2 wide B={B} nblk={nblk}"
                bf16 = f.band.dtype == torch.bfloat16
                query = {k: bc.query_room(k, mode, kind, B, nb2, bf16) for k in ("K1", "K2")}
                formula = {k: bc.room(k, mode, kind, B, nb2, bf16) for k in ("K1", "K2")}
                if {k: v is None for k, v in query.items()} != \
                        {k: v is None for k, v in formula.items()}:
                    raise RuntimeError(f"{what}: {mode_name(f, kind)}: the card's room {query} "
                                       f"and the formula's {formula} disagree")
                try:
                    res = check_kernels(f, b, what)
                except RuntimeError as e:  # K1 pivoted c64 past its window's room must raise
                    if not (mode == "pivoted" and kind == "c64" and "CUDA error 9" in str(e)):
                        raise
                    try:
                        bc.require_room(mode, (kind,), B, nb2, device=dev)
                    except bc.NoRoom as refusal:
                        refused = str(refusal)
                    else:
                        raise RuntimeError(f"{what}: the plan-time room check passed a mode "
                                           f"whose launch fails ({e})")
                    if query["K1"] is not None:
                        raise RuntimeError(f"{what}: the card's room query {query} passed a "
                                           f"mode whose launch fails ({e})")
                    log(f"  {what}: K1 {mode_name(f, kind)} refused, as it must: its two windows "
                        f"of (B + 1) nb = {(B + 1) * nb2} complex entries and a ring tile of "
                        f"nb / 16 rows leave no room in a block's 232,448 B of shared memory "
                        f"at any cluster size: the launch ({e}), the card's room query "
                        f"{query}, the plan-time check ({refused})")
                    continue
                fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
                y = fwd(b)
                chosen = {"K1": bc.last_choice(nb2)}
                bwd(y)
                chosen["K2"] = bc.last_choice(nb2)
                for k, (a, _) in res.items():
                    errs[key_of(k, f, kind)] = max(errs.get(key_of(k, f, kind), 0.0), a)
                ms = {"K1": cuda_ms(lambda: fwd(b), 3), "K2": cuda_ms(lambda: bwd(y), 3)}
                plain = {"K1": cuda_ms(lambda: fwd_plain(b), 1),
                         "K2": cuda_ms(lambda: bwd_plain(y), 1)}
                for k in ("K1", "K2"):
                    c = chosen[k]
                    log(f"  {what}: {k} {mode_name(f, kind)}: window {c['window']} block rows, "
                        f"a cluster of {c['cluster']} blocks, {c['tiles']} ring tiles, "
                        f"{c['smem']} B of shared memory a block; {ms[k]:.4f} ms (the room "
                        f"query {query[k]}, the formula {formula[k]})")
                    out.append(band_entry(k, f, kind, f", random factor B={B} nblk={nblk}",
                                          errs[key_of(k, f, kind)], ms[k], plain[k]))
                del b, y
            del f
    return out


def gate_eigen_stage(what: str, st: dict, classes: tuple, builds: int = 1) -> str:
    """An eigen stage's band solves all of one factor class of ``classes``;
    K1/K2 in that class's mode once per band solve, in the types it takes
    (a complex factor c64; a real factor, at a real shift, f32 x1 for real
    vectors and f32 x2 for a complex vector as two columns), K1 and K2 alike
    per type, and no other band launch; G's permute-in and permute-out once
    each per band solve, in and out alike per type; one original-order S
    launch per original-order matvec; no flat complex128 G; at most
    ``builds`` plans of each kind.  Returns the class."""
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.solver import band_cuda as bc

    if len(st["solves"]) != 1 or next(iter(st["solves"])) not in classes:
        raise RuntimeError(f"{what}: band solves {st['solves']}, expected one class of {classes}")
    cls = next(iter(st["solves"]))
    n, L = st["solves"][cls], st["launches"]
    mode = CLASS_KEYS[cls][0].split(".")[0]
    types = {"c64": "c128"} if cls in COMPLEX_CLASSES else {"f32x1": "f64", "f32x2": "c128"}
    k1 = {t: L[f"K1.{mode}.{t}"] for t in types}
    k2 = {t: L[f"K2.{mode}.{t}"] for t in types}
    others = {k: v for k, v in L.items() if k in bc.LAUNCHES and v and not any(
        k == f"{kk}.{mode}.{t}" for kk in ("K1", "K2") for t in types)}
    pin = {t: L[f"permute_in.{src}.{t}"] for t, src in types.items()}
    pout = {t: L[f"permute_out.{t}.{src}"] for t, src in types.items()}
    n_in = sum(L[f"permute_in.{t}"] for t in sc.PERMUTES["in"])
    n_out = sum(L[f"permute_out.{t}"] for t in sc.PERMUTES["out"])
    s_orig = sum(L[m + ".original"] for m in sc.SPMV_KEYS)
    s_perm = sum(L[m] for m in sc.SPMV_KEYS)
    if not (k1 == k2 == pin == pout and sum(k1.values()) == n_in == n_out == n > 0) or others:
        raise RuntimeError(f"{what}: {n} band solves of {cls}: K1 {k1}, K2 {k2}, permute-in "
                           f"{pin} ({n_in} in all), permute-out {pout} ({n_out}), other band "
                           f"launches {others}")
    if L["gather_c128"] or not (s_orig == st["matvecs"] > 0) or s_perm:
        raise RuntimeError(f"{what}: {L['gather_c128']} flat complex128 G launches, {s_orig} "
                           f"original-order and {s_perm} permuted S launches for "
                           f"{st['matvecs']} original-order matvecs")
    if any(v > builds for v in st["builds"].values()):
        raise RuntimeError(f"{what} planned a pattern again: {st['builds']} (at most {builds})")
    return cls


def reckon_band(pattern, n: int) -> dict:
    """The band of ``pattern`` under its RCM ordering at ``band_nb()``:
    bandwidth, B, and the gigabytes of the real (f32) and complex64 bands
    and of their pivoted extras."""
    from lsafw_tpu_torch.solver import band as tband

    perm = tband.pattern_permutation(pattern)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size)
    bw = int(np.abs(iperm[pattern.row_ids] - iperm[pattern.indices]).max())
    nb = tband.band_nb()
    B = max(1, -(-bw // nb))
    nblk_pad = -(-(-(-n // nb)) // 128) * 128
    gb = {}
    for name, real in (("real", True), ("c64", False)):
        gb[name] = tband.BandPlan.band_bytes(n, B, nb=nb, per_entry=4 if real else 8) / 1e9
        extra = tband.pivoted_extra_bytes(SimpleNamespace(nb=nb, B=B, real=real,
                                                          nblk_pad=nblk_pad))
        gb[name + "_extra"] = extra / 1e9
    return dict(bw=bw, B=B, nb=nb, **gb)


def log_reckoning(what: str, rk: dict, nnz: int, n: int) -> None:
    log(f"{what}: {n} DOFs, {nnz} nonzeros ({nnz / n:.1f} a row); RCM bandwidth {rk['bw']}: B = "
        f"{rk['B']} at nb = {rk['nb']}; real band {rk['real']:.2f} GB + pivoted extras "
        f"{rk['real_extra']:.2f} GB = {rk['real'] + rk['real_extra']:.2f} GB; complex64 band "
        f"{rk['c64']:.2f} GB + pivoted extras {rk['c64_extra']:.2f} GB = "
        f"{rk['c64'] + rk['c64_extra']:.2f} GB")


def conjugates_paired(sig: np.ndarray, tol_abs: float, rel: bool) -> tuple[int, list]:
    """(complex eigenvalues whose conjugate is among ``sig``, those whose
    conjugate is not): within ``tol_abs`` (times max(1, |s|) when ``rel``)."""
    cplx = sig[np.abs(sig.imag) > (1e-4 if rel else 1e-8)]
    paired, lone = 0, []
    for z in cplx:
        d = np.abs(sig - np.conj(z)).min()
        if d < tol_abs * (max(1.0, abs(z)) if rel else 1.0):
            paired += 1
        else:
            lone.append(complex(z))
    return paired, lone


def lone_conjugates(what: str, sig: np.ndarray, vecs: list, A, M, target: complex,
                    res_tol: float) -> list:
    """The complex eigenvalues among ``sig`` whose conjugate is not among
    them (within 1e-4 max(1, |sigma|), test_step_spectrum.py's rule), but
    for one at the edge of the set: at a real target a conjugate pair is
    equidistant from it, so the cut of the ``nev`` nearest can split the
    farthest pair; such a mode's conjugate is held to be an eigenpair by
    its true residual, ||A conj(x) - conj(sigma) M conj(x)|| / ||x|| <=
    ``res_tol`` (the pencil is real)."""
    from lsafw_tpu_torch.solver.eigen import eigen_residuals

    _, lone = conjugates_paired(sig, 1e-4, rel=True)
    edge = float(np.abs(sig - target).max())
    out = []
    for z in lone:
        i = int(np.argmin(np.abs(sig - z)))
        if complex(target).imag == 0.0 and abs(abs(z - target) - edge) <= 1e-8 * max(1.0, edge):
            r = float(eigen_residuals(A, M, [(np.conj(z), np.conj(vecs[i]))])[0])
            log(f"{what}: {z:.10f} is the farthest of the set; its conjugate, ranked just "
                f"outside it, has the true residual {r:.2e} (<= {res_tol:g})")
            if r <= res_tol:
                continue
        out.append(z)
    return out


def eigen_stage(A, M, nev: int, ncv: int, target: complex):
    """``EigenSolver`` (SINVERT, the default banded st_pc) for ``nev`` pairs
    nearest ``target``: (eigenvalues, residuals, solver), the eigenvectors
    in ``solver.vectors``."""
    import torch
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    es = EigenSolver(A, M, EigensolverConfig(num_eig=nev, atol=1e-9, ncv=ncv))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    pairs = es.solve()
    torch.cuda.synchronize()
    es.vectors = [p[1] for p in pairs]
    return np.array([p[0] for p in pairs]), eigen_residuals(A, M, pairs), es


def log_eigen(what: str, sig: np.ndarray, res: np.ndarray, es) -> None:
    op = es.operator
    log(f"{what}: {len(sig)} eigenvalues {[f'{z.real:+.10f}{z.imag:+.10f}j' for z in sig]}; "
        f"residuals max {res.max():.2e}; Krylov-Schur {es.result.restarts} cycles, "
        f"{es.result.iterations} applies; factor {type(op.device_op.blu).__name__} "
        f"{op.factor_seconds:.2f} s, contraction {op.rho:.2e}, refinement cap {op.refine_its}")


def gate_baseflow(what: str, solver, st: dict) -> None:
    """Every Newton solve of the ramp converged; the band solves all on
    real pivoted factors, K1/K2 pivoted f32 x1 once per band solve, G and
    S as in phase 3."""
    s = solver.stats
    log(f"{what}: factor {s['factor_s']:.2f} s in {s['factors']} ({s['pivoted']} pivoted), band "
        f"solves {s['solve_s']:.2f} s in {s['solves']}, SpMV {s['spmv_s']:.2f} s in {s['spmvs']}; "
        f"Newton iterations {[r.iterations for r in solver.newton_results]}, GCR iterations "
        f"{s['gcr_its']} ({s['gcr_its'] / max(s['factors'], 1):.2f} a factor)")
    if not all(r.converged for r in solver.newton_results):
        raise RuntimeError(f"{what}: a Newton solve of the ramp did not converge")
    if s["pivoted"] != s["factors"]:
        raise RuntimeError(f"{what}: {s['factors']} factors, {s['pivoted']} pivoted")
    gate_stage(what, st, "pivoted.f32x1", "RealPivotedBandedLU", "f64.f32x1", builds=1)


@contextmanager
def last_newton_factor():
    """Keep the last band factor the banded Newton made while the block
    runs (``out["factor"]``), for the kernels' checks and times after it.
    The hook drops the factor it holds before the next one is made, so the
    solve's peak memory is unchanged."""
    from lsafw_tpu_torch.solver import newton

    out: dict = {}
    factor_auto = newton.factor_auto

    def kept(*args, **kw):
        out.pop("factor", None)
        out["factor"], pivoted = factor_auto(*args, **kw)
        return out["factor"], pivoted

    newton.factor_auto = kept
    try:
        yield out
    finally:
        newton.factor_auto = factor_auto


def cube_case(device, n: int) -> dict:
    """test_cavity3d.py's lid-driven cube on ``unit_cube(n)``: the lid z = 1
    at u = (1, 0, 0), the other walls no-slip; one pressure DOF pinned in
    both BC sets, as ``examples/cube.py`` pins it (the enclosed flow's
    constant pressure is otherwise in the kernel of J and of A - sigma M)."""
    import torch
    from lsafw_tpu_torch.config import BoundaryConditionsConfig as C
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs, pin_dofs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.mesh import unit_cube
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    mesh = unit_cube(n)
    mark_boundary_facets(mesh, lambda x: np.where(np.isclose(x[:, 2], 1.0), LID, WALL)
                         .astype(np.int32))
    spaces = define_spaces(mesh)

    def walls(lid: float):
        return [C(marker=LID, type="dirichlet_velocity", value=(lid, 0.0, 0.0)),
                C(marker=WALL, type="dirichlet_velocity", value=(0.0, 0.0, 0.0))]

    bcs_base, bcs_pert = define_bcs(mesh, spaces, walls(1.0)), define_bcs(mesh, spaces, walls(0.0))
    for bcs in (bcs_base, bcs_pert):
        pin_dofs(bcs, spaces.dofs_p[0])
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0)


def cube_path(dev, errs: dict) -> dict:
    """Phase 10: the lid-driven cube at Re = 100 on ``unit_cube(CUBE_N)``
    under ``CUBE_ENV``: the banded Newton baseflow (ramped, ``CUBE_RAMP`` steps, tol
    1e-9; real pivoted f32 factors), the eigensystem and ``CUBE_NEV`` pairs
    nearest ``CUBE_TARGET`` (ncv ``CUBE_NCV``; the pivoted complex64
    factor), each a stage, with test_cavity3d.py's gates; then K1/K2 on a
    real pivoted factor of the last Jacobian and on the eigen factor, and S
    on (A, M), each held against its plain version and timed."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver

    what = "phase 10"
    t_phase = time.time()
    case = cube_case(dev, CUBE_N)
    ctx, mesh = case["ctx"], case["mesh"]
    rk = reckon_band(ctx.pattern, ctx.spaces.num_dofs)
    log(f"{what}: lid-driven cube, unit_cube({CUBE_N}) tetrahedra: {mesh.num_cells} cells; mesh, "
        f"spaces and assembly context {case['seconds']:.2f} s (host)")
    log_reckoning(what, rk, ctx.pattern.nnz, ctx.spaces.num_dofs)
    log(f"{what}: the phase's budgets {CUBE_ENV}")
    stages: dict = {}
    with env(**CUBE_ENV):
        with plain_loops_forbidden(), last_newton_factor() as last:
            with stage("baseflow", stages):
                solver = BaseFlowSolver(ctx, mesh, case["bcs_base"], re=CUBE_RE)
                w = solver.solve(ramp=True, steps=CUBE_RAMP, tol=1e-9, linear_solver="banded")
        log_stage(f"{what}: baseflow", stages["baseflow"])
        gate_baseflow(f"{what} baseflow", solver, stages["baseflow"])
        above = stages["baseflow"]["peak_gb"] - stages["baseflow"]["resident_gb"]
        log(f"{what}: baseflow peak {above:.2f} GB above its start against the real pivoted "
            f"factor's reckoned {rk['real'] + rk['real_extra']:.2f} GB")
        # K1/K2 pivoted f32 x1 at the cube's B, on the last Newton factor
        size = f"{ctx.spaces.num_dofs / 1e3:.0f}k lid cube"
        kernels = band_kernels([(f", {size} Newton (phase 10)", last.pop("factor"))], errs,
                               dev, only=("f32x1",), plain_reps=1)
        torch.cuda.empty_cache()
        with plain_loops_forbidden():
            with stage("assemble", stages):
                A, M = LinearizedNavierStokesAssembler(w, ctx, CUBE_RE, case["bcs_pert"],
                                                       mesh).assemble_eigensystem()
            with stage("eigen", stages):
                sig, res, es = eigen_stage(A, M, CUBE_NEV, CUBE_NCV, CUBE_TARGET)
    eig = stages["eigen"]
    log_stage(f"{what}: eigen", eig)
    log_eigen(f"{what}: eigen", sig, res, es)
    log(f"{what}: eigen peak {eig['peak_gb'] - eig['resident_gb']:.2f} GB above its start against "
        f"the pivoted complex64 factor's reckoned {rk['c64'] + rk['c64_extra']:.2f} GB")
    # the factor class the budget gives: the pivoted one (at 20^3 too)
    pivot_gb = float(CUBE_ENV["LSAFW_PIVOT_MEM_GB"])
    expect = "PivotedBandedLU" if rk["c64"] + rk["c64_extra"] <= pivot_gb else "BandedLU"
    gate_eigen_stage(f"{what} eigen", eig, (expect,))
    paired, lone = conjugates_paired(sig, 1e-6, rel=False)
    if len(sig) != CUBE_NEV or not (sig.real < 0).all() or not res.max() <= 1e-8 or paired < 2:
        raise RuntimeError(f"{what}: test_cavity3d.py's gates: {len(sig)} pairs ({CUBE_NEV}), "
                           f"sigma {sig} (every real part < 0), residuals {res} (<= 1e-8), "
                           f"{paired} complex modes paired with their conjugates (>= 2)")
    op = es.operator
    kernels += band_kernels([(f", {size} eigen (phase 10)", op.device_op.blu)], errs, dev,
                            plain_reps=1)
    kernels += spmv_timed(op.device_op.Cop, A, M, dev, f", {size} (phase 10)")
    del es, op
    out = dict(stages=stages, kernels=kernels, sigma=sig, dofs=ctx.spaces.num_dofs, B=rk["B"],
               launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


def spmv_timed(cop, A, M, dev, label: str, modes: tuple = ("real", "shifted", "mass")) -> list:
    """S in its main-path modes (real: J's pattern and values class, here
    A; shifted (A - sigma M); mass; shifted_real: (A - sigma M) x on an
    f64 x at the operator's real sigma) in the original order on a shifted
    operator's storage: held against the plain version, timed with L2
    evicted beside cuSPARSE, bounded by its bytes.  Returns kernels-line
    entries (launches filled in from ``_key``)."""
    s_real = cop.sigma.real
    cases = {k: v for k, v in spmv_cases(cop, dev, s_real=s_real).items()
             if k[1] == "original" and k[0] in modes}
    errs = check_spmv(cases, f"on (A, M){label}")
    libs = spmv_library(A, M, cop.sigma, dev, s_real=s_real)
    ntiles = cop.plan.tile_row.size - 1
    out = []
    names = {"real": "real J x (J's pattern)", "shifted": "shifted", "mass": "mass",
             "shifted_real": "shifted, f64 x at the real shift"}
    lines = {"real": "lsafw_tpu/ops/bcsr.py:446", "shifted": "lsafw_tpu/ops/bcsr.py:638",
             "mass": "lsafw_tpu/ops/bcsr.py:646", "shifted_real": "lsafw_tpu/ops/bcsr.py:638"}
    for (mode, order), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(*spmv_work(mode, order, cop.plan.n, cop.plan.nnz, ntiles),
                                   FP64_FLOPS_PER_S)
        e = dict(name=f"csr_tiled_spmv_kernel (S), {names[mode]}, {order} order{label}",
                 route="cuda", source="lsafw_tpu_torch/csrc/spmv_gather.cu", replaces=lines[mode],
                 launches=0, _key=S_KEYS[mode] + ".original", max_abs_err=errs[(mode, order)],
                 ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=cold_ms(libs[mode]))
        log(f"{label.strip(', ')}: S {mode}: {e['ms']:.4f} ms cold, bound {bound_ms:.4f} ms "
            f"({100 * bound_ms / e['ms']:.1f}%), cuSPARSE {e['library_ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms; {cop.plan.nnz} nonzeros in {ntiles} tiles "
            f"({cop.plan.n / ntiles:.1f} rows a tile)")
        out.append(e)
    return out


def cylinder_diagnostics(case, w) -> dict:
    """Phase 10b, on the 43k cylinder's Re = 40 baseflow of phase 7:
    test_cylinder_stability.py's recirculation length and drag coefficient
    C_d = 2 F_x (the traction integral on the card)."""
    from lsafw_tpu_torch.solver.baseflow import compute_drag, compute_recirculation_length

    t0 = time.time()
    L = compute_recirculation_length(case["ctx"], w)
    cd = 2.0 * compute_drag(case["ctx"], case["mesh"], w, re=NONMODAL_RE,
                            cylinder_marker=CYL_MARKER)
    log(f"phase 10b: the 43k cylinder at Re = {NONMODAL_RE:g} (phase 7's baseflow): L_r = "
        f"{L:.6f} (1.5, 4.0), C_d = {cd:.6f} (1.2, 2.0); {time.time() - t0:.2f} s")
    if not (1.5 < L < 4.0 and 1.2 < cd < 2.0):
        raise RuntimeError(f"phase 10b: L_r {L} not in (1.5, 4.0) or C_d {cd} not in (1.2, 2.0)")
    return dict(L=L, cd=cd)


def step_case(device) -> dict:
    """test_step_spectrum.py's backward-facing step (``STEP_GEOMETRY``):
    walls no-slip, the outlet's pressure 0, the parabolic inlet profile
    4 y (1 - y) on the upper channel; perturbation BCs on walls and inlet."""
    import torch
    from lsafw_tpu_torch.config import BoundaryConditionsConfig as C, StepFlowGeometryConfig
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import step_flow_mesh
    from lsafw_tpu_torch.meshing.tags import facets_with_marker, mark_boundary_facets

    t0 = time.time()
    g = STEP_GEOMETRY
    mesh = step_flow_mesh(StepFlowGeometryConfig(**g), max_iter=100)
    t_mesh = time.time() - t0

    def marker(x):
        out = np.full(x.shape[0], STEP_WALL, dtype=np.int32)
        out[np.isclose(x[:, 0], -g["inlet_length"])] = STEP_INLET
        out[np.isclose(x[:, 0], g["outlet_length"])] = STEP_OUTLET
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    bcs_base = define_bcs(mesh, spaces, [
        C(marker=STEP_WALL, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=STEP_OUTLET, type="dirichlet_pressure", value=0.0)])
    dofs = spaces.velocity.dofs_on_facets(facets_with_marker(mesh, STEP_INLET))
    y = spaces.velocity.dof_coords[dofs][:, 1]
    bcs_base.dirichlet_mask[dofs] = True
    bcs_base.dirichlet_values[dofs] = np.where(dofs % 2 == 0,
                                               np.clip(4.0 * y * (1.0 - y), 0.0, None), 0.0)
    bcs_pert = define_bcs(mesh, spaces, [
        C(marker=STEP_WALL, type="dirichlet_velocity", value=(0.0, 0.0)),
        C(marker=STEP_INLET, type="dirichlet_velocity", value=(0.0, 0.0))])
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs_base=bcs_base, bcs_pert=bcs_pert, ctx=ctx,
                mesh_seconds=t_mesh, seconds=time.time() - t0)


def step_path(dev) -> dict:
    """Phase 10b: test_step_spectrum.py on the card: the Re = 150 ramped
    banded baseflow (4 steps, tol 1e-9, max_it 40), its recirculation
    length in (1, 12), and STEP_NEV pairs nearest 0 at ncv STEP_NCV (the
    Krylov-Schur restarts the test exists to force): every sigma_r < 0,
    conjugates within 1e-4 max(1, |sigma|), residuals <= 1e-6."""
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver, compute_recirculation_length

    what = "phase 10b"
    t_phase = time.time()
    case = step_case(dev)
    ctx = case["ctx"]
    rk = reckon_band(ctx.pattern, ctx.spaces.num_dofs)
    log(f"{what}: backward-facing step (test_step_spectrum.py): {case['mesh'].num_cells} "
        f"triangles, mesh {case['mesh_seconds']:.2f} s, case {case['seconds']:.2f} s (host)")
    log_reckoning(what, rk, ctx.pattern.nnz, ctx.spaces.num_dofs)
    stages: dict = {}
    with plain_loops_forbidden():
        with stage("baseflow", stages):
            solver = BaseFlowSolver(ctx, case["mesh"], case["bcs_base"], re=STEP_RE)
            w = solver.solve(ramp=True, steps=4, tol=1e-9, max_it=40, linear_solver="banded")
        log_stage(f"{what}: baseflow", stages["baseflow"])
        gate_baseflow(f"{what} baseflow", solver, stages["baseflow"])
        L = compute_recirculation_length(ctx, w)
        log(f"{what}: recirculation length {L:.6f} (1, 12)")
        if not 1.0 < L < 12.0:
            raise RuntimeError(f"{what}: recirculation length {L} not in (1, 12)")
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, ctx, STEP_RE, case["bcs_pert"],
                                                   case["mesh"]).assemble_eigensystem()
        with stage("eigen", stages):
            sig, res, es = eigen_stage(A, M, STEP_NEV, STEP_NCV, 0.0)
    eig = stages["eigen"]
    log_stage(f"{what}: eigen", eig)
    log_eigen(f"{what}: eigen", sig, res, es)
    gate_eigen_stage(f"{what} eigen", eig, REAL_CLASSES)
    lone = lone_conjugates(what, sig, es.vectors, A, M, 0.0, 1e-6)
    if len(sig) != STEP_NEV or not (sig.real < 0).all() or lone or not res.max() <= 1e-6:
        raise RuntimeError(f"{what}: test_step_spectrum.py's gates: {len(sig)} pairs "
                           f"({STEP_NEV}), sigma {sig} (every real part < 0), without their "
                           f"conjugates {lone}, largest residual {res.max():.2e} (<= 1e-6)")
    out = dict(stages=stages, sigma=sig, L=L, restarts=es.result.restarts,
               launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all")
    return out


def step3d_path(dev, errs: dict) -> dict:
    """Phase 10c: the 3D step from ``config_files/3D/step/*.toml``
    (``step_flow_mesh`` with dim = 3: distmesh3d on the host): the Re = 50
    banded baseflow (ramped, 3 steps, tol 1e-9), a recirculation behind
    the step, STEP3D_NEV pairs nearest 0 on the default factor (a real
    pivoted one at this real shift: residuals <= 1e-8, conjugates as phase
    10b) and again pivot-free (``LSAFW_PIVOT_MEM_GB=0``), each a stage: the
    pivot-free factor either refused by its calibration (FactorUnusable,
    no band solve of another factor) or its sigma within 1e-8 of the
    default's; then K1/K2 on the eigen factor and on the last Newton
    factor, and S on (A, M)."""
    import torch
    from lsafw_tpu_torch.config import load_bc_config, load_facet_config
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import decoupled_pressure_dofs, define_bcs, pin_dofs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver, compute_recirculation_length
    from lsafw_tpu_torch.solver.eigen import FactorUnusable

    what = "phase 10c"
    t_phase = time.time()
    cfg = STEP3D_CONFIG
    mesh, t_mesh = host_mesh("step3d")
    t_wait = time.time() - t_phase
    mark_boundary_facets(mesh, load_facet_config(cfg / "facets.toml"))
    spaces = define_spaces(mesh)
    bcs = define_bcs(mesh, spaces, load_bc_config(cfg / "bcs.toml"))
    ctx = AssemblyContext.build(spaces, device=dev)
    free_p = decoupled_pressure_dofs(spaces, bcs)
    pin_dofs(bcs, free_p)
    bcs_pert = bcs.homogeneous()
    torch.cuda.synchronize()
    t_case = time.time() - t_phase
    rk = reckon_band(ctx.pattern, spaces.num_dofs)
    log(f"{what}: 3D step from {'/'.join(cfg.parts[-3:])}/*.toml: "
        f"{mesh.num_vertices} vertices, {mesh.num_cells} tetrahedra; mesh (distmesh3d) "
        f"{t_mesh:.2f} s in the mesh worker (waited for {t_wait:.2f} s), case {t_case:.2f} s "
        f"(host)")
    log_reckoning(what, rk, ctx.pattern.nnz, spaces.num_dofs)
    log(f"{what}: {free_p.size} decoupled pressure DOFs pinned (rows and columns zero after the "
        f"Dirichlet elimination): {free_p.tolist()} at "
        f"{spaces.pressure.node_coords[free_p - spaces.num_velocity_dofs].tolist()}")
    stages: dict = {}
    with plain_loops_forbidden(), last_newton_factor() as last:
        with stage("baseflow", stages):
            solver = BaseFlowSolver(ctx, mesh, bcs, re=STEP3D_RE)
            w = solver.solve(ramp=True, steps=3, tol=1e-9, linear_solver="banded")
    log_stage(f"{what}: baseflow", stages["baseflow"])
    gate_baseflow(f"{what} baseflow", solver, stages["baseflow"])
    L = compute_recirculation_length(ctx, w)
    log(f"{what}: recirculation length {L:.6f} (> 0: behind the step)")
    if not L > 0.0:
        raise RuntimeError(f"{what}: no recirculation behind the step (L = {L})")
    kernels = band_kernels([(", 3D step Newton (phase 10c)", last.pop("factor"))], errs, dev,
                           only=("f32x1",))
    with plain_loops_forbidden():
        with stage("assemble", stages):
            A, M = LinearizedNavierStokesAssembler(w, ctx, STEP3D_RE, bcs_pert,
                                                   mesh).assemble_eigensystem()
        with stage("eigen", stages):
            sig, res, es = eigen_stage(A, M, STEP3D_NEV, STEP3D_NCV, 0.0)
        # the pivot-free factor of the same pencil: at sigma = 0 a real
        # factor of A with the saddle regularization; its calibration may
        # refuse it (FactorUnusable, no fallback), else its sigma is held
        # to the default factor's
        refused = None
        with env(LSAFW_PIVOT_MEM_GB="0"), stage("eigen pivot-free", stages):
            try:
                sig_pf, res_pf, es_pf = eigen_stage(A, M, STEP3D_NEV, STEP3D_NCV, 0.0)
            except FactorUnusable as e:
                refused = str(e)
    st = stages["eigen"]
    log_stage(f"{what}: eigen", st)
    log_eigen(f"{what}: eigen", sig, res, es)
    cls = gate_eigen_stage(f"{what} eigen", st, REAL_CLASSES)
    lone = lone_conjugates(what, sig, es.vectors, A, M, 0.0, 1e-8)
    if cls != "RealPivotedBandedLU" or len(sig) != STEP3D_NEV or lone or not res.max() <= 1e-8:
        raise RuntimeError(f"{what} eigen: {cls} factor, {len(sig)} pairs ({STEP3D_NEV}), "
                           f"without their conjugates {lone}, largest residual {res.max():.2e} "
                           f"(<= 1e-8)")
    pf = stages["eigen pivot-free"]
    log_stage(f"{what}: eigen pivot-free", pf)
    if refused is not None:
        log(f"{what}: the pivot-free factor refused, as the calibration must refuse it: {refused}")
        if pf["solves"].get("RealPivotedBandedLU") or pf["launches"]["K1.pivoted.f32x2"]:
            raise RuntimeError(f"{what}: a pivoted factor ran in the pivot-free stage: {pf}")
    else:
        log_eigen(f"{what}: eigen pivot-free", sig_pf, res_pf, es_pf)
        cls_pf = gate_eigen_stage(f"{what} eigen pivot-free", pf, REAL_CLASSES)
        gap = max(float(np.abs(sig_pf - z).min()) for z in sig)
        log(f"{what}: the pivot-free factor's sigma within {gap:.2e} of the default factor's")
        if cls_pf != "RealBandedLU" or not gap <= 1e-8 or not res_pf.max() <= 1e-8:
            raise RuntimeError(f"{what}: pivot-free {cls_pf}, sigma gap {gap:.2e} (<= 1e-8), "
                               f"residual {res_pf.max():.2e}")
        del es_pf
    op = es.operator
    kernels += band_kernels([(", 3D step eigen (phase 10c)", op.device_op.blu)], errs, dev)
    kernels += spmv_timed(op.device_op.Cop, A, M, dev, ", 3D step (phase 10c)")
    out = dict(stages=stages, kernels=kernels, sigma=sig, L=L, dofs=spaces.num_dofs, B=rk["B"],
               mesh_seconds=t_mesh, refused=refused,
               launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all ({t_wait:.1f} s of it waiting for the host mesh)")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the self-consistent model, harmonic balance and Hill's method
# ---------------------------------------------------------------------------

SCM_RE = 60.0  # examples/scm_limit_cycle.py, examples/scm_hb2.py
SCM_CONFIG = Path(__file__).resolve().parent / "config_files" / "2D" / "cylinder"
SCM_DOFS = 11323  # doc/scm_re60_small.json, doc/scm_hb2_re60.json, doc/floquet_re60_small.json
SCM_SIGMA0 = 0.04029458801579838 + 0.7696851273858805j  # doc/scm_re60_small.json history[0]
SCM_A = 2.914231806515781  # doc/scm_re60_small.json
SCM_DNS = 0.8528907621933606  # doc/shedding_re60_small.json, as scm_re60_small.json cites it
HB1_REC = (2.897778977214202, 0.8559647533486048)  # doc/scm_hb2_re60.json: A, omega
HB2_REC = (2.8991342152443913, 0.8631488748270492, 0.5263010887028963)  # A, omega, A2
HB2_DNS = 0.8622250948215022  # doc/scm_hb2_re60.json's dns_omega
FLOQUET_MU = 0.8020084141670835  # doc/floquet_re60_small.json: the leading non-trivial |mu|
HILL_BLOCKS, HILL_NUM = 3, 12  # examples/scm_hb2.py --hill
SCM_CLASSES = {"Newton": ("RealPivotedBandedLU",), "bordered": ("RealPivotedBandedLU",),
               "eigen": COMPLEX_CLASSES, "q2": COMPLEX_CLASSES}


def scm_case(device, mesh=None) -> dict:
    """The examples' 11k cylinder: ``geometry_small.toml`` (or its ``mesh``
    made already), ``facets_small.toml``, ``bcs.toml`` and
    ``bcs_perturbation.toml`` of ``config_files/2D/cylinder``."""
    import torch
    from lsafw_tpu_torch.config import (load_bc_config, load_cylinder_flow_config,
                                        load_facet_config)
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.geometries import cylinder_flow_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets

    t0 = time.time()
    if mesh is None:
        mesh = cylinder_flow_mesh(load_cylinder_flow_config(SCM_CONFIG / "geometry_small.toml"))
    mark_boundary_facets(mesh, load_facet_config(SCM_CONFIG / "facets_small.toml"))
    spaces = define_spaces(mesh)
    bcs = define_bcs(mesh, spaces, load_bc_config(SCM_CONFIG / "bcs.toml"))
    bcs_pert = define_bcs(mesh, spaces, load_bc_config(SCM_CONFIG / "bcs_perturbation.toml"))
    ctx = AssemblyContext.build(spaces, device=device)
    torch.cuda.synchronize()
    return dict(mesh=mesh, spaces=spaces, bcs=bcs, bcs_pert=bcs_pert, ctx=ctx,
                seconds=time.time() - t0)


@contextmanager
def attr(obj, name: str, value):
    """``obj.<name>`` set to ``value`` while the block runs."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def scm_path(dev, errs: dict) -> dict:
    """Phase 11: ``examples/scm_limit_cycle.py`` then ``examples/scm_hb2.py
    --hill`` on the examples' 11k cylinder at Re = 60 (full width): 11a the
    ramped banded baseflow and ``SelfConsistentModel.solve(w, A0=0.1,
    tol_sigma=2e-4)``, every mean Newton and eigensolve a stage; 11b HB1
    and 11c HB2 (``solve_coupled``), every bordered solve and HB2's q2 seed
    a stage; 11d ``hill_floquet`` (n_blocks 3, num 12) on HB2's cycle, a
    stage, and its pairs held in the reference's complex pencil built on
    the host; then the repair
    of the silent refinement miss: the pivot-free factor of an 11k (A, M)
    with its refinement cap forced to 1 must raise ``FactorUnusable`` from
    the eigensolve; then K1/K2 and S on the phase's factors and matrices.
    Gates: the record's DOF count, the launch gates of ``gate_class`` in
    each stage's factor class (no plan built beyond each pattern's first),
    and the records' values (``tests/benchmark/test_scm.py``,
    ``doc/scm_re60_small.json``, ``doc/scm_hb2_re60.json``)."""
    import torch
    from lsafw_tpu_torch import hill, scm
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
    from lsafw_tpu_torch.ops.sparse import spmv
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.eigen import (EigenSolver, EigensolverConfig, FactorUnusable,
                                              ShiftInvertOperator, STType)

    what = "phase 11"
    t_phase = time.time()
    case = scm_case(dev)
    ctx, mesh, bcs, bcs_pert = case["ctx"], case["mesh"], case["bcs"], case["bcs_pert"]
    n = case["spaces"].num_dofs
    log(f"{what}: the examples' cylinder from {'/'.join(SCM_CONFIG.parts[-3:])}/"
        f"{{geometry,facets}}_small.toml, bcs.toml, bcs_perturbation.toml: {n} DOFs (the "
        f"records' {SCM_DOFS}); case {case['seconds']:.2f} s (host)")
    if n != SCM_DOFS:
        raise RuntimeError(f"{what}: {n} DOFs, the records were made at {SCM_DOFS}")
    model = scm.SelfConsistentModel(ctx, mesh, bcs, bcs_pert, SCM_RE, device=dev)
    for name, pat in (("the cylinder", ctx.pattern), ("HB1's K0", model._block(1).pattern),
                      ("HB2's K0", model._block(2).pattern)):
        log_reckoning(f"{what}: {name}", reckon_band(pat, pat.shape[0]), pat.nnz, pat.shape[0])
    stages: dict = {}
    figures: dict = {}
    cur = {"phase": "11a", "n": 0}
    kept: dict = {}
    saved = {k: getattr(scm, k) for k in ("NewtonSolver", "EigenSolver", "_forced_solve",
                                          "factor_auto")}

    def named(kind: str) -> str:
        cur["n"] += 1
        return f"{cur['phase']} {kind} {cur['n']}"

    class Newton(saved["NewtonSolver"]):
        def solve(self, w0, re, **kw):
            with stage(named("Newton"), stages):
                return super().solve(w0, re, **kw)

    class Eigen(saved["EigenSolver"]):
        def solve(self):
            name = named("eigen")
            with stage(name, stages):
                out = super().solve()
            figures[name] = self.operator.figures()
            return out

    def forced_solve(*args, **kw):
        with stage(named("q2 seed"), stages):
            return saved["_forced_solve"](*args, **kw)

    def factor_kept(*args, **kw):  # K0's factor, kept for the kernel times (the last one alone)
        kept.pop(cur["phase"], None)
        out = saved["factor_auto"](*args, **kw)
        kept[cur["phase"]] = out[0]
        return out

    bordered = model._bordered_solve

    def bordered_staged(K0, c, r, F):
        kept[cur["phase"] + " K0"] = K0  # the last K0, for S's times
        with stage(named("bordered"), stages):
            return bordered(K0, c, r, F)

    model._bordered_solve = bordered_staged
    for k, v in (("NewtonSolver", Newton), ("EigenSolver", Eigen), ("_forced_solve", forced_solve),
                 ("factor_auto", factor_kept)):
        setattr(scm, k, v)
    t = {}
    try:
        with plain_loops_forbidden():
            with stage("11a baseflow", stages):
                solver = BaseFlowSolver(ctx, mesh, bcs, re=SCM_RE)
                w = solver.solve(ramp=True, steps=4, tol=1e-10, max_it=40, linear_solver="banded")
            gate_baseflow(f"{what} 11a baseflow", solver, stages["11a baseflow"])
            t0 = time.time()
            res = model.solve(np.asarray(w), A0=0.1, tol_sigma=2e-4)
            t["11a"] = time.time() - t0
            cur.update(phase="11b", n=0)
            A0 = res.amplitude_sl or res.amplitude
            t0 = time.time()
            hb1 = model.solve_coupled(res.mean, A0 * res.mode, abs(res.sigma.imag))
            t["11b"] = time.time() - t0
            stats_hb1 = dict(model.stats, gcr_its=list(model.stats["gcr_its"]))
            cur.update(phase="11c", n=0)
            t0 = time.time()
            hb2 = model.solve_coupled(hb1.mean, hb1.amplitude * hb1.mode, hb1.sigma.imag,
                                      harmonics=2)
            t["11c"] = time.time() - t0
    finally:
        for k, v in saved.items():
            setattr(scm, k, v)
        model._bordered_solve = bordered
    # every stage in its factor class's mode; the first of each kind may plan
    # (a real and a complex band of the cylinder's pattern, each K0's band)
    planned: set = set()
    per_kind: dict = {}
    for name, st in stages.items():
        if name == "11a baseflow" or not st["solves"]:  # a Newton already converged solves nothing
            continue
        ph, kind = name.split(" ")[:2]
        key = (ph if kind == "bordered" else "", "q2" if kind == "q2" else kind)
        builds = int(key not in planned and kind in ("eigen", "bordered"))
        planned.add(key)
        cls = gate_class(f"{what} {name}", st, SCM_CLASSES[key[1]], builds)
        agg = per_kind.setdefault((ph, kind), dict(n=0, seconds=0.0, solves=0, peak=0.0,
                                                   classes=set()))
        agg["n"] += 1
        agg["seconds"] += st["seconds"]
        agg["solves"] += sum(st["solves"].values())
        agg["peak"] = max(agg["peak"], st["peak_gb"] - st["resident_gb"])
        agg["classes"].add(cls)
    for (ph, kind), a in per_kind.items():
        log(f"{what}: {ph} {a['n']} {kind} stages, {a['seconds']:.2f} s, {a['solves']} band "
            f"solves, factor classes {sorted(a['classes'])}, peak {a['peak']:.3f} GB above a "
            f"stage's start")
    slow = sorted(((st["seconds"], name) for name, st in stages.items()), reverse=True)[:6]
    log(f"{what}: the slowest stages: " + ", ".join(f"{n} {sec:.2f} s" for sec, n in slow))
    eig = [figures[k] for k in figures if k.startswith("11a eigen")]
    log(f"{what} 11a: {len(eig)} eigensolves, factors {sum(f['factor_s'] for f in eig):.2f} s, "
        f"contraction max {max(f['rho'] for f in eig):.2e}, applies "
        f"{sum(f['applies'] for f in eig)}, pivoted {sorted({f['pivoted'] for f in eig})}")
    hist = res.history
    omega = abs(res.sigma.imag)
    s0 = complex(hist[0][1], hist[0][2])
    log(f"{what} 11a: the alternation {t['11a']:.1f} s, {len(hist) - 1} outer iterations (record "
        f"19): history[0] sigma = {s0.real:+.6f}{s0.imag:+.6f}j (record "
        f"{SCM_SIGMA0.real:+.6f}{SCM_SIGMA0.imag:+.6f}j), converged {res.converged}, A = "
        f"{res.amplitude:.6f} (record {SCM_A:.6f}, {100 * abs(res.amplitude / SCM_A - 1):.2f}% "
        f"off), sigma = {res.sigma.real:+.3e}{res.sigma.imag:+.6f}j, A_SL {res.amplitude_sl}; "
        f"omega {omega:.6f} against the DNS {SCM_DNS:.6f}: {100 * abs(omega / SCM_DNS - 1):.3f}% "
        f"(record 0.37%)")
    checks = [
        (s0.real > 5e-3, f"history[0] sigma_r {s0.real:.3e} <= 5e-3"),
        (res.converged and abs(res.sigma.real) <= 2e-3,
         f"converged {res.converged}, |sigma_r| {abs(res.sigma.real):.2e}"),
        (1.005 * s0.imag < omega < 1.3 * s0.imag, f"omega {omega} outside (1.005, 1.3) x "
                                                  f"omega_Hopf {s0.imag}"),
        (abs(omega / SCM_DNS - 1) <= 0.01, f"omega {omega} over 1% from the DNS {SCM_DNS}"),
        (abs(res.amplitude / SCM_A - 1) <= 0.05, f"A {res.amplitude} over 5% from {SCM_A}"),
    ]
    M = model._Mmat
    q2 = torch.as_tensor(hb2.q2, device=dev)
    a2 = float(torch.sqrt(torch.vdot(q2, spmv(M, q2)).real))
    for name, r, rec, secs in (("11b HB1", hb1, HB1_REC, t["11b"]),
                               ("11c HB2", hb2, HB2_REC, t["11c"])):
        its = [st_ for st_ in stages if st_.startswith(name[:3] + " bordered")]
        log(f"{what} {name}: {secs:.1f} s, {len(r.history)} Newton iterations, converged "
            f"{r.converged}: A = {r.amplitude:.8f} (record {rec[0]:.8f}, rel "
            f"{abs(r.amplitude / rec[0] - 1):.1e}), omega = {r.sigma.imag:.8f} (record "
            f"{rec[1]:.8f}, rel {abs(r.sigma.imag / rec[1] - 1):.1e})"
            + (f", A2 = {a2:.8f} (record {rec[2]:.8f}, rel {abs(a2 / rec[2] - 1):.1e}); omega "
               f"against the DNS {HB2_DNS:.6f}: {100 * abs(r.sigma.imag / HB2_DNS - 1):.3f}% "
               f"(record 0.107%)" if len(rec) == 3 else "")
            + f"; {len(its)} bordered solves")
        checks += [(r.converged, f"{name} did not converge"),
                   (abs(r.amplitude / rec[0] - 1) <= 1e-4, f"{name} A {r.amplitude} vs {rec[0]}"),
                   (abs(r.sigma.imag / rec[1] - 1) <= 1e-4,
                    f"{name} omega {r.sigma.imag} vs {rec[1]}")]
    checks += [(abs(a2 / HB2_REC[2] - 1) <= 1e-4, f"11c A2 {a2} vs {HB2_REC[2]}"),
               (abs(hb2.sigma.imag / HB2_DNS - 1) <= 5e-3,
                f"11c omega {hb2.sigma.imag} over 0.5% from the DNS {HB2_DNS}")]
    gcr1, gcr = stats_hb1["gcr_its"], model.stats["gcr_its"]
    log(f"{what} 11b/11c: GCR iterations per bordered solve HB1 {gcr1}, HB2 {gcr[len(gcr1):]}; "
        f"K0 values formed on the device in {model.stats['form_s']:.3f} s, K0 factors "
        f"{model.stats['factor_s']:.3f} s, GCR {model.stats['solve_s']:.3f} s")
    for ok, msg in checks:
        if not ok:
            raise RuntimeError(f"{what}: {msg}")

    # 11d: Hill's method on HB2's cycle
    mask = np.asarray(bcs.dirichlet_mask, bool)
    A, Mb = LinearizedNavierStokesAssembler(hb2.mean, ctx, SCM_RE, bcs,
                                            mesh).assemble_eigensystem()
    harmonics = [hb2.amplitude * hb2.mode, hb2.q2]
    om = hb2.sigma.imag
    hill_es: list = []

    class HillEigen(EigenSolver):
        def solve(self):
            hill_es.append(self)
            self.pairs = super().solve()
            return self.pairs

    with plain_loops_forbidden(), attr(hill, "EigenSolver", HillEigen), stage("11d Hill", stages):
        hl = hill.hill_floquet(ctx, A, Mb, harmonics, om, n_blocks=HILL_BLOCKS, num=HILL_NUM,
                               bc_mask=mask, device=dev)
    es = hill_es[-1]
    Hp, Bp = es.A, es.M
    log_reckoning(f"{what} 11d: the Hill pair", reckon_band(Hp.pattern, Hp.shape[0]),
                  Hp.pattern.nnz, Hp.shape[0])
    st = stages["11d Hill"]
    stage_line(f"{what}: 11d Hill", st, es.operator.figures())
    log(f"{what} 11d: Krylov-Schur {es.result.restarts} cycles, {es.result.iterations} applies, "
        f"{es.result.nconv} converged; factor {type(es.operator.device_op.blu).__name__}, "
        f"refinement cap {es.operator.refine_its}; {st['seconds']:.2f} s with the pair's "
        f"assembly on the card")
    gate_eigen_stage(f"{what} 11d Hill", st, COMPLEX_CLASSES, builds=1)
    ex = hl.exponents
    triv = int(np.argmin(np.abs(ex)))
    rest = np.delete(ex, triv)
    lead = rest[np.argsort(-rest.real)]
    mu = np.exp(lead * 2 * np.pi / om)
    log(f"{what} 11d: {len(hl.raw)} raw eigenvalues, {len(ex)} principal exponents "
        f"{[f'{z.real:+.8f}{z.imag:+.8f}j' for z in sorted(ex, key=lambda z: -z.real)]}; trivial "
        f"|lambda| = {abs(ex[triv]):.2e} (<= {1e-2 * om:.2e}); the leading non-trivial |mu| = "
        f"{abs(mu[0]):.6f} beside the DNS monodromy's {FLOQUET_MU:.4f} "
        f"(doc/floquet_re60_small.json; not gated)")
    if not abs(ex[triv]) <= 1e-2 * om or not (rest.real < 0).all():
        raise RuntimeError(f"{what} 11d: trivial |lambda| {abs(ex[triv]):.2e} (<= {1e-2 * om:.2e}) "
                           f"or a non-trivial exponent with Re >= 0: {rest}")
    # on the host: the card's pairs held in the reference's own complex pencil
    # (H, B), built as the reference builds it.  (scipy's eigs of that
    # pencil needs SuperLU of a 79,261-row complex matrix: over 4 minutes at
    # n_blocks = 2 on a CPU sandbox, and 36.9 s at n_blocks = 1 on the card
    # machine's host, a third of the phase's budget; the CPU parity test
    # holds the method to the reference's eigs.)
    t0 = time.time()
    H, B = hill._host_hill(ctx, A, Mb, harmonics, om, HILL_BLOCKS, mask)
    z = np.stack([p[1] for p in es.pairs], axis=1)
    W = hill._to_harmonics(z, HILL_BLOCKS, n)
    lam = np.array([p[0] for p in es.pairs])
    resid = np.linalg.norm(H @ W - (B @ W) * lam, axis=0) / np.linalg.norm(W, axis=0)
    worst = float((resid / (np.abs(lam) + 1.0)).max())
    log(f"{what} 11d: the card's {len(lam)} Hill pairs in the reference's complex pencil "
        f"({H.shape[0]} rows, {H.nnz} nonzeros, built on the host): true residual "
        f"{worst:.2e} relative to |lambda| + 1 (1e-8); {time.time() - t0:.1f} s")
    if not worst <= 1e-8:
        raise RuntimeError(f"{what} 11d: residual {worst:.2e} in the reference's pencil")
    del H, B, W

    # the repair: a refinement that misses raises (the 11k pivot-free factor,
    # its refinement cap forced to 1 GCR iteration, needs about 8)
    Ar, Mr = LinearizedNavierStokesAssembler(w, ctx, SCM_RE, bcs_pert, mesh).assemble_eigensystem()
    refused = None
    t0 = time.time()
    with env(LSAFW_PIVOT_MEM_GB="0"), attr(ShiftInvertOperator, "_CAP", 1), \
            plain_loops_forbidden():
        rep = EigenSolver(Ar, Mr, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
        rep.set_st_type(STType.SINVERT)
        rep.set_target(SCM_SIGMA0)
        try:
            rep.solve()
        except FactorUnusable as e:
            refused = str(e)
    outcome = "returned pairs" if refused is None else f"raised FactorUnusable: {refused}"
    log(f"{what}: the repair, on the 11k baseflow's pivot-free factor with the refinement cap "
        f"forced to 1 ({time.time() - t0:.2f} s): {outcome}")
    if refused is None:
        raise RuntimeError(f"{what}: an eigensolve whose refinement misses returned its pairs")
    del rep, Ar, Mr

    # K1/K2 and S on the phase's factors and matrices
    hill_blu, cop = es.operator.device_op.blu, es.operator.device_op.Cop
    kernels = band_kernels([(", HB1 K0 (phase 11b)", kept["11b"]),
                            (", HB2 K0 (phase 11c)", kept["11c"])], errs, dev, only=("f32x1",),
                           plain_reps=1)
    kernels += band_kernels([(", the Hill pair (phase 11d)", hill_blu)], errs, dev, plain_reps=1)
    K0 = kept["11c K0"]
    kernels += spmv_timed(BCSRShiftedOp.from_csr(K0, K0, 0.0), K0, K0, dev,
                          ", HB2's K0 (phase 11c)", modes=("real",))
    kernels += spmv_timed(cop, Hp, Bp, dev, ", the Hill pair (phase 11d)",
                          modes=("shifted", "mass"))
    out = dict(stages=stages, kernels=kernels, res=res, hb1=hb1, hb2=hb2, hill=hl,
               launches={k: sum(s_["launches"][k] for s_ in stages.values()) for k in counts()})
    out["seconds"] = time.time() - t_phase
    log(f"{what}: {out['seconds']:.1f} s in all (budget 120 s; the kernel checks and times "
        f"included)")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the Krylov and preconditioner menu, the other spectral transforms
# ---------------------------------------------------------------------------


NONSYM_KSPS = ("gmres", "fgmres", "lgmres", "gcr", "bicg", "bcgs", "cgs", "lsqr")
NONSYM_PCS = ("ilu", "bjacobi")
NONSYM_MAXITER = 1000
SPD_PCS = ("none", "jacobi", "bjacobi", "sor", "ilu", "icc", "gamg", "pmg")
MEMBRANE_NX = (120, 240)  # bench.py:132's 240 x 240 P2 membrane (231,361 DOFs) and its half
SPD_MAXITER = 20000
ILU8_MAXITER = 2000  # the logged CG + ILU(0) at 8 sweeps: about 3x what the converged factor needs
KSP_TOL = 1e-10
MEMBRANE_32 = ((2.0, 4.0), 32)  # tests/benchmark/test_vibrating_membrane.py: 32 x 32 P2 on 2 x 4


def synced(fn):
    """(fn(), seconds), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def true_residual(mv, b, x) -> float:
    import torch

    return float(torch.linalg.vector_norm(b - mv(x)) / torch.linalg.vector_norm(b))


def converged_sweeps(plan, A) -> tuple[int, float]:
    """The Chow-Patel sweep count, doubled from the reference's 8, at which
    one more sweep changes the ILU(0) values by under 1e-10 (relative), and
    that change."""
    import torch
    from lsafw_tpu_torch.solver import ilu as tilu

    sweeps, change = 8, 1.0
    while change > 1e-10 and sweeps < 512:
        sweeps *= 2
        v1 = tilu.ilu0_factor_values(plan, A.data, sweeps=sweeps)
        v2 = tilu.ilu0_factor_values(plan, A.data, sweeps=sweeps + 1)
        change = float(torch.linalg.vector_norm(v2 - v1) / torch.linalg.vector_norm(v2))
    return sweeps, change


def gmres_si_path(mp: dict, stages: dict) -> None:
    """12a: the inexact shift-invert on phase 3's (A, M) at 0.74j, first
    ``set_st_pc_type("gmres")``, then STPRECOND: GMRES(40) on complex128
    vectors preconditioned by the pivoted complex64 band factor of C.
    Gates: sigma within 1e-8 of phase 3's, residual 1e-8, no host LU (it
    raises), one K1 / K2 pivoted c64 launch per preconditioner apply (one
    band solve per GMRES step, per cycle and per solve's M b: counted
    against the operator's GMRES figures), G's permutes and S per matvec
    as in phase 3."""
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)

    A, M = mp["A"], mp["M"]
    for route in ("gmres", "precond"):
        name = f"12a {route}"
        with stage(name, stages):
            es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
            if route == "gmres":
                es.set_st_type(STType.SINVERT)
                es.set_st_pc_type("gmres")
            else:
                es.set_st_type(STType.PRECOND)
            es.set_target(TARGET)
            pairs = es.solve()
        st, op = stages[name], es.operator
        f = op.figures()
        sigma, resid = pairs[0][0], float(eigen_residuals(A, M, pairs)[0])
        applies = f["gmres_its"] + f["gmres_cycles"] + f["gmres_solves"]
        log(f"phase 12a: {route}: sigma = {sigma.real:+.12f}{sigma.imag:+.12f}j (phase 3: "
            f"{abs(sigma - mp['sigma']):.1e} away), residual {resid:.2e}; {st['seconds']:.2f} s "
            f"(factor {f['factor_s']:.2f} s, pivoted {f['pivoted']}); {f['applies']} shift-invert "
            f"applies, GMRES {f['gmres_its']} steps in {f['gmres_cycles']} cycles: "
            f"{f['gmres_its'] / max(f['gmres_solves'], 1):.2f} steps and "
            f"{f['gmres_cycles'] / max(f['gmres_solves'], 1):.2f} cycles an apply, "
            f"{applies} preconditioner applies; band solves {st['solves']}, original-order "
            f"matvecs {st['matvecs']}; launches {nonzero(st['launches'])}; host LU calls 0 "
            f"(every host LU raises)")
        if op.method != "gmres" or not op.pivoted:
            raise RuntimeError(f"phase {name}: method {op.method}, pivoted {op.pivoted}")
        if abs(sigma - mp["sigma"]) > 1e-8 or not resid <= 1e-8:
            raise RuntimeError(f"phase {name}: sigma {sigma} against phase 3's {mp['sigma']}, "
                               f"residual {resid:.2e}")
        gate_stage(f"phase {name}", st, "pivoted.c64", "PivotedBandedLU", "c128.c64", builds=1)
        if st["solves"]["PivotedBandedLU"] != applies:
            raise RuntimeError(f"phase {name}: {st['solves']} band solves for {applies} "
                               f"preconditioner applies")


def nonsym_menu(case, mp: dict, J, stages: dict) -> None:
    """12b: the nonsymmetric menu on the velocity block of phase 3's last
    Newton Jacobian (``extract_subblocks(J)["vv"]``): each Krylov type of
    ``NONSYM_KSPS`` with ILU(0) (its Chow-Patel sweeps doubled from the
    reference's 8 until a sweep changes the values by under 1e-10; GMRES
    and BiCGStab at 8 sweeps logged first) and with block-Jacobi(64), to
    1e-10 within 600 steps.  Gates: the true residual <= 1e-8 wherever a
    solver reports convergence; GMRES + ILU and BiCGStab + ILU converge."""
    import torch
    from lsafw_tpu_torch.interop import csr_from_numpy
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.ops.bcsr import matvec_of
    from lsafw_tpu_torch.ops.sparse import pattern_csr
    from lsafw_tpu_torch.solver import ilu as tilu
    from lsafw_tpu_torch.solver.linear import solve
    from lsafw_tpu_torch.solver.precond import block_jacobi

    vv = LinearizedNavierStokesAssembler(mp["w"], case["ctx"], 47.0, case["bcs_pert"],
                                         case["mesh"]).extract_subblocks(J)["vv"].tocsr()
    vv.sort_indices()
    A = csr_from_numpy(vv.indptr, vv.indices, vv.data, vv.shape, device=DEVICE)
    At = A.transpose()
    g = torch.Generator(device=A.device).manual_seed(12)
    b = torch.randn(A.shape[0], generator=g, dtype=torch.float64, device=A.device)
    mv, rmv = matvec_of(A), matvec_of(At)
    t0 = time.time()
    plan = tilu.ILU0Plan.build(pattern_csr(A.pattern))
    t_plan = time.time() - t0
    v8, t_sweeps = synced(lambda: tilu.ilu0_factor_values(plan, A.data))
    if not torch.equal(v8, tilu.ilu0_factor_values(plan, A.data)):
        raise RuntimeError("phase 12b: two runs of the 8 Chow-Patel sweeps gave different values")
    # the reference's default 8 Chow-Patel sweeps leave the fixed point
    # unconverged on this block: logged, not gated; the menu then runs on
    # the sweep count at which a sweep changes the values by < 1e-10
    ilu8 = tilu.ilu0(A, plan=plan)
    for ksp in ("gmres", "bcgs"):
        res = solve(mv, b, ksp_type=ksp, tol=KSP_TOL, maxiter=NONSYM_MAXITER, M=ilu8)
        log(f"phase 12b: {ksp} + ILU(0) at the reference's 8 sweeps: converged {res.converged}, "
            f"{res.iterations} iterations, monitored residual {res.residual:.2e}, true residual "
            f"{true_residual(mv, b, res.x):.2e}")
    sweeps, change = converged_sweeps(plan, A)
    _, t_conv = synced(lambda: tilu.ilu0_factor_values(plan, A.data, sweeps=sweeps))
    ilu = tilu.ilu0(A, plan=plan, factor_sweeps=sweeps)
    bj, t_bj = synced(lambda: block_jacobi(A, 64))
    pcs = {"ilu": ilu, "bjacobi": bj}
    log(f"phase 12b: the velocity block of phase 3's last Jacobian: {A.shape[0]} rows, "
        f"{vv.nnz} nonzeros; ILU(0): plan {t_plan:.2f} s on the host ({plan.tr_p.size} "
        f"triples), 8 sweeps {1e3 * t_sweeps:.2f} ms (bit-identical on a second run), "
        f"{sweeps} sweeps (the last one's change "
        f"{change:.1e}) {1e3 * t_conv:.2f} ms, one apply (12 S products) "
        f"{cuda_ms(lambda: ilu(b), 10):.3f} ms; block-Jacobi(64): batched inverse "
        f"{1e3 * t_bj:.2f} ms, one apply {cuda_ms(lambda: pcs['bjacobi'](b), 10):.3f} ms")
    done = {}
    for pc in NONSYM_PCS:
        for ksp in NONSYM_KSPS:
            name = f"12b {ksp}+{pc}"
            with stage(name, stages):
                res = solve(mv, b, ksp_type=ksp, tol=KSP_TOL, maxiter=NONSYM_MAXITER, M=pcs[pc],
                            rmatvec=rmv)
            true = true_residual(mv, b, res.x)
            done[(ksp, pc)] = res.converged
            log(f"phase 12b: {ksp} + {pc}{' (unpreconditioned, as PETSc)' if ksp == 'lsqr' else ''}"
                f": converged {res.converged}, {res.iterations} iterations"
                f"{f' ({res.cycles} cycles)' if res.cycles else ''}, monitored residual "
                f"{res.residual:.2e}, true residual {true:.2e}, {stages[name]['seconds']:.3f} s")
            if res.converged and not true <= 1e-8:
                raise RuntimeError(f"phase {name}: converged with a true residual {true:.2e}")
    if not (done[("gmres", "ilu")] and done[("bcgs", "ilu")]):
        raise RuntimeError(f"phase 12b: GMRES + ILU or BiCGStab + ILU did not converge: {done}")


def spd_menu(stages: dict) -> tuple[dict, object]:
    """12c: the SPD menu on the P2 membrane stiffness of the JAX package's
    bench grid (``MEMBRANE_NX``): CG with each PC of ``SPD_PCS`` (ILU(0)
    and ICC(0), one factor, on the converged sweep count of
    :func:`converged_sweeps`: at the reference's 8 sweeps the factor is not
    symmetric enough for CG at 240 x 240), MINRES with Jacobi, Chebyshev
    with power-iteration bounds, to 1e-10.  Gates:
    true residual <= 1e-8 each; at each size AMG's iterations x 4 < plain
    CG's and pMG's x 3 < Jacobi's; at 240 AMG's at most twice its count at
    120 and pMG's within +6 of its count at 120; pMG one K1 / K2 pivoted
    f32 x1 launch per V-cycle.  Returns the iteration counts and the pMG
    preconditioner at nx = 240 (its coarse factor's kernels are checked
    after the phase)."""
    import torch
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
    from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
    from lsafw_tpu_torch.ops.bcsr import matvec_of
    from lsafw_tpu_torch.ops.sparse import pattern_csr
    from lsafw_tpu_torch.solver import amg, ilu as tilu, pmg
    from lsafw_tpu_torch.solver.linear import cg, chebyshev, minres, power_norm
    from lsafw_tpu_torch.solver.precond import block_jacobi, jacobi

    its: dict = {}
    for nx in MEMBRANE_NX:
        mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), nx, nx)
        (K, _, mask), t_asm = synced(lambda: assemble_membrane_evp(mesh, device=DEVICE))
        n = K.shape[0]
        mask_t = torch.as_tensor(mask, device=K.device)
        g = torch.Generator(device=K.device).manual_seed(nx)
        b = torch.randn(n, generator=g, dtype=torch.float64, device=K.device)
        b = torch.where(mask_t, torch.zeros_like(b), b)
        mv = matvec_of(K)
        log(f"phase 12c: nx = {nx}: {n} DOFs, {K.pattern.nnz} nonzeros, assembled in "
            f"{t_asm:.2f} s")
        ilu_plan = None
        vcycles = {"n": 0}
        for pc in SPD_PCS:
            t0 = time.time()
            with stage(f"12c nx={nx} {pc} build", stages):
                if pc == "none":
                    M = None
                elif pc == "jacobi":
                    M = jacobi(K)
                elif pc == "bjacobi":
                    M = block_jacobi(K, 64)
                elif pc == "sor":
                    M = tilu.ssor(K)
                elif pc in ("ilu", "icc"):  # ICC(0) on an SPD matrix is the ILU(0) factor
                    if ilu_plan is None:
                        ilu_plan = tilu.ILU0Plan.build(pattern_csr(K.pattern))
                        res8 = cg(mv, b, tol=KSP_TOL, maxiter=ILU8_MAXITER,
                                  M=tilu.ilu0(K, plan=ilu_plan))
                        log(f"phase 12c: nx = {nx}: CG + ILU(0) at the reference's 8 sweeps: "
                            f"converged {res8.converged}, {res8.iterations} iterations, "
                            f"monitored residual {res8.residual:.2e}, true residual "
                            f"{true_residual(mv, b, res8.x):.2e} (logged, not gated)")
                        sweeps, change = converged_sweeps(ilu_plan, K)
                    M = tilu.ilu0(K, plan=ilu_plan, factor_sweeps=sweeps)
                elif pc == "gamg":
                    M = amg.amg_preconditioner(K)
                else:
                    mg = pmg.build_pmg_pc(make_scalar_space(mesh, "p2"), K, mask)

                    def M(r, mg=mg):
                        vcycles["n"] += 1
                        return mg.apply(r)
            t_build = time.time() - t0
            name = f"12c nx={nx} cg+{pc}"
            vcycles["n"] = 0
            with stage(name, stages):
                res = cg(mv, b, tol=KSP_TOL, maxiter=SPD_MAXITER, M=M)
            st = stages[name]
            true = true_residual(mv, b, res.x)
            its[(nx, pc)] = res.iterations
            extra = ""
            if pc == "gamg":
                h = M.hierarchy
                extra = (f", {len(h.levels) + 1} levels, coarsest {h.coarse_inv.shape[0]}, "
                         f"one V-cycle {cuda_ms(lambda: M(b), 5):.3f} ms")
            elif pc == "pmg":
                extra = (f", coarse P1 {mg.coarse_matrix.shape[0]} rows on a "
                         f"{type(mg.coarse).__name__} (B = {mg.coarse.B}), {vcycles['n']} "
                         f"V-cycles, one V-cycle {cuda_ms(lambda: mg.apply(b), 5):.3f} ms")
            elif pc in ("ilu", "icc", "sor", "bjacobi", "jacobi"):
                extra = f", one apply {cuda_ms(lambda: M(b), 5):.3f} ms"
                if pc in ("ilu", "icc"):
                    extra += (f", {sweeps} Chow-Patel sweeps (the last one's change "
                              f"{change:.1e}; {ilu_plan.tr_p.size} triples)")
            log(f"phase 12c: nx = {nx}: CG + {pc}: converged {res.converged}, {res.iterations} "
                f"iterations, true residual {true:.2e}, {st['seconds']:.3f} s; build "
                f"{t_build:.3f} s{extra}")
            if not (res.converged and true <= 1e-8):
                raise RuntimeError(f"phase {name}: converged {res.converged}, true residual "
                                   f"{true:.2e}")
            if pc == "pmg":
                gate_band_launches(f"phase {name}", st["launches"], "pivoted.f32x1",
                                   vcycles["n"])
                if not (st["launches"]["permute_in.f64.f32x1"]
                        == st["launches"]["permute_out.f32x1.f64"] == vcycles["n"]):
                    raise RuntimeError(f"phase {name}: permutes {nonzero(st['launches'])} for "
                                       f"{vcycles['n']} V-cycles")
        name = f"12c nx={nx} minres+jacobi"
        with stage(name, stages):
            res = minres(mv, b, tol=KSP_TOL, maxiter=SPD_MAXITER, M=jacobi(K))
        true = true_residual(mv, b, res.x)
        log(f"phase 12c: nx = {nx}: MINRES + jacobi: converged {res.converged}, "
            f"{res.iterations} iterations, true residual {true:.2e}, "
            f"{stages[name]['seconds']:.3f} s")
        if not (res.converged and true <= 1e-8):
            raise RuntimeError(f"phase {name}: converged {res.converged}, true {true:.2e}")
        # Chebyshev's bounds: lmax by 30 power iterations on K (x 1.05); lmin
        # by 12 inverse power iterations, each a pMG-preconditioned CG solve
        # (x 0.95)
        t0 = time.time()
        lmax = power_norm(mv, b, 30)
        lmin = 1.0 / power_norm(
            lambda v, mg=mg: cg(mv, v, tol=1e-10, maxiter=SPD_MAXITER, M=mg.apply).x, b, 12)
        t_bounds = time.time() - t0
        name = f"12c nx={nx} chebyshev"
        with stage(name, stages):
            res = chebyshev(mv, b, lmin=0.95 * lmin, lmax=1.05 * lmax, tol=KSP_TOL,
                            maxiter=SPD_MAXITER)
        true = true_residual(mv, b, res.x)
        log(f"phase 12c: nx = {nx}: Chebyshev on [{0.95 * lmin:.4e}, {1.05 * lmax:.4e}] (bounds "
            f"in {t_bounds:.2f} s): converged {res.converged}, {res.iterations} iterations, true "
            f"residual {true:.2e}, {stages[name]['seconds']:.3f} s")
        if not (res.converged and true <= 1e-8):
            raise RuntimeError(f"phase {name}: converged {res.converged}, true {true:.2e}")
        del K, M
    for nx in MEMBRANE_NX:
        if not (4 * its[(nx, "gamg")] < its[(nx, "none")]
                and 3 * its[(nx, "pmg")] < its[(nx, "jacobi")]):
            raise RuntimeError(f"phase 12c: nx = {nx}: AMG x 4 against plain CG, pMG x 3 against "
                               f"Jacobi: {its}")
    lo, hi = MEMBRANE_NX
    if not (its[(hi, "gamg")] <= 2 * its[(lo, "gamg")]
            and its[(hi, "pmg")] <= its[(lo, "pmg")] + 6):
        raise RuntimeError(f"phase 12c: AMG or pMG counts grow with the mesh: {its}")
    log(f"phase 12c: iterations {({f'{nx} {pc}': k for (nx, pc), k in its.items()})}: AMG "
        f"{its[(hi, 'gamg')]} at {hi} against {its[(lo, 'gamg')]} at {lo} (at most x 2) and "
        f"plain CG's {its[(hi, 'none')]} (x 4 under it); pMG {its[(hi, 'pmg')]} against "
        f"{its[(lo, 'pmg')]} (+6 at most) and Jacobi's {its[(hi, 'jacobi')]} (x 3 under it)")
    return its, mg


def transforms_path(stages: dict) -> list:
    """12d: the other transforms on the reference's membrane
    (``MEMBRANE_32``): FILTER on K alone against SINVERT's three smallest
    on the same K (rel 1e-8); SHIFT on (K, M) restricted to the free DOFs
    (M is zero on its Dirichlet rows, and SHIFT needs M^-1): the three
    largest, residuals <= 1e-8 (|lambda| + 1), M^-1 a real band factor on
    the card (K1 / K2 pivoted f32 x2 once per band solve); SHELL wrapping
    the SINVERT apply at 1.0: the same five pairs as SINVERT, 1e-10.
    Returns (label, band factor) of SINVERT at 1.0 (SHELL's factor) and
    of SHIFT's M."""
    import torch
    from lsafw_tpu_torch.interop import csr_from_numpy
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
    from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, EpsWhich, ShiftInvertOperator, STType, eigen_residuals)

    (a, bside), nx = MEMBRANE_32
    K, M, mask = assemble_membrane_evp(rectangle_mesh((0.0, 0.0), (a, bside), nx, nx),
                                       device=DEVICE)

    def run(name, A, Mm, cfg, setup):
        with stage(name, stages):
            es = EigenSolver(A, Mm, cfg)
            setup(es)
            pairs = es.solve()
        return pairs, es

    cfg3 = EigensolverConfig(num_eig=3, atol=1e-10, ncv=20)

    def si0(es):
        es.set_st_type(STType.SINVERT)
        es.set_target(0.0)

    si, _ = run("12d sinvert K", K, None, cfg3, si0)
    lam_si = np.sort([p[0].real for p in si])

    def filt(es):
        es.set_st_type(STType.FILTER)
        es.set_target(float(2.0 * lam_si[-1]))
        es.set_which_eigenpairs(EpsWhich.SMALLEST_REAL)
        es.set_filter_degree(60)

    fl, es_f = run("12d filter K", K, None, cfg3, filt)
    lam_f = np.sort([p[0].real for p in fl])
    rel = float(np.max(np.abs(lam_f - lam_si) / np.abs(lam_si)))
    log(f"phase 12d: FILTER (degree 60, cutoff {2.0 * lam_si[-1]:.6e}) on K: {lam_f} against "
        f"SINVERT's {lam_si}: rel {rel:.1e}; {stages['12d filter K']['seconds']:.2f} s, "
        f"{es_f.operator.applies} filter applies ({60 * es_f.operator.applies} matvecs), "
        f"launches {nonzero(stages['12d filter K']['launches'])}")
    if not rel <= 1e-8:
        raise RuntimeError(f"phase 12d: FILTER {lam_f} against SINVERT {lam_si}: rel {rel:.1e}")
    free = np.flatnonzero(~mask)
    Ks, Ms = K.to_scipy()[free][:, free].tocsr(), M.to_scipy()[free][:, free].tocsr()
    Ks.sort_indices()
    Ms.sort_indices()
    Kf = csr_from_numpy(Ks.indptr, Ks.indices, Ks.data, Ks.shape, device=DEVICE)
    Mf = CSRMatrix(Kf.pattern, torch.as_tensor(Ms.data, device=Kf.device))

    def shift(es):
        es.set_which_eigenpairs(EpsWhich.LARGEST_MAGNITUDE)

    sh, es_s = run("12d shift", Kf, Mf, cfg3, shift)
    lam_s = np.array([p[0] for p in sh])
    res_s = eigen_residuals(Kf, Mf, sh) / (np.abs(lam_s) + 1.0)
    st = stages["12d shift"]
    f = es_s.operator.figures()
    log(f"phase 12d: SHIFT on the free DOFs' (K, M) ({Kf.shape[0]} rows): the three largest "
        f"{lam_s.real}, residuals / (|lambda| + 1) {res_s}; {st['seconds']:.2f} s, "
        f"{f['applies']} applies, M's factor {f['factor_s']:.3f} s, contraction "
        f"{f['rho']:.2e}, refinement cap {f['refine_its']}; band solves {st['solves']}, "
        f"launches {nonzero(st['launches'])}")
    if not (res_s <= 1e-8).all():
        raise RuntimeError(f"phase 12d: SHIFT residuals {res_s}")
    gate_eigen_stage("phase 12d shift", st, REAL_CLASSES, builds=2)
    cfg5 = EigensolverConfig(num_eig=5, atol=1e-10, ncv=30)

    def si1(es):
        es.set_st_type(STType.SINVERT)
        es.set_target(1.0)

    si5, es_i = run("12d sinvert", K, M, cfg5, si1)
    op = ShiftInvertOperator(K, M, 1.0, inner_tol=1e-10)

    def shell(es):
        es.set_st_shell(op.apply, lambda t: op.back_transform(t))

    sl, _ = run("12d shell", K, M, cfg5, shell)
    lam_a = np.sort_complex(np.array([p[0] for p in si5]))
    lam_b = np.sort_complex(np.array([p[0] for p in sl]))
    diff = float(np.max(np.abs(lam_a - lam_b) / np.maximum(1.0, np.abs(lam_a))))
    res_b = eigen_residuals(K, M, sl) / (np.abs(lam_b) + 1.0)
    log(f"phase 12d: SHELL wrapping the SINVERT apply at 1.0: {lam_b.real} against SINVERT's "
        f"{lam_a.real}: {diff:.1e}; residuals {res_b.max():.1e}; "
        f"{stages['12d shell']['seconds']:.2f} s against {stages['12d sinvert']['seconds']:.2f} s")
    if not (diff <= 1e-10 and (res_b <= 1e-8).all()):
        raise RuntimeError(f"phase 12d: SHELL {lam_b} against SINVERT {lam_a}: {diff:.1e}")
    for name in ("12d sinvert K", "12d sinvert", "12d shell"):
        gate_eigen_stage(f"phase {name}", stages[name], REAL_CLASSES, builds=2)
    st = stages["12d filter K"]
    s_orig = sum(st["launches"][m + ".original"] for m in ("spmv_real", "spmv_complex"))
    if st["solves"] or any(st["launches"][k] for k in st["launches"] if k.startswith("K")) \
            or not s_orig == st["matvecs"] > 0:
        raise RuntimeError(f"phase 12d filter: band solves {st['solves']}, {s_orig} S launches "
                           f"for {st['matvecs']} matvecs: {nonzero(st['launches'])}")
    return [(", 32x32 membrane SINVERT / SHELL (phase 12d)", es_i.operator.device_op.blu),
            (", 32x32 membrane SHIFT's M (phase 12d)", es_s.operator.mop.blu)]


def factor_kernels(factors: list, errs: dict, dev, types: str = "real",
                   backward: tuple = (), library: bool = False) -> list:
    """G's permute forms in the real types (``types="complex"``: complex128
    to complex64 and back) on each (label, band factor) pair's
    permutation, then K1/K2 on the factor (:func:`band_kernels`, one call
    of each plain loop, with ``library`` the pivot-free K1's library call):
    each held against its plain version.  Returns the kernels-line
    entries."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    real = ({(f, t) for f in ("in", "out") for t in sc.PERMUTES[f] if "f32" in t}
            if types == "real" else {("in", "c128.c64"), ("out", "c64.c128")})
    for label, f in factors:
        n = f.iperm.numel()
        g = torch.Generator(device=dev).manual_seed(12)
        br = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        bc = torch.complex(torch.randn(n, generator=g, device=dev, dtype=torch.float64),
                           torch.randn(n, generator=g, device=dev, dtype=torch.float64))
        check_permutes(permute_cases(br, bc, f.perm, f.iperm, f.nb, real),
                       f"on the permutation of{label.split(',', 1)[1]}")
    return band_kernels(factors, errs, dev, plain_reps=1, backward=backward, library=library)


def krylov_path(case, mp: dict, J, errs: dict, dev) -> dict:
    """Phase 12 (after phase 5): 12a on phase 3's (A, M), 12b on its last
    Jacobian, 12c and 12d on the membranes; each stage's launches read on
    its own and summed.  Then G and K1/K2 on the phase's own factors
    (pMG's coarse P1 factor at nx = 240, 12d's SINVERT / SHELL and SHIFT
    M factors), each against its plain version."""
    stages: dict = {}
    t0 = time.time()
    with plain_loops_forbidden():
        gmres_si_path(mp, stages)
        nonsym_menu(case, mp, J, stages)
        _, mg = spd_menu(stages)
        factors = transforms_path(stages)
    seconds = time.time() - t0
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in counts()}
    log(f"phase 12: {seconds:.1f} s (budget 60 s); launches {nonzero(launches)}")
    t0 = time.time()
    coarse = (f", pMG's coarse P1 at nx = {MEMBRANE_NX[-1]} (phase 12c)", mg.coarse)
    kernels = factor_kernels([coarse] + factors, errs, dev)
    log(f"phase 12: G and K1/K2 on the phase's factors, checked and timed in "
        f"{time.time() - t0:.1f} s")
    return dict(launches=launches, seconds=seconds, stages=stages, kernels=kernels, pmg=mg)


# ---------------------------------------------------------------------------
# Phase 13: the structured stencil / multigrid / LOBPCG path, the nested
# two-grid eigen refinement and the element operator
# ---------------------------------------------------------------------------

STRUCT_NX = 240  # bench.py:132's 240 x 240 Taylor-Hood rectangle (520,803 DOFs)
STRUCT_TOL = {"f64": 1e-12, "f32": 1e-5}  # against S (f64), against the f64 product (f32)
MEMBRANE_SIGMA = 19.0 + 0.3j  # tests/unit/test_eigen.py:370
NESTED_NX = (60, 240)  # the membranes' coarse and fine grids of 13c
# 13b's sizes, cut for the script's time limit: the membrane of the power
# iteration at 64 x 128 (power_probe.py: 96 is the largest nx at which the
# fixed 200-step Jacobi CG converges, 128 does not) and the unit cube at 24^3
# (117,649 P2 DOFs, in place of 32^3's 274,625)
POWER_NX = 64
MG_CUBE_N = 24
# relative P2 errors of 3 pi^2 and of the 6 pi^2 triple (its worst member) on
# unit_cube(16), measured on the CPU by scripts/torch_cube_p2_error.py
# (3.55e-5 and 1.86e-4; the error falls as h^4, so they bound the 24^3 ones)
CUBE_ERR16 = (3.56e-5, 1.87e-4)


def structured_ops(dev) -> dict:
    """13a's operators at bench.py's size: the 240 x 240 Taylor-Hood space,
    random CSR values on its pattern from default_rng(0) in bench.py's draw
    order, the element matrices (nc, 15, 15), their assembled CSR, and the
    stencil operator of the values."""
    import torch
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.ops.sparse import CSRMatrix, assemble_csr_data
    from lsafw_tpu_torch.ops.stencil import build_stencil_operator

    t0 = time.time()
    mesh, t_mesh = host_mesh("structured")
    spaces = define_spaces(mesh)
    ctx = AssemblyContext.build(spaces, device=dev)
    n, nnz, nc = spaces.num_dofs, ctx.pattern.nnz, mesh.num_cells
    rng = np.random.default_rng(0)
    rng.standard_normal(n)  # bench.py's w_base
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    A = CSRMatrix(ctx.pattern, torch.as_tensor(rng.standard_normal(nnz), device=dev))
    Ael = torch.as_tensor(rng.standard_normal((nc, 15, 15)) * 0.01, device=dev)
    E = CSRMatrix(ctx.pattern, assemble_csr_data(ctx.pattern, Ael))
    st = build_stencil_operator(ctx.pattern, A.data, spaces)
    torch.cuda.synchronize()
    log(f"phase 13a: {STRUCT_NX} x {STRUCT_NX} Taylor-Hood: {n} DOFs, {nnz} nonzeros, {nc} cells; "
        f"{st.structure.num_classes} DOF classes, {len(st.structure.buckets)} stencil buckets "
        f"(pad {st.structure.pad}, {st.structure.coeff_size} coefficients); set-up "
        f"{time.time() - t0:.1f} s (the mesh and its tables {t_mesh:.1f} s of it, or made "
        f"earlier by the mesh worker)")
    return dict(ctx=ctx, n=n, nnz=nnz, nc=nc, x=x, A=A, Ael=Ael, E=E, st=st)


def stencil_vs_s(ops: dict, dev) -> None:
    """13a: the stencil and element products against S's original-order
    product of the same CSR (f64 rel 1e-12; f32 against the f64 product
    rel 1e-5), S and G against their plain versions at these shapes, and
    the times: each operator (CUDA events, L2 evicted), S's and
    cuSPARSE's, launches per product (device operations under the
    profiler) and the byte bound."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.ops.bcsr import BCSROperator
    from lsafw_tpu_torch.ops.elementop import ElementOperator
    from lsafw_tpu_torch.ops.stencil import StencilOperator

    x, n, nnz, nc = ops["x"], ops["n"], ops["nnz"], ops["nc"]

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).to(torch.float64))
                     / torch.linalg.vector_norm(b.to(torch.float64)))

    for label, csr, kind in (("stencil", ops["A"], "stencil"), ("element", ops["E"], "element")):
        t0 = time.time()
        s_op = BCSROperator.from_csr(csr)
        tiles = s_op.plan.on(dev)
        y_s = s_op.matvec(x)
        e_s = rel(y_s, sc.csr_spmv_plain(tiles, s_op.vals, x))
        lib = csr.torch_csr()
        if kind == "stencil":
            st = ops["st"]
            xp = st.pack(x)
            ops32 = StencilOperator(st.structure, st.coeffs.float())
            xp32 = xp.float()
            y64 = st.unpack(st.matvec(xp))
            y32 = st.unpack(ops32.matvec(xp32)).double()
            f64 = lambda: st.matvec(xp)  # noqa: E731
            f32 = lambda: ops32.matvec(xp32)  # noqa: E731
            nbytes = {d: st.structure.coeff_size * s + 2 * n * s for d, s in (("f64", 8),
                                                                               ("f32", 4))}
            flops = 2.0 * nnz
        else:
            el = ElementOperator(ops["Ael"], ops["ctx"].mixed_cell_dofs, n)
            el32 = ElementOperator(ops["Ael"].float(), ops["ctx"].mixed_cell_dofs, n)
            x32 = x.float()
            y64, y32 = el.matvec(x), el32.matvec(x32).double()
            f64, f32 = (lambda: el.matvec(x)), (lambda: el32.matvec(x32))
            nbytes = {d: (nc * 225 + 2 * nc * 15 + 2 * n) * s + 3 * nc * 15 * 4
                      for d, s in (("f64", 8), ("f32", 4))}
            flops = 2.0 * nc * 225
            idx = el._map._idx
            if not torch.equal(sc.gather(x, idx), x[idx.long()]):
                raise RuntimeError("phase 13a: G's flat gather disagrees with x[idx] at the "
                                   "element operator's shape")
        e64, e32 = rel(y64, y_s), rel(y32, y64)
        t1 = time.time()
        times = {"f64": cold_ms(f64, 5), "f32": cold_ms(f32, 5),
                 "S": cold_ms(lambda: s_op.matvec(x), 5), "cuSPARSE": cold_ms(lambda: lib @ x, 5)}
        ops_per = dict.fromkeys(("f64", "f32"), device_busy(f64)[2])  # f32: the same operations
        b = {d: bound(nbytes[d], flops, FP64_FLOPS_PER_S if d == "f64" else FP32_FLOPS_PER_S)[0]
             for d in ("f64", "f32")}
        b_s = bound(*spmv_work("real", "original", n, nnz, s_op.plan.tile_row.size - 1),
                    FP64_FLOPS_PER_S)[0]
        log(f"phase 13a: {label} f64 against S: rel {e64:.1e} (limit {STRUCT_TOL['f64']:.0e}); "
            f"f32 against f64: rel {e32:.1e} (limit {STRUCT_TOL['f32']:.0e}); S against its plain "
            f"version: rel {e_s:.1e}")
        log(f"phase 13a: {label} f64 {times['f64']:.4f} ms ({ops_per['f64']} device operations, "
            f"bound {b['f64']:.4f} ms), f32 {times['f32']:.4f} ms ({ops_per['f32']} operations, "
            f"bound {b['f32']:.4f} ms); S {times['S']:.4f} ms (1 launch, bound {b_s:.4f} ms), "
            f"cuSPARSE {times['cuSPARSE']:.4f} ms (times with the L2 evicted); S's plan and the "
            f"checks {t1 - t0:.1f} s, the times {time.time() - t1:.1f} s")
        if not (e64 <= STRUCT_TOL["f64"] and e32 <= STRUCT_TOL["f32"] and e_s <= SPMV_REL_TOL):
            raise RuntimeError(f"phase 13a: {label}: f64 {e64:.1e}, f32 {e32:.1e}, S {e_s:.1e}")
        del s_op, lib


TRUNCATED_B = 2  # the truncated fine bands of 13c: B = 2 block diagonals at nb = 128


def truncated_plan(A, B: int = TRUNCATED_B):
    """A complex64 band plan of A's pattern clipped to ``B`` off-diagonal
    blocks (entries outside are dropped: a budget-truncated band)."""
    from lsafw_tpu_torch.solver import band as tband

    nb = tband.band_nb()
    cap = tband.BandPlan.band_bytes(A.shape[0], B, nb=nb, per_entry=8)
    return tband.plan_for_csr(A, nb=nb, max_bytes=cap, force_f32=True)


def membrane_case(nx: int, dev, side: tuple = (1.0, 1.0)) -> dict:
    """The P2 membrane (K, M, mask) of the nx x nx grid on the rectangle
    [0, side] and its mesh and space."""
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
    from lsafw_tpu_torch.models.membrane import assemble_membrane_evp

    mesh = rectangle_mesh((0.0, 0.0), side, nx, int(round(nx * side[1] / side[0])))
    K, M, mask = assemble_membrane_evp(mesh, device=dev)
    return dict(mesh=mesh, K=K, M=M, mask=mask, space=make_scalar_space(mesh, "p2"))


def packed_start(op, mask, seed: int, m: int | None = None):
    """Seeded start vectors, zero on the Dirichlet DOFs, in the stencil's
    packed layout (rows of an (m, n) block where m is given)."""
    import torch

    rng = np.random.default_rng(seed)
    rows = [np.where(mask, 0.0, rng.standard_normal(mask.size)) for _ in range(m or 1)]
    X = torch.stack([op.pack(torch.as_tensor(r, device=op.coeffs.device)) for r in rows])
    return X if m else X[0]


def vcycle_line(what: str, pc, r) -> str:
    import torch

    ms = cuda_ms(lambda: pc.apply(r), 5)
    _, busy, nops = device_busy(lambda: pc.apply(r))
    torch.cuda.synchronize()
    return f"{what} V-cycle {ms:.3f} ms ({nops} device operations, the card busy {busy:.3f} ms)"


def lobpcg_path(mem: dict, pmg_pc, stages: dict, dev) -> dict:
    """13b: LOBPCG with multigrid.  2D on the 240 x 240 membrane (the
    pencil of phase 12c): ``build_multigrid_pc`` + ``lobpcg_smallest_pc``
    and ``lobpcg_smallest_pc`` on the CSR (K, M) with phase 12's
    ``PMGPreconditioner``, each: lambda_1 within 1e-9 of the banded
    SINVERT eigenvalue of the same pencil, residual <= tol (1e-10 and 1e-9,
    the reference's tests' own), fewer than 60 iterations; ``shift_invert_power`` on the 2 x 4 rectangle at
    ``POWER_NX`` (test_power_stencil.py's gates); 3D on ``unit_cube(MG_CUBE_N)``
    with ``build_multigrid_nd_pc``: ``lobpcg_smallest_pc`` (3 pi^2 within
    ``CUBE_ERR16[0]``, fewer than 60 iterations) and ``lobpcg_block_pc``
    with m = 4 (every residual <= tol, the three above within
    ``CUBE_ERR16[1]`` of 6 pi^2, the degenerate pair of the triple equal to
    1e-7)."""
    import torch
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.models.membrane import analytic_eigenvalues, assemble_membrane_evp
    from lsafw_tpu_torch.ops.stencil import build_stencil_operator
    from lsafw_tpu_torch.ops.stencil_nd import build_stencil_nd
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
    from lsafw_tpu_torch.solver.multigrid import build_multigrid_pc
    from lsafw_tpu_torch.solver.multigrid_nd import build_multigrid_nd_pc
    from lsafw_tpu_torch.solver.power import (lobpcg_block_pc, lobpcg_smallest_pc,
                                              shift_invert_power)

    K, M, mask, mesh = mem["K"], mem["M"], mem["mask"], mem["mesh"]
    with stage("13b sinvert", stages):
        es = EigenSolver(K, M, EigensolverConfig(num_eig=1, atol=1e-10, ncv=16))
        es.set_st_type(STType.SINVERT)
        es.set_target(19.0)
        lam_si = es.solve()[0][0].real
    tols = {"multigrid on the stencil": 1e-10, "p-MG on the CSR pair": 1e-9}  # test_multigrid.py,
    # test_pmg.py: the reference's tolerances
    with stage("13b build 2D", stages):
        mg = build_multigrid_pc(mesh, K, mask)
        Mop = build_stencil_operator(K.pattern, M.data, [(mem["space"], 1)], bc_mask=mask,
                                     bc_diag=0.0)
    x0 = packed_start(mg.op2, mask, 1)
    with stage("13b lobpcg mg", stages):
        r_mg = lobpcg_smallest_pc(mg.op2, Mop, x0, mg, tol=tols["multigrid on the stencil"],
                                  max_iter=100)
    with stage("13b lobpcg pmg", stages):
        r_pmg = lobpcg_smallest_pc(K, M, mg.op2.unpack(x0), pmg_pc,
                                   tol=tols["p-MG on the CSR pair"], max_iter=100)
    for name, r in (("multigrid on the stencil", r_mg), ("p-MG on the CSR pair", r_pmg)):
        d, tol = abs(r.eigenvalue - lam_si) / lam_si, tols[name]
        log(f"phase 13b: 2D LOBPCG with {name}: lambda_1 {r.eigenvalue:.12f} against SINVERT's "
            f"{lam_si:.12f}: rel {d:.1e}; {r.iterations} iterations, residual {r.residual:.1e}")
        if not (d <= 1e-9 and r.residual <= tol and r.iterations < 60):
            raise RuntimeError(f"phase 13b: 2D LOBPCG with {name}: rel {d:.1e}, "
                               f"{r.iterations} iterations, residual {r.residual:.1e}")
    log(f"phase 13b: 2D: {len(mg.ops1)} P1 levels; " + vcycle_line("the", mg, x0) + "; p-MG's "
        + vcycle_line("", pmg_pc, mg.op2.unpack(x0)) + f"; stages: multigrid "
        f"{stages['13b lobpcg mg']['seconds']:.2f} s, p-MG {stages['13b lobpcg pmg']['seconds']:.2f}"
        f" s, SINVERT {stages['13b sinvert']['seconds']:.2f} s, builds "
        f"{stages['13b build 2D']['seconds']:.2f} s")
    with stage("13b shift_invert_power", stages):
        pw = membrane_case(POWER_NX, dev, (2.0, 4.0))
        Kp = build_stencil_operator(pw["K"].pattern, pw["K"].data, [(pw["space"], 1)],
                                    bc_mask=pw["mask"], bc_diag=1.0)
        Mp = build_stencil_operator(pw["K"].pattern, pw["M"].data, [(pw["space"], 1)],
                                    bc_mask=pw["mask"], bc_diag=0.0)
        d = (pw["K"].diagonal() - pw["M"].diagonal())[Kp.structure.on(dev)["perm"].long()]
        inv = torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                          torch.ones_like(d))
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(Kp.structure.packed_size),
                            device=dev)
        sp_ = shift_invert_power(Kp, Mp, 1.0, x, inv, tol=1e-12, max_outer=50, cg_iters=200)
    exact = analytic_eigenvalues(2.0, 4.0, 1)[0]
    d = abs(sp_.eigenvalue - exact) / exact
    log(f"phase 13b: shift_invert_power on the {POWER_NX} x {2 * POWER_NX} P2 membrane of the "
        f"2 x 4 rectangle ({pw['K'].shape[0]} DOFs, 200 Jacobi-CG steps a solve): lambda_1 "
        f"{sp_.eigenvalue:.12f}, rel {d:.1e} from the analytic (limit 1e-4), residual "
        f"{sp_.residual:.1e} (limit 1e-6), {sp_.iterations} outer iterations, "
        f"{stages['13b shift_invert_power']['seconds']:.2f} s")
    if not (d < 1e-4 and sp_.residual < 1e-6):
        raise RuntimeError(f"phase 13b: shift_invert_power rel {d:.1e}, residual "
                           f"{sp_.residual:.1e}")
    with stage("13b build 3D", stages):
        mesh3, _ = host_mesh("cube")
        K3, M3, mask3 = assemble_membrane_evp(mesh3, device=dev)
        mg3 = build_multigrid_nd_pc(mesh3, K3, mask3)
        Mop3 = build_stencil_nd(K3.pattern, M3.data, [(make_scalar_space(mesh3, "p2"), 1)],
                                bc_mask=mask3, bc_diag=0.0)
    x3 = packed_start(mg3.op2, mask3, 1)
    with stage("13b lobpcg 3D", stages):
        r3 = lobpcg_smallest_pc(mg3.op2, Mop3, x3, mg3, tol=1e-9, max_iter=100)
    with stage("13b lobpcg block 3D", stages):
        rb = lobpcg_block_pc(mg3.op2, Mop3, packed_start(mg3.op2, mask3, 2, m=4), mg3, tol=1e-8,
                             max_iter=200)
    lam3 = 3.0 * np.pi ** 2
    d3 = abs(r3.eigenvalue - lam3) / lam3
    lb = rb.eigenvalues.cpu().numpy()
    resb = rb.residuals.cpu().numpy()
    dtri = np.abs(lb[1:] - 2 * lam3) / (2 * lam3)
    pair = min(abs(lb[1] - lb[2]), abs(lb[2] - lb[3])) / lb[2]
    log(f"phase 13b: 3D unit_cube({MG_CUBE_N}) ({K3.shape[0]} DOFs, {len(mg3.ops1)} P1 levels, "
        f"{len(mg3.op2.structure.buckets)} P2 buckets): lambda_1 {r3.eigenvalue:.10f}, rel "
        f"{d3:.1e} from 3 pi^2 (limit {CUBE_ERR16[0]:.2e}), {r3.iterations} iterations, residual "
        f"{r3.residual:.1e}; block m = 4: {lb.tolist()}, residuals {resb.tolist()}, "
        f"{rb.iterations} iterations; the triple's rel from 6 pi^2 {dtri.tolist()} (limit "
        f"{CUBE_ERR16[1]:.2e}), its degenerate pair equal to {pair:.1e}; "
        + vcycle_line("the 3D", mg3, x3) + f"; stages {stages['13b lobpcg 3D']['seconds']:.2f} s,"
        f" {stages['13b lobpcg block 3D']['seconds']:.2f} s, build "
        f"{stages['13b build 3D']['seconds']:.2f} s")
    if not (d3 <= CUBE_ERR16[0] and r3.iterations < 60 and r3.residual <= 1e-9):
        raise RuntimeError(f"phase 13b: 3D lambda_1 rel {d3:.1e}, {r3.iterations} iterations")
    if not ((resb <= 1e-8).all() and (dtri <= CUBE_ERR16[1]).all() and pair <= 1e-7
            and abs(lb[0] - lam3) / lam3 <= CUBE_ERR16[0]):
        raise RuntimeError(f"phase 13b: 3D block LOBPCG {lb}, residuals {resb}")
    return dict(lam_si=lam_si)


def true_rel(A, M, theta: complex, v: np.ndarray) -> tuple[float, float]:
    """(rel, its evaluation floor) on the host (scipy): rel = |A v - theta M
    v| / sqrt(|A v - theta M v|^2 + |theta|^2 |M v|^2), the quantity
    ``nested_eigenpair`` reports; the floor 64 eps |(|A| + |theta| |M|) |v||
    over the same denominator bounds the rounding of any f64 evaluation of
    it (rows of at most 64 terms)."""
    As, Ms = A.to_scipy(), M.to_scipy()
    Av, Mv = As @ v, Ms @ v
    r = np.linalg.norm(Av - theta * Mv)
    den = np.sqrt(r ** 2 + abs(theta) ** 2 * np.linalg.norm(Mv) ** 2)
    av = np.abs(v)
    floor = 64 * np.finfo(float).eps * np.linalg.norm(abs(As) @ av + abs(theta) * (abs(Ms) @ av))
    return float(r / den), float(floor / den)


def gate_report(what: str, rel: float, rel_true: tuple[float, float]) -> None:
    """The refinement's returned rel against the true one: 1e-6 relative,
    over twice the evaluation floor (both are f64 evaluations)."""
    rt, floor = rel_true
    if not abs(rel - rt) <= 1e-6 * rt + 2 * floor:
        raise RuntimeError(f"{what}: the reported residual {rel:.6e} is not the true {rt:.6e} "
                           f"(evaluation floor {floor:.1e})")


def nested_cylinder(case, mp: dict, stages: dict, dev) -> dict:
    """13c on the 43k cylinder: the examples' 11,323-DOF cylinder (same
    domain) at Re = 47 as the coarse grid (banded Newton baseflow, its
    eigenpair near 0.74j), P from ``interpolation_matrix``, the guess
    P x_c.  Gated: ``nested_eigenpair`` with the exact fine band factor at
    the coarse sigma.  Logged: the multiplicative ``TwoGridSIPC`` with
    ``DiagSIPC``, then with a truncated fine band, the coarse term the 11k
    exact band SI operator deflated by ``coarse_deflation``, the factors and
    the fine C at the search target 0.74j; gated that
    each reports its true residual, and where it converges, that its sigma
    is phase 3's.  Then ``set_elements`` on the 43k eigen stage with
    ``LSAFW_BCSR_MEM_GB=0``: sigma within 1e-8 of phase 3's, no S launch."""
    import torch
    from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver, interpolation_matrix
    from lsafw_tpu_torch.solver.eigen import (BandedSIOp, DiagSIPC, EigenSolver,
                                              EigensolverConfig, ShiftInvertOperator, STType,
                                              TwoGridSIPC, eigen_residuals, ell_of_csr,
                                              nested_eigenpair)

    A, M, sig3 = mp["A"], mp["M"], mp["sigma"]
    mask = case["bcs_pert"].dirichlet_mask
    with stage("13c coarse", stages):
        c = scm_case(dev, host_mesh("scm")[0])
        bf = BaseFlowSolver(c["ctx"], c["mesh"], c["bcs"], re=47.0)
        w_c = bf.solve(ramp=True, steps=3, tol=1e-8, max_it=40, linear_solver="banded")
        A_c, M_c = LinearizedNavierStokesAssembler(w_c, c["ctx"], 47.0, c["bcs_pert"],
                                                   c["mesh"]).assemble_eigensystem()
        es = EigenSolver(A_c, M_c, EigensolverConfig(num_eig=1, atol=1e-10, ncv=16))
        es.set_st_type(STType.SINVERT)
        es.set_target(TARGET)
        sig_c, x_c = es.solve()[0]
        P = interpolation_matrix(c["spaces"], case["spaces"])
    v0 = P @ x_c
    log(f"phase 13c: the {c['spaces'].num_dofs}-DOF coarse cylinder at Re = 47: sigma_c "
        f"{sig_c:.10f} ({stages['13c coarse']['seconds']:.2f} s with its baseflow); P "
        f"{P.shape[0]} x {P.shape[1]} ({P.nnz} entries)")
    out = {}
    with stage("13c nested exact", stages):
        sio = ShiftInvertOperator(A, M, sig_c, method="banded")
        th, v, rel, it = nested_eigenpair(sio.device_op, v0, sig_c, tol=1e-11, inner_tol=1e-3,
                                          inner_its=60, max_outer=20, bc_mask=mask)
    res = float(eigen_residuals(A, M, [(th, v)])[0])
    rt = true_rel(A, M, th, v)
    log(f"phase 13c: nested_eigenpair on the exact fine factor at sigma_c: sigma {th:.12f} "
        f"({abs(th - sig3):.1e} from phase 3's), {it} outer steps, rel {rel:.2e} (true "
        f"{rt[0]:.2e}, floor {rt[1]:.1e}), residual {res:.1e}; "
        f"{stages['13c nested exact']['seconds']:.2f} s")
    if not (abs(th - sig3) <= 1e-8 and res <= 1e-8):
        raise RuntimeError(f"phase 13c: nested sigma {th} against {sig3}, residual {res:.1e}")
    gate_report("phase 13c nested exact", rel, rt)
    out["exact"] = sio.device_op.blu
    del sio
    # the two-grid's factors, its C and its Jacobi at the search target (the
    # membranes' design: a fixed factor shift near the eigenvalue; the coarse
    # factor at sigma_c itself would be singular)
    s0 = TARGET
    sio_c = ShiftInvertOperator(A_c, M_c, s0, method="banded")
    out["coarse"] = sio_c.device_op.blu
    Pd, Pc = ell_of_csr(P, device=dev)
    cproj = TwoGridSIPC.coarse_deflation(x_c, M_c)
    Cop = BCSRShiftedOp.from_csr(A, M, s0)
    rop = BandedSIOp(A, M, None, s0, Cop)
    with env(LSAFW_PIVOT_MEM_GB="0"):
        plan = truncated_plan(A)
        trunc = tband.factor_auto(plan, A.data - s0.real * M.data, (-s0.imag) * M.data,
                                  diag_slots=A.pattern.diag_slots)[0]
    out["truncated"] = trunc
    fines = (("DiagSIPC", DiagSIPC.from_pair(A, M, s0)),
             (f"a truncated band (B = {plan.B} at nb = {plan.nb})", trunc))
    for name, fine in fines:
        # scripts/dev_500k.py's two-grid settings, the outer steps cut to 4
        pc = TwoGridSIPC(sio_c.device_op, fine, Pd, Pc, Cop=Cop, cproj=cproj,
                         nc=P.shape[1], coarse_tol=1e-2, coarse_its=12)
        key = f"13c two-grid {name.split(' (')[0]}"
        with stage(key, stages):
            th, v, rel, it = nested_eigenpair(BandedSIOp(A, M, pc, s0), v0, sig_c,
                                              tol=1e-10, inner_tol=1e-4, inner_its=30, m=16,
                                              max_outer=4, bc_mask=mask, resid_op=rop)
        rt = true_rel(A, M, th, v)
        log(f"phase 13c: TwoGridSIPC multiplicative with {name} on Navier-Stokes (a finding, not "
            f"a gate): {it} outer steps, rel {rel:.2e}, true {rt[0]:.2e}, sigma {th:.12f} "
            f"({abs(th - sig3):.1e} from phase 3's); {stages[key]['seconds']:.2f} s")
        gate_report(f"phase 13c two-grid {name}", rel, rt)
        if rel <= 1e-10 and not abs(th - sig3) <= 1e-8:
            raise RuntimeError(f"phase 13c: two-grid with {name} converged to {th}, not {sig3}")
    A_el, M_el, dofs = LinearizedNavierStokesAssembler(mp["w"], case["ctx"], 47.0,
                                                       case["bcs_pert"],
                                                       case["mesh"]).element_matrices()
    with env(LSAFW_BCSR_MEM_GB="0"), stage("13c elements", stages):
        es = EigenSolver(A, M, EigensolverConfig(num_eig=1, atol=1e-8, ncv=16))
        es.set_st_type(STType.SINVERT)
        es.set_target(TARGET)
        es.set_elements(case["ctx"], A_el, M_el, mask, dofs=dofs)
        pairs = es.solve()
    st = stages["13c elements"]
    sig_e = pairs[0][0]
    res_e = float(eigen_residuals(A, M, pairs)[0])
    s_launches = sum(v for k, v in st["launches"].items() if k.startswith("spmv"))
    log(f"phase 13c: set_elements on the 43k eigen stage (LSAFW_BCSR_MEM_GB=0): sigma "
        f"{sig_e:.12f} ({abs(sig_e - sig3):.1e} from phase 3's), residual {res_e:.1e}; "
        f"{st['seconds']:.2f} s, {es.operator.applies} applies, {s_launches} S launches, launches "
        f"{nonzero(st['launches'])}")
    if not (abs(sig_e - sig3) <= 1e-8 and res_e <= 1e-8 and s_launches == 0
            and es.operator.device_op.Mop is not None):
        raise RuntimeError(f"phase 13c: element refinement sigma {sig_e}, {s_launches} S launches")
    return out


def nested_membranes(stages: dict, fine: dict, dev) -> dict:
    """13c on the membranes: the fine 240 x 240 and coarse 60 x 60 grids at
    sigma = 19 + 0.3j, the three designs of test_eigen.py:347-503 (a
    truncated band with the additive coarse term; ``DiagSIPC``
    multiplicative, smooth_steps 2, omega 0.7; the ``galerkin_pair`` coarse
    as a bare band factor with the Galerkin sandwich apply) and the
    truncated band alone as the control.  Gates: true residual |K v - theta
    M v| / |K v| <= 1e-8 for the two-grid designs, their thetas within 1e-7
    of each other, the reported residuals true, and the control 100x worse
    or itself <= 1e-8."""
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.baseflow import point_interpolation_matrix
    from lsafw_tpu_torch.solver.eigen import (BandedSIOp, DiagSIPC, EigenSolver,
                                              EigensolverConfig, ShiftInvertOperator, STType,
                                              TwoGridSIPC, ell_of_csr, galerkin_pair,
                                              nested_eigenpair)

    sigma = MEMBRANE_SIGMA
    coarse = membrane_case(NESTED_NX[0], dev)
    K_f, M_f, mask_f = fine["K"], fine["M"], fine["mask"]
    with stage("13c membrane coarse", stages):
        sio_c = ShiftInvertOperator(coarse["K"], coarse["M"], sigma, method="banded")
        es = EigenSolver(coarse["K"], coarse["M"], EigensolverConfig(num_eig=1, atol=1e-10,
                                                                     ncv=12))
        es.set_st_type(STType.SINVERT)
        es.set_target(19.0)
        lam_c, x_c = es.solve()[0]
        P = point_interpolation_matrix(coarse["space"].node_coords, fine["space"].node_coords)
        Pd, Pc = ell_of_csr(P, device=dev)
        Cop = BCSRShiftedOp.from_csr(K_f, M_f, sigma)
        Cf = CSRMatrix(K_f.pattern, K_f.data - sigma.real * M_f.data)
        with env(LSAFW_PIVOT_MEM_GB="0"):
            plan = truncated_plan(Cf)
            trunc = tband.factor_auto(plan, Cf.data, (-sigma.imag) * M_f.data,
                                      diag_slots=K_f.pattern.diag_slots)[0]
        A_g, M_g = galerkin_pair(P, K_f, M_f)
        gplan = tband.plan_for_csr(A_g)
        blu_g = tband.factor_auto(gplan, A_g.data - sigma.real * M_g.data,
                                  (-sigma.imag) * M_g.data, diag_slots=A_g.pattern.diag_slots)[0]
        jac = DiagSIPC.from_pair(K_f, M_f, sigma)
    v0 = P @ x_c
    Ks, Ms = K_f.to_scipy(), M_f.to_scipy()
    rop = BandedSIOp(K_f, M_f, None, sigma, Cop)
    kw = dict(nc=P.shape[1], coarse_tol=1e-8, coarse_its=25)
    designs = {
        "truncated band + additive coarse": (BandedSIOp(K_f, M_f, TwoGridSIPC(
            sio_c.device_op, trunc, Pd, Pc, **kw), sigma, Cop), None),
        "DiagSIPC multiplicative": (BandedSIOp(K_f, M_f, TwoGridSIPC(
            sio_c.device_op, jac, Pd, Pc, Cop=Cop, smooth_steps=2, omega=0.7, **kw), sigma),
            rop),
        "Galerkin bare band": (BandedSIOp(K_f, M_f, TwoGridSIPC(
            blu_g, jac, Pd, Pc, Cop=Cop, sig0=sigma, smooth_steps=2, omega=0.7, **kw), sigma),
            rop),
        "control: the truncated band alone": (BandedSIOp(K_f, M_f, trunc, sigma, Cop), None),
    }
    got = {}
    for name, (op, resid_op) in designs.items():
        key = f"13c membrane {name}"
        with stage(key, stages):  # the control stalls: its outer steps cut from 15 to 6
            th, v, rel, it = nested_eigenpair(
                op, v0, lam_c, tol=1e-9, inner_tol=1e-4, inner_its=60,
                max_outer=6 if name.startswith("control") else 15, bc_mask=mask_f,
                resid_op=resid_op)
        r = np.linalg.norm(Ks @ v - th * (Ms @ v)) / np.linalg.norm(Ks @ v)
        rt = true_rel(K_f, M_f, th, v)
        got[name] = (th, r)
        log(f"phase 13c: membrane {NESTED_NX[1]}^2 / {NESTED_NX[0]}^2, {name}: theta "
            f"{th:.12f}, {it} outer steps, |K v - theta M v| / |K v| {r:.2e}, rel {rel:.2e} (true "
            f"{rt[0]:.2e}, floor {rt[1]:.1e}); {stages[key]['seconds']:.2f} s")
        gate_report(f"phase 13c membrane {name}", rel, rt)
    log(f"phase 13c: the truncated fine band: B = {plan.B} at nb = {plan.nb}; the Galerkin coarse pair "
        f"{A_g.shape[0]} rows, {A_g.pattern.nnz} entries, band B = {gplan.B}")
    ths = [got[k][0] for k in list(designs)[:3]]
    spread = max(abs(a - b) for a in ths for b in ths)
    ctrl = got["control: the truncated band alone"][1]
    best = max(got[k][1] for k in list(designs)[:3])
    if not (best <= 1e-8 and spread <= 1e-7 and (best <= 1e-2 * ctrl or ctrl <= 1e-8)):
        raise RuntimeError(f"phase 13c: membranes: worst two-grid residual {best:.1e}, theta "
                           f"spread {spread:.1e}, control {ctrl:.1e}")
    return {"membrane coarse": sio_c.device_op.blu, "membrane truncated": trunc,
            "membrane Galerkin": blu_g}


def structured_path(case, mp: dict, pmg_pc, errs: dict, dev) -> dict:
    """Phase 13 (after phase 12): 13a, 13b and 13c, each stage's launches
    read on its own and summed; host LU and the torch substitution loops
    raise.  Then G's permutes and K1/K2 on the phase's own factors (the
    11k coarse factor, the truncated 43k band, the membranes' coarse,
    truncated fine and Galerkin factors), each against its plain version."""
    import torch

    stages: dict = {}
    t0 = time.time()
    with plain_loops_forbidden():
        with stage("13a", stages):
            ops = structured_ops(dev)
            stencil_vs_s(ops, dev)
        del ops
        torch.cuda.empty_cache()
        fine = membrane_case(NESTED_NX[1], dev)
        lobpcg_path(fine, pmg_pc, stages, dev)
        factors = nested_cylinder(case, mp, stages, dev)
        factors.update(nested_membranes(stages, fine, dev))
    seconds = time.time() - t0
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in counts()}
    log(f"phase 13: {seconds:.1f} s (budget 60 s); stages "
        + ", ".join(f"{k} {st['seconds']:.1f}" for k, st in stages.items())
        + f"; launches {nonzero(launches)}")
    t0 = time.time()
    # the truncated 43k Navier-Stokes band (pivot-free, B = 2 of 7, the
    # saddle regularization) leaves U so ill-conditioned that two f32
    # backward substitutions differ in their solutions (4e-2 relative on
    # the card, where K1 agrees to 5e-8): its K2 is held by its backward
    # error; the membrane's truncated band, the same mode and B, directly
    kernels = factor_kernels([(f", {k} (phase 13c)", f) for k, f in factors.items()], errs, dev,
                             types="complex", backward=(", truncated (phase 13c)",),
                             library=True)
    log(f"phase 13: G and K1/K2 on the phase's factors, checked and timed in "
        f"{time.time() - t0:.1f} s")
    return dict(launches=launches, seconds=seconds, kernels=kernels)


# ---------------------------------------------------------------------------
# Phase 14: the command line and its I/O
# ---------------------------------------------------------------------------

MSH_REL = 6.2e-16  # write_msh's 16 significant digits, read back to the nearest double


@contextmanager
def messages(name: str):
    """The messages logged (INFO and up) by logger ``name`` and its
    children while the block runs (the CLI resets the handlers of the
    package's root logger, so ``name`` is one of its children)."""
    import logging

    seen: list = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    lg = logging.getLogger(name)
    keep, level = Keep(logging.INFO), lg.level
    lg.addHandler(keep)
    lg.setLevel(logging.INFO)
    try:
        yield seen
    finally:
        lg.removeHandler(keep)
        lg.setLevel(level)


def cli_run(argv: list, what: str) -> None:
    """``python -m lsafw_tpu_torch <argv>`` in this process; it must exit 0."""
    from lsafw_tpu_torch import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"{what}: lsafw_tpu_torch {' '.join(map(str, argv))} exited {rc}")


def _standard_host_check(As) -> dict:
    """14c's cross-check, in the check worker: scipy's ``eigs`` nearest
    TARGET of the standard problem A on one counted host LU."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from lsafw_tpu_torch.solver import eigen as teigen

    t0 = time.time()
    with host_lu_counted() as hl:
        As = As.astype(np.complex128)
        lu = teigen.SparseLU((As - TARGET * sp.identity(As.shape[0], format="csr")).tocsc())
        # ARPACK from a seeded random start, independent of the card's
        # answer; tol 1e-10 on the shift-inverted eigenvalue is a few 1e-11
        # on sigma (1e-12 took 15.9 s, 1e-10 11.8 s with ncv 20 or 40)
        v0 = np.random.default_rng(14).standard_normal(As.shape[0]).astype(np.complex128)
        sigma = spla.eigs(As, k=1, sigma=TARGET, ncv=20, tol=1e-10, return_eigenvectors=False,
                          v0=v0, OPinv=spla.LinearOperator(As.shape, matvec=lu.solve,
                                                           dtype=np.complex128))[0]
    return dict(sigma=complex(sigma), host_lu=hl["host_lu"], seconds=time.time() - t0)


def cli_path(case6: dict, p6: dict, a43, name_power: str, dev) -> dict:
    """Phase 14 (after phase 6c): the port's command line in this process
    (``lsafw_tpu_torch.cli.main``), its files in a temporary directory
    removed at the end, host LU and the torch substitution loops raising.
    14a ``write_msh`` of phase 6's production mesh and ``mesh --from-file
    --outdir --key``: the cached mesh's cells and facet tags equal phase
    6's, its vertices within ``MSH_REL``; 14b ``assemble --from-file`` with
    the production TOML files (phase 6's Newton parameters) and ``eigen
    --target=0.74j --si-method banded`` on its A.mtx, M.mtx: (A, M) against
    phase 6's (structure exact, values rel 1e-12), sigma within 1e-8 of
    phase 6's, the exported eigenvector's residual on the host from the
    files <= 1e-8, K1/K2 in phase 6's modes once per band solve, one band
    plan in the eigen stage with M taken on A's pattern; 14c
    ``EigenSolver(A, None)`` on phase 3's A at 0.74j (the pencil (A, I)):
    residual <= 1e-8, sigma within 1e-8 of scipy's ``eigs`` on one counted
    host LU, K1/K2 pivoted c64 once per band solve, S once per matvec;
    14d ``python -m lsafw_tpu_torch.diagnose`` as a subprocess: exit 0,
    the card ``nvidia-smi`` names, f64 and complex128 ok."""
    import logging
    import tempfile

    import scipy.io as sio
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from lsafw_tpu_torch.meshing.io import write_msh
    from lsafw_tpu_torch.solver import eigen as teigen
    from lsafw_tpu_torch.solver.eigen import (
        EigenSolver, EigensolverConfig, STType, eigen_residuals)
    from lsafw_tpu_torch.utils.cache import CacheStore

    stages: dict = {}
    t_all = time.time()
    cfg = PRODUCTION_CONFIG
    mesh = case6["mesh"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp, plain_loops_forbidden():
        d = Path(tmp)
        msh = d / "production.msh"
        t0 = time.time()
        write_msh(mesh, msh)
        t_write = time.time() - t0
        with stage("14a", stages):
            cli_run(["mesh", "--from-file", msh, "--outdir", d / "cache", "--key", "production"],
                    "phase 14a")
        got = CacheStore(d / "cache").load_mesh("production")
        dv = np.abs(got.vertices - mesh.vertices)
        worst = float((dv / np.maximum(np.abs(mesh.vertices), 1e-300)).max())
        log(f"phase 14a: {mesh.num_vertices} vertices, {mesh.num_cells} cells, "
            f"{int((mesh.facet_tags != 0).sum())} tagged facets; write_msh {t_write:.2f} s "
            f"({msh.stat().st_size / 1e6:.1f} MB), mesh --from-file (read, spaces, context, cache) "
            f"{stages['14a']['seconds']:.2f} s; vertices within {worst:.2e} relative (limit "
            f"{MSH_REL:.1e}: 16 significant digits)")
        if not (np.array_equal(got.cells, mesh.cells)
                and np.array_equal(got.facet_tags, mesh.facet_tags) and worst <= MSH_REL):
            raise RuntimeError(f"phase 14a: the cached mesh differs from phase 6's (vertices "
                               f"{worst:.2e} relative)")

        mats, modes = d / "mats", d / "modes"
        with stage("14b assemble", stages):
            cli_run(["assemble", "--from-file", msh, "--bc-config", cfg / "bcs.toml",
                     "--perturbation-bc-config", cfg / "bcs_perturbation.toml", "--re", "47",
                     "--ramp", "--steps", "3", "--tol", "1e-8", "--max-it", "40", "--outdir",
                     mats], "phase 14b assemble")
        with messages("lsafw_tpu_torch.ops.sparse") as said, stage("14b eigen", stages):
            cli_run(["eigen", "--matdir", mats, "--target=0.74j", "--si-method", "banded",
                     "--outdir", modes], "phase 14b eigen")
        t0 = time.time()
        files = {k: sp.csr_matrix(sio.mmread(mats / f"{k}.mtx")) for k in ("A", "M")}
        t_mmread = time.time() - t0
        for k, got in files.items():
            ref = p6[k].to_scipy()
            got.sort_indices()
            ref.sort_indices()
            same = (np.array_equal(got.indptr, ref.indptr)
                    and np.array_equal(got.indices, ref.indices))
            rel = float(np.abs(got.data - ref.data).max() / np.abs(ref.data).max()) if same else 1.0
            log(f"phase 14b: {k}.mtx ({got.nnz} entries, {(mats / f'{k}.mtx').stat().st_size / 1e6:.1f}"
                f" MB) against phase 6's: structure {'equal' if same else 'DIFFERENT'}, values "
                f"within {rel:.2e} relative (limit 1e-12)")
            if not (same and rel <= 1e-12):
                raise RuntimeError(f"phase 14b: {k}.mtx differs from phase 6's {k}")
        sigma = complex(*json.loads((modes / "eigenvalues.json").read_text())[0])
        z = np.load(modes / "eigvec_0.npz")
        x = z["re"] + 1j * z["im"]
        As, Ms = files["A"], files["M"]
        resid = float(np.linalg.norm(As @ x - sigma * (Ms @ x)) / np.linalg.norm(x))
        asm, eig = stages["14b assemble"], stages["14b eigen"]
        log(f"phase 14b: assemble {asm['seconds']:.2f} s, eigen {eig['seconds']:.2f} s (scipy "
            f"mmread of both files here {t_mmread:.2f} s); sigma = {sigma.real:+.12f}"
            f"{sigma.imag:+.12f}j, {abs(sigma - p6['sigma']):.2e} from phase 6's; residual from "
            f"the files {resid:.2e}")
        for what, st_ in (("phase 14b assemble", asm), ("phase 14b eigen", eig)):
            log_stage(what, st_)
        if abs(sigma - p6["sigma"]) > 1e-8 or not resid <= 1e-8:
            raise RuntimeError(f"phase 14b: sigma {sigma} against phase 6's {p6['sigma']}, "
                               f"residual {resid:.2e}")
        gate_stage("phase 14b assemble", asm, "pivoted.f32x1", "RealPivotedBandedLU",
                   "f64.f32x1", builds=1)
        gate_stage("phase 14b eigen", eig, "pivot_free.c64", "BandedLU", "c128.c64", builds=1)
        adopted = [m for m in said if m.startswith("M's pattern equals A's")]
        log(f"phase 14b: eigen stage plans built {eig['builds']}; {adopted}")
        if eig["builds"].get("band") != 1 or len(adopted) != 1:
            raise RuntimeError(f"phase 14b: the eigen stage built {eig['builds']} plans, M taken "
                               f"on A's pattern {len(adopted)} times (expected 1 band plan, 1)")
    logging.getLogger("lsafw_tpu_torch").handlers.clear()  # the CLI's console handler
    logging.getLogger("lsafw_tpu_torch").setLevel(logging.NOTSET)

    with plain_loops_forbidden(), stage("14c", stages):
        # atol 1e-10: at 1e-8 Krylov-Schur stops with a true residual of a few
        # 1e-9 on this standard problem (the small cylinder's: 3.4e-9)
        es = EigenSolver(a43, None, EigensolverConfig(num_eig=1, atol=1e-10, ncv=16))
        es.set_st_type(STType.SINVERT)
        es.set_target(TARGET)
        es.set_st_pc_type("banded")
        pairs = es.solve()
    sigma_c = pairs[0][0]
    resid_c = float(eigen_residuals(a43, None, pairs)[0])
    st = stages["14c"]
    op = es.operator
    log(f"phase 14c: EigenSolver(A, None) at {TARGET}: sigma = {sigma_c.real:+.12f}"
        f"{sigma_c.imag:+.12f}j, residual {resid_c:.2e}, {st['seconds']:.2f} s, pivoted "
        f"{op.pivoted}, {op.applies} applies")
    log_stage("phase 14c", st)
    if not resid_c <= 1e-8:
        raise RuntimeError(f"phase 14c: sigma {sigma_c}: residual {resid_c:.2e}")

    def gate(hc: dict) -> None:  # in the check worker, gated at the script's end
        host = hc["sigma"]
        log(f"phase 14c: scipy eigs on {hc['host_lu']} host LU in the check worker "
            f"({hc['seconds']:.2f} s): {host.real:+.12f}{host.imag:+.12f}j, "
            f"{abs(host - sigma_c):.2e} from the card's sigma")
        if abs(host - sigma_c) > 1e-8 or hc["host_lu"] != 1:
            raise RuntimeError(f"phase 14c: sigma {sigma_c} against the host's {host} on "
                               f"{hc['host_lu']} host LU")

    start_host_check("phase 14c", _standard_host_check, (a43.to_scipy(),), gate)
    gate_stage("phase 14c", st, "pivoted.c64", "PivotedBandedLU", "c128.c64", builds=1)
    if not (st["launches"]["spmv_shifted.original"] > 0 and op.M is not None
            and op.M.pattern is op.A.pattern):
        raise RuntimeError(f"phase 14c: S's shifted mode not on the (A, I) pencil: "
                           f"{nonzero(st['launches'])}")

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "lsafw_tpu_torch.diagnose"], capture_output=True,
                          text=True, timeout=300, cwd=Path(__file__).resolve().parent)
    t_diag = time.time() - t0
    report = dict(line.split(":", 1) for line in proc.stdout.splitlines() if ":" in line)
    report = {k.strip(): v.strip() for k, v in report.items()}
    card_name = name_power.split(",")[0].strip()
    log(f"phase 14d: python -m lsafw_tpu_torch.diagnose exited {proc.returncode} in {t_diag:.1f} "
        f"s: device {report.get('device')!r}, float64 {report.get('float64')!r}, complex128 "
        f"{report.get('complex128')!r}, nvcc {report.get('nvcc')!r}, built kernels "
        f"{report.get('built kernels')!r}")
    if not (proc.returncode == 0 and report.get("device") == f"{card_name} (cuda)"
            and report.get("float64") == report.get("complex128") == "ok"):
        raise RuntimeError(f"phase 14d: diagnose's report against the card {card_name!r}:\n"
                           f"{proc.stdout}\n{proc.stderr[-2000:]}")
    seconds = time.time() - t_all
    launches = {k: sum(st_["launches"][k] for st_ in stages.values()) for k in counts()}
    log(f"phase 14: {seconds:.1f} s (budget 60 s); stages "
        + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in stages.items())
        + f", 14d {t_diag:.1f}; launches {nonzero(launches)}")
    return dict(launches=launches, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 15: tensor cells, periodic pairs, elasticity, SIPG DG, from_complex_csr
# ---------------------------------------------------------------------------

DATA = Path(__file__).resolve().parent / "scripts" / "data"
PLATE_L, PLATE_H = 10.0, 1.0  # tests/benchmark/test_elasticity.py's NAFEMS FV52 plate
PLATE_E, PLATE_NU, PLATE_RHO = 200e9, 0.3, 8000.0
NAFEMS_FREQS = (45.897, 109.440, 109.440, 167.890, 193.590, 206.190, 206.190)
PLATE_TARGET = (2 * np.pi * 40.0) ** 2  # test_elasticity.py's solve_modes: around mode 1
PLATE_NEV, PLATE_NCV = 12, 40  # scripts/dev_nafems_study.py's solve_modes(asm, num=12)
PLATE_LADDER = ((8, 2), (12, 3), (16, 4))  # scripts/data/nafems_study.json's rungs
HEX_PLATE = (32, 6)  # the reference's 32 x 32 x 6 Q1 hexahedra (scripts/dev_nafems_study.py:8-9)
FD_STEP = 40.0  # test_density_sensitivity_analytical_and_fd's centred step in rho
QUAD_NX = (32, 64)  # the distorted unit square's Q2 membrane (64, 128 cut for the script's time)
QUAD_TARGET = 40.0  # nearest four: 5 pi^2 (twice), 2 pi^2, 8 pi^2
CHANNEL_NX, CHANNEL_RE = 64, 100.0  # test_q2_quads.py's Poiseuille channel, 37,507 DOFs
PERIODIC_NX, PERIODIC_TARGET = 128, 45.0  # six nearest: pi^2, 4 pi^2, 5 pi^2 x2, 8 pi^2 x2
DG_NX, DG_ETA, DG_SIGMA = (8, 12), 12.0, 25.0  # test_dg_3d_box_eigenvalues' (16 cut to 12)


def rel_residuals(A, M, pairs) -> np.ndarray:
    """||A x - lambda M x|| / (|lambda| ||M x||) of each pair (host scipy):
    free of the units of the pencil and of x's norm.  (The absolute
    ||A x - lambda M x|| / ||x|| of the Navier-Stokes phases is ||K|| eps,
    about 1e-3, for the plates, and 1e-8 relative to |lambda| + 1 is below
    what Krylov-Schur at the benchmark's atol 1e-9 leaves on modes far from
    the shift.)"""
    As, Ms = A.to_scipy(), M.to_scipy()
    out = []
    for lam, x in pairs:
        x = np.asarray(x, dtype=np.complex128)
        Mx = Ms @ x
        out.append(np.linalg.norm(As @ x - lam * Mx) / (abs(lam) * np.linalg.norm(Mx)))
    return np.asarray(out)


def si_stage(A, M, target: float, nev: int, ncv: int, atol: float, name: str, stages: dict):
    """``EigenSolver`` (SINVERT, the banded st_pc) as stage ``name``:
    (pairs, solver)."""
    import torch
    from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType

    with stage(name, stages):
        es = EigenSolver(A, M, EigensolverConfig(num_eig=nev, atol=atol, ncv=ncv))
        es.set_st_type(STType.SINVERT)
        es.set_target(target)
        pairs = es.solve()
        torch.cuda.synchronize()
    return pairs, es


def factor_line(what: str, es) -> str:
    """The factor ``factor_auto`` picked at the stage's real shift, and its
    calibration."""
    op = es.operator
    trial = "" if op.trial_its is None else f", trial GCR {op.trial_its} iterations"
    return (f"{what}: {type(op.device_op.blu).__name__} (pivoted {op.pivoted}, B = "
            f"{op.device_op.blu.B}), factor {op.factor_seconds:.3f} s, contraction {op.rho:.2e}"
            f"{trial}, refinement cap {op.refine_its}; {es.result.iterations} applies, "
            f"{es.result.restarts} Krylov-Schur cycles; {acceptance_text(acceptance(es))}")


def plate_mesh(n: int, nz: int, hexes: bool = False):
    """test_elasticity.py's build_plate: the 10 x 10 x 1 box, u_z pinned on
    the four side faces; P2 tetrahedra or Q1 hexahedra."""
    from lsafw_tpu_torch.fem.spaces import make_vector_space
    from lsafw_tpu_torch.meshing.mesh import CellType, box_mesh
    from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
    from lsafw_tpu_torch.models import elasticity as el

    mesh = box_mesh((0, 0, 0), (PLATE_L, PLATE_L, PLATE_H), n, n, nz,
                    CellType.HEXAHEDRON if hexes else CellType.TETRAHEDRON)

    def marker(x):
        out = np.full(x.shape[0], 9, dtype=np.int32)
        out[np.isclose(x[:, 0], 0.0)] = 1
        out[np.isclose(x[:, 0], PLATE_L)] = 2
        out[np.isclose(x[:, 1], 0.0)] = 3
        out[np.isclose(x[:, 1], PLATE_L)] = 4
        return out

    mark_boundary_facets(mesh, marker)
    space = make_vector_space(mesh, "q1") if hexes else el.define_space(mesh, degree=2)
    bcs = el.define_bcs(mesh, space, axis_normal=(el.AxisNormalBc(tags=(1, 2), axis=2),
                                                  el.AxisNormalBc(tags=(3, 4), axis=2)))
    return space, bcs


def plate_modes(space, bcs, dev, name: str, stages: dict, *, rho: float = PLATE_RHO,
                nev: int = PLATE_NEV) -> dict:
    """Assembly and the banded shift-invert of one plate as stages
    ``name`` + " assemble" / " eigen", then ``process_modes`` (the
    rigid-body modes, at 0 Hz, dropped below 0.2 Hz as the benchmark does)."""
    from lsafw_tpu_torch.models import elasticity as el

    with stage(name + " assemble", stages):
        asm = el.ElasticityEigenAssembler(space, young_modulus=PLATE_E, poisson_ratio=PLATE_NU,
                                          density=rho, bcs=bcs, device=dev)
        M, K = asm.assemble_eigensystem()
    pairs, es = si_stage(K, M, PLATE_TARGET, nev, PLATE_NCV, 1e-9, name + " eigen", stages)
    return dict(asm=asm, K=K, M=M, es=es, modes=el.process_modes(pairs, K, M, skip_below_hz=0.2))


def gate_plate(what: str, p: dict, st: dict) -> np.ndarray:
    """The seven lowest modes: residuals <= 1e-8 (:func:`rel_residuals`),
    mass normalisation, Rayleigh quotients within 1e-6 of omega_n^2, the
    109.44 Hz pair within 2%; the eigen stage's launches
    (:func:`gate_eigen_stage`).  Returns the seven frequencies."""
    modes = p["modes"]
    if len(modes) < 7:
        raise RuntimeError(f"{what}: {len(modes)} modes above 0.2 Hz, 7 expected: "
                           f"{[m.fn for m in modes]}")
    seven = modes[:7]
    f = np.array([m.fn for m in seven])
    pairs = [(complex(m.value), np.asarray(m.function, dtype=np.complex128)) for m in seven]
    res = rel_residuals(p["K"], p["M"], pairs)
    rq = max(abs(m.rq_omega2 - m.wn**2) / m.wn**2 for m in seven)
    nafems = np.abs(f - np.array(NAFEMS_FREQS)) / np.array(NAFEMS_FREQS)
    log(f"{what}: f = {[f'{x:.10f}' for x in f]} Hz; residuals max {res.max():.2e}; Rayleigh "
        f"quotients {rq:.2e}; NAFEMS errors {[f'{x:.4f}' for x in nafems]}; pair 2/3 "
        f"{abs(f[1] - f[2]) / f[1]:.2e}")
    log(factor_line(what, p["es"]))
    if not (res.max() <= 1e-8 and all(m.mass_chk for m in seven) and rq <= 1e-6
            and abs(f[1] - f[2]) / f[1] < 0.02):
        raise RuntimeError(f"{what}: residuals {res}, mass_chk {[m.mass_chk for m in seven]}, "
                           f"Rayleigh quotients {rq:.2e}, pair {f[1]}, {f[2]}")
    gate_eigen_stage(f"{what} eigen", st, REAL_CLASSES)
    return f


def richardson(freqs: list, ns: tuple) -> list:
    """scripts/dev_nafems_study.py's per-mode extrapolation f(h) = f_inf +
    c h^p on the three rungs (h = 1/n), p by bisection in (0.5, 4)."""
    h = np.array([1.0 / n for n in ns])
    out = []
    for k in range(7):
        f = np.array([row[k] for row in freqs])
        r01, r12 = f[0] - f[1], f[1] - f[2]
        if abs(r12) < 1e-12 or r01 * r12 <= 0:
            out.append(float(f[-1]))
            continue
        target = r01 / r12

        def ratio(p):
            return (h[0] ** p - h[1] ** p) / (h[1] ** p - h[2] ** p)

        lo, hi = 0.5, 4.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if (ratio(mid) - target) * (ratio(lo) - target) <= 0:
                hi = mid
            else:
                lo = mid
        p = 0.5 * (lo + hi)
        out.append(float(f[2] - r12 / (h[1] ** p - h[2] ** p) * h[2] ** p))
    return out


def _plate_host_check(Ks, Ms) -> dict:
    """15b's cross-check, in the check worker: scipy's shift-invert
    ``eigsh`` at the plate's target on one counted host LU, from a seeded
    start."""
    import scipy.sparse.linalg as spla
    from lsafw_tpu_torch.solver import eigen as teigen

    t0 = time.time()
    with host_lu_counted() as hl:
        lu = teigen.SparseLU((Ks - PLATE_TARGET * Ms).tocsc())
        v0 = np.random.default_rng(15).standard_normal(Ks.shape[0])
        lam = spla.eigsh(Ks, k=PLATE_NEV, M=Ms, sigma=PLATE_TARGET, ncv=PLATE_NCV, tol=1e-12,
                         v0=v0, return_eigenvectors=False,
                         OPinv=spla.LinearOperator(Ks.shape, matvec=lu.solve, dtype=np.float64))
    return dict(lam=lam, host_lu=hl["host_lu"], seconds=time.time() - t0)


def plates_path(dev, stages: dict, keep: dict) -> dict:
    """15a, the NAFEMS FV52 ladder on P2 tetrahedra (the study's rungs): the
    seven frequencies of each within rel 1e-7 of nafems_study.json's, the
    Richardson limit within 1e-6 of its f_inf, at 16 x 4 every NAFEMS error
    under 5%; the (8, 2) plate's density sensitivity against -lambda/rho
    (1e-3) and the centred difference at rho +- 40 (2e-3).  15b, the
    reference's 32 x 32 x 6 Q1 hexahedra: residuals, mass normalisation,
    and the seven frequencies within 1e-8 of scipy's shift-invert on one
    counted host LU from a seeded start.  Each plate's eigen stage: K1/K2
    once per band solve, in the mode factor_auto picked."""
    import torch
    import scipy.sparse.linalg as spla
    from lsafw_tpu_torch.models import elasticity as el
    from lsafw_tpu_torch.solver import eigen as teigen

    study = json.loads((DATA / "nafems_study.json").read_text())
    freqs = []
    for i, (n, nz) in enumerate(PLATE_LADDER):
        what = f"phase 15a plate {n}x{n}x{nz}"
        rung = study["ladder"][i]
        t0 = time.time()
        space, bcs = plate_mesh(n, nz)
        t_mesh = time.time() - t0
        p = plate_modes(space, bcs, dev, f"15a {n}x{nz}", stages)
        log(f"{what}: {space.num_dofs} DOFs (study: {rung['ndofs']}), mesh and space {t_mesh:.2f} s "
            f"(host), assemble {stages[f'15a {n}x{nz} assemble']['seconds']:.2f} s, eigen "
            f"{stages[f'15a {n}x{nz} eigen']['seconds']:.2f} s")
        log_stage(f"{what} eigen", stages[f"15a {n}x{nz} eigen"])
        f = gate_plate(what, p, stages[f"15a {n}x{nz} eigen"])
        rel = np.abs(f - np.array(rung["freqs"])) / np.array(rung["freqs"])
        log(f"{what}: against nafems_study.json's rung: rel {rel.max():.2e}")
        if space.num_dofs != rung["ndofs"] or not rel.max() <= 1e-7:
            raise RuntimeError(f"{what}: {space.num_dofs} DOFs, frequencies {f} against the "
                               f"study's {rung['freqs']} (rel {rel.max():.2e} > 1e-7)")
        freqs.append(f)
        if (n, nz) == PLATE_LADDER[0]:
            first = dict(space=space, bcs=bcs, p=p)
        if (n, nz) == PLATE_LADDER[-1]:
            nafems = np.abs(f - np.array(NAFEMS_FREQS)) / np.array(NAFEMS_FREQS)
            if not nafems.max() < 0.05:
                raise RuntimeError(f"{what}: NAFEMS errors {nafems} (the 5% gate)")
            keep["plate"] = p["es"]
        del p
    finf = richardson(freqs, tuple(n for n, _ in PLATE_LADDER))
    rel_inf = np.abs(np.array(finf) - np.array(study["f_inf"])) / np.array(study["f_inf"])
    log(f"phase 15a: Richardson f_inf {[f'{x:.8f}' for x in finf]} Hz, rel {rel_inf.max():.2e} "
        f"from nafems_study.json's")
    if not rel_inf.max() <= 1e-6:
        raise RuntimeError(f"phase 15a: f_inf {finf} against {study['f_inf']}")

    # density sensitivity on the first rung (test_density_sensitivity_analytical_and_fd)
    p0 = first["p"]
    m0 = p0["modes"][0]
    lam0 = m0.wn**2
    d_lam = p0["asm"].compute_sensitivity(torch.as_tensor(m0.function, device=dev), lam0,
                                          param="rho", dparam=1.0)

    def lam_of_rho(rho):
        q = plate_modes(first["space"], first["bcs"], dev, f"15a FD rho={rho:g}", stages,
                        rho=rho, nev=1)
        return q["modes"][0].wn**2

    fd = el.compute_density_sensitivity_fd(lam_of_rho, PLATE_RHO, step=FD_STEP)
    dfn = el.process_sensitivity(d_lam, m0.fn)
    log(f"phase 15a sensitivity: d lambda / d rho = {d_lam:.10e}, -lambda/rho "
        f"{-lam0 / PLATE_RHO:.10e}, centred FD (step {FD_STEP:g}) {fd:.10e}; d f_n = {dfn:.4e} Hz")
    if not (abs(d_lam + lam0 / PLATE_RHO) <= 1e-3 * lam0 / PLATE_RHO
            and abs(d_lam - fd) <= 2e-3 * abs(fd) and dfn < 0):
        raise RuntimeError(f"phase 15a sensitivity: {d_lam} against {-lam0 / PLATE_RHO} and the "
                           f"FD {fd}")
    for k in ("15a FD rho=7960", "15a FD rho=8040"):
        gate_eigen_stage(f"phase {k} eigen", stages[k + " eigen"], REAL_CLASSES)
    del first, p0

    # 15b: the reference's Q1 hexahedra
    what = f"phase 15b Q1 hex plate {HEX_PLATE[0]}x{HEX_PLATE[0]}x{HEX_PLATE[1]}"
    space, bcs = plate_mesh(*HEX_PLATE, hexes=True)
    p = plate_modes(space, bcs, dev, "15b", stages)
    log(f"{what}: {space.num_dofs} DOFs, assemble {stages['15b assemble']['seconds']:.2f} s, "
        f"eigen {stages['15b eigen']['seconds']:.2f} s")
    log_stage(f"{what} eigen", stages["15b eigen"])
    f = gate_plate(what, p, stages["15b eigen"])

    def gate(hc: dict) -> None:  # in the check worker, gated at phase 15's end
        host = np.sort(np.sqrt(hc["lam"][hc["lam"] > (2 * np.pi * 0.2) ** 2]) / (2 * np.pi))[:7]
        rel = np.abs(f - host) / host
        log(f"{what}: scipy eigsh on {hc['host_lu']} host LU in the check worker "
            f"({hc['seconds']:.2f} s): {[f'{x:.10f}' for x in host]} Hz, rel {rel.max():.2e}; "
            f"NAFEMS errors "
            f"{[f'{x:.4f}' for x in np.abs(f - np.array(NAFEMS_FREQS)) / np.array(NAFEMS_FREQS)]} "
            f"(logged: no record to gate against)")
        if hc["host_lu"] != 1 or not rel.max() <= 1e-8:
            raise RuntimeError(f"{what}: frequencies {f} against the host's {host} on "
                               f"{hc['host_lu']} host LU")

    start_host_check("phase 15b", _plate_host_check, (p["K"].to_scipy(), p["M"].to_scipy()),
                     gate)
    keep["hex"] = p["es"]
    return dict(freqs=freqs, f_inf=finf, hex=f, sensitivity=d_lam, fd=fd)


def distorted_square(n: int):
    """test_nonaffine.py's unit square of n x n quads, interior vertices
    moved by a smooth field that vanishes on the boundary."""
    from lsafw_tpu_torch.meshing.mesh import CellType, Mesh, rectangle_mesh

    mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, cell_type=CellType.QUADRILATERAL)
    v = mesh.vertices.copy()
    x, y = v[:, 0], v[:, 1]
    v[:, 0] = x + 0.06 * np.sin(np.pi * x) * np.sin(np.pi * y)
    v[:, 1] = y - 0.05 * np.sin(np.pi * x) * np.sin(np.pi * y)
    return Mesh(v, mesh.cells, CellType.QUADRILATERAL)


def channel_case(n: int, dev):
    """test_q2_quads.py's channel on n x n quads: Q2/Q1, no-slip walls,
    Poiseuille 4y(1 - y) at x = 0, do-nothing at x = 1."""
    from lsafw_tpu_torch.config import BoundaryConditionsConfig
    from lsafw_tpu_torch.fem.assembly import AssemblyContext
    from lsafw_tpu_torch.fem.bcs import define_bcs
    from lsafw_tpu_torch.fem.spaces import define_spaces
    from lsafw_tpu_torch.meshing.mesh import CellType, rectangle_mesh
    from lsafw_tpu_torch.meshing.tags import facets_with_marker, mark_boundary_facets

    mesh = rectangle_mesh((0, 0), (1.0, 1.0), n, n, cell_type=CellType.QUADRILATERAL)

    def marker(x):
        out = np.full(x.shape[0], 2, dtype=np.int32)
        out[np.isclose(x[:, 1], 0.0) | np.isclose(x[:, 1], 1.0)] = 4
        out[np.isclose(x[:, 0], 0.0)] = 1
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    bcs = define_bcs(mesh, spaces, [BoundaryConditionsConfig(marker=4, type="dirichlet_velocity",
                                                             value=(0.0, 0.0))])
    inlet = spaces.velocity.dofs_on_facets(facets_with_marker(mesh, 1))
    y = spaces.velocity.dof_coords[inlet][:, 1]
    bcs.dirichlet_mask[inlet] = True
    bcs.dirichlet_values[inlet] = np.where(inlet % 2 == 0, 4.0 * y * (1.0 - y), 0.0)
    return mesh, spaces, bcs, AssemblyContext.build(spaces, device=dev)


def gate_poiseuille(what: str, spaces, w, re: float) -> None:
    """Velocity against 4y(1 - y) within 1e-8, the pressure slope -8/Re
    within rtol 1e-6."""
    u, p = spaces.split(np.asarray(w))
    y = spaces.velocity.node_coords[:, 1]
    err = float(np.abs(u - np.stack([4 * y * (1 - y), 0 * y], axis=1)).max())
    slope = float(np.polyfit(spaces.pressure.node_coords[:, 0], p, 1)[0])
    log(f"{what}: velocity {err:.2e} from 4y(1 - y), pressure slope {slope:.10f} (-8/Re = "
        f"{-8.0 / re:.10f}, rel {abs(slope + 8.0 / re) / (8.0 / re):.2e})")
    if not (err <= 1e-8 and abs(slope + 8.0 / re) <= 1e-6 * 8.0 / re):
        raise RuntimeError(f"{what}: velocity {err:.2e}, slope {slope} against {-8.0 / re}")


def tensor_path(dev, stages: dict, keep: dict) -> dict:
    """15c: the Q2 membrane on the distorted unit square at QUAD_NX (the
    error at the finer at least 8x smaller, residuals 1e-8); the Q2/Q1
    Poiseuille channel (the banded Stokes solve at Re = 1, then the ramped
    banded Newton to Re = 100: Poiseuille within 1e-8, the pressure slope
    -8/Re within 1e-6); the P2 membrane on the unit square with x = 0
    paired to x = 1 (Dirichlet on y = 0, 1; K and M folded): the six
    eigenvalues nearest 45 within rel 1e-6 of 4 pi^2 m^2 + pi^2 n^2."""
    import torch
    from lsafw_tpu_torch.fem.assembly import (
        SpaceContext, dirichlet_matrix_data, mass_scalar, stiffness_scalar)
    from lsafw_tpu_torch.fem.bcs import (
        apply_periodic_constraints_matrix, compute_periodic_dof_pairs)
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import unit_square
    from lsafw_tpu_torch.meshing.tags import facets_with_marker, mark_boundary_facets
    from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
    from lsafw_tpu_torch.models.navier_stokes import StokesAssembler
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver.band import plan_for_csr
    from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
    from lsafw_tpu_torch.solver.newton import banded_solve

    out: dict = {}
    exact = np.pi**2 * np.array([2.0, 5.0, 5.0, 8.0])
    errs = {}
    for n in QUAD_NX:
        what = f"phase 15c Q2 membrane, distorted {n}x{n}"
        t0 = time.time()
        mesh = distorted_square(n)
        with stage(f"15c quad {n} assemble", stages):
            K, M, _ = assemble_membrane_evp(mesh, family="q2", device=dev)
        pairs, es = si_stage(K, M, QUAD_TARGET, 4, 20, 1e-10, f"15c quad {n} eigen", stages)
        lam = np.sort([p[0].real for p in pairs])
        res = rel_residuals(K, M, pairs)
        errs[n] = float((np.abs(lam - exact) / exact).max())
        log(f"{what}: {K.shape[0]} DOFs, {time.time() - t0:.2f} s; lambda {lam.tolist()}, rel "
            f"error {errs[n]:.3e}, residuals max {res.max():.2e}")
        log(factor_line(what, es))
        log_stage(f"{what} eigen", stages[f"15c quad {n} eigen"])
        if not res.max() <= 1e-8:
            raise RuntimeError(f"{what}: residuals {res}")
        gate_eigen_stage(f"{what} eigen", stages[f"15c quad {n} eigen"], REAL_CLASSES)
        del K, M, es
    ratio = errs[QUAD_NX[0]] / errs[QUAD_NX[1]]
    log(f"phase 15c Q2 membrane: error {QUAD_NX[0]} / {QUAD_NX[1]} = {ratio:.2f} (at least 8)")
    if not ratio >= 8.0:
        raise RuntimeError(f"phase 15c Q2 membrane: errors {errs}, ratio {ratio:.2f} < 8")
    out["quad_errors"] = errs

    what = f"phase 15c Q2/Q1 channel {CHANNEL_NX}x{CHANNEL_NX}"
    t0 = time.time()
    mesh, spaces, bcs, ctx = channel_case(CHANNEL_NX, dev)
    log(f"{what}: {spaces.num_dofs} DOFs, case {time.time() - t0:.2f} s (host)")
    with stage("15c Stokes", stages):
        A, b = StokesAssembler(ctx, mesh, bcs, re=1.0).get_matrix_forms()
        res = banded_solve(A, b, plan_for_csr(A, real=True), tol=1e-13)
        torch.cuda.synchronize()
    log_stage(f"{what} Stokes", stages["15c Stokes"])
    if not res.converged:
        raise RuntimeError(f"{what}: the banded Stokes solve reached {res.residual:.2e}")
    gate_class(f"{what} Stokes", stages["15c Stokes"], ("RealPivotedBandedLU",), builds=1)
    gate_poiseuille(f"{what} Stokes (Re = 1)", spaces, res.x.cpu().numpy(), 1.0)
    with last_newton_factor() as last, stage("15c Newton", stages):
        solver = BaseFlowSolver(ctx, mesh, bcs, re=CHANNEL_RE)
        w = solver.solve(ramp=True, steps=3, tol=1e-10, max_it=20, linear_solver="banded")
        torch.cuda.synchronize()
    log_stage(f"{what} Newton", stages["15c Newton"])
    gate_baseflow(f"{what} Newton", solver, stages["15c Newton"])
    gate_class(f"{what} Newton", stages["15c Newton"], ("RealPivotedBandedLU",), builds=1)
    gate_poiseuille(f"{what} Newton (Re = {CHANNEL_RE:g})", spaces, w, CHANNEL_RE)
    J = solver_jacobian(ctx, mesh, bcs, w)
    keep["channel"] = (last.pop("factor"), J)
    del A, b, res, solver, ctx

    what = f"phase 15c periodic P2 membrane {PERIODIC_NX}x{PERIODIC_NX}"
    t0 = time.time()
    mesh = unit_square(PERIODIC_NX)

    def marker(x):
        out_ = np.full(x.shape[0], 3, dtype=np.int32)
        out_[np.isclose(x[:, 0], 0.0)] = 1
        out_[np.isclose(x[:, 0], 1.0)] = 2
        return out_

    mark_boundary_facets(mesh, marker)
    space = make_scalar_space(mesh, "p2")
    mask = np.zeros(space.num_dofs, dtype=bool)
    mask[space.nodes_on_facets(facets_with_marker(mesh, 3))] = True
    pairs_p = compute_periodic_dof_pairs(space, mesh, 1, 2)
    t_host = time.time() - t0
    with stage("15c periodic assemble", stages):
        ctx = SpaceContext.build(space, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        K = CSRMatrix(ctx.pattern, dirichlet_matrix_data(
            ctx.pattern, ctx.scatter(stiffness_scalar(ctx)).data, mask_t, 1.0))
        M = CSRMatrix(ctx.pattern, dirichlet_matrix_data(
            ctx.pattern, ctx.scatter(mass_scalar(ctx)).data, mask_t, 0.0))
        torch.cuda.synchronize()
    t1 = time.time()
    Kf = apply_periodic_constraints_matrix(K, pairs_p)
    Mf = apply_periodic_constraints_matrix(M, pairs_p)
    t_fold = time.time() - t1
    pairs, es = si_stage(Kf, Mf, PERIODIC_TARGET, 6, 30, 1e-10, "15c periodic eigen", stages)
    lam = np.sort([p[0].real for p in pairs])
    want = np.sort(np.pi**2 * np.array([1.0, 4.0, 5.0, 5.0, 8.0, 8.0]))
    rel = np.abs(lam - want) / want
    res = rel_residuals(Kf, Mf, pairs)
    log(f"{what}: {space.num_dofs} DOFs, {pairs_p[0].size} periodic pairs, mesh, space and pairs "
        f"{t_host:.2f} s (host), the fold of K and M {t_fold:.2f} s (host scipy); lambda "
        f"{lam.tolist()}, rel {rel.max():.2e} from pi^2 (1, 4, 5, 5, 8, 8), residuals max "
        f"{res.max():.2e}")
    log(factor_line(what, es))
    log_stage(f"{what} eigen", stages["15c periodic eigen"])
    if not (rel.max() <= 1e-6 and res.max() <= 1e-8):
        raise RuntimeError(f"{what}: lambda {lam} against {want} (rel {rel.max():.2e}), "
                           f"residuals {res}")
    gate_eigen_stage(f"{what} eigen", stages["15c periodic eigen"], REAL_CLASSES)
    out["periodic"] = lam
    return out


def solver_jacobian(ctx, mesh, bcs, w):
    """The Newton Jacobian at ``w`` (the channel's S row is timed on it)."""
    from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler

    return StationaryNavierStokesAssembler(ctx, mesh, bcs).jacobian(w, CHANNEL_RE)


def dg_and_band_path(dev, stages: dict) -> dict:
    """15d: SIPG DG on ``unit_cube`` at DG_NX (eta = 12, SINVERT at 25): the
    two lowest within rel 5e-2 of pi^2 (l^2 + m^2 + n^2), the finer
    closer, residuals 1e-8; the 43k complex operator of
    ``scripts/data/C43k_sig074.npz`` through ``PivotedBandedLU`` and
    ``BandedLU.from_complex_csr`` (plan on the host, factor on the card), a
    seeded right-hand side solved by GCR refinement (S's shifted mode on C
    = A - 1j M, A = Re C, M = -Im C): the true relative residual, by scipy
    on the host, <= 1e-10; K1/K2 once per band solve."""
    import torch
    import scipy.sparse as sp
    from lsafw_tpu_torch.meshing.mesh import unit_cube
    from lsafw_tpu_torch.models.dg import assemble_dg_poisson
    from lsafw_tpu_torch.models.membrane import analytic_eigenvalues_3d
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp
    from lsafw_tpu_torch.ops.sparse import CSRMatrix
    from lsafw_tpu_torch.solver import band as tband
    from lsafw_tpu_torch.solver.eigen import BandedSIOp, banded_solve_raw

    out: dict = {}
    want = analytic_eigenvalues_3d(1.0, 1.0, 1.0, 2)
    errs = {}
    for n in DG_NX:
        what = f"phase 15d DG unit_cube({n})"
        t0 = time.time()
        mesh = unit_cube(n)
        with stage(f"15d DG {n} assemble", stages):
            K, M = assemble_dg_poisson(mesh, eta=DG_ETA, device=dev)
        pairs, es = si_stage(K, M, DG_SIGMA, 2, 20, 1e-10, f"15d DG {n} eigen", stages)
        lam = np.sort([p[0].real for p in pairs])
        rel = np.abs(lam - want) / want
        res = rel_residuals(K, M, pairs)
        errs[n] = float(rel.max())
        log(f"{what}: {K.shape[0]} DOFs, {time.time() - t0:.2f} s (assembly on the host "
            f"{stages[f'15d DG {n} assemble']['seconds']:.2f} s); lambda {lam.tolist()}, rel "
            f"{rel.tolist()} from pi^2 (3, 6), residuals max {res.max():.2e}")
        log(factor_line(what, es))
        log_stage(f"{what} eigen", stages[f"15d DG {n} eigen"])
        if not (rel.max() < 5e-2 and res.max() <= 1e-8):
            raise RuntimeError(f"{what}: lambda {lam} against {want}, residuals {res}")
        gate_eigen_stage(f"{what} eigen", stages[f"15d DG {n} eigen"], REAL_CLASSES)
        del K, M, es
    if not errs[DG_NX[1]] < errs[DG_NX[0]]:
        raise RuntimeError(f"phase 15d DG: errors {errs}: the finer is not closer")
    out["dg_errors"] = errs

    d = np.load(DATA / "C43k_sig074.npz")
    C = sp.csr_matrix((d["data"], d["indices"], d["indptr"]), shape=tuple(d["shape"]))
    C.sort_indices()
    A = CSRMatrix.from_scipy(sp.csr_matrix((C.data.real, C.indices, C.indptr), shape=C.shape),
                             device=dev)
    Mneg = CSRMatrix(A.pattern, torch.as_tensor(-C.data.imag, device=dev))
    rng = np.random.default_rng(15)
    bh = rng.standard_normal(C.shape[0]) + 1j * rng.standard_normal(C.shape[0])
    b = torch.as_tensor(bh, device=dev)
    out["C43k"] = {}
    for cls, key, delta in (("PivotedBandedLU", "pivoted.c64", 0.0),
                            ("BandedLU", "pivot_free.c64", 1e-7)):
        what = f"phase 15d {cls}.from_complex_csr (C43k_sig074.npz)"
        with stage(f"15d {cls}", stages):
            t0 = time.time()
            lu = getattr(tband, cls).from_complex_csr(C, delta=delta, device=dev)
            torch.cuda.synchronize()
            t_factor = time.time() - t0
            op = BandedSIOp(A, Mneg, lu, 1j, BCSRShiftedOp.from_csr(A, Mneg, 1j))
            x = banded_solve_raw(op, b, tol=1e-11, max_its=60)
            torch.cuda.synchronize()
        st = stages[f"15d {cls}"]
        xh = x.cpu().numpy()
        true = float(np.linalg.norm(C @ xh - bh) / np.linalg.norm(bh))
        log(f"{what}: n = {C.shape[0]}, B = {lu.B}, plan and factor {t_factor:.2f} s (the plan "
            f"on the host), {st['solves'].get(cls, 0)} band solves; true relative residual "
            f"{true:.2e} (scipy, on the host)")
        log_stage(what, st)
        if not true <= 1e-10:
            raise RuntimeError(f"{what}: true relative residual {true:.2e} > 1e-10")
        gate_stage(what, st, key, cls, "c128.c64", builds=1)
        out["C43k"][cls] = dict(residual=true, factor_s=t_factor)
        del lu, op, x
    return out


def phase15_path(dev, errs: dict) -> dict:
    """Phase 15: tensor-product cells, periodic pairs, elasticity with the
    NAFEMS FV52 plate, SIPG DG and ``from_complex_csr`` on the card (15a
    and 15b :func:`plates_path`, 15c :func:`tensor_path`, 15d
    :func:`dg_and_band_path`), host LU and the torch substitution loops
    raising; each stage's launches read on its own and summed.  Then K1/K2
    on the 16 x 4 plate's, the Q1-hex plate's and the channel's factors
    and S at their shapes, each against its plain version."""
    import torch
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp

    stages: dict = {}
    keep: dict = {}
    t0 = time.time()
    with plain_loops_forbidden():
        p15 = plates_path(dev, stages, keep)
        torch.cuda.empty_cache()
        p15.update(tensor_path(dev, stages, keep))
        torch.cuda.empty_cache()
        p15.update(dg_and_band_path(dev, stages))
    finish_host_checks("phase 15b")
    seconds = time.time() - t0
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in counts()}
    solves: dict = {}
    for st in stages.values():
        for k, v in st["solves"].items():
            solves[k] = solves.get(k, 0) + v
    peak = max(st["peak_gb"] for st in stages.values())
    log(f"phase 15: {seconds:.1f} s (budget 60 s); stages "
        + ", ".join(f"{k} {st['seconds']:.2f}" for k, st in stages.items())
        + f"; peak device memory {peak:.2f} GB; band solves {solves}; host LU 1 (15b's "
        f"counted cross-check); launches {nonzero(launches)}")
    t1 = time.time()
    plate, hexes = keep["plate"].operator, keep["hex"].operator
    factor, J = keep["channel"]
    kernels = band_kernels([(", 16x4 P2 plate (phase 15a)", plate.device_op.blu),
                            (", 32x32x6 Q1 hex plate (phase 15b)", hexes.device_op.blu),
                            (", 64x64 Q2/Q1 channel Newton (phase 15c)", factor)], errs, dev,
                           plain_reps=1)
    for label, op in ((", 16x4 P2 plate (phase 15a)", plate),
                      (", 32x32x6 Q1 hex plate (phase 15b)", hexes)):
        kernels += spmv_timed(op.device_op.Cop, op.A, op.M, dev, label,
                              modes=("shifted", "shifted_real", "mass"))
    kernels += spmv_timed(BCSRShiftedOp.from_csr(J, J, 0.0), J, J, dev,
                          ", 64x64 Q2/Q1 channel Jacobian (phase 15c)", modes=("real",))
    log(f"phase 15: K1/K2 and S on the phase's factors and operators, checked and timed in "
        f"{time.time() - t1:.1f} s")
    return dict(launches=launches, seconds=seconds, kernels=kernels, results=p15)


# ---------------------------------------------------------------------------
# Phase 16: scale-out on torch.distributed
# ---------------------------------------------------------------------------

P16_SPIKES = ("exact", "truncated")  # 16b, then 16c, in the same two ranks
P16_RANKS = 2
P16_CHUNK = 4  # scripts/dev_sharded_pipeline.py:258-260's chunk; the port's nb (band_nb())
P16_TIMEOUT = 300.0  # the ranks' wait (a hung collective fails the phase, not the script's limit)
SHARDED_RECORD = DATA / "sharded_pipeline_43k.json"  # the reference's 8-device 43k record


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def gloo_probe(dev) -> dict:
    """Which gloo collectives take a CUDA tensor as they are (the port
    stages the others through the host, ``parallel/collectives.py``):
    each the port uses tried once on every rank, f64 and complex128."""
    import torch
    import torch.distributed as dist

    out = {}
    for name in ("all_reduce", "all_gather"):
        for dt in (torch.float64, torch.complex128):
            t = torch.ones(4, dtype=dt, device=dev)
            try:
                if name == "all_reduce":
                    dist.all_reduce(t)
                else:
                    dist.all_gather([torch.empty_like(t) for _ in range(dist.get_world_size())], t)
                out[f"{name}.{str(dt).split('.')[-1]}"] = "native"
            except Exception as e:  # noqa: BLE001  (what gloo refuses is the finding)
                out[f"{name}.{str(dt).split('.')[-1]}"] = f"refused: {str(e).splitlines()[0][:90]}"
    return out


@contextmanager
def collective_seconds(dev):
    """Wall seconds and calls of the port's collectives while the block
    runs; the stream is synchronised (untimed) before each, so that the
    kernels queued before it are not counted as its time."""
    from lsafw_tpu_torch.parallel import collectives, sharded
    from lsafw_tpu_torch.solver import band_sharded

    seen = {"calls": 0, "seconds": 0.0}
    sites = [(collectives, "all_reduce"), (collectives, "all_gather"), (sharded, "all_gather"),
             (band_sharded, "all_gather")]
    saved = [getattr(m, n) for m, n in sites]

    def timed(fn):
        def call(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            seen["seconds"] += time.perf_counter() - t0
            seen["calls"] += 1
            return out

        return call

    for (m, n), fn in zip(sites, saved):
        setattr(m, n, timed(fn))
    try:
        yield seen
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)


def phase16_rank(rank: int, world: int, folder: str, dev: str, queue) -> None:
    """One rank of 16b/16c: join the gloo group, install phase 3's guards
    (host LU raises; the torch substitution loops raise on a CUDA tensor),
    and run ``sharded_si_eigensolve`` on phase 3's (A, M) at 0.74j once per
    SPIKE path, each with its launch counts zeroed just before and read
    just after; sends its figures (rank 0 its eigenvectors too) back."""
    import traceback

    try:
        import scipy.sparse as sp
        import torch
        from lsafw_tpu_torch.parallel import (
            device_mesh, initialize_distributed, sharded_si_eigensolve)
        from lsafw_tpu_torch.solver.band import band_nb

        forbid_host_lu()
        initialize_distributed(f"file://{folder}/store", world, rank, backend="gloo",
                               device=dev)
        mesh = device_mesh()
        probe = gloo_probe(mesh.device) if mesh.device.type == "cuda" else {}
        if rank == 0:
            log(f"phase 16b rank 0: gloo collectives on CUDA tensors: {probe}")
        z = np.load(Path(folder) / "pencil.npz")
        A, M = (sp.csr_matrix((z[f"{m}_data"], z[f"{m}_indices"], z[f"{m}_indptr"]),
                              shape=tuple(z["shape"])) for m in "AM")
        out = dict(rank=rank, probe=probe, runs={})
        for spike in P16_SPIKES:
            reset_counts()
            if mesh.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(mesh.device)
            _sync(mesh.device)
            t0 = time.time()
            with plain_loops_forbidden(), band_solves() as solves, \
                    collective_seconds(mesh.device) as coll:
                res = sharded_si_eigensolve(A, M, complex(z["target"]), mesh, nev=1, ncv=16,
                                            tol=1e-10, nb=band_nb(), chunk=P16_CHUNK,
                                            spike=spike)
                _sync(mesh.device)
            run = dict(seconds=time.time() - t0, launches=counts(), solves=dict(solves),
                       collectives=dict(coll),
                       sigma=complex(res.eigenvalues[0]), spike=res.spike,
                       degraded=res.degraded, calibration=res.calibration_residual,
                       stats=res.stats, converged=bool(res.converged),
                       peak_gb=(torch.cuda.max_memory_allocated(mesh.device) / 1e9
                                if mesh.device.type == "cuda" else 0.0))
            if rank == 0:
                run["x"] = res.eigenvectors[0]
            out["runs"][spike] = run
        torch.distributed.destroy_process_group()
        queue.put(out)
    except BaseException:
        queue.put(dict(rank=rank, error=traceback.format_exc()))
        raise


@contextmanager
def phase16_ranks(A, M, target: complex, dev: str, world: int = P16_RANKS):
    """Spawn ``world`` ranks of :func:`phase16_rank` on this card with (A, M)
    in a temporary ``.npz``, and yield a function that waits for their
    figures (rank order): the ranks start while the block runs (16a).  A
    rank that fails or does not answer within ``P16_TIMEOUT`` fails the
    phase; every rank is stopped when the block ends."""
    import queue as queue_mod
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        arrays = {"shape": np.array(A.shape), "target": np.array(complex(target))}
        for name, S in (("A", A.to_scipy()), ("M", M.to_scipy())):
            arrays.update({f"{name}_data": S.data, f"{name}_indices": S.indices,
                           f"{name}_indptr": S.indptr})
        np.savez(Path(folder) / "pencil.npz", **arrays)
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=phase16_rank, args=(r, world, folder, dev, q))
                 for r in range(world)]
        for p in procs:
            p.start()

        def collect() -> list:
            outs, t_end = [], time.time() + P16_TIMEOUT
            while len(outs) < world:
                try:
                    outs.append(q.get(timeout=max(t_end - time.time(), 0.1)))
                except queue_mod.Empty:
                    raise RuntimeError(f"phase 16b: {world - len(outs)} of {world} ranks did not "
                                       f"answer within {P16_TIMEOUT:.0f} s") from None
                if "error" in outs[-1]:
                    raise RuntimeError(f"phase 16b: rank {outs[-1]['rank']} failed:\n"
                                       f"{outs[-1]['error']}")
            return sorted(outs, key=lambda o: o["rank"])

        try:
            yield collect
        finally:
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.terminate()
                    p.join()


def world_of_one(A, dev) -> dict:
    """16a: a world of one over NCCL (a ``file://`` store): ``shard_csr`` of
    phase 3's A against S's own matvec of A (rel <= 1e-12), one
    ``all_reduce`` and one ``all_gather`` on CUDA tensors, ``is_rank0``;
    its launches counted."""
    import tempfile

    import torch
    import torch.distributed as dist
    from lsafw_tpu_torch.ops.bcsr import BCSROperator
    from lsafw_tpu_torch.parallel import (
        device_mesh, initialize_distributed, is_rank0, launch, shard_csr, shard_vector)
    from lsafw_tpu_torch.parallel.collectives import all_gather, all_reduce
    from lsafw_tpu_torch.parallel.sharded import gather_vector

    ref = BCSROperator.from_csr(A)
    x = torch.randn(A.shape[0], dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(16))
    y_ref = ref.matvec(x)
    with tempfile.TemporaryDirectory() as folder:
        reset_counts()
        t0 = time.time()
        initialize_distributed(f"file://{folder}/store", 1, 0, backend="nccl", device=dev)
        try:
            mesh = device_mesh()
            backend = dist.get_backend()
            op = shard_csr(A, mesh)
            y = gather_vector(op.matvec(shard_vector(x.cpu().numpy(), mesh)), op.n, mesh)
            err = rel_err(torch.as_tensor(y, device=dev), y_ref)[1]
            z = torch.arange(6, dtype=torch.float64, device=dev).to(torch.complex128) * (1 + 1j)
            red, gat = all_reduce(z, mesh.group), all_gather(z, mesh.group)
            _sync(dev)
            launches = counts()
            ok = (bool(torch.equal(red, z)) and bool(torch.equal(gat, z)) and red.is_cuda
                  and gat.is_cuda and is_rank0() and mesh.size == 1)
        finally:
            dist.destroy_process_group()
            launch._DEVICE.clear()
    seconds = time.time() - t0
    log(f"phase 16a: a world of one over {backend} (file:// store): shard_csr of phase 3's A "
        f"against S's own matvec rel {err:.2e}, all_reduce / all_gather on complex128 CUDA "
        f"tensors {'exact' if ok else 'WRONG'}, is_rank0 {is_rank0()}; {seconds:.2f} s; launches "
        f"{nonzero(launches)}")
    if not (err <= 1e-12 and ok and backend == "nccl"):
        raise RuntimeError(f"phase 16a: rel {err:.2e}, collectives ok {ok}, backend {backend}")
    if launches["spmv_real"] != 1:
        raise RuntimeError(f"phase 16a: {launches['spmv_real']} S launches for one local matvec")
    return dict(launches=launches, seconds=seconds)


def backward_error(A, M, lam: complex, x: np.ndarray) -> float:
    """||A x - lam M x|| / ((a + |lam| m) ||x||), the residual on the host,
    a and m the largest row 2-norms of A and M (``EigenSolver.backward_errors``)."""
    from lsafw_tpu_torch.solver.eigen import eigen_residuals, largest_row_norm

    scale = largest_row_norm(A) + abs(lam) * largest_row_norm(M)
    return float(eigen_residuals(A, M, [(lam, x)])[0]) / scale


def rank_spmv_timed(cop, dev, label: str) -> list:
    """S on a rank's ``ShardedPencil`` operand (its rows of C = A - sigma
    M and of M in the segments' order, global column ids): (A - sigma M) x
    and M x on the whole npad-long complex128 x, as the rank's matvec and
    mass apply take it after the all-gather; held against the plain
    version, timed with L2 evicted beside torch's sparse CSR product of
    the same rows (cuSPARSE), bounded by its bytes with x counted at the
    columns the rows reference."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    csr, s = cop.csr, cop.sigma
    n, nnz = csr.n, int(csr.crow[csr.n])
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.complex(*(torch.randn(csr.ncols, generator=g, device=dev, dtype=torch.float64)
                        for _ in range(2)))
    cases = {("shifted", "rank"): (lambda: sc.csr_shifted_spmv(csr, cop.vA, cop.vM, x, s),
                                   lambda: sc.csr_spmv_plain(csr, cop.vA, x, cop.vM, s)),
             ("mass", "rank"): (lambda: sc.csr_spmv(csr, cop.vM, x),
                                lambda: sc.csr_spmv_plain(csr, cop.vM, x))}
    errs = check_spmv(cases, f"on{label.lstrip(',')}")
    crow, col = csr.crow[: n + 1], csr.col[:nnz].long()
    lib_A, lib_M = (torch.sparse_csr_tensor(crow, col, v[:nnz], size=(n, csr.ncols))
                    for v in (cop.vA, cop.vM))
    xs = torch.stack([x.real, x.imag], dim=1)

    def product(S):
        y = S @ xs
        return torch.complex(y[:, 0], y[:, 1])

    libs = {"shifted": lambda: product(lib_A) - s * product(lib_M), "mass": lambda: product(lib_M)}
    nx = int(torch.unique(col).numel())
    ntiles = csr.tile_row.numel() - 1
    names = {"shifted": "shifted", "mass": "mass"}
    lines = {"shifted": "lsafw_tpu/ops/bcsr.py:615", "mass": "lsafw_tpu/ops/bcsr.py:622"}
    out = []
    for (mode, _), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(*spmv_work(mode, "permuted", n, nnz, ntiles, nx),
                                   FP64_FLOPS_PER_S)
        e = dict(name=f"csr_tiled_spmv_kernel (S), {names[mode]}{label}",
                 route="cuda", source="lsafw_tpu_torch/csrc/spmv_gather.cu", replaces=lines[mode],
                 launches=0, _key=S_KEYS[mode], max_abs_err=errs[(mode, "rank")],
                 ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=cold_ms(libs[mode]))
        log(f"phase 16: S {mode} on{label.lstrip(',')}: {e['ms']:.4f} ms cold, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / e['ms']:.1f}%), cuSPARSE {e['library_ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms; {nnz} nonzeros in {ntiles} tiles, x read at {nx} of "
            f"{csr.ncols} columns")
        out.append(e)
    return out


def rank_kernels(A, M, target: complex, errs: dict, dev) -> list:
    """K1/K2 and G's permutes on rank 0's segment factor of 16b/16c and S
    on its ``ShardedPencil`` operand, each against its plain version at the
    shapes the ranks gave them.  Both are rebuilt here by the ranks' own code
    (``ShardedBandedPrecond.build``, ``ShardedPencil.build``) on a mesh of
    ``P16_RANKS`` ranks seen from rank 0, without a process group (neither
    build runs a collective).  Returns the kernels-line entries."""
    import torch
    from lsafw_tpu_torch.parallel.sharded import DeviceMesh, ShardedPencil
    from lsafw_tpu_torch.solver.band import band_nb
    from lsafw_tpu_torch.solver.band_sharded import SegmentPlan, ShardedBandedPrecond

    t0 = time.time()
    As, Ms = A.to_scipy(), M.to_scipy()
    Cs = (As.astype(np.complex128) - complex(target) * Ms).tocsr()
    mesh = DeviceMesh(None, 0, P16_RANKS, torch.device(dev))
    plan = SegmentPlan.build(Cs, P16_RANKS, nb=band_nb(), chunk=P16_CHUNK)
    pc = ShardedBandedPrecond.build(Cs, mesh, chunk=P16_CHUNK, plan=plan)
    cop = ShardedPencil.build(As, Ms, target, pc.perm_pad, pc.npad, pc.rows, mesh)
    _sync(dev)
    log(f"phase 16: rank 0's segment factor ({type(pc.seg).__name__}, {pc.seg_rows} rows, nb "
        f"{pc.nb}, B {pc.B}) and its {pc.seg_rows} x {pc.npad} S operand rebuilt in "
        f"{time.time() - t0:.2f} s")
    kernels = band_kernels([(f", rank 0's {pc.seg_rows}-row segment of the 43k pencil "
                             f"(phase 16)", pc.seg)], errs, dev, plain_reps=1)
    kernels += rank_spmv_timed(cop, dev, f", rank 0's {pc.seg_rows} x {pc.npad} block of the 43k "
                               f"pencil (phase 16)")
    kernels += segment_permutes(pc.seg, dev, f", rank 0's {pc.seg_rows}-row segment (phase 16)")
    return kernels


def segment_permutes(f, dev, label: str) -> list:
    """G's permute-in (complex128 to complex64) and permute-out (back) of
    a segment solve on the segment factor's own permutation, each against
    its plain version (bit for bit), timed with L2 evicted, bounded by
    its bytes."""
    import torch
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    n, npad = f.iperm.numel(), f.perm.numel()
    g = torch.Generator(device=dev).manual_seed(17)
    br = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    bc = torch.complex(br, torch.randn(n, generator=g, device=dev, dtype=torch.float64))
    cases = permute_cases(br, bc, f.perm, f.iperm, f.band.shape[2],
                          keys={("in", "c128.c64"), ("out", "c64.c128")})
    check_permutes(cases, f"on{label.lstrip(',')}")
    nbytes = {"in": npad * 4 + n * 16 + npad * 8, "out": n * 4 + n * 8 + n * 16}
    out = []
    for (form, types), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(nbytes[form], 0, FP32_FLOPS_PER_S)
        e = dict(name=f"permute_{form}_kernel (G, permute-{form}), "
                      f"{types.replace('.', ' to ')}{label}", route="cuda",
                 source="lsafw_tpu_torch/csrc/spmv_gather.cu",
                 replaces="scripts/dev_pallas_gather.py:55", launches=0,
                 _key=f"permute_{form}.{types}", max_abs_err=0.0, ms=cold_ms(kern),
                 plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log(f"phase 16: G permute-{form} {types} on{label.lstrip(',')}: {e['ms']:.4f} ms cold, "
            f"plain {e['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms")
        out.append(e)
    return out


def phase16_path(A, M, sigma3: complex, dev, errs: dict) -> dict:
    """Phase 16: 16a (a world of one over NCCL), then two ranks spawned on
    this card over gloo (NCCL refuses two ranks on one device) running
    ``sharded_si_eigensolve`` on phase 3's (A, M) at 0.74j, nev 1, ncv 16,
    tol 1e-10, two segments at the port's nb: 16b the exact SPIKE, 16c the
    truncated SPIKE FGMRES.  Gates: 16b's sigma within 1e-8 of phase 3's,
    its backward error <= 1e-8 on the host from the returned vector (the
    original order), the ranks' host LU and torch loops on CUDA tensors 0
    (both raise), in each rank K1 and K2 once per segment solve in the mode
    ``factor_auto`` logged, G's permute-in and -out once each, S once per
    local matvec; 16c's sigma within 1e-8 of 16b's.  Logged: the SPIKE path,
    the calibration residual, the segment factor's mode, B and bw, the
    couplings dropped, the strips' solves and seconds, applies, refinement
    steps, each rank's peak device memory, every stage's seconds, the
    gloo collectives that take CUDA tensors, and the distance to the
    reference's 8-device record (its baseflow differs: not gated)."""
    from lsafw_tpu_torch.ops import spmv_cuda as sc

    t0 = time.time()
    with phase16_ranks(A, M, TARGET, str(dev)) as collect:  # the ranks start beside 16a
        p16a = world_of_one(A, dev)
        t1 = time.time()
        ranks = collect()
    t_ranks = time.time() - t1
    log(f"phase 16b: {P16_RANKS} ranks spawned on one card over gloo (NCCL takes one rank a "
        f"device); gloo on CUDA tensors: {ranks[0]['probe']}")
    launches = dict(p16a["launches"])
    sig = {}
    for spike in P16_SPIKES:
        what = "phase 16b" if spike == "exact" else "phase 16c"
        for o in ranks:
            r = o["runs"][spike]
            st = r["stats"]
            for k, v in r["launches"].items():
                launches[k] += v
            mode = "pivoted" if st["pivoted"] else "pivot_free"
            cls = "PivotedBandedLU" if st["pivoted"] else "BandedLU"
            solves = r["solves"].get(cls, 0)
            log(f"{what} rank {o['rank']}: {r['spike']} SPIKE (degraded {r['degraded']}), "
                f"calibration residual {r['calibration']}, sigma "
                f"{r['sigma'].real:+.12f}{r['sigma'].imag:+.12f}j; segment {st['seg_rows']} of "
                f"{st['npad']} rows, {mode} c64 factor at nb {st['nb']}, B {st['B']}, bw "
                f"{st.get('bw', '-')}, {st['dropped']} couplings dropped, factor "
                f"{st['factor_seconds']:.2f} s; strips {st.get('strip_solves', 0)} segment "
                f"solves in {st.get('strip_seconds', 0.0):.2f} s; {st['applies']} applies, "
                f"{st['refinements']} refinement steps, {st['fgmres_its']} FGMRES iterations, "
                f"worst inner residual {st['worst_inner']:.1e}; {st['matvecs']} local matvecs, "
                f"{sum(r['solves'].values())} segment solves; peak device memory "
                f"{r['peak_gb']:.3f} GB; seconds: plan {st['plan_seconds']:.2f}, build "
                f"{st.get('build_seconds', st['factor_seconds']):.2f}, calibration "
                f"{st.get('calibration_seconds', 0.0):.2f}, Krylov-Schur "
                f"{st['krylov_seconds']:.2f}, all {r['seconds']:.2f}, in "
                f"{r['collectives']['calls']} collectives {r['collectives']['seconds']:.2f}; "
                f"launches {nonzero(r['launches'])}")
            gate_band_launches(f"{what} rank {o['rank']}", r["launches"], f"{mode}.c64", solves)
            pin, pout = r["launches"]["permute_in.c128.c64"], r["launches"]["permute_out.c64.c128"]
            s_all = sum(r["launches"][m + o_] for m in sc.SPMV_KEYS for o_ in ("", ".original"))
            if not (pin == pout == solves == sum(r["solves"].values()) > 0):
                raise RuntimeError(f"{what} rank {o['rank']}: permutes {pin}/{pout} for "
                                   f"{solves} segment solves ({r['solves']})")
            if not s_all == st["matvecs"] > 0:
                raise RuntimeError(f"{what} rank {o['rank']}: {s_all} S launches for "
                                   f"{st['matvecs']} local matvecs")
            if r["sigma"] != ranks[0]["runs"][spike]["sigma"]:
                raise RuntimeError(f"{what}: the ranks' sigma differ: {r['sigma']} against "
                                   f"{ranks[0]['runs'][spike]['sigma']}")
        sig[spike] = ranks[0]["runs"][spike]["sigma"]
    x = ranks[0]["runs"]["exact"]["x"]
    bwd = backward_error(A, M, sig["exact"], x)
    rec = json.loads(SHARDED_RECORD.read_text())
    s_rec = complex(rec["sigma_re"], rec["sigma_im"])
    exact = ranks[0]["runs"]["exact"]
    log(f"phase 16b: sigma {sig['exact'].real:+.12f}{sig['exact'].imag:+.12f}j, "
        f"{abs(sig['exact'] - sigma3):.1e} from phase 3's; backward error {bwd:.2e}; host LU "
        f"calls 0 and torch loops on CUDA tensors 0 in every rank (both raise there); the "
        f"reference's {rec['n_dev']}-device record {s_rec:.10f} is "
        f"{abs(sig['exact'] - s_rec):.2e} away (another baseflow: logged, not gated)")
    if exact["spike"] != "exact":
        log(f"phase 16b: the exact SPIKE degraded to the truncated path (calibration residual "
            f"{exact['calibration']}): a finding for ROADMAP queue 3")
    if not (abs(sig["exact"] - sigma3) <= 1e-8 and bwd <= 1e-8):
        raise RuntimeError(f"phase 16b: sigma {sig['exact']} against phase 3's {sigma3}, "
                           f"backward error {bwd:.2e}")
    log(f"phase 16c: truncated SPIKE sigma {sig['truncated'].real:+.12f}"
        f"{sig['truncated'].imag:+.12f}j, {abs(sig['truncated'] - sig['exact']):.1e} from 16b's")
    if not abs(sig["truncated"] - sig["exact"]) <= 1e-8:
        raise RuntimeError(f"phase 16c: sigma {sig['truncated']} against 16b's {sig['exact']}")
    seconds = time.time() - t0
    log(f"phase 16: {seconds:.1f} s (16a {p16a['seconds']:.1f} s while the ranks start, then "
        f"{t_ranks:.1f} s for the ranks; budget 45 s); launches {nonzero(launches)}")
    t1 = time.time()
    kernels = rank_kernels(A, M, TARGET, errs, dev)
    log(f"phase 16: K1/K2, S and G at a rank's shapes, checked and timed in "
        f"{time.time() - t1:.1f} s")
    return dict(launches=launches, seconds=seconds, sigma=sig, kernels=kernels)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from lsafw_tpu_torch.ops import spmv_cuda as sc
    from lsafw_tpu_torch.solver import band as tband

    t_start = time.time()
    mark("1")
    dev = torch.device(DEVICE)
    name_power = card()
    log(f"phase 1: card {name_power}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()
    mark("2")
    errs: dict = {}  # launch key ("K1.pivoted.c64", ...) -> max abs error over phases 2 and 4
    if "--phase13" in sys.argv[1:]:  # phases 3 and 13 alone, no result lines
        from lsafw_tpu_torch.solver.pmg import build_pmg_pc

        start_mesh_worker()
        forbid_host_lu()
        case = cylinder_case(dev)
        with plain_loops_forbidden():
            mp = main_path(case)
        mem = membrane_case(MEMBRANE_NX[-1], dev)
        p13 = structured_path(case, mp, build_pmg_pc(mem["space"], mem["K"], mem["mask"]), errs,
                              dev)
        for e in p13["kernels"]:
            log(f"phase 13: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
                f"{e['bound_ms']:.4f} ms, {p13['launches'][e['_key']]} launches in phase 13")
        log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
        return 0
    if "--phase16" in sys.argv[1:]:  # phases 3 and 16 alone, no result lines
        forbid_host_lu()
        case = cylinder_case(dev)
        with plain_loops_forbidden():
            mp = main_path(case)
        mark("16")
        p16 = phase16_path(mp["A"], mp["M"], mp["sigma"], dev, errs)
        for e in p16["kernels"]:
            log(f"phase 16: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
                f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} "
                f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), max abs err "
                f"{e['max_abs_err']:.2e}, {p16['launches'][e['_key']]} launches in phase 16")
        log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
        return 0
    if "--phase15" in sys.argv[1:]:  # phase 15 alone after the build, no result lines
        forbid_host_lu()
        mark("15")
        p15 = phase15_path(dev, errs)
        for e in p15["kernels"]:
            log(f"phase 15: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
                f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} "
                f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
                f"{p15['launches'][e['_key']]} launches in phase 15")
        log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
        return 0

    nb = 128
    random_entries: dict = {}  # launch key -> phase 2's kernels-line entry

    def note(out: dict, f, kind: str) -> None:
        for k, (a, _) in out.items():
            errs[key_of(k, f, kind)] = max(errs.get(key_of(k, f, kind), 0.0), a)

    for (nb2, storage), shapes in PHASE2_SHAPES.items():
        mark(f"2 nb={nb2} {storage}")
        bf16 = storage == "bf16"
        for B, nblk in shapes:
            for real in (False, True):
                for pivoted in ((False,) if bf16 else (False, True)):  # pivoted: never bf16
                    f = (random_pivoted(B, nb2, nblk, dev, real) if pivoted
                         else random_band(B, nb2, nblk + B, nblk, dev, real, bf16))
                    for seed, kind in enumerate(kinds(f)):
                        b = rhs(kind, nblk, nb2, dev, seed)
                        note(check_kernels(f, b, f"phase 2 random B={B} nblk={nblk}"), f, kind)
                        fwd, fwd_plain, bwd, bwd_plain = substitutions(f)
                        y = fwd(b)
                        ms = {"K1": cuda_ms(lambda: fwd(b), 5), "K2": cuda_ms(lambda: bwd(y), 5)}
                        plain = {"K1": cuda_ms(lambda: fwd_plain(b), 1),
                                 "K2": cuda_ms(lambda: bwd_plain(y), 1)}
                        log(f"  phase 2 random B={B} nblk={nblk}: {mode_name(f, kind)}: K1 "
                            f"{ms['K1']:.4f} ms, K2 {ms['K2']:.4f} ms")
                        # the pivot-free K1 on f32 storage at the last shape of nb = 256
                        # (a mode no main path runs) beside its library call
                        lib = (k1_library(f, b, fwd(b)) if nb2 == 256 and not bf16
                               and mode_of(f) == "pivot_free" and (B, nblk) == shapes[-1]
                               else None)
                        for k in ms:  # the last shape's, for modes no main path runs
                            random_entries[key_of(k, f, kind)] = band_entry(
                                k, f, kind, f", random factor B={B} nblk={nblk}",
                                errs[key_of(k, f, kind)], ms[k], plain[k],
                                lib if k == "K1" else None)
                    del f
    mark("2 wide")
    wide_entries = wide_kernels(dev, errs)
    mark("2 G")
    gi = gather_inputs(dev)
    g_errs = check_gather(gi)
    for nb2, n in ((nb, 10007), (256, 20011)):
        br, bc, perm, iperm = random_permutation(n, nb2, dev, seed=4)
        check_permutes(permute_cases(br, bc, perm, iperm, nb2),
                       f"on a random permutation at nb = {nb2}")
    mark("2 S")
    rop = random_shifted_op(20011, dev, seed=5)
    check_spmv(spmv_cases(rop, dev), "on a random matrix")
    rop = random_shifted_op(20011, dev, seed=6, row_lens=S3D_ROW_LENS)
    check_spmv(spmv_cases(rop, dev), "on a random matrix with 3D row lengths")
    del rop
    log(f"phase 2: K1/K2 match their plain versions in both modes and every type, f32 and bf16 "
        f"storage, at (B, block rows) per (nb, storage) {PHASE2_SHAPES}, and in {WIDE_MODES} at "
        f"(B, block rows) per nb {PHASE2_WIDE}; G matches x[idx] at the probes' shapes, its "
        f"permute forms their plain versions at nb = 128 and 256; S its plain version in every "
        f"mode and order, on 2D and 3D row lengths")
    if "--kernels" in sys.argv[1:]:
        return 0

    mark("3")
    start_mesh_worker()
    forbid_host_lu()
    case = cylinder_case(dev)
    with plain_loops_forbidden():
        mp = main_path(case)
    pf = pivot_free_path(mp["A"], mp["M"], mp["sigma"])
    p3c = bf16_path(case, mp, pf)

    # phase 4: agreement and times
    mark("4")
    cop = mp["op"].device_op.Cop
    cases = spmv_cases(cop, dev)
    s_errs = check_spmv(cases, "on the main path's (A, M)")
    mg = main_path_gathers(mp["A"], cop, dev)
    mg_errs = check_main_gathers(mg)
    with env(LSAFW_PIVOT_MEM_GB="0"):  # phase 3c's real bf16 band, factored again
        J = p3c["J"]
        jac_bf16 = tband.factor_auto(p3c["rplan"], J.data, diag_slots=J.pattern.diag_slots)[0]
    kernels = band_kernels([("", f) for f in main_path_factors(mp, pf)]
                           + [(", 43k phase 3c", p3c["op"].device_op.blu),
                              (", 43k phase 3c Jacobian", jac_bf16)], errs, dev, library=True)
    del jac_bf16
    launches = {k: mp["launches"][k] + pf["launches"][k] for k in sc.LAUNCHES}

    src = "lsafw_tpu_torch/csrc/spmv_gather.cu"
    run_a, two_pass = "scripts/dev_pallas_gather.py:55", "scripts/dev_pallas_gather2.py:111"
    g_cases = []  # (name, replaces, launch key, error, kernel, plain, library, bound)
    for kind, elem in (("f64", 8), ("c128", 16)):
        x, idx = mg[kind][0]
        what = ("CSR value refill" if kind == "f64" else
                "a band permutation (not on the main path)") + \
            f" at the main path's shapes (x {x.numel()}, idx {idx.numel()})"
        g_cases.append((f"flat form, {kind}, {what}", run_a, f"gather_{kind}", mg_errs[kind],
                        lambda x=x, idx=idx: sc.gather(x, idx),
                        lambda x=x, idx=idx: sc.gather_plain(x, idx), lambda x=x, idx=idx: x[idx],
                        gather_bound(elem, int(torch.unique(idx).numel()), idx.numel() * 4,
                                     idx.numel())))
    g_cases += [
        ("flat form, f32, at run_a's shapes (a probe's type, not on the main path)", run_a,
         "gather_f32", g_errs["flat"],
         lambda: sc.gather(gi["xa"], gi["idx"]), lambda: sc.gather_plain(gi["xa"], gi["idx"]),
         lambda: gi["xa"][gi["idx"]],
         gather_bound(4, int(torch.unique(gi["idx"]).numel()), gi["idx"].numel() * 4,
                      gi["idx"].numel())),
        ("two-pass form, f32, at pallas_two_pass's shapes (not on the main path)", two_pass,
         "gather_two_pass", g_errs["two_pass"],
         lambda: sc.gather_two_pass(gi["x2d"], gi["rowsel"], gi["lanesel"]),
         lambda: sc.gather_two_pass_plain(gi["x2d"], gi["rowsel"], gi["lanesel"]),
         lambda: gi["x"][gi["flat"]],
         gather_bound(4, int(torch.unique(gi["flat"]).numel()), gi["rowsel"].numel() * 8,
                      gi["rowsel"].numel())),
    ]
    for form, line, key, err, kern, plain, lib, (bound_ms, bound_by) in g_cases:
        kernels.append(dict(name=f"gather_kernel (G), {form}", route="cuda", source=src,
                            replaces=line, launches=launches[key], _key=key, max_abs_err=err,
                            ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=cold_ms(lib)))
        log(f"phase 4: G {form}: with L2 warm (graph replays) {graph_ms(kern):.4f} ms, x[idx] "
            f"{graph_ms(lib):.4f} ms; one call with its host overhead (CUDA events) "
            f"{cuda_ms(kern, 20):.4f} ms, x[idx] {cuda_ms(lib, 20):.4f} ms")
    size = {"f64": 8, "c128": 16, "c64": 8, "f32x1": 4, "f32x2": 8}
    main_types = {"in.c128.c64", "out.c64.c128", "in.f64.f32x1", "out.f32x1.f64",
                  "in.c128.f32x2", "out.f32x2.c128"}
    for (form, types), (kern, plain) in mg["permutes"].items():
        a, b = types.split(".")
        ix, bcx, brx = mg["plans"]["c64" if "c64" in types else "f32"]
        n, npad = ix["iperm"].numel(), ix["perm_pad"].numel()
        if form == "in":  # perm, b, the band-order output
            nbytes = npad * 4 + n * size[a] + npad * size[b]
            bvec = bcx if a == "c128" else brx
            dt = torch.complex64 if b == "c64" else torch.float32
            seq = (lambda v=bvec, p=ix["perm_pad"], dt=dt: op_sequence_in(v, p, n, nb, dt))
        else:  # iperm, the n band-order slots it reads, the output
            nbytes = n * 4 + n * size[a] + n * size[b]
            x = sc.permute_in_plain(bcx if b == "c128" else brx, ix["perm_pad"], nb,
                                    torch.complex64 if a == "c64" else torch.float32)
            to = torch.complex128 if b == "c128" else torch.float64
            seq = (lambda x=x, p=ix["iperm"], to=to: op_sequence_out(x, p, to))
        on_main = f"{form}.{types}" in main_types
        bound_ms, bound_by = bound(nbytes, 0, FP32_FLOPS_PER_S)
        e = dict(name=f"permute_{form}_kernel (G, permute-{form}), {types.replace('.', ' to ')}"
                      f"{'' if on_main else ' (not on the main path)'}", route="cuda", source=src,
                 replaces=run_a, launches=launches[f"permute_{form}.{types}"],
                 _key=f"permute_{form}.{types}", max_abs_err=0.0,
                 ms=cold_ms(kern), plain_ms=cold_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)
        kernels.append(e)
        log(f"phase 4: G permute-{form} {types}: one call with its host overhead (CUDA events) "
            f"{cuda_ms(kern, 20):.4f} ms, plain {cuda_ms(plain, 20):.4f} ms")
        if on_main:
            log(f"phase 4: G permute-{form} {types}: the op sequence it replaces: cold "
                f"{cold_ms(seq):.4f} ms, with its host overhead {cuda_ms(seq, 20):.4f} ms")
    s_lines = {"real": "lsafw_tpu/ops/bcsr.py:388", "shifted": "lsafw_tpu/ops/bcsr.py:615",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:587", "mass": "lsafw_tpu/ops/bcsr.py:622",
               "shifted_real": "lsafw_tpu/ops/bcsr.py:615",
               "shifted_real_mass": "lsafw_tpu/ops/bcsr.py:587"}
    o_lines = {"real": "lsafw_tpu/ops/bcsr.py:446", "shifted": "lsafw_tpu/ops/bcsr.py:638",
               "shifted_mass": "lsafw_tpu/ops/bcsr.py:638", "mass": "lsafw_tpu/ops/bcsr.py:646",
               "shifted_real": "lsafw_tpu/ops/bcsr.py:638",
               "shifted_real_mass": "lsafw_tpu/ops/bcsr.py:638"}
    s_names = {"real": "real", "shifted": "shifted", "shifted_mass": "shifted+mass",
               "mass": "mass", "shifted_real": f"shifted, f64 x at the real shift {CN_SHIFT:g}",
               "shifted_real_mass": f"shifted+mass, f64 x at the real shift {CN_SHIFT:g}"}
    libs = spmv_library(mp["A"], mp["M"], cop.sigma, dev)
    ntiles = cop.plan.tile_row.size - 1
    for (mode, order), (kern, plain) in cases.items():
        bound_ms, bound_by = bound(*spmv_work(mode, order, cop.plan.n, cop.plan.nnz, ntiles),
                                   FP64_FLOPS_PER_S)
        key = S_KEYS[mode] + ("" if order == "permuted" else ".original")
        # the Cayley right-hand side of phase 7 (real) and the Floquet trips'
        # right-hand sides of phase 9 (complex, at sigma = 0) ask for both
        # outputs; a mode with M x counts its launches under the same mode
        # without it (one kernel, one key)
        on_main = order == "original"
        paired = mode in ("shifted_mass", "shifted_real_mass")
        note = (" (launches counted with the mode without M x)" if paired and on_main else
                "" if on_main else " (not on the main path)")
        e = dict(name=f"csr_tiled_spmv_kernel (S), {s_names[mode]}, {order} order{note}",
                 route="cuda", source=src,
                 replaces=(s_lines if order == "permuted" else o_lines)[mode],
                 launches=0 if paired else launches[key],
                 _key=None if paired else key,
                 max_abs_err=s_errs[(mode, order)], ms=cold_ms(kern), plain_ms=cold_ms(plain),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=cold_ms(libs[mode]))
        kernels.append(e)
        log(f"phase 4: S {mode} {order}: with L2 warm (graph replays) {graph_ms(kern):.4f} ms, "
            f"cuSPARSE {graph_ms(libs[mode]):.4f} ms; one call with its host overhead (CUDA "
            f"events) {cuda_ms(kern, 20):.4f} ms, cuSPARSE {cuda_ms(libs[mode], 20):.4f} ms")
    # the panel LU backends
    for dt in (torch.float32, torch.complex64):
        panel = torch.randn(((mp["op"].device_op.blu.B + 1) * nb, nb), dtype=dt, device=dev)
        times = {}
        for lib in ("default", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            times[lib] = cuda_ms(lambda: torch.linalg.lu_factor_ex(panel), 20)
        torch.backends.cuda.preferred_linalg_library("default")
        log(f"phase 4: one {tuple(panel.shape)} {dt} panel LU: PyTorch's default backend "
            f"{times['default']:.3f} ms, cuSOLVER {times['cusolver']:.3f} ms")
    v = torch.randn(mp["A"].shape[0], dtype=torch.complex128, device=dev)
    reset_counts()
    wall, busy, ops = device_busy(lambda: mp["op"].apply(v))
    log(f"phase 4: one pivoted shift-invert apply under the profiler: {ops} device operations "
        f"({sum(counts().values())} of the port's kernels), {wall:.1f} ms wall, the card busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
    gcr_ms, gcr_busy, gcr_ops, its = gcr_iterations(mp, dev)
    log(f"phase 4: {its} GCR iterations of a real banded solve under the profiler: {gcr_ops} "
        f"device operations ({gcr_ops / its:.1f} per iteration), {gcr_ms:.1f} ms wall, the card "
        f"busy {gcr_busy:.2f} ms ({100 * gcr_busy / gcr_ms:.1f}%); the baseflow launched "
        f"{mp['per_gcr']:.2f} of the port's kernels per GCR iteration")

    mark("5")
    p5 = sensitivity_path(case, mp)
    mark("12")
    p12 = krylov_path(case, mp, p3c["J"], errs, dev)
    kernels += p12.pop("kernels")
    del p12["stages"]
    mark("13")
    p13 = structured_path(case, mp, p12.pop("pmg"), errs, dev)
    kernels += p13.pop("kernels")
    torch.cuda.empty_cache()
    mark("16")
    p16 = phase16_path(mp["A"], mp["M"], mp["sigma"], dev, errs)
    kernels += p16.pop("kernels")
    mp_launches, pf_launches, p3c_launches = mp["launches"], pf["launches"], p3c["launches"]
    p3 = {k: mp[k] for k in ("w", "A", "M", "sigma")}  # phase 8's 2D base and answer
    a43 = p3["A"]  # phase 14c's standard problem
    del mp, pf, p3c, cop, cases, mg, p5["stages"]
    torch.cuda.empty_cache()
    mark("7")
    p7 = nonmodal_path(case, "7", dev, sweep=OMEGAS, k=2, norm=True, cross_check=True)
    del p7["stages"]
    torch.cuda.empty_cache()
    mark("8")
    p8 = {"span": span_path(case, p3, "8", dev, cross_check=True)}
    torch.cuda.empty_cache()
    p8["wnl"] = wnl_path(case, "8", dev, cross_check=True)
    del p3
    torch.cuda.empty_cache()
    floquet_factors: list = []
    mark("9")
    p9 = unsteady_path(case, p7, dev, keep=floquet_factors)
    # phase 4, continued: K1/K2 pivoted f32 (x2: the Floquet trips') on a 9d factor
    kernels += band_kernels([(", 43k phase 9d Floquet", floquet_factors[0])], errs, dev)
    del floquet_factors
    p10cyl = cylinder_diagnostics(case, p7["w"])
    del case, p9["stages"], p7["M"]
    torch.cuda.empty_cache()
    finish_host_checks("phase 7")
    finish_host_checks("phase 8")

    mark("6")
    p6 = production_path(dev)
    p6b = production_rerun(p6, "6b", "pivot_free.c64.nb256", LSAFW_BAND_NB="256")
    p6c = production_rerun(p6, "6c", "pivot_free.bf16.c64", LSAFW_BAND_MEM_GB="4")
    eig6, eig6c = p6["stages"]["eigen"], p6c["stage"]
    above6, above6c = (s_["peak_gb"] - s_["resident_gb"] for s_ in (eig6, eig6c))
    solve_ms = {ph: one_band_solve_ms(r["op"].device_op.blu, dev)
                for ph, r in (("6", p6), ("6b", p6b), ("6c", p6c))}
    log(f"phase 6: one band solve (permute-in, K1, K2, permute-out) {solve_ms['6']:.3f} ms at "
        f"nb = 128 (phase 6), {solve_ms['6b']:.3f} ms at nb = 256 (6b), {solve_ms['6c']:.3f} ms on "
        f"the bf16 band (6c); factors {p6['op'].factor_seconds:.2f} / "
        f"{p6b['op'].factor_seconds:.2f} / {p6c['op'].factor_seconds:.2f} s; eigen stages "
        f"{eig6['seconds']:.2f} / {p6b['stage']['seconds']:.2f} / {eig6c['seconds']:.2f} s")
    log(f"phase 6c: peak device memory {above6c:.3f} GB above the stage's start against phase 6's "
        f"{above6:.3f} GB: {above6c / max(above6, 1e-9):.3f} (limit 0.6)")
    if not above6c <= 0.6 * above6:
        raise RuntimeError(f"phase 6c: the bf16 stage's peak {above6c:.3f} GB above its start is "
                           f"over 0.6 x phase 6's {above6:.3f} GB")
    # phase 4, continued: K1/K2 on the production factors
    kernels += band_kernels([(", 175k phase 6", p6["op"].device_op.blu),
                             (", 175k phase 6b", p6b["op"].device_op.blu),
                             (", 175k phase 6c", p6c["op"].device_op.blu)], errs, dev,
                            plain_reps=1, library=True)
    mains = {"3": mp_launches, "3b": pf_launches, "3c": p3c_launches, "6": p6["launches"],
             "6b": p6b["launches"], "6c": p6c["launches"]}
    case6 = p6["case"]
    p6d = {k: p6[k] for k in ("w", "A", "M", "sigma")}  # phase 8b's 2D base and answer
    del p6, p6b, p6c
    torch.cuda.empty_cache()
    mark("14")
    p14 = cli_path(case6, p6d, a43, name_power, dev)
    del a43
    torch.cuda.empty_cache()

    transient_factors: list = []
    mark("7b")
    p7b = nonmodal_path(case6, "7b", dev, time_factors=transient_factors,
                        horizon=(HORIZON / 2, CN_STEPS // 2), w0=p6d["w"])
    del p7b["stages"]
    # phase 4, continued: K1/K2 pivoted f32 on the 175k transient's real factor
    kernels += band_kernels([(", 175k phase 7b", transient_factors[0])], errs, dev, plain_reps=1)
    del transient_factors
    torch.cuda.empty_cache()
    log(f"phase 7: phases 7 and 7b took {p7['seconds'] + p7b['seconds']:.1f} s (budget 150 s)")

    q3_factors: list = []
    mark("8b")
    p8b = {"span": span_path(case6, p6d, "8b", dev, keep=q3_factors)}
    # phase 4, continued: K1/K2 on the 175k quasi-3D factor of beta = SPAN_BETA
    kernels += band_kernels([(", 175k phase 8b quasi-3D", q3_factors[0])], errs, dev, plain_reps=1,
                            library=True)
    w6 = p6d["w"]  # 8b WNL's warm start
    del q3_factors, p6d
    torch.cuda.empty_cache()
    p8b["wnl"] = wnl_path(case6, "8b", dev, w0=w6)
    del case6, w6
    p8s = {ph: sum(p[k]["seconds"] for k in ("span", "wnl")) for ph, p in (("8", p8), ("8b", p8b))}
    log(f"phase 8: phases 8 and 8b took {p8s['8'] + p8s['8b']:.1f} s ({p8s['8']:.1f} + "
        f"{p8s['8b']:.1f} s; budget 150 s)")
    torch.cuda.empty_cache()

    mark("10")
    p10 = cube_path(dev, errs)
    kernels += p10.pop("kernels")
    torch.cuda.empty_cache()
    mark("10b")
    p10b = step_path(dev)
    mark("10c")
    p10c = step3d_path(dev, errs)
    kernels += p10c.pop("kernels")
    p10s = " + ".join(f"{p['seconds']:.1f}" for p in (p10, p10b, p10c))
    log(f"phase 10: phases 10, 10b and 10c took "
        f"{sum(p['seconds'] for p in (p10, p10b, p10c)):.1f} s ({p10s} s; budget 250 s); the "
        f"cylinder's diagnostics L_r {p10cyl['L']:.6f}, C_d {p10cyl['cd']:.6f}")
    torch.cuda.empty_cache()
    mark("11")
    p11 = scm_path(dev, errs)
    kernels += p11.pop("kernels")
    torch.cuda.empty_cache()
    mark("15")
    p15 = phase15_path(dev, errs)
    kernels += p15.pop("kernels")
    finish_host_checks()
    mark("kernels line")
    timed = {e["_key"] for e in kernels}
    kernels += [e for key, e in random_entries.items() if key not in timed]
    kernels += wide_entries
    for e in kernels:
        key = e.pop("_key")
        if key:
            e["launches"] = sum(m[key] for m in mains.values())
        e["launches_phase5"] = p5["launches"][key] if key else 0
        e["launches_phase6"] = sum(mains[ph][key] for ph in ("6", "6b", "6c")) if key else 0
        e["launches_phase7"] = p7["launches"][key] + p7b["launches"][key] if key else 0
        e["launches_phase8"] = sum(p[k]["launches"][key] for p in (p8, p8b)
                                   for k in ("span", "wnl")) if key else 0
        e["launches_phase9"] = p9["launches"][key] if key else 0
        e["launches_phase10"] = sum(p["launches"][key] for p in (p10, p10b, p10c)) if key else 0
        e["launches_phase11"] = p11["launches"][key] if key else 0
        e["launches_phase12"] = p12["launches"][key] if key else 0
        e["launches_phase13"] = p13["launches"][key] if key else 0
        e["launches_phase14"] = p14["launches"][key] if key else 0
        e["launches_phase15"] = p15["launches"][key] if key else 0
        e["launches_phase16"] = p16["launches"][key] if key else 0
    for e in kernels:
        log(f"phase 4: {e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{100 * e['bound_ms'] / e['ms']:.1f}% of bound, {e['launches']} launches "
            f"({e['launches_phase5']} in phase 5, {e['launches_phase6']} in phase 6, "
            f"{e['launches_phase7']} in phase 7, {e['launches_phase8']} in phase 8, "
            f"{e['launches_phase9']} in phase 9, {e['launches_phase10']} in phase 10, "
            f"{e['launches_phase11']} in phase 11, {e['launches_phase12']} in phase 12, "
            f"{e['launches_phase13']} in phase 13, {e['launches_phase14']} in phase 14, "
            f"{e['launches_phase15']} in phase 15, {e['launches_phase16']} in phase 16)")
    t_end = time.time()
    log(f"chip_smoke: seconds by phase, from each phase's start to the next's: "
        f"{phase_seconds(t_end)}")
    log(f"chip_smoke: {t_end - t_start:.1f} s in all")

    log(name_power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
