"""Command-line driver.

Drop-in workflow replacement for the reference executable (src/main.cpp):
run with no flags and it prompts for the same 10 parameters in the same
order on stderr / reads them from stdin, so existing parameter pipes
(reference run.sh:36-37 `mpirun -n N SM_NxxNt < parameters`) work verbatim:

    python -m schwingermodel_tpu < parameters

ranks_x/ranks_t select the device-mesh shape (the reference's MPI rank
grid); on a single device use 1 1. Lattice dims are runtime flags (--nx/--nt)
instead of the reference's compile-time CMake constants (CMakeLists.txt:17-18)
-- no rebuild per size. Everything else (chains, quenched mode, condensate
measurement, checkpoint/resume, cold start, dtype) is new capability exposed
as optional flags.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _prompt(question: str, cast, interactive: bool):
    """Reference-style parameter input: prompt on stderr, value from stdin
    (src/main.cpp:30-58)."""
    if interactive:
        print(question, file=sys.stderr)
    line = sys.stdin.readline()
    if not line:
        raise SystemExit(f"missing input for: {question}")
    return cast(line.split()[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu",
        description="HMC for the two-flavor Schwinger model (JAX/XLA)",
    )
    p.add_argument("--nx", type=int, default=64, help="lattice extent in x")
    p.add_argument("--nt", type=int, default=64, help="lattice extent in t")
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--m0", type=float, default=None)
    p.add_argument("--md-steps", type=int, default=None)
    p.add_argument("--tau", type=float, default=None, help="trajectory length")
    p.add_argument("--ntherm", type=int, default=None)
    p.add_argument("--nmeas", type=int, default=None)
    p.add_argument("--nsteps", type=int, default=None,
                   help="decorrelation sweeps between measurements")
    p.add_argument("--save-conf", action="store_true", default=None)
    p.add_argument("--ranks-x", type=int, default=None,
                   help="device mesh extent in x (reference ranks_x)")
    p.add_argument("--ranks-t", type=int, default=None)
    p.add_argument("--ranks-chain", type=int, default=1,
                   help="device mesh extent over independent chains (data "
                        "parallelism; requires --chains divisible by it)")
    p.add_argument("--cg-tol", type=float, default=None,
                   help="CG relative tolerance (reference 1e-10 in f64)")
    p.add_argument("--cg-max-iter", type=int, default=10000)
    p.add_argument("--cg-refine", dest="cg_refine", action="store_true",
                   default=None,
                   help="mixed-precision refinement on f32 runs: f32 inner "
                        "solves + f64 true-residual accumulation, meeting "
                        "the reference's 1e-10 contract (default: on for "
                        "float32 runs; --no-cg-refine for the loose "
                        "f32-only solver)")
    p.add_argument("--no-cg-refine", dest="cg_refine", action="store_false")
    p.add_argument("--cg-inner-tol", type=float, default=1e-5,
                   help="relative tolerance of each f32 inner solve under "
                        "--cg-refine")
    p.add_argument("--cg-force-tol", type=float, default=None,
                   help="MD force-solve tolerance (default auto: 1e-8 "
                        "under --cg-refine, else --cg-tol; the Metropolis "
                        "action solves always run at --cg-tol -- see "
                        "config.CGParams.force_tol)")
    p.add_argument("--cg-refine-impl", choices=["auto", "x64", "dfloat"],
                   default="auto",
                   help="true-residual arithmetic: x64 (native f64) or "
                        "dfloat (double-float f32 pairs, solvers/dfloat.py; "
                        "needs a compiler that keeps error-free transforms, "
                        "checked at start-up). auto = x64")
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="default: float32 on GPU, float64 on CPU "
                        "(utils/device.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chains", type=int, default=1,
                   help="independent vmapped chains")
    p.add_argument("--quenched", action="store_true",
                   help="pure gauge theory (no fermions)")
    p.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                   default="leapfrog",
                   help="MD scheme: the reference's leapfrog, or the "
                        "2nd-order minimum-norm Omelyan integrator (2 force "
                        "evals/step, ~10x smaller dH error constant)")
    p.add_argument("--hasenbusch-dm", type=float, default=None,
                   metavar="DM",
                   help="Hasenbusch mass preconditioning: split the fermion "
                        "determinant with a second pseudofermion at the "
                        "heavier auxiliary mass m0+DM (restores acceptance "
                        "near the critical mass; typical DM ~ 0.2-0.5). "
                        "Off by default -- the reference's single-"
                        "pseudofermion algorithm")
    p.add_argument("--no-even-odd", dest="even_odd", action="store_false",
                   default=True,
                   help="disable even-odd (Schur) preconditioning and use the "
                        "reference's plain full-D pseudofermions")
    p.add_argument("--no-cg-forecast", dest="cg_forecast", action="store_false",
                   default=True,
                   help="disable chronological CG forecasting and restart "
                        "every solve from b like the reference")
    p.add_argument("--autotune", action="store_true",
                   help="dual-averaging step-size warmup targeting the "
                        "reference's 0.6-0.8 acceptance band")
    p.add_argument("--tune-target", type=float, default=0.7)
    p.add_argument("--n-tune", type=int, default=100,
                   help="warmup trajectories used for tuning")
    p.add_argument("--condensate", action="store_true",
                   help="measure the chiral condensate")
    p.add_argument("--n-noise", type=int, default=8,
                   help="noise vectors per condensate estimate")
    p.add_argument("--cold-start", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a checkpoint (.npz)")
    p.add_argument("--read-conf", default=None, metavar="CTXT",
                   help="start from a saved gauge configuration (.ctxt)")
    p.add_argument("--checkpoint", default=None, metavar="CKPT",
                   help="write a checkpoint at the end of the run")
    p.add_argument("--no-simdata", action="store_true")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu/cuda)")
    p.add_argument("--num-cpu-devices", type=int, default=None,
                   help="virtual CPU device count (sharding tests without "
                        "several GPUs)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address "
                        "(also honored: JAX_COORDINATOR_ADDRESS / SLURM / "
                        "Open MPI autodetection)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's id")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler device trace to DIR "
                        "(view with XProf/TensorBoard)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    if args.num_cpu_devices:
        jax.config.update("jax_num_cpu_devices", args.num_cpu_devices)

    from schwingermodel_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from schwingermodel_tpu.config import (
        CGParams, HMCParams, LatticeParams, RunParams,
    )
    from schwingermodel_tpu.io import ctxt
    from schwingermodel_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from schwingermodel_tpu.parallel import lattice_mesh, multihost
    from schwingermodel_tpu.runner import run_hmc

    # Multi-host: bring up jax.distributed before the backend is touched
    # (reference: MPI_Init before anything else, main.cpp:13). No-op for a
    # plain single-process run.
    distributed = multihost.maybe_initialize(
        args.coordinator, args.num_processes, args.process_id)
    primary = multihost.is_primary()
    echo = print if primary else (lambda *a, **k: None)

    # Precision policy of this device (utils/device.py): float32 with f64
    # true-residual refinement on a GPU, so the shipped configuration meets
    # the reference's 1e-10 solver contract (src/main.cpp:26-27) out of the
    # box; float64 throughout on the CPU.
    from schwingermodel_tpu.utils.device import device_policy

    try:
        policy = device_policy()
    except ValueError as e:
        raise SystemExit(str(e))
    dtype = args.dtype or policy.real_dtype
    cg_refine = args.cg_refine if args.cg_refine is not None else (
        dtype == "float32")
    if dtype != "float32":
        cg_refine = False
    refine_impl = args.cg_refine_impl
    if refine_impl == "auto":
        refine_impl = "x64"
    if dtype == "float64" or (cg_refine and refine_impl == "x64"):
        jax.config.update("jax_enable_x64", True)
    if cg_refine and refine_impl == "dfloat":
        from schwingermodel_tpu.solvers.dfloat import eft_selfcheck

        if not eft_selfcheck():
            raise SystemExit(
                "--cg-refine-impl dfloat: this backend's compiler breaks "
                "the error-free float transforms double-float arithmetic "
                "needs (an LLVM backend that contracts mul+add to FMA). Use "
                "--cg-refine-impl x64, or on CPU set "
                "XLA_FLAGS=--xla_backend_optimization_level=0")

    # ---- parameters: flags, else reference-style stdin prompts ----
    need_stdin = any(
        v is None for v in (args.ranks_x, args.ranks_t, args.m0, args.md_steps,
                            args.tau, args.beta, args.ntherm, args.nmeas,
                            args.nsteps)
    ) and args.resume is None
    if not need_stdin and args.save_conf is None:
        args.save_conf = False
    interactive = sys.stdin.isatty()
    if need_stdin:
        if interactive:
            print("  -----------------------------", file=sys.stderr)
            print("|  Two-flavor Schwinger model   |", file=sys.stderr)
            print("| Hybrid Monte Carlo simulation |", file=sys.stderr)
            print("  -----------------------------", file=sys.stderr)
            print(f"Nx {args.nx} Nt {args.nt}", file=sys.stderr)
        get = lambda q, c, cur: cur if cur is not None else _prompt(q, c, interactive)
        args.ranks_x = get("ranks_x: ", int, args.ranks_x)
        args.ranks_t = get("ranks_t: ", int, args.ranks_t)
        args.m0 = get("m0: ", float, args.m0)
        args.md_steps = get("Molecular dynamics steps: ", int, args.md_steps)
        args.tau = get("Trajectory length: ", float, args.tau)
        args.beta = get("beta: ", float, args.beta)
        args.ntherm = get("Thermalization: ", int, args.ntherm)
        args.nmeas = get("Measurements: ", int, args.nmeas)
        args.nsteps = get("Step (sweeps between measurements): ", int, args.nsteps)
        args.save_conf = bool(get("Save configurations yes/no (1 or 0): ", int,
                                  None if args.save_conf is None else int(args.save_conf)))

    initial_theta = None
    start_traj = 0
    if args.resume:
        ck = load_checkpoint(args.resume)
        lattice, hmc, run = ck["lattice"], ck["hmc"], ck["run"]
        initial_theta = ck["theta"]
        start_traj = ck["traj_index"]
        # allow extending the run
        if args.nmeas is not None:
            run = RunParams(**{**run.__dict__, "n_meas": args.nmeas, "n_therm": 0})
    else:
        cg_tol = args.cg_tol if args.cg_tol is not None else (
            1e-6 if (dtype == "float32" and not cg_refine) else 1e-10)
        lattice = LatticeParams(Nx=args.nx, Nt=args.nt, real_dtype=dtype)
        even_odd = args.even_odd and lattice.Nx % 2 == 0 and lattice.Nt % 2 == 0
        hmc = HMCParams(
            beta=args.beta, m0=args.m0, md_steps=args.md_steps,
            trajectory_length=args.tau, quenched=args.quenched,
            even_odd=even_odd, cg_forecast=args.cg_forecast,
            integrator=args.integrator,
            hasenbusch_dm=args.hasenbusch_dm,
            cg=CGParams(tol=cg_tol, max_iter=args.cg_max_iter,
                        refine=cg_refine, refine_impl=refine_impl,
                        inner_tol=args.cg_inner_tol,
                        force_tol=args.cg_force_tol),
        )
        mesh_shape = (args.ranks_x, args.ranks_t)
        if args.ranks_chain > 1:
            mesh_shape = (args.ranks_chain,) + mesh_shape
        run = RunParams(
            n_therm=args.ntherm, n_meas=args.nmeas, n_steps=args.nsteps,
            save_conf=bool(args.save_conf), n_chains=args.chains,
            seed=args.seed, out_dir=args.out_dir,
            mesh_shape=mesh_shape,
            autotune=args.autotune, tune_target=args.tune_target,
            n_tune=args.n_tune,
        )

    if args.read_conf:
        U = ctxt.read_conf(args.read_conf, lattice.Nx, lattice.Nt)
        initial_theta = ctxt.theta_from_links(U)
    elif args.cold_start and initial_theta is None:
        initial_theta = np.zeros((2, lattice.Nx, lattice.Nt))

    mesh = None
    shape = run.mesh_shape or (1, 1)
    rc = shape[0] if len(shape) == 3 else 1
    rx, rt = shape[-2:]
    n_mesh = rc * rx * rt
    if distributed and n_mesh <= 1:
        # multi-host with no explicit mesh: lattice axes on each host's
        # local devices, chains across hosts (parallel/multihost.py)
        mesh = multihost.multihost_mesh(lattice.Nx, lattice.Nt)
        rc, rx, rt = mesh.devices.shape
        if run.n_chains % rc:
            # round UP to the next multiple of the chain axis: never silently
            # reduce the statistics the user asked for
            n_new = rc * (-(-run.n_chains // rc))
            echo(f"note: --chains {run.n_chains} rounded up to {n_new} "
                 f"(chain mesh axis = {rc})")
            run = RunParams(**{**run.__dict__, "n_chains": n_new})
    elif n_mesh > 1:
        n_dev = len(jax.devices())
        if n_mesh > n_dev:
            print(f"error: mesh {'x'.join(map(str, shape))} needs {n_mesh} "
                  f"devices, have {n_dev}", file=sys.stderr)
            return 1
        if lattice.Nx % rx or lattice.Nt % rt:
            # reference exits the same way (mpi_setup.h:12-19)
            print(f"error: lattice {lattice.Nx}x{lattice.Nt} not divisible "
                  f"by mesh {rx}x{rt}", file=sys.stderr)
            return 1
        if rc > 1 and run.n_chains % rc:
            print(f"error: --chains {run.n_chains} not divisible by "
                  f"--ranks-chain {rc}", file=sys.stderr)
            return 1
        mesh = lattice_mesh(shape)

    kappa = 1.0 / (2.0 * (hmc.m0 + 2.0))
    echo("*" * 70)
    echo("*                              PARAMETERS")
    echo(f"* Nx = {lattice.Nx}, Nt = {lattice.Nt}")
    echo(f"* m0 = {hmc.m0:g}, kappa = {kappa:g}")
    if hmc.hasenbusch_dm:
        echo(f"* Hasenbusch split: auxiliary mass m1 = "
             f"{hmc.m0 + hmc.hasenbusch_dm:g} (dm = {hmc.hasenbusch_dm:g})")
    echo(f"* beta = {hmc.beta:g}" + ("  (quenched)" if hmc.quenched else ""))
    echo(f"* Thermalization confs = {run.n_therm}")
    echo(f"* Measurement confs = {run.n_meas}")
    echo(f"* Decorrelation steps (confs dropped between measurements) = {run.n_steps}")
    echo(f"* Trajectory length = {hmc.trajectory_length:g}, "
          f"Leapfrog steps = {hmc.md_steps}, "
          f"Integration step = {hmc.step_size:g}")
    refine_desc = (f" (mixed-precision: f32 inner tol {hmc.cg.inner_tol:g} "
                   f"+ f64 refinement)" if hmc.cg.refine else "")
    echo(f"* CG max iterations = {hmc.cg.max_iter}, "
         f"CG tolerance = {hmc.cg.tol:g}{refine_desc}")
    ftol = hmc.cg.resolved_force_tol()
    if ftol != hmc.cg.tol:
        # self-describing split-residual contract: action solves run at
        # cg.tol, force solves at the resolved force tolerance
        # (config.CGParams.force_tol; advisor round-4 finding)
        echo(f"* CG force tolerance = {ftol:g} "
             f"(action solves at {hmc.cg.tol:g})")
    mesh_desc = f"{rx}x{rt}" + (f" x {rc} chain groups" if rc > 1 else "")
    echo(f"* Device mesh = {mesh_desc} on {jax.default_backend()} "
          f"({len(jax.devices())} device(s) visible)")
    echo(f"* Chains = {run.n_chains}, dtype = {lattice.real_dtype}, "
          f"seed = {run.seed}")
    echo("*" * 70)

    from schwingermodel_tpu.utils.metrics import profiler_trace

    if primary:
        # SimData, saved and ill configurations all land here
        os.makedirs(run.out_dir, exist_ok=True)
    with profiler_trace(args.profile):
        result = run_hmc(
            lattice, hmc, run,
            initial_theta=initial_theta, start_traj_index=start_traj,
            measure_condensate=args.condensate, n_noise=args.n_noise,
            mesh=mesh, progress=lambda s: echo(s),
            write_simdata=not args.no_simdata,
        )
    if args.profile:
        print(f"Profiler trace written to {args.profile}")

    echo(f"Average plaquette value / volume: Ep = {result.Ep:.17g} "
          f"dEp = {result.dEp:.17g}")
    echo(f"Average gauge action / volume: gS = {result.gS:.17g} "
          f"dgS = {result.dgS:.17g}")
    if args.condensate:
        s = result.summary("chiral_condensate")
        print(f"Chiral condensate: {s['mean']:.10g} +- {s['error']:.3g} "
              f"(tau_int {s['tau_int']:.2f})")
    echo(f"Acceptance rate: {result.acceptance_rate:.17g}")
    n_traj = (result.traj_index - start_traj) * max(run.n_chains, 1)
    echo(f"<exp(-dH)> = {result.exp_mdH_mean:.17g}")
    echo(f"CG iterations per trajectory = "
         f"{result.cg_iters_total / max(n_traj, 1):.6g}")
    echo(f"All CG solves converged: {result.all_converged}")
    echo(f"Execution time = {result.elapsed_seconds:.6f} s")
    echo("-------------------------------")
    if result.n_ill:
        print(f"WARNING: {result.n_ill} ill (CG-failed) configurations dumped")

    if args.checkpoint and primary:
        # primary-only, like every other writer (result.theta is already a
        # globally gathered numpy copy -- runner.RunResult)
        save_checkpoint(
            args.checkpoint, theta=result.theta, key=result.key,
            traj_index=result.traj_index, lattice=lattice, hmc=hmc, run=run,
            chains={k: v.reshape(len(v), -1).mean(axis=1)
                    for k, v in result.chains.items()},
        )
        print(f"Checkpoint written to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
