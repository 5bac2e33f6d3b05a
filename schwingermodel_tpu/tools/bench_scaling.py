"""Volume-scaling harness: trajectory throughput vs device-mesh shape.

Measures HMC traj/s for the same physics at a fixed global lattice across a
list of mesh shapes (1x1 = single device baseline, then rx x rt lattice
domain decompositions and optional rc x rx x rt chain meshes), printing one
JSON line per mesh with the ratio to the single-device number.

Every mesh runs the sampler's trajectory (plain vmapped/sharded jnp path)
at the device's precision policy (utils/device.py). Against N virtual CPU
devices (--platform cpu --devices 8) it cannot measure a real interconnect
but does count the full SPMD overhead stack: ppermute halo exchanges per
Dirac hop, psum'd CG dots with cross-shard sync, and the lockstep CG
termination (solvers/cg.py sync_pred); its times are CPU times, never
device numbers. On a host of GPUs the same tool reports NVLink-attached
scaling (the reference's analog is its ranks_x x ranks_t MPI grid,
include/mpi_setup.h:39-71).

    python -m schwingermodel_tpu.tools.bench_scaling \
        --platform cpu --devices 8 --nx 64 --nt 64 \
        --meshes 1x1,1x2,2x2,1x4,2x4
"""

from __future__ import annotations

import argparse
import json
import time


def _parse_meshes(spec: str):
    out = []
    for part in spec.split(","):
        dims = tuple(int(d) for d in part.strip().split("x"))
        if len(dims) not in (2, 3):
            raise ValueError(f"mesh {part!r}: want RXxRT or RCxRXxRT")
        out.append(dims)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu.tools.bench_scaling")
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--m0", type=float, default=0.2)
    p.add_argument("--md-steps", type=int, default=10)
    p.add_argument("--tau", type=float, default=0.1)
    p.add_argument("--meshes", default="1x1,1x2,2x2,1x4")
    p.add_argument("--n-therm", type=int, default=30)
    p.add_argument("--n-timed", type=int, default=30)
    p.add_argument("--platform", default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="virtual CPU device count (cpu platform only)")
    # ---- multi-process chain-axis scaling (the BASELINE.md north star) ----
    p.add_argument("--chain-scaling", default=None, metavar="P1,P2,...",
                   help="orchestrate the chain-axis scaling proxy: spawn "
                        "each listed process count as real OS processes "
                        "under jax.distributed (CPU), report global traj/s "
                        "vs process count and the scaling efficiency")
    p.add_argument("--chains-per-slot", type=int, default=2,
                   help="locally vmapped chains per chain-mesh slot")
    p.add_argument("--json", default=None,
                   help="write the chain-scaling result table here")
    p.add_argument("--chain-worker", action="store_true",
                   help="run the chain-mesh measurement in THIS process "
                        "(multi-process launch auto-detected from SLURM / "
                        "Open MPI or the JAX_COORDINATOR_ADDRESS variables)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    if args.chain_scaling:
        return _chain_scaling_parent(args)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.devices:
        jax.config.update("jax_num_cpu_devices", args.devices)

    if args.coordinator is not None or args.chain_worker:
        return _chain_scaling_worker(args)

    import jax.numpy as jnp

    from schwingermodel_tpu.hmc.sampler import hmc_trajectory
    from schwingermodel_tpu.parallel.mesh import lattice_mesh
    from schwingermodel_tpu.parallel.sharded import (
        make_sharded_traj_fn, theta_sharding,
    )
    from schwingermodel_tpu.utils import prng
    from schwingermodel_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    model = _policy_model(args)
    lat = model.lattice
    key = prng.root_key(0)

    def block_fn(traj_fn, n, n_chains=1):
        @jax.jit
        def run(theta, k0):
            keys = jax.vmap(lambda i: prng.trajectory_key(k0, i))(
                jnp.arange(n))
            if n_chains > 1:
                keys = jax.vmap(lambda k: jax.vmap(
                    lambda c: jax.random.fold_in(k, c))(
                        jnp.arange(n_chains)))(keys)

            def body(th, k):
                th, st = traj_fn(th, k)
                return th, jnp.sum(st.cg_iters)

            th, it = jax.lax.scan(body, theta, keys)
            return th, jnp.sum(it)

        return run

    def measure(mesh_shape):
        n_chains = mesh_shape[0] if len(mesh_shape) == 3 else 1
        shape = ((n_chains,) if n_chains > 1 else ()) + (2, args.nx, args.nt)
        theta = jax.random.uniform(key, shape, minval=-jnp.pi,
                                   maxval=jnp.pi, dtype=lat.rdtype)
        if mesh_shape in ((1, 1), (1, 1, 1)):
            traj_fn = lambda th, k: hmc_trajectory(model, th, k)  # noqa: E731
        else:
            mesh = lattice_mesh(mesh_shape)
            theta = jax.device_put(theta, theta_sharding(mesh))
            traj_fn = make_sharded_traj_fn(model, mesh)
        therm = block_fn(traj_fn, args.n_therm, n_chains)
        theta, it = therm(theta, key)
        jax.device_get(it)
        timed = block_fn(traj_fn, args.n_timed, n_chains)
        th2, it = timed(theta, jax.random.fold_in(key, 1))
        jax.device_get(it)                      # compile + warm
        t0 = time.perf_counter()
        th2, it = timed(theta, jax.random.fold_in(key, 2))
        iters = int(jax.device_get(it))         # readback fence
        dt = time.perf_counter() - t0
        return args.n_timed * max(n_chains, 1) / dt, iters

    base = None
    for mesh_shape in _parse_meshes(args.meshes):
        n_dev = 1
        for d in mesh_shape:
            n_dev *= d
        if n_dev > len(jax.devices()):
            print(json.dumps({"mesh": "x".join(map(str, mesh_shape)),
                              "skipped": f"needs {n_dev} devices"}))
            continue
        tps, iters = measure(mesh_shape)
        if base is None:
            base = tps
        print(json.dumps({
            "metric": "hmc_traj_per_s",
            "mesh": "x".join(map(str, mesh_shape)),
            "lattice": f"{args.nx}x{args.nt}",
            "dtype": lat.real_dtype,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "value": round(tps, 3),
            "unit": "traj/s",
            "cg_iters": iters,
            "vs_single_device": round(tps / base, 3),
        }), flush=True)
    return 0


def _policy_model(args):
    """The benchmark model at this device's precision policy
    (utils/device.py); enables x64 where the policy needs it."""
    import jax

    from schwingermodel_tpu.tools.bench_points import policy_model
    from schwingermodel_tpu.utils.device import device_policy

    policy = device_policy()
    if policy.needs_x64:
        jax.config.update("jax_enable_x64", True)
    return policy_model(args.nx, args.nt, policy, beta=args.beta,
                        m0=args.m0, md_steps=args.md_steps,
                        trajectory_length=args.tau, max_iter=2000)


def _chain_scaling_worker(args) -> int:
    """One process of a jax.distributed chain-mesh run: measures GLOBAL
    traj/s over the ('chain','x','t') multihost mesh (chain axis across
    processes -- parallel/multihost.py's cross-host layout) and prints one
    JSON line from process 0."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.parallel import multihost
    from schwingermodel_tpu.parallel.sharded import (
        make_sharded_traj_fn,
        theta_sharding,
    )
    from schwingermodel_tpu.utils import prng
    from schwingermodel_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    multihost.maybe_initialize(args.coordinator, args.num_processes,
                               args.process_id)

    model = _policy_model(args)
    lat = model.lattice
    mesh = multihost.multihost_mesh(args.nx, args.nt)
    rc = mesh.shape["chain"]
    C = rc * args.chains_per_slot
    key = prng.root_key(0)

    theta = jax.random.uniform(key, (C, 2, args.nx, args.nt),
                               minval=-jnp.pi, maxval=jnp.pi,
                               dtype=lat.rdtype)
    theta = jax.device_put(theta, theta_sharding(mesh))
    traj = make_sharded_traj_fn(model, mesh)

    @jax.jit
    def block(th, k0, idx):
        def body(t, i):
            ks = jax.vmap(lambda c: jax.random.fold_in(
                prng.trajectory_key(k0, i), c))(jnp.arange(C))
            t, st = traj(t, ks)
            return t, jnp.sum(st.cg_iters)
        th, it = jax.lax.scan(body, th, idx)
        return th, jnp.sum(it)

    theta, it = block(theta, key, jnp.arange(args.n_therm))
    jax.device_get(it)
    th2, it = block(theta, jax.random.fold_in(key, 1),
                    jnp.arange(args.n_timed))
    jax.device_get(it)
    t0 = _time.perf_counter()
    th2, it = block(theta, jax.random.fold_in(key, 2),
                    jnp.arange(args.n_timed))
    jax.device_get(it)
    dt = _time.perf_counter() - t0

    if multihost.is_primary():
        print(json.dumps({
            "metric": "chain_scaling_traj_per_s",
            "processes": jax.process_count(),
            "chains_total": C,
            "lattice": f"{args.nx}x{args.nt}",
            "value": round(args.n_timed * C / dt, 3),
            "unit": "traj/s (global)",
        }), flush=True)
    return 0


def _chain_scaling_parent(args) -> int:
    """Spawn each process count as REAL OS processes (localhost
    jax.distributed coordinator, CPU backend) and report the chain-axis
    scaling efficiency: eff(P) = rate(P) / (P * rate(1)). This is the
    2-process CPU proxy for multi-host chain scaling; the same workers
    launched one per host (with --coordinator) measure the real
    network number."""
    import os
    import socket
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    rows = []
    for P in [int(x) for x in args.chain_scaling.split(",")]:
        port = free_port()
        env = {**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        cmd0 = [_sys.executable, "-m",
                "schwingermodel_tpu.tools.bench_scaling",
                "--platform", "cpu", "--devices", str(args.devices or 1),
                "--nx", str(args.nx), "--nt", str(args.nt),
                "--beta", str(args.beta), "--m0", str(args.m0),
                "--md-steps", str(args.md_steps), "--tau", str(args.tau),
                "--n-therm", str(args.n_therm),
                "--n-timed", str(args.n_timed),
                "--chains-per-slot", str(args.chains_per_slot),
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(P)]
        # Pin every worker to ONE core so eff(P) measures communication
        # overhead, not core-count dilution (the P=1 baseline would
        # otherwise use all host cores while P workers share them).
        ncores = os.cpu_count() or 1
        import shutil
        pin = shutil.which("taskset") is not None
        def cmd_for(i):
            base = cmd0 + ["--process-id", str(i)]
            if pin:
                return ["taskset", "-c", str(i % ncores)] + base
            return base
        procs = [subprocess.Popen(cmd_for(i),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=repo)
                 for i in range(P)]
        outs = [pr.communicate(timeout=1800)[0] for pr in procs]
        if any(pr.returncode for pr in procs):
            for i, o in enumerate(outs):
                print(f"--- P={P} proc {i} rc={procs[i].returncode} ---")
                print(o[-2000:])
            return 1
        row = None
        for line in outs[0].splitlines():
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if cand.get("metric") == "chain_scaling_traj_per_s":
                row = cand
        assert row is not None, outs[0][-2000:]
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]
    ncores = os.cpu_count() or 1
    for r in rows:
        scale = r["processes"] / base["processes"]
        r["efficiency_vs_linear"] = round(
            r["value"] / (base["value"] * scale), 3)
        # On a host with fewer cores than processes, linear scaling is
        # physically impossible (compute time-shares cores); the quantity
        # the proxy CAN measure there is whether the COMMUNICATION layer
        # (jax.distributed lockstep, per-block barriers) degrades beyond
        # core sharing: rate(P) vs the core-saturated ideal
        # rate(min(P, ncores)) * 1.
        sat = min(r["processes"], ncores) / min(base["processes"], ncores)
        r["efficiency_vs_core_saturated"] = round(
            r["value"] / (base["value"] * sat), 3)
    summary = {
        "metric": "chain_axis_scaling_efficiency",
        "per_process_devices": args.devices or 1,
        "host_cores": ncores,
        "rows": rows,
        "efficiency": rows[-1]["efficiency_vs_linear"],
        "efficiency_core_saturated": rows[-1][
            "efficiency_vs_core_saturated"],
    }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
