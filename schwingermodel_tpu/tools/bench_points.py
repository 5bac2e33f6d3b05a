"""Operating-point benches beyond the demo config.

The headline bench (bench.py) anchors on the reference demo config --
64x64, beta=4, m0=0.2, tau=0.1 -- which thermalizes at acceptance ~0.998,
the easiest point. POINTS below is the cell list where the solver contract
is actually stressed; it is kept as data for the benchmark definition:

  - 128x128 beta=4 m0=0.2 tau=0.1      (the flagship volume, BASELINE
                                        configs[5]; C=8 chains)
  - 64x64  beta=4 m0=0.2  tau=1        (physics trajectory length,
                                        acceptance 0.6-0.8 band,
                                        reference README.md:87-94), hand-set
                                        and autotuned
  - 32x32 / 64x64 beta=2 m0=-0.19 tau=1 with Hasenbusch (near-critical:
                                        m_crit(beta=2) = -0.1968(9); CG
                                        iteration counts blow up,
                                        README.md:94)

Every point runs the runner's trajectory step -- C vmapped chains of
sampler.hmc_trajectory -- at the device's precision policy
(utils/device.py: f32 + 1e-10 x64 refinement on a GPU) and prints one JSON
row: traj/s, acceptance, CG iters/traj, all solves converged, and the
device it ran on. Without a GPU the tool exits non-zero.

    python -m schwingermodel_tpu.tools.bench_points [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import time


POINTS = [
    # name, Nx, Nt, beta, m0, md_steps, tau, chains, n_timed,
    #   integrator, max_iter, extras
    ("128x128_b4_tau0.1", 128, 128, 4.0, 0.2, 10, 0.1, 8, 60,
     "leapfrog", 10000, {}),
    # tau=1 at 64x64 needs dt fine enough for the 0.6-0.8 acceptance
    # band (dH ~ dt^4 * V; the reference's "MD_steps=10, tau=1" advice is
    # calibrated on its 8x8/16x16 validation lattices, README.md:87-94)
    ("64x64_b4_tau1", 64, 64, 4.0, 0.2, 40, 1.0, 32, 40,
     "leapfrog", 10000, {}),
    # the same point with the dual-averaging autotuner choosing the step
    # (hmc/autotune.py; target 0.7 = mid reference band README.md:87-94)
    ("64x64_b4_tau1_tuned", 64, 64, 4.0, 0.2, 40, 1.0, 32, 40,
     "leapfrog", 10000, {"tune": True}),
    # near-critical at m_crit(beta=2) = -0.1968(9): single-pseudofermion
    # HMC acceptance collapses with volume here (the reference's own 32x32
    # golden runs at acceptance 0.002, tests/golden/refphys.json); these
    # rows run Hasenbusch mass preconditioning (two pseudofermions,
    # config.HMCParams.hasenbusch_dm).
    ("32x32_b2_m-0.19_tau1_hb", 32, 32, 2.0, -0.19, 26, 1.0, 32, 40,
     "leapfrog", 20000, {"hasenbusch_dm": 0.4}),
    ("64x64_b2_m-0.19_tau1_hb", 64, 64, 2.0, -0.19, 36, 1.0, 16, 30,
     "leapfrog", 20000, {"hasenbusch_dm": 0.4}),
]


def make_block(model, C):
    """n trajectories of C vmapped chains (the runner's step,
    runner._traj_fn + jax.vmap) as one device program; returns the
    summed acceptance, CG iterations and converged flags."""
    import functools

    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.hmc import sampler
    from schwingermodel_tpu.utils import prng

    traj = jax.vmap(functools.partial(sampler.hmc_trajectory, model))

    @functools.partial(jax.jit, static_argnames=("n",))
    def block(th, k0, n):
        def body(carry, i):
            keys = jax.random.split(prng.trajectory_key(k0, i), C)
            th, st = traj(carry, keys)
            return th, (jnp.sum(st.accepted), jnp.sum(st.cg_iters),
                        jnp.sum(st.cg_converged))
        th, (acc, it, cv) = jax.lax.scan(body, th, jnp.arange(n))
        return th, jnp.sum(acc), jnp.sum(it), jnp.sum(cv)

    return block


def run_cell(model, C, n_therm, n_timed, seed=0, anneal=(), tune=False,
             chunk=20):
    """Throughput of one cell on the vmapped sampler.

    anneal: intermediate m0 values to thermalize through before the target
    mass -- near m_crit a hot start sits on exceptional configurations that
    reject forever. tune: run the dual-averaging step-size warmup after
    thermalization and time at the tuned md_steps. Programs are chunked to
    `chunk` trajectories with a host fence each. Returns
    (traj/s, acceptance, CG iters/traj, all converged, tune info)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.utils import prng

    Nx, Nt = model.lattice.Nx, model.lattice.Nt
    key = prng.root_key(seed)
    th = jax.random.uniform(
        jax.random.fold_in(key, 7), (C, 2, Nx, Nt),
        minval=-jnp.pi, maxval=jnp.pi, dtype=model.lattice.rdtype)

    def run_chunks(block, th, k0, n):
        acc = iters = conv = 0.0
        done = 0
        while done < n:
            m = min(chunk, n - done)
            th, a, it, cv = block(th, jax.random.fold_in(k0, done), m)
            acc += float(a); iters += float(it); conv += float(cv)
            done += m
        return th, acc, iters, conv

    for k, m0_a in enumerate(anneal):
        m_a = dataclasses.replace(
            model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
        th, *_ = run_chunks(make_block(m_a, C), th,
                            jax.random.fold_in(key, 500 + k), n_therm)

    block = make_block(model, C)
    th, *_ = run_chunks(block, th, key, n_therm)

    tune_info = {}
    if tune:
        from schwingermodel_tpu.hmc import autotune as at

        th, hmc_tuned, eps = at.autotune(
            model, th, jax.random.fold_in(key, 0x7E0E), n_tune=150,
            target=0.7)
        tune_info = {"tuned": True, "tuned_eps": float(eps),
                     "md_steps_tuned": int(hmc_tuned.md_steps)}
        model = dataclasses.replace(model, hmc=hmc_tuned)
        block = make_block(model, C)
        # short re-thermalization at the tuned step
        th, *_ = run_chunks(block, th, jax.random.fold_in(key, 3),
                            min(40, n_therm))

    run_chunks(block, th, jax.random.fold_in(key, 1), n_timed)  # compile
    t0 = time.perf_counter()
    _, acc, iters, conv = run_chunks(block, th, jax.random.fold_in(key, 2),
                                     n_timed)
    dt = time.perf_counter() - t0
    n = n_timed * C
    return n / dt, acc / n, iters / n, conv == n, tune_info


def policy_model(Nx, Nt, policy, **hmc_kw):
    """SchwingerModel at the device's precision policy; CG max_iter from
    hmc_kw['max_iter'] (default 10000)."""
    from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu.models.schwinger import SchwingerModel

    max_iter = hmc_kw.pop("max_iter", 10000)
    cg = CGParams(tol=1e-10, max_iter=max_iter, refine=policy.refine,
                  refine_impl=policy.refine_impl)
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=policy.real_dtype),
        hmc=HMCParams(even_odd=True, cg=cg, **hmc_kw))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu.tools.bench_points")
    p.add_argument("--json", default=None)
    p.add_argument("--only", default=None,
                   help="substring filter on point names")
    p.add_argument("--n-therm", type=int, default=60)
    args = p.parse_args(argv)

    import jax

    from schwingermodel_tpu.utils.cache import enable_compilation_cache
    from schwingermodel_tpu.utils.device import device_policy, require_gpu

    enable_compilation_cache()
    device = require_gpu()
    policy = device_policy()
    if policy.needs_x64:
        jax.config.update("jax_enable_x64", True)

    rows = []
    for (name, Nx, Nt, beta, m0, md, tau, C, n_timed, integ,
         max_it, extras) in POINTS:
        if args.only and args.only not in name:
            continue
        hb_dm = extras.get("hasenbusch_dm")
        model = policy_model(
            Nx, Nt, policy, beta=beta, m0=m0, md_steps=md,
            trajectory_length=tau, integrator=integ, hasenbusch_dm=hb_dm,
            max_iter=max_it)
        anneal = (0.0, m0 / 2) if m0 < 0 else ()
        v, acc, iters, conv, tune_info = run_cell(
            model, C, args.n_therm, n_timed, anneal=anneal,
            tune=bool(extras.get("tune")))
        row = {"metric": f"hmc_traj_per_s_{name}", "value": v,
               "unit": "traj/s",
               "contract": f"1e-10 ({policy.real_dtype}"
                           f"{' + x64 refinement' if policy.refine else ''})",
               "lattice": f"{Nx}x{Nt}", "beta": beta, "m0": m0,
               "md_steps": md, "tau": tau, "integrator": integ,
               "chains": C, "acceptance": acc, "cg_iters_per_traj": iters,
               "all_converged": bool(conv), **device}
        if hb_dm is not None:
            row["hasenbusch_dm"] = hb_dm
        row.update(tune_info)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
