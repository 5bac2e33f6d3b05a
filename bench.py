"""Headline benchmark: HMC trajectories/second at 64x64 (reference demo config).

Runs the runner's trajectory step -- C vmapped chains of
sampler.hmc_trajectory -- at the device's precision policy
(utils/device.py: float32 with x64 true-residual refinement on a GPU, so
every solve meets the reference's 1e-10 contract on an f64 residual,
src/main.cpp:26-27 / src/conjugate_gradient.cpp:45). That is exactly what
`python -m schwingermodel_tpu` runs on the card.

Prints one JSON line per metric; the LAST line is the headline (aggregate
trajectories/s at C=32). Every row names the device it ran on: platform,
device kind, device count and the card's name and power limit
(nvidia-smi). Without a GPU the bench exits non-zero instead of timing
the CPU.

Baseline: the C++/MPI reference (Fabian2598/SchwingerModel) publishes no
performance numbers (BASELINE.md); CPP_BASELINE_TRAJ_PER_S is the
reference compiled -O3, single rank, on one x86 CPU core at the same
config -- 64x64, beta=4, m0=0.2, 10 MD steps, tau=0.1 (run.sh:4-17), tol
1e-10 in f64. vs_baseline = our traj/s divided by that.

Methodology: timed trajectories run as one device program (lax.scan) per
chunk; a host readback of the outputs is the timing fence; the timed
program is compiled and run once before the timed window.
"""

import json

from schwingermodel_tpu.utils.cache import enable_compilation_cache

# reference @ g++ -O3, single rank, one x86 CPU core, 64x64, beta=4,
# m0=0.2, MD_steps=10, tau=0.1, CG tol 1e-10 (f64), 100 therm + 100 meas
# trajectories from hot start: 200 traj / 112.04 s.
CPP_BASELINE_TRAJ_PER_S = 1.785

N_THERM = 100
N_CHAINS = 32


def emit(metric, value, unit, vs_baseline=None, **extra):
    row = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    row.update(extra)
    print(json.dumps(row), flush=True)


def main():
    import jax

    from schwingermodel_tpu.tools.bench_points import policy_model, run_cell
    from schwingermodel_tpu.utils.device import device_policy, require_gpu

    enable_compilation_cache()
    device = require_gpu()
    policy = device_policy()
    if policy.needs_x64:
        jax.config.update("jax_enable_x64", True)
    model = policy_model(64, 64, policy, beta=4.0, m0=0.2, md_steps=10,
                         trajectory_length=0.1, max_iter=2000)
    contract = (f"1e-10 ({policy.real_dtype}"
                f"{' + x64 refinement' if policy.refine else ''})")

    v1, acc1, it1, conv1, _ = run_cell(model, 1, N_THERM, 200, seed=0)
    emit("hmc_traj_per_s_64x64", v1, "traj/s",
         v1 / CPP_BASELINE_TRAJ_PER_S, contract=contract, chains=1,
         acceptance=acc1, cg_iters_per_traj=it1, all_converged=conv1,
         **device)

    v, acc, it, conv, _ = run_cell(model, N_CHAINS, N_THERM, 100, seed=1)
    emit("hmc_traj_per_s_64x64_agg_c32", v, "traj/s",
         v / CPP_BASELINE_TRAJ_PER_S, contract=contract, chains=N_CHAINS,
         acceptance=acc, cg_iters_per_traj=it, all_converged=conv,
         **device)


if __name__ == "__main__":
    main()
