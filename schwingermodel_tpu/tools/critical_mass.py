"""Locate the critical mass m_crit(beta) from the PCAC quark mass.

Reproduces the physics behind the reference's critical-mass table
(README.md:100-111, quoted from Christian/Jansen/Nagai/Pollakowski,
Nucl. Phys. B 739 (2006)): scan m0 at fixed beta, measure the PCAC quark
mass m_PCAC = d_t C_{A0 P} / (2 C_PP) from point-source correlators
(observables.meson_correlators) on decorrelated configurations, and
linearly extrapolate m_PCAC(m0) -> 0. Wilson fermions: m_PCAC vanishes at
m0 = m_crit, linearly up to O(a) artifacts.

HMC runs C vmapped chains of the sampler at the device's precision policy
(utils/device.py: f32 + 1e-10 x64 refinement on a GPU, f64 on the CPU); the
correlator solves ride the same precision dispatch via dirac_inverse.

    python -m schwingermodel_tpu.tools.critical_mass \
        --beta 2 --nx 16 --nt 16 \
        --m0-list=-0.30,-0.26,-0.22,-0.18,-0.14 \
        --json docs/critical_mass_b2.json --markdown docs/CRITICAL_MASS.md
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np


def jackknife_bins(samples: np.ndarray, n_bins: int = 20):
    """[n, ...] -> [n_bins, ...] leave-one-bin-out means."""
    n = (samples.shape[0] // n_bins) * n_bins
    s = samples[:n].reshape(n_bins, -1, *samples.shape[1:])
    bin_means = s.mean(axis=1)
    total = bin_means.mean(axis=0)
    return total, np.array([
        (total * n_bins - bin_means[i]) / (n_bins - 1)
        for i in range(n_bins)])


def pcac_plateau(C_PP: np.ndarray, C_A0P: np.ndarray, window):
    """Plateau-averaged m_PCAC with jackknife error from per-measurement
    correlators [n, Nt]."""
    from schwingermodel_tpu.observables import pcac_mass

    n_bins = min(20, max(4, C_PP.shape[0] // 4))
    _, pp_jk = jackknife_bins(C_PP, n_bins)
    _, ap_jk = jackknife_bins(C_A0P, n_bins)
    t0, t1 = window
    # nanmean: pcac_mass masks (statistically impossible) C_PP <= 0 noise
    # artifacts as NaN instead of letting them flip the ratio's sign
    vals = np.array([
        np.nanmean(pcac_mass(pp_jk[i], ap_jk[i])[t0:t1])
        for i in range(pp_jk.shape[0])])
    center = np.nanmean(
        pcac_mass(C_PP.mean(axis=0), C_A0P.mean(axis=0))[t0:t1])
    err = float(np.sqrt((n_bins - 1) * np.var(vals)))
    return float(center), err


def fit_zero_crossing(m0s, ms, errs):
    """Weighted linear fit m_PCAC = a (m0 - m_crit); returns
    (m_crit, err, slope)."""
    w = 1.0 / np.maximum(np.asarray(errs), 1e-12) ** 2
    x = np.asarray(m0s)
    y = np.asarray(ms)
    S, Sx, Sy = w.sum(), (w * x).sum(), (w * y).sum()
    Sxx, Sxy = (w * x * x).sum(), (w * x * y).sum()
    D = S * Sxx - Sx * Sx
    a = (S * Sxy - Sx * Sy) / D          # slope
    b = (Sxx * Sy - Sx * Sxy) / D        # intercept
    var_a = S / D
    var_b = Sxx / D
    cov_ab = -Sx / D
    m_crit = -b / a
    # error propagation for -b/a
    err = abs(m_crit) * np.sqrt(
        var_b / b ** 2 + var_a / a ** 2 - 2 * cov_ab / (a * b))
    return float(m_crit), float(err), float(a)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu.tools.critical_mass")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--nt", type=int, default=16)
    # scan the SUBcritical side only (m0 > m_crit = -0.1968): beyond the
    # critical mass Wilson HMC sits on exceptional configurations and the
    # PCAC signal drowns; the zero crossing extrapolates linearly from
    # m_q > 0 exactly as in the reference's source (Nucl. Phys. B 739)
    p.add_argument("--m0-list", default="-0.18,-0.16,-0.14,-0.12,-0.10")
    p.add_argument("--md-steps", type=int, default=20)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--n-therm", type=int, default=200)
    p.add_argument("--n-blocks", type=int, default=40,
                   help="measurement blocks (one correlator set per chain "
                        "per block)")
    p.add_argument("--n-skip", type=int, default=5,
                   help="decorrelation trajectories between blocks")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--min-acceptance", type=float, default=0.5,
                   help="points below this acceptance are reported but "
                        "excluded from the zero-crossing fit (stuck "
                        "chains bias the plateau)")
    p.add_argument("--json", default=None)
    p.add_argument("--markdown", default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.utils.cache import enable_compilation_cache
    from schwingermodel_tpu.utils.device import device_policy

    enable_compilation_cache()
    policy = device_policy()
    if policy.needs_x64:
        jax.config.update("jax_enable_x64", True)

    from schwingermodel_tpu import observables as obs
    from schwingermodel_tpu.hmc.sampler import hmc_trajectory
    from schwingermodel_tpu.tools.bench_points import policy_model
    from schwingermodel_tpu.utils import prng

    Nx, Nt, C = args.nx, args.nt, args.chains

    def make_block(model):
        """n vmapped trajectories of all C chains as one device program."""
        @functools.partial(jax.jit, static_argnames=("n",))
        def block(th, k0, n):
            def body(carry, i):
                th = carry
                keys = jax.vmap(lambda c: jax.random.fold_in(
                    prng.trajectory_key(k0, i), c))(jnp.arange(C))
                th, st = jax.vmap(
                    lambda t, k: hmc_trajectory(model, t, k))(th, keys)
                return th, jnp.sum(st.accepted)
            th, acc = jax.lax.scan(body, th, jnp.arange(n))
            return th, jnp.sum(acc)
        return block

    def run_point(m0: float):
        model = policy_model(Nx, Nt, policy, beta=args.beta, m0=m0,
                             md_steps=args.md_steps,
                             trajectory_length=args.tau, max_iter=20000)
        import dataclasses

        key = prng.root_key(args.seed)
        th = jax.random.uniform(
            jax.random.fold_in(key, 11), (C, 2, Nx, Nt),
            minval=-jnp.pi, maxval=jnp.pi, dtype=model.lattice.rdtype)
        block = make_block(model)

        @jax.jit
        def measure(thetas):
            def one(t):
                r = obs.meson_correlators(model, t)
                return r.C_PP, r.C_A0P, r.solves.all_converged

            pp, ap, conv = jax.lax.map(one, thetas)
            return pp, ap, jnp.all(conv)

        # anneal the thermalization through a safe mass (hot starts near
        # m_crit otherwise stick on exceptional configurations)
        if m0 < -0.05:
            for k, m0_a in enumerate((0.0, m0 / 2)):
                m_a = dataclasses.replace(
                    model, hmc=dataclasses.replace(model.hmc, m0=m0_a))
                th, a_ = make_block(m_a)(
                    th, jax.random.fold_in(key, 700 + k), args.n_therm // 2)
                float(a_)
        th, acc = block(th, key, args.n_therm)
        acc_count = float(acc)
        pps, aps = [], []
        all_conv = True
        for bidx in range(args.n_blocks):
            th, acc = block(th, jax.random.fold_in(key, 1000 + bidx),
                            args.n_skip)
            acc_count += float(acc)
            pp, ap, conv = measure(th)
            all_conv &= bool(conv)
            pps.append(np.asarray(pp, np.float64))
            aps.append(np.asarray(ap, np.float64))
        n_traj = (args.n_therm + args.n_blocks * args.n_skip) * C
        acc_rate = acc_count / n_traj
        C_PP = np.concatenate(pps, axis=0)
        C_A0P = np.concatenate(aps, axis=0)
        window = (3, max(5, Nt // 2 - 1))
        m, err = pcac_plateau(C_PP, C_A0P, window)
        return m, err, acc_rate, all_conv

    m0s = [float(x) for x in args.m0_list.split(",")]
    rows = []
    for m0 in m0s:
        m, err, acc, conv = run_point(m0)
        row = {"m0": m0, "m_pcac": m, "err": err,
               "acceptance": round(acc, 3), "all_converged": conv}
        rows.append(row)
        print(json.dumps(row), flush=True)

    fit_rows = [r for r in rows
                if r["acceptance"] >= args.min_acceptance]
    dropped = [r["m0"] for r in rows if r not in fit_rows]
    m_crit, m_err, slope = fit_zero_crossing(
        [r["m0"] for r in fit_rows], [r["m_pcac"] for r in fit_rows],
        [r["err"] for r in fit_rows])
    # the reference's critical-mass table (README.md:100-111, from
    # Christian/Jansen/Nagai/Pollakowski, Nucl. Phys. B 739 (2006))
    LITERATURE = {1.0: (-0.3204, 0.0007), 2.0: (-0.1968, 0.0009),
                  3.0: (-0.1351, 0.0002), 4.0: (-0.1033, 0.0001),
                  5.0: (-0.0840, 0.0001), 6.0: (-0.0719, 0.0001)}
    lit = LITERATURE.get(float(args.beta))
    summary = {
        "metric": "critical_mass",
        "beta": args.beta, "lattice": f"{Nx}x{Nt}",
        "m_crit": round(m_crit, 5), "err": round(m_err, 5),
        "slope": round(slope, 4),
        "fit_points": len(fit_rows),
        "dropped_low_acceptance": dropped,
        "literature": {"m_crit": lit[0] if lit else None,
                       "err": lit[1] if lit else None,
                       "source": "reference README.md:100-111 "
                                 "(Nucl. Phys. B 739 (2006))"},
        "rows": rows,
    }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(f"# Critical mass at beta = {args.beta:g}\n\n")
            f.write(
                f"PCAC quark-mass scan on {Nx}x{Nt} ({policy.real_dtype}"
                f"{' + 1e-10 x64 refinement' if policy.refine else ''}, "
                f"{C} vmapped chains; "
                f"md_steps={args.md_steps}, tau={args.tau:g}).\n\n"
                "| m0 | m_PCAC | err | acceptance |\n|---|---|---|---|\n")
            for r in rows:
                f.write(f"| {r['m0']:g} | {r['m_pcac']:.5f} | "
                        f"{r['err']:.5f} | {r['acceptance']:.3f} |\n")
            lit_s = (f"{lit[0]:g}({round(lit[1] * 1e4):g}e-4)" if lit
                     else "n/a")
            f.write(
                f"\nLinear zero crossing: **m_crit = {m_crit:.4f} +- "
                f"{m_err:.4f}** (literature, infinite-volume: "
                f"{lit_s}, reference README.md:100-111; finite-{Nx}^2 "
                f"lattice artifacts shift the crossing at O(a, 1/L)).\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
