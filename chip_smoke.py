#!/usr/bin/env python3
"""Smoke test of the HMC main path on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the lattice-sharded path on four

One card: runs the on-card test tier (tests_gpu/) and the reference's demo
configuration (64x64, beta=4, m0=0.2, 10 MD steps, tau=0.1; reference
run.sh:4-17) through `python -m schwingermodel_tpu` at 1 and 32 vmapped
chains, each in a child process started before this process touches the
card (one JAX process per card at a time). Then, in this process: the
refined solve against the NumPy f64 oracle (tests/reference_impl.py), the
same-noise dH of the GPU policy against float64 throughout, the compiled
trajectory step (compile time, memory_analysis, no dot/convolution in its
HLO), eft_selfcheck() (reported, not asserted) and the jnp even-odd CG's
microseconds per iteration.

--four-cards: only the lattice-sharded path and what it is compared with:
one trajectory through the CLI on a (2,2) lattice mesh and on a (4,1,1)
chain mesh with 4 chains, each against the same CLI run on one card (same
seed).

Prints the card's name and power limit (nvidia-smi) first, one line per
phase, and as its last line exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed phase raises and the script exits non-zero without that line;
so does a run that finds no GPU or no repository next to this file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")

# the reference's demo configuration (run.sh:4-17)
N_DEMO = 64
DEMO = ["--beta", "4", "--m0", "0.2", "--md-steps", "10", "--tau", "0.1",
        "--nsteps", "0"]
# (lattice extent, chains) of the CG microseconds-per-iteration rows
CG_ROWS = ((64, 1), (64, 32), (128, 8))
# same-noise dH, f32 + x64 refinement vs float64 throughout, 64x64 demo:
# the f32 MD error (angles, momenta, forces rounded to f32 every step),
# measured 1.1e-4 on CPU with this code -- the solver contributes ~1e-8.
DH_TOL = 1e-3
# one card against four: same acceptance decisions, and angles within this
# after each trajectory (psum order differs across cards; f32 MD).
THETA_TOL = 1e-4

ONE_CARD = ["gpu_tests", "cli_demo_c1", "cli_demo_c32", "oracle_solve",
            "same_noise_dh", "trajectory_step", "eft_selfcheck",
            "cg_us_per_iter"]
FOUR_CARDS = ["cli_lattice_2x2", "cli_chains_4x1x1", "one_card_vs_2x2",
              "one_card_vs_4x1x1"]
# phases that run in a child process, before this process opens the card
CHILD = {"gpu_tests", "cli_demo_c1", "cli_demo_c32", "cli_lattice_2x2",
         "cli_chains_4x1x1"}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def device_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def select_phases(four_cards: bool) -> list:
    return list(FOUR_CARDS if four_cards else ONE_CARD)


def parse_cli(stdout: str) -> dict:
    """The numbers `python -m schwingermodel_tpu` prints at the end."""
    pats = {
        "acceptance": r"Acceptance rate: (\S+)",
        "exp_mdH": r"<exp\(-dH\)> = (\S+)",
        "cg_iters_per_traj": r"CG iterations per trajectory = (\S+)",
        "all_converged": r"All CG solves converged: (\S+)",
        "Ep": r"Ep = (\S+)",
        "seconds": r"Execution time = (\S+) s",
    }
    out = {}
    for k, p in pats.items():
        m = re.search(p, stdout)
        if m is None:
            raise PhaseError(f"CLI output lacks {k!r}:\n{stdout[-2000:]}")
        v = m.group(1)
        out[k] = v == "True" if k == "all_converged" else float(v)
    out["perf"] = [ln[len("perf: "):] for ln in stdout.splitlines()
                   if ln.startswith("perf: ")]
    return out


def report(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


# ---------------------------------------------------------------- children

def _child(cmd, timeout):
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise PhaseError(f"{' '.join(cmd)} exited {p.returncode}:\n"
                         f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return p.stdout, wall


def cli_argv(out_dir, chains=1, ranks=(1, 1), ranks_chain=1, n_therm=10,
             n_meas=20, checkpoint=None, seed=1):
    argv = DEMO + ["--nx", str(N_DEMO), "--nt", str(N_DEMO),
                   "--ntherm", str(n_therm), "--nmeas", str(n_meas),
                   "--ranks-x", str(ranks[0]), "--ranks-t", str(ranks[1]),
                   "--chains", str(chains), "--seed", str(seed),
                   "--out-dir", out_dir]
    if ranks_chain > 1:
        argv += ["--ranks-chain", str(ranks_chain)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    return argv


def run_cli_child(name, **kw):
    out_dir = os.path.join(OUT, name)
    stdout, wall = _child([sys.executable, "-m", "schwingermodel_tpu"]
                          + cli_argv(out_dir, **kw), timeout=900)
    res = parse_cli(stdout)
    res["wall_s"] = wall
    res["simdata"] = [os.path.basename(f) for f in
                      glob.glob(os.path.join(out_dir, "*SimData.txt"))]
    return res


def phase_gpu_tests():
    import xml.etree.ElementTree as ET

    xml = os.path.join(OUT, "tests_gpu.xml")
    stdout, wall = _child([sys.executable, "-m", "pytest", "tests_gpu", "-q",
                           "-p", "no:cacheprovider", f"--junitxml={xml}"],
                          timeout=900)
    counts = dict.fromkeys(("tests", "errors", "failures", "skipped"), 0)
    for suite in ET.parse(xml).getroot().iter("testsuite"):
        for k in counts:
            counts[k] += int(suite.get(k, 0))
    n = counts.pop("tests")
    check(n > 0 and not any(counts.values()),
          f"tests_gpu: {n} tests, {counts}:\n{stdout[-3000:]}")
    report("gpu_tests", tests=n, passed=n, wall_s=wall)


def _demo_phase(name, chains, n_therm, n_meas):
    r = run_cli_child(name, chains=chains, n_therm=n_therm, n_meas=n_meas)
    check(r["all_converged"], f"{name}: a CG solve did not converge")
    check(r["acceptance"] > 0.9, f"{name}: acceptance {r['acceptance']}")
    check(len(r["simdata"]) == 1, f"{name}: no SimData file written")
    report(name, chains=chains, trajectories=(n_therm + n_meas) * chains,
           **r)


def phase_cli_demo_c1():
    _demo_phase("cli_demo_c1", 1, 10, 20)


def phase_cli_demo_c32():
    _demo_phase("cli_demo_c32", 32, 5, 10)


# the four-card comparisons: ONE trajectory from the same seed, on a mesh
# (child process, all four cards) and on one card (this process)
MESH_RUNS = {
    "2x2": dict(chains=1, ranks=(2, 2)),
    "4x1x1": dict(chains=4, ranks_chain=4),
}


def _mesh_cli(tag):
    name = "cli_" + ("lattice_" if tag == "2x2" else "chains_") + tag
    r = run_cli_child(name, n_therm=0, n_meas=1,
                      checkpoint=os.path.join(OUT, f"ck_{tag}.npz"),
                      **MESH_RUNS[tag])
    check(r["all_converged"], f"{name}: a CG solve did not converge")
    report(name, **r)
    return r


def phase_cli_lattice_2x2():
    return _mesh_cli("2x2")


def phase_cli_chains_4x1x1():
    return _mesh_cli("4x1x1")


# ------------------------------------------------------------- this process

def init_jax(n_cards):
    """Open the card(s) in this process; PhaseError without a GPU."""
    import jax

    from schwingermodel_tpu.utils.cache import enable_compilation_cache
    from schwingermodel_tpu.utils.device import device_policy

    enable_compilation_cache()
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= n_cards, f"{len(devs)} GPU(s), need {n_cards}")
    policy = device_policy()
    jax.config.update("jax_enable_x64", policy.needs_x64)
    return policy


def _demo_model(policy, N=None, dtype=None, **kw):
    from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu.models.schwinger import SchwingerModel

    N = N or N_DEMO
    dtype = dtype or policy.real_dtype
    refine = policy.refine and dtype == "float32"
    return SchwingerModel(
        lattice=LatticeParams(Nx=N, Nt=N, real_dtype=dtype),
        hmc=HMCParams(beta=4.0, m0=0.2, md_steps=10, trajectory_length=0.1,
                      even_odd=True,
                      cg=CGParams(tol=1e-10, max_iter=10000, refine=refine,
                                  refine_impl=policy.refine_impl), **kw))


def _hot(key, shape, dtype):
    import jax
    import jax.numpy as jnp

    return jax.random.uniform(key, shape, minval=-jnp.pi, maxval=jnp.pi,
                              dtype=dtype)


def phase_oracle_solve(policy):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from schwingermodel_tpu.ops import eo

    # by file location: another installed package may own the name `tests`
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from reference_impl import links_ref, schur_normal_ref

    N = N_DEMO
    model = _demo_model(policy)
    key = jax.random.PRNGKey(11)
    theta = _hot(key, (2, N, N), jnp.float32)
    kb = jax.random.split(key)[1]
    b = jax.lax.complex(*jax.random.normal(kb, (2, 2, N, N // 2),
                                           jnp.float32))
    t0 = time.perf_counter()
    res = jax.jit(lambda t, v: model._solve_eo(t, model.eo_ops(t), v))(
        theta, b)
    jax.block_until_ready(res)
    secs = time.perf_counter() - t0
    zeros = jnp.zeros_like(res.x)
    x = np.asarray(eo.unpack(model.geom, res.x, zeros))
    bf = np.asarray(eo.unpack(model.geom, b.astype(jnp.complex128), zeros))
    r = bf - schur_normal_ref(links_ref(theta), x, model.hmc.m0)
    rel = float(np.linalg.norm(r) / np.linalg.norm(bf))
    report("oracle_solve", lattice=f"{N}x{N}", operator="Dhat Dhat^+",
           rel_true_residual_f64=rel, limit=1e-10,
           solver_converged=bool(res.converged), cg_iters=int(res.iters),
           compile_and_run_s=secs)
    check(bool(res.converged) and rel <= 1e-10,
          f"oracle_solve: true residual {rel:.3e} > 1e-10")


def phase_same_noise_dh(policy):
    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.hmc.sampler import draw_noise, trajectory_given_noise
    from schwingermodel_tpu.utils.device import device_policy

    m32 = _demo_model(policy)
    m64 = _demo_model(device_policy("cpu"))     # float64 throughout
    key = jax.random.PRNGKey(12)
    th = _hot(jax.random.fold_in(key, 1), (2, N_DEMO, N_DEMO), jnp.float32)
    pi, chi, r = draw_noise(m32, th.shape, jax.random.fold_in(key, 2))

    def traj(m, *a):
        return jax.jit(lambda *b: trajectory_given_noise(m, *b))(*a)

    t0 = time.perf_counter()
    _, s32 = traj(m32, th, pi, chi, r)
    _, s64 = traj(m64, th.astype(jnp.float64), pi.astype(jnp.float64),
                  chi.astype(jnp.complex128), r.astype(jnp.float64))
    jax.block_until_ready((s32, s64))
    d = abs(float(s32.delta_H) - float(s64.delta_H))
    report("same_noise_dh", dH_f32_x64=float(s32.delta_H),
           dH_f64=float(s64.delta_H), abs_diff=d, tol=DH_TOL,
           accepted=[bool(s32.accepted), bool(s64.accepted)],
           cg_iters=[int(s32.cg_iters), int(s64.cg_iters)],
           compile_and_run_s=time.perf_counter() - t0)
    check(bool(s32.cg_converged) and bool(s64.cg_converged),
          "same_noise_dh: a solve did not converge")
    check(d <= DH_TOL, f"same_noise_dh: |ddH| {d:.3e} > {DH_TOL}")
    # decisions agree unless the uniform sits inside the dH band
    band = abs(float(jnp.exp(-s64.delta_H)) - float(r)) <= 2 * DH_TOL
    check(bool(s32.accepted) == bool(s64.accepted) or band,
          "same_noise_dh: acceptance decisions differ")


_HLO_MATMUL = re.compile(r"\b(dot|convolution)\(|__cublas")


def phase_trajectory_step(policy):
    """The runner's step at 1 and 32 chains: compile time,
    memory_analysis, and no matrix product in its HLO (TF32 cannot
    apply)."""
    import functools

    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.hmc import sampler

    model = _demo_model(policy)
    for C in (1, 32):
        step = functools.partial(sampler.hmc_trajectory, model)
        shape = (2, N_DEMO, N_DEMO)
        shape = shape if C == 1 else (C,) + shape
        keys = (jax.random.PRNGKey(3) if C == 1
                else jax.random.split(jax.random.PRNGKey(3), C))
        fn = jax.jit(step if C == 1 else jax.vmap(step))
        th = _hot(jax.random.PRNGKey(4), shape, jnp.float32)
        t0 = time.perf_counter()
        lowered = fn.lower(th, keys)
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        hlo = compiled.as_text()
        mm = sorted(set(m.group(0) for m in _HLO_MATMUL.finditer(hlo)))
        mem = compiled.memory_analysis()
        th2, st = compiled(th, keys)
        jax.block_until_ready(th2)
        t3 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            th2, st = compiled(th2, keys)
        jax.block_until_ready(th2)
        t4 = time.perf_counter()
        report("trajectory_step", chains=C, lower_s=t1 - t0,
               compile_s=t2 - t1, first_run_s=t3 - t2,
               steady_s_per_step=(t4 - t3) / reps,
               cg_iters_per_traj=float(jnp.mean(st.cg_iters)),
               all_converged=bool(jnp.all(st.cg_converged)),
               matmul_ops_in_hlo=mm,
               memory_analysis=str(mem))
        check(not mm, f"trajectory_step: matrix products in HLO: {mm}")
        check(bool(jnp.all(st.cg_converged)),
              "trajectory_step: a solve did not converge")
        check(bool(jnp.all(jnp.isfinite(st.delta_H))),
              "trajectory_step: non-finite dH")


def phase_eft_selfcheck(policy):
    from schwingermodel_tpu.solvers.dfloat import eft_selfcheck

    report("eft_selfcheck", preserves_error_free_transforms=eft_selfcheck(),
           note="reported, not asserted; the GPU policy uses the x64 impl")


def phase_cg_us_per_iter(policy, n_iter=300, reps=5):
    """The jnp even-odd CG (f32, the refinement's inner solver) at the demo
    couplings, run with tol 0 up to n_iter iterations: it stops earlier
    only when the recursive residual underflows (~80 iterations at 32x32).
    Time per iteration executed: the XLA baseline any hand-written CG must
    beat."""
    import jax
    import jax.numpy as jnp

    from schwingermodel_tpu.config import CGParams

    for N, C in CG_ROWS:
        model = _demo_model(policy, N=N)
        model = dataclasses.replace(model, hmc=dataclasses.replace(
            model.hmc, cg=CGParams(tol=0.0, max_iter=n_iter)))

        def solve(th, b):
            ops = model.eo_ops(th)
            return model._cg(model._eo_cg_operator(ops), b, None, 0.0).iters

        key = jax.random.PRNGKey(N + C)
        lead = () if C == 1 else (C,)
        th = _hot(key, lead + (2, N, N), jnp.float32)
        b = jax.lax.complex(*jax.random.normal(
            jax.random.fold_in(key, 1), (2,) + lead + (2, N, N // 2),
            jnp.float32))
        fn = jax.jit(solve if C == 1 else jax.vmap(solve))
        it = fn(th, b)
        jax.block_until_ready(it)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            it = fn(th, b)
            jax.block_until_ready(it)
            times.append(time.perf_counter() - t0)
        iters = int(jnp.max(it))
        check(iters >= 50, f"cg_us_per_iter: ran {iters} iterations")
        t = sorted(times)[reps // 2]
        report("cg_us_per_iter", lattice=f"{N}x{N}", chains=C,
               iterations=iters, us_per_iter=1e6 * t / iters,
               us_per_iter_per_chain=1e6 * t / iters / C,
               median_of=reps, all_s=times)


def _cli_in_process(argv):
    from schwingermodel_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"CLI {argv} returned {rc}:\n{buf.getvalue()[-2000:]}")
    return parse_cli(buf.getvalue())


def _wrapped_max_diff(a, b):
    import numpy as np

    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.minimum(d, 2 * np.pi - d).max())


def _one_card_vs(tag, mesh_res):
    """The same CLI run (one trajectory, same seed) on one card against
    the mesh run: the same acceptance, and angles within THETA_TOL -- a
    chain accepted on one side and rejected on the other would differ by
    the whole MD displacement, so this also pins every chain's decision."""
    import numpy as np

    kw = dict(MESH_RUNS[tag])
    kw.pop("ranks", None)
    kw.pop("ranks_chain", None)
    ck1 = os.path.join(OUT, f"ck_{tag}_one_card.npz")
    one = _cli_in_process(cli_argv(os.path.join(OUT, f"one_card_{tag}"),
                                   n_therm=0, n_meas=1, checkpoint=ck1,
                                   **kw))
    d = _wrapped_max_diff(np.load(ck1)["theta"],
                          np.load(os.path.join(OUT, f"ck_{tag}.npz"))["theta"])
    report(f"one_card_vs_{tag}", chains=kw["chains"],
           acceptance_mesh_vs_one_card=[mesh_res["acceptance"],
                                        one["acceptance"]],
           Ep=[mesh_res["Ep"], one["Ep"]], max_theta_diff=d, tol=THETA_TOL)
    check(mesh_res["acceptance"] == one["acceptance"],
          f"{tag}: acceptance differs from one card")
    check(d <= THETA_TOL, f"{tag}: theta differs by {d:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the lattice-sharded path on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from schwingermodel_tpu.utils.device import power_limit
    except ImportError as e:
        print(f"chip_smoke: no schwingermodel_tpu package next to this "
              f"script ({e})", file=sys.stderr)
        return 2
    smi = power_limit()
    if not smi:
        print("chip_smoke: no NVIDIA GPU (nvidia-smi lists none)",
              file=sys.stderr)
        return 1
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}", flush=True)

    n_cards = 4 if args.four_cards else 1
    os.makedirs(OUT, exist_ok=True)
    policy = None
    mesh_runs = {}
    t_start = time.perf_counter()
    for name in select_phases(args.four_cards):
        t0 = time.perf_counter()
        if name in CHILD:
            mesh_runs[name] = globals()["phase_" + name]()
        else:
            if policy is None:
                policy = init_jax(n_cards)
            if name.startswith("one_card_vs_"):
                tag = name[len("one_card_vs_"):]
                mesh = [v for k, v in mesh_runs.items() if k.endswith(tag)]
                _one_card_vs(tag, mesh[0])
            else:
                globals()["phase_" + name](policy)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    import jax

    devs = jax.devices()
    print(device_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
