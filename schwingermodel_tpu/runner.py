"""The outer Monte-Carlo loop: thermalize, measure, accumulate, summarize.

Device-resident re-design of HMC::HMC_algorithm (src/hmc.cpp:183-215) and
the driver logic around it (src/main.cpp:148-174):

  - The whole measurement phase runs *on device* as a lax.scan over
    measurement blocks (each = Nsteps+1 trajectories + the measurements),
    compiled once; observable chains come back to the host in a single
    transfer, where the reference's structure (host loop per trajectory,
    hmc.cpp:196-212) would pay a host<->device round trip thousands of
    times.
  - When per-measurement host work is required (save_conf=1 writes every
    configuration like the reference, or ill-config dumping at failure
    time), the loop falls back to one host step per measurement block.
  - Independent chains are a vmapped leading axis (RunParams.n_chains); the
    reference runs exactly one chain per job.
  - Lattice sharding over a device mesh (RunParams.mesh_shape) reuses the
    same blocks with the shard_map step from parallel.sharded.
  - CG failure: the trajectory scan captures, per chain, the pre-trajectory
    configuration and global index of the FIRST failing trajectory in each
    host-visible phase; the runner dumps it as ..._illConf{k}.ctxt with its
    trajectory index (the reference writes the failing configuration from
    inside Force, src/hmc.cpp:48-56 -- here (seed, traj_index) reproduces
    the failing solve bit-exactly, tests/test_illconf.py).
  - Configuration saving, SimData summary, jackknife errors (20 bins,
    hmc.cpp:213-214) and acceptance accounting (getacceptance_rate,
    include/hmc.h:42-47) match the reference's conventions.

Everything here is host-side orchestration; all physics lives in jitted code.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from schwingermodel_tpu import observables as obs
from schwingermodel_tpu.config import HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.io import ctxt
from schwingermodel_tpu.io.simdata import SimData, simdata_filename
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.parallel import multihost
from schwingermodel_tpu.utils import prng, statistics
from schwingermodel_tpu.utils.metrics import PerfMonitor


@dataclasses.dataclass
class RunResult:
    Ep: float               # mean plaquette (per site)
    dEp: float              # 20-bin jackknife error
    gS: float               # gauge action density
    dgS: float
    acceptance_rate: float  # accepted / total post-thermalization updates
    elapsed_seconds: float
    chains: dict            # observable name -> np.ndarray [n_meas, (n_chains)]
    n_ill: int              # number of ill (CG-failed) events dumped/reported
    theta: np.ndarray       # final configuration(s)
    key: np.ndarray         # root key (for checkpoint/resume)
    traj_index: int         # trajectories consumed (per chain)
    cg_iters_total: int = 0
    # every CG solve of every trajectory (thermalization included) met its
    # tolerance
    all_converged: bool = True
    # <exp(-dH)> over the measured trajectories (= 1 in equilibrium)
    exp_mdH_mean: float = float("nan")
    perf: Optional[dict] = None  # per-phase timing/throughput (utils.metrics)
    # one entry per dumped ill configuration: {traj_index, chain, file};
    # (seed, traj_index) reproduces the failing solve deterministically
    ill_records: list = dataclasses.field(default_factory=list)

    def summary(self, name: str) -> dict:
        return statistics.binned_summary(np.asarray(self.chains[name]).reshape(-1))


def _traj_fn(model: SchwingerModel, mesh) -> Callable:
    if mesh is not None:
        from schwingermodel_tpu.parallel.sharded import make_sharded_traj_fn

        return make_sharded_traj_fn(model, mesh)
    return partial(sampler.hmc_trajectory, model)


def _measure(model: SchwingerModel, theta, key, with_condensate: bool,
             n_noise: int):
    out = {
        "plaquette": obs.mean_plaquette(model, theta),
        "gauge_action_density": obs.gauge_action_density(model, theta),
        "top_charge": obs.topological_charge(model, theta),
    }
    if with_condensate:
        res = obs.chiral_condensate(model, theta, key, n_noise=n_noise)
        out["chiral_condensate"] = res.value
    return out


def hot_start(lattice: LatticeParams, key, n_chains: int = 1):
    """Random uniform angles (reference RandomU1, src/gauge_conf.cpp:23-36)."""
    shape = (2, lattice.Nx, lattice.Nt)
    if n_chains > 1:
        shape = (n_chains,) + shape
    return jax.random.uniform(
        key, shape, minval=-jnp.pi, maxval=jnp.pi, dtype=lattice.rdtype
    )


def cold_start(lattice: LatticeParams, n_chains: int = 1):
    shape = (2, lattice.Nx, lattice.Nt)
    if n_chains > 1:
        shape = (n_chains,) + shape
    return jnp.zeros(shape, dtype=lattice.rdtype)


def run_hmc(
    lattice: LatticeParams,
    hmc: HMCParams,
    run: RunParams,
    *,
    initial_theta=None,
    start_traj_index: int = 0,
    measure_condensate: bool = False,
    n_noise: int = 8,
    mesh=None,
    progress: Optional[Callable[[str], None]] = None,
    write_simdata: bool = False,
    host: Optional[str] = None,
) -> RunResult:
    """Full simulation (reference main.cpp:148-174 + hmc.cpp:183-215)."""
    t_begin = time.perf_counter()
    log = progress or (lambda s: None)
    model = SchwingerModel(lattice=lattice, hmc=hmc)

    n_chains = run.n_chains
    chain_sharded = False
    if mesh is not None and n_chains > 1:
        from schwingermodel_tpu.parallel.mesh import CHAIN_AXIS_NAME

        if CHAIN_AXIS_NAME not in mesh.axis_names:
            raise ValueError(
                "running multiple chains on a device mesh needs a 3D "
                "('chain', 'x', 't') mesh (parallel.lattice_mesh((rc, rx, rt)))"
            )
        rc = mesh.shape[CHAIN_AXIS_NAME]
        if n_chains % rc:
            raise ValueError(
                f"n_chains={n_chains} not divisible by the mesh chain axis "
                f"({rc})")
        chain_sharded = True

    key = prng.root_key(run.seed)
    k_init, k_run = jax.random.split(key)
    if initial_theta is None:
        theta = hot_start(lattice, k_init, n_chains)
    else:
        theta = jnp.asarray(initial_theta, dtype=lattice.rdtype)
        if n_chains > 1 and theta.ndim == 3:
            theta = jnp.broadcast_to(theta, (n_chains,) + theta.shape)

    # ---- optional step-size autotuning warmup (hmc/autotune.py) ----
    n_therm_left = run.n_therm
    tuned_eps = None
    if run.autotune:
        from schwingermodel_tpu.hmc import autotune as at

        tune_traj = None
        if mesh is not None:
            s = _traj_fn(model, mesh)
            tune_traj = lambda th, k, dt: s(th, k, dt=dt)
        n_tune = min(run.n_tune, run.n_therm) if run.n_therm else run.n_tune
        theta, hmc_tuned, tuned_eps = at.autotune(
            model, theta, jax.random.fold_in(k_run, 0x7E0E),
            n_tune=n_tune, target=run.tune_target, traj_fn=tune_traj,
            traj_handles_chains=chain_sharded,
        )
        n_therm_left = max(0, run.n_therm - n_tune)
        if hmc_tuned.md_steps != hmc.md_steps:
            log(f"autotune: eps={tuned_eps:.5f} -> md_steps "
                f"{hmc.md_steps} -> {hmc_tuned.md_steps} "
                f"(dt {hmc.step_size:.5f} -> {hmc_tuned.step_size:.5f})")
        else:
            log(f"autotune: eps={tuned_eps:.5f}, md_steps={hmc.md_steps} kept")
        hmc = hmc_tuned
        model = SchwingerModel(lattice=lattice, hmc=hmc)

    traj = _traj_fn(model, mesh)
    if n_chains > 1 and not chain_sharded:
        traj = jax.vmap(traj)
    # (chain_sharded: the step consumes the chain batch itself)

    def keys_for(start: int, n: int):
        """Per-trajectory keys [n] (or [n, n_chains]) from the run key."""
        idx = jnp.arange(start, start + n)
        ks = jax.vmap(lambda i: prng.trajectory_key(k_run, i))(idx)
        if n_chains > 1:
            ks = jax.vmap(lambda k: jax.random.split(k, n_chains))(ks)
        return ks

    def meas_keys_for(n: int):
        idx = jnp.arange(n)
        ks = jax.vmap(lambda i: jax.random.fold_in(k_run, 10_000_000 + i))(idx)
        if n_chains > 1:
            ks = jax.vmap(lambda k: jax.random.split(k, n_chains))(ks)
        return ks

    # ---- SimData header (reference main.cpp:97-126) ----
    simdata = None
    if write_simdata and multihost.is_primary():
        rx, rt = (mesh.devices.shape[-2:] if mesh is not None else (1, 1))
        simdata = SimData(os.path.join(
            run.out_dir, simdata_filename(lattice.Nx, lattice.Nt, hmc.m0)))
        simdata.write_header(
            Nx=lattice.Nx, Nt=lattice.Nt, ranks_x=rx, ranks_t=rt,
            beta=hmc.beta, n_therm=run.n_therm, n_meas=run.n_meas,
            n_steps=run.n_steps, trajectory_length=hmc.trajectory_length,
            md_steps=hmc.md_steps, cg_max_iter=hmc.cg.max_iter,
            cg_tol=hmc.cg.tol, m0=hmc.m0, host=host,
            cg_force_tol=hmc.cg.resolved_force_tol(),
        )

    # ---- failure-time capture (reference src/hmc.cpp:48-56) ----
    # The reference dumps the offending gauge configuration from inside
    # Force at the moment CG fails. Under a fused device program the
    # equivalent is: the scan carries, per chain, the PRE-trajectory
    # configuration and global index of the first trajectory whose solve
    # failed. Noise is drawn deterministically from (seed, trajectory
    # index), so that pair reproduces the failing solve exactly
    # (tests/test_illconf.py). One capture per host-visible phase; the
    # host dumps it as ..._illConf{k}.ctxt and resets the capture window.
    def _fail_init(theta):
        lead = theta.shape[:-3]          # () or (n_chains,)
        return (jnp.zeros_like(theta),                 # first failing theta
                jnp.zeros(lead, dtype=bool),           # failure seen
                jnp.full(lead, -1, dtype=jnp.int32))   # its trajectory index

    # one scanned trajectory block:
    # (theta, fail, keys[n(,C)], idx[n]) -> theta', fail', stats'
    @jax.jit
    def block(theta, fail, keys, idx):
        def body(carry, inp):
            th, (f_th, f_seen, f_idx) = carry
            k, i = inp
            th2, st = traj(th, k)
            bad = jnp.logical_and(jnp.logical_not(st.cg_converged),
                                  jnp.logical_not(f_seen))
            f_th = jnp.where(bad.reshape(bad.shape + (1, 1, 1)), th, f_th)
            f_idx = jnp.where(bad, i, f_idx)
            f_seen = jnp.logical_or(f_seen, bad)
            return (th2, (f_th, f_seen, f_idx)), st
        (theta, fail), st = jax.lax.scan(body, (theta, fail), (keys, idx))
        return theta, fail, st

    # Host-safe scalar reductions of per-trajectory stats. Computed *inside*
    # jit so the outputs are replicated scalars: in multi-host mode the raw
    # stats arrays are sharded across processes (out_specs P('chain')) and
    # np.asarray on them would raise (non-fully-addressable); replicated
    # scalars are addressable everywhere.
    @jax.jit
    def _stat_scalars(st):
        return (jnp.sum(st.accepted.astype(jnp.int32)),
                jnp.sum(st.cg_iters),
                jnp.all(st.cg_converged),
                jnp.sum(st.exp_mdH))

    def measure_one(theta_c, key_c):
        return _measure(model, theta_c, key_c,
                        with_condensate=measure_condensate, n_noise=n_noise)

    measure_v = jax.vmap(measure_one) if n_chains > 1 else measure_one
    measure = jax.jit(measure_v)

    traj_index = start_traj_index
    all_conv = True
    n_ill = 0
    cg_iters_total = 0
    ill_records = []

    def idx_for(start: int, n: int):
        return jnp.arange(start, start + n, dtype=jnp.int32)

    def dump_fail(fail):
        """Dump the captured first-failure configuration(s): the exact
        pre-trajectory theta whose solve failed, with its trajectory index
        (reference dumps from inside Force, src/hmc.cpp:48-56)."""
        nonlocal n_ill
        f_th, f_seen, f_idx = fail
        seen = np.atleast_1d(multihost.gather_global(f_seen)).reshape(-1)
        if not seen.any():
            return
        th = multihost.gather_global(f_th).reshape(
            -1, 2, lattice.Nx, lattice.Nt)
        idxs = np.atleast_1d(multihost.gather_global(f_idx)).reshape(-1)
        for c in np.nonzero(seen)[0]:
            name = ctxt.ill_conf_filename(
                lattice.Nx, lattice.Nt, hmc.beta, hmc.m0, n_ill)
            if multihost.is_primary():
                ctxt.write_conf(os.path.join(run.out_dir, name),
                                ctxt.links_from_theta(th[c]))
            ill_records.append({"traj_index": int(idxs[c]), "chain": int(c),
                                "file": name})
            n_ill += 1
            log(f"CG failed to converge at trajectory {int(idxs[c])}"
                + (f" (chain {c})" if len(seen) > 1 else "")
                + f"; pre-trajectory configuration dumped to {name}")

    perf = PerfMonitor(volume=lattice.volume, even_odd=hmc.even_odd)

    # ---- thermalization (hmc.cpp:187-191) ----
    therm_chunk = 100
    done = 0
    fail = _fail_init(theta)
    with perf.phase("thermalize"):
        while done < n_therm_left:
            n = min(therm_chunk, n_therm_left - done)
            theta, fail, st = block(theta, fail, keys_for(traj_index, n),
                                    idx_for(traj_index, n))
            _, it_s, conv_s, _ = _stat_scalars(st)
            all_conv &= bool(conv_s)
            if not bool(conv_s):
                dump_fail(fail)
                fail = _fail_init(theta)
            it = int(it_s)
            cg_iters_total += it
            perf.add(trajectories=n * max(n_chains, 1), cg_iters=it)
            done += n
            traj_index += n
            log(f"{done} thermalization configurations generated")

    # ---- measurements (hmc.cpp:196-212) ----
    # reference order: update, measure, then Nsteps decorrelation updates
    # (skipped after the last measurement, hmc.cpp:207-209). Equivalent
    # regrouping with one uniform block shape: [1 update + measure] then
    # (n_meas-1) x [Nsteps+1 updates + measure].
    per_meas = 1 + run.n_steps
    slow_path = run.save_conf  # per-measurement host I/O required

    perf.start("measure")
    theta, fail, st0 = block(theta, fail, keys_for(traj_index, 1),
                             idx_for(traj_index, 1))
    traj_index += 1
    mk = meas_keys_for(run.n_meas)
    o0 = measure(theta, jax.tree.map(lambda a: a[0], mk))
    acc0, it0, conv0, emh0 = _stat_scalars(st0)
    all_conv &= bool(conv0)
    expmdh_total = float(emh0)
    accepted = [np.asarray(acc0).reshape(1)]
    cg_iters_total += int(it0)
    meas_list = [o0]
    updates_total = int(np.prod(np.shape(st0.accepted)))
    if not bool(conv0):
        dump_fail(fail)
        fail = _fail_init(theta)
    if run.save_conf:
        _save_confs(theta, 0, lattice, hmc, run, n_chains)

    if slow_path:
        for i in range(1, run.n_meas):
            theta, fail, st = block(theta, fail, keys_for(traj_index, per_meas),
                                    idx_for(traj_index, per_meas))
            traj_index += per_meas
            o = measure(theta, jax.tree.map(lambda a: a[i], mk))
            acc_s, it_s, conv_s, emh_s = _stat_scalars(st)
            all_conv &= bool(conv_s)
            expmdh_total += float(emh_s)
            if not bool(conv_s):
                dump_fail(fail)
                fail = _fail_init(theta)
            accepted.append(np.asarray(acc_s).reshape(1))
            cg_iters_total += int(it_s)
            updates_total += int(np.prod(np.shape(st.accepted)))
            meas_list.append(o)
            _save_confs(theta, i, lattice, hmc, run, n_chains)
        chains = {
            k: np.stack([multihost.gather_global(m[k]) for m in meas_list])
            for k in meas_list[0]
        }
        accepted_total = int(np.sum(np.concatenate(accepted)))
    elif run.n_meas > 1:
        # fast path: the remaining n_meas-1 blocks in ONE device program
        @jax.jit
        def meas_phase(theta, fail, block_keys, block_idx, meas_ks):
            def body(carry, inp):
                th, fl = carry
                bk, bi, mk_i = inp
                # nested jit is inlined by the tracer
                th, fl, st = block(th, fl, bk, bi)
                o = measure_v(th, mk_i)
                blockstats = (
                    jnp.sum(st.accepted.astype(jnp.int32)),
                    jnp.sum(st.cg_iters),
                    jnp.all(st.cg_converged),
                    jnp.sum(st.exp_mdH),
                )
                return (th, fl), (o, blockstats)
            (theta, fail), out = jax.lax.scan(
                body, (theta, fail), (block_keys, block_idx, meas_ks))
            return theta, fail, out

        nb = run.n_meas - 1
        bkeys = keys_for(traj_index, nb * per_meas)
        bkeys = jax.tree.map(
            lambda a: a.reshape((nb, per_meas) + a.shape[1:]), bkeys)
        bidx = idx_for(traj_index, nb * per_meas).reshape(nb, per_meas)
        mks = jax.tree.map(lambda a: a[1:], mk)
        theta, fail, (o_rest, (acc_b, iters_b, conv_b, emh_b)) = meas_phase(
            theta, fail, bkeys, bidx, mks)
        traj_index += nb * per_meas
        updates_total += nb * per_meas * max(n_chains, 1)
        accepted_total = int(np.sum(np.concatenate(accepted))) + int(jnp.sum(acc_b))
        cg_iters_total += int(jnp.sum(iters_b))
        expmdh_total += float(jnp.sum(emh_b))
        conv_np = np.asarray(conv_b)
        all_conv &= bool(conv_np.all())
        if not conv_np.all():
            n_bad = int((~conv_np).sum())
            log(f"CG failed to converge in {n_bad} measurement block(s)")
            dump_fail(fail)
        chains = {
            k: np.concatenate(
                [multihost.gather_global(o0[k])[None],
                 multihost.gather_global(o_rest[k])], axis=0)
            for k in o0
        }
    else:
        chains = {k: multihost.gather_global(v)[None] for k, v in o0.items()}
        accepted_total = int(np.sum(np.concatenate(accepted)))

    perf.add(trajectories=updates_total,
             cg_iters=cg_iters_total
             - sum(p.cg_iters for p in perf.phases.values()),
             phase="measure")
    perf.stop("measure")
    for line in perf.report_lines():
        log("perf: " + line)

    elapsed = time.perf_counter() - t_begin

    # ---- summary (hmc.cpp:213-214: mean + 20-bin jackknife) ----
    def _jack(name):
        x = chains[name].reshape(len(chains[name]), -1)   # [n_meas, n_chains]
        n_meas, n_ch = x.shape
        if n_meas < 2:
            # one measurement: no error estimate
            return float(x.mean()), float("nan")
        if n_ch == 1:
            n_bins = min(20, max(2, n_meas // 2))
            return statistics.mean(x[:, 0]), statistics.jackknife_error(
                x[:, 0], n_bins)
        # multi-chain: bin along TIME within each chain (autocorrelation is
        # per-chain), then jackknife over the pooled chain x bin means --
        # inter-chain variance enters the error instead of being averaged
        # away by a per-measurement pooling
        n_bins_t = min(20, max(2, n_meas // 2))
        m = (n_meas // n_bins_t) * n_bins_t
        b = x[:m].reshape(n_bins_t, m // n_bins_t, n_ch).mean(axis=1)
        pooled = b.reshape(-1)                            # [n_bins_t * n_ch]
        return float(x.mean()), statistics.jackknife_error(
            pooled, len(pooled))

    Ep, dEp = _jack("plaquette")
    gS, dgS = _jack("gauge_action_density")
    acceptance = accepted_total / max(updates_total, 1)

    result = RunResult(
        Ep=Ep, dEp=dEp, gS=gS, dgS=dgS,
        acceptance_rate=acceptance, elapsed_seconds=elapsed,
        chains=chains, n_ill=n_ill,
        theta=multihost.gather_global(theta).reshape(
            (-1, 2, lattice.Nx, lattice.Nt) if n_chains > 1
            else (2, lattice.Nx, lattice.Nt)),
        key=np.asarray(key),
        traj_index=traj_index, cg_iters_total=cg_iters_total,
        all_converged=all_conv,
        exp_mdH_mean=expmdh_total / max(updates_total, 1),
        perf=perf.summary(), ill_records=ill_records,
    )

    if simdata is not None:
        extra = {}
        if measure_condensate:
            cc, dcc = _jack("chiral_condensate")
            extra["chiral_condensate"] = (cc, dcc)
        simdata.append_results(
            Ep=Ep, dEp=dEp, gS=gS, dgS=dgS,
            acceptance_rate=acceptance, elapsed_seconds=elapsed,
            extra=extra or None,
        )
    return result


def _save_confs(theta, index, lattice, hmc, run, n_chains):
    """Write configuration(s) like the reference (hmc.cpp:201-208).

    Multi-host: gather the sharded field to every process (the device-mesh
    MPI_Gatherv, gauge_conf.cpp:390-395) and write on process 0 only."""
    th = multihost.gather_global(theta)
    if not multihost.is_primary():
        return
    th = th.reshape(-1, 2, lattice.Nx, lattice.Nt)
    for c, th_c in enumerate(th):
        name = ctxt.conf_filename(
            lattice.Nx, lattice.Nt, hmc.beta, hmc.m0,
            index if n_chains == 1 else index * n_chains + c)
        ctxt.write_conf(os.path.join(run.out_dir, name),
                        ctxt.links_from_theta(th_c))
