"""Coupling (beta) scan driver.

Reproduces the reference's validation study (HMC_doc.pdf Fig. 1: average
plaquette vs beta on 16x16, HMC against an independent Metropolis code)
as a first-class driver. The reference has no scan machinery at all -- each
beta is a separate interactive run of the executable (src/main.cpp:30-58).

Design: `beta` is a *traced* scalar argument of the compiled
trajectory (hmc/sampler.py), so the entire scan reuses ONE executable --
XLA compiles a single (therm + measure) program and the host loop just feeds
it different beta values and warm-starts each point from the previous one's
final configuration. On a quenched scan the exact 2D U(1) answer
<P> = I1(beta)/I0(beta) is attached per point as a physics gate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from schwingermodel_tpu import observables as obs
from schwingermodel_tpu.config import HMCParams, LatticeParams
from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.utils import prng, statistics


def exact_quenched_plaquette(beta) -> jax.Array:
    """Exact 2D U(1) pure-gauge mean plaquette <P> = I1(beta)/I0(beta)
    (infinite volume == any volume with open integration; standard result,
    used as the framework's analytic validation gate -- SURVEY.md section 4).
    Uses exponentially-scaled Bessels so large beta doesn't overflow."""
    b = jnp.asarray(beta, dtype=jnp.float64 if jax.config.jax_enable_x64
                    else jnp.float32)
    return jax.scipy.special.i1e(b) / jax.scipy.special.i0e(b)


@dataclasses.dataclass
class BetaScanResult:
    betas: np.ndarray          # [n_points]
    Ep: np.ndarray             # mean plaquette per point
    dEp: np.ndarray            # 20-bin jackknife error
    acceptance: np.ndarray     # acceptance rate per point
    plaquette_chains: np.ndarray  # [n_points, n_meas(, n_chains)]
    exact: Optional[np.ndarray]   # I1/I0 curve for quenched scans, else None
    elapsed_seconds: float

    def as_table(self) -> str:
        lines = ["# beta       Ep          dEp        acc"
                 + ("       exact(I1/I0)" if self.exact is not None else "")]
        for i, b in enumerate(self.betas):
            row = (f"{b:8.4f}  {self.Ep[i]:.8f}  {self.dEp[i]:.2e}  "
                   f"{self.acceptance[i]:.3f}")
            if self.exact is not None:
                row += f"  {self.exact[i]:.8f}"
            lines.append(row)
        return "\n".join(lines)


def run_beta_scan(
    lattice: LatticeParams,
    hmc: HMCParams,
    betas,
    *,
    n_therm: int = 200,
    n_meas: int = 200,
    n_steps: int = 0,
    n_chains: int = 1,
    seed: int = 0,
    progress: Optional[Callable[[str], None]] = None,
) -> BetaScanResult:
    """Scan <P>(beta). hmc.beta is ignored (each point overrides it).

    Points after the first warm-start from the previous point's final
    configuration, so late points need far fewer thermalization sweeps than
    a cold run would; n_therm is still applied per point for safety.
    """
    t0 = time.perf_counter()
    log = progress or (lambda s: None)
    betas = np.atleast_1d(np.asarray(betas, dtype=np.float64))
    model = SchwingerModel(lattice=lattice, hmc=hmc)
    key = prng.root_key(seed)

    def traj(theta, key, beta):
        return sampler.hmc_trajectory(model, theta, key, beta=beta)

    if n_chains > 1:
        traj_v = jax.vmap(traj, in_axes=(0, 0, None))
    else:
        traj_v = traj

    per = n_steps + 1

    @jax.jit
    def run_point(theta, beta, kt, km):
        """Therm + measure at one traced beta; returns (theta', plaqs, acc)."""
        def upd(th, k):
            th, st = traj_v(th, k, beta)
            return th, st.accepted

        def body_t(th, k):
            th, _ = upd(th, k)
            return th, None

        theta, _ = jax.lax.scan(body_t, theta, kt)

        def body_m(th, ks):
            th, acc = jax.lax.scan(upd, th, ks)
            return th, (obs.mean_plaquette(model, th),
                        jnp.sum(acc.astype(jnp.int32)))

        theta, (plaqs, accs) = jax.lax.scan(body_m, theta, km)
        return theta, plaqs, accs

    # hot start at the first beta
    k_init, k_run = jax.random.split(key)
    shape = (2, lattice.Nx, lattice.Nt)
    if n_chains > 1:
        shape = (n_chains,) + shape
    theta = jax.random.uniform(k_init, shape, minval=-jnp.pi, maxval=jnp.pi,
                               dtype=lattice.rdtype)

    def keys_for(point: int, phase: int, n: int):
        base = jax.random.fold_in(jax.random.fold_in(k_run, point), phase)
        ks = jax.vmap(lambda i: prng.trajectory_key(base, i))(jnp.arange(n))
        if n_chains > 1:
            ks = jax.vmap(lambda k: jax.random.split(k, n_chains))(ks)
        return ks

    Ep, dEp, acc_rates, chains_all = [], [], [], []
    for p, b in enumerate(betas):
        kt = keys_for(p, 0, n_therm)
        km = keys_for(p, 1, n_meas * per)
        km = jax.tree.map(lambda a: a.reshape((n_meas, per) + a.shape[1:]), km)
        theta, plaqs, accs = run_point(
            theta, jnp.asarray(b, dtype=lattice.rdtype), kt, km)
        plaqs = np.asarray(plaqs)
        pooled = plaqs.reshape(len(plaqs), -1).mean(axis=1)
        n_bins = min(20, max(2, len(pooled) // 2))
        Ep.append(statistics.mean(pooled))
        dEp.append(statistics.jackknife_error(pooled, n_bins))
        acc_rates.append(float(np.sum(np.asarray(accs)))
                         / (n_meas * per * max(n_chains, 1)))
        chains_all.append(plaqs)
        log(f"beta={b:g}: Ep={Ep[-1]:.6f} +- {dEp[-1]:.1e}, acc={acc_rates[-1]:.3f}")

    exact = None
    if hmc.quenched:
        exact = np.asarray(
            jax.vmap(exact_quenched_plaquette)(jnp.asarray(betas)))

    return BetaScanResult(
        betas=betas, Ep=np.asarray(Ep), dEp=np.asarray(dEp),
        acceptance=np.asarray(acc_rates),
        plaquette_chains=np.stack(chains_all),
        exact=exact, elapsed_seconds=time.perf_counter() - t0,
    )
