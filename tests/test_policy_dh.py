"""Same-noise dH: the GPU precision policy against float64 throughout.

One trajectory from the same start, momenta, pseudofermion noise and
Metropolis uniform, run (a) under utils/device.py's GPU policy -- float32
fields and MD, x64 true-residual refinement (action solves at 1e-10, force
solves at 1e-8) -- and (b) in float64 throughout with the reference's
plain 1e-10 CG. The difference of the two dH is the f32 MD error: angles,
momenta and forces rounded to f32 at every step (measured ~1.3e-5 at 8x8,
md_steps=4, tau=0.4), not solver error. Tolerance: 1e-4 on dH, 1e-5 on
the final angles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc.sampler import trajectory_given_noise
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.utils.device import device_policy

DH_TOL = 1e-4
THETA_TOL = 1e-5


def _model(policy, even_odd, integrator):
    return SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype=policy.real_dtype),
        hmc=HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.4,
                      even_odd=even_odd, integrator=integrator,
                      cg=CGParams(tol=1e-10, max_iter=10000,
                                  refine=policy.refine,
                                  refine_impl=policy.refine_impl)))


def _traj(model, theta, pi, chi, r):
    dt = model.lattice.rdtype
    ct = model.lattice.cdtype
    return jax.jit(lambda a, b, c, u: trajectory_given_noise(model, a, b, c, u))(
        jnp.asarray(theta, dt), jnp.asarray(pi, dt), jnp.asarray(chi, ct),
        jnp.asarray(r, dt))


@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
@pytest.mark.parametrize("even_odd", [True, False], ids=["eo", "fullD"])
def test_same_noise_dH_gpu_policy_vs_f64(rng, even_odd, integrator):
    gpu = _model(device_policy("gpu"), even_odd, integrator)
    f64 = _model(device_policy("cpu"), even_odd, integrator)
    # f32-exact inputs, so both runs start from identical values
    theta = np.float32(rng.uniform(-np.pi, np.pi, (2, 8, 8)))
    pi = np.float32(rng.standard_normal((2, 8, 8)))
    cs = (2, 8, 4) if even_odd else (2, 8, 8)
    chi = ((rng.standard_normal(cs) + 1j * rng.standard_normal(cs))
           / np.sqrt(2.0)).astype(np.complex64)

    th_g, st_g = _traj(gpu, theta, pi, chi, 0.5)
    th_d, st_d = _traj(f64, theta, pi, chi, 0.5)

    assert st_g.delta_H.dtype == jnp.float64        # Metropolis-grade dH
    assert bool(st_g.cg_converged) and bool(st_d.cg_converged)
    assert abs(float(st_g.delta_H) - float(st_d.delta_H)) <= DH_TOL
    assert bool(st_g.accepted) == bool(st_d.accepted)
    d = np.abs(np.asarray(th_g, np.float64) - np.asarray(th_d))
    d = np.minimum(d, 2 * np.pi - d)                 # angles wrap at +-pi
    assert d.max() <= THETA_TOL, d.max()
