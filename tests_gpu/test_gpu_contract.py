"""The GPU precision policy on the card: the 1e-10 solver contract
against the NumPy f64 oracle, certified condensate solves, and
<exp(-dH)> = 1 over a short multi-chain run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu import observables as obs
from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import eo
from schwingermodel_tpu.utils import prng
from reference_impl import links_ref, normal_ref, schur_normal_ref

pytestmark = pytest.mark.gpu

TOL = 1e-10


def _model(policy, Nx, Nt, m0=0.2, beta=4.0, even_odd=True, dtype=None,
           **hmc_kw):
    dtype = dtype or policy.real_dtype
    refine = policy.refine and dtype == "float32"
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=dtype),
        hmc=HMCParams(beta=beta, m0=m0, even_odd=even_odd,
                      cg=CGParams(tol=TOL, max_iter=10000, refine=refine,
                                  refine_impl=policy.refine_impl),
                      **hmc_kw))


@pytest.mark.parametrize("even_odd", [True, False], ids=["eo", "fullD"])
def test_refined_solve_meets_contract_on_gpu(gpu, rng, even_odd):
    """64x64 refined solve on the card: f64 true residual from the NumPy
    oracle <= 1e-10 ||b||."""
    N = 64
    model = _model(gpu, N, N, even_odd=even_odd)
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, N, N)), jnp.float32)
    nt_b = N // 2 if even_odd else N
    b = jnp.asarray(rng.standard_normal((2, N, nt_b))
                    + 1j * rng.standard_normal((2, N, nt_b)), jnp.complex64)
    if even_odd:
        res = jax.jit(lambda t, v: model._solve_eo(t, model.eo_ops(t), v))(
            theta, b)
        zeros = jnp.zeros_like(res.x)
        x = np.asarray(eo.unpack(model.geom, res.x, zeros))
        bf = np.asarray(eo.unpack(model.geom, b.astype(jnp.complex128),
                                  zeros))
        r = bf - schur_normal_ref(links_ref(theta), x, model.hmc.m0)
    else:
        res = jax.jit(model.solve_normal)(theta, b)
        bf = np.asarray(b, np.complex128)
        r = bf - normal_ref(links_ref(theta), np.asarray(res.x),
                            model.hmc.m0)
    assert bool(res.converged)
    assert np.linalg.norm(r) / np.linalg.norm(bf) <= TOL


def test_condensate_certified_on_gpu(gpu, rng):
    """Every condensate solve under the f32 + x64 contract converges, and
    the estimate agrees with the same estimator run in float64 on the card
    (the f32 assembly D^+ psi bounds the difference)."""
    N = 32
    m32 = _model(gpu, N, N, beta=2.0, m0=0.1)
    m64 = _model(gpu, N, N, beta=2.0, m0=0.1, dtype="float64")
    theta = np.float32(rng.uniform(-np.pi, np.pi, (2, N, N)))
    zs = obs.condensate_noise(m64, jax.random.PRNGKey(5), theta.shape, 4)
    r32 = jax.jit(lambda t, z: obs.chiral_condensate_given_noise(m32, t, z))(
        jnp.asarray(theta), zs.astype(jnp.complex64))
    r64 = jax.jit(lambda t, z: obs.chiral_condensate_given_noise(m64, t, z))(
        jnp.asarray(theta, jnp.float64), zs)
    assert bool(r32.solves.all_converged) and bool(r64.solves.all_converged)
    assert abs(float(r32.value) - float(r64.value)) <= 1e-5 * abs(
        float(r64.value)) + 1e-7


def test_expmdh_unity_on_gpu(gpu):
    """<exp(-dH)> = 1 within 4 sigma over 8 chains x 40 trajectories after
    40 thermalization trajectories (16x16, beta=2, m0=0.1, tau=1)."""
    C, N = 8, 16
    model = _model(gpu, N, N, beta=2.0, m0=0.1, md_steps=10,
                   trajectory_length=1.0)
    traj = jax.vmap(lambda t, k: sampler.hmc_trajectory(model, t, k))
    key = prng.root_key(9)

    @jax.jit
    def run(th, idx):
        def body(t, i):
            t, st = traj(t, jax.random.split(prng.trajectory_key(key, i), C))
            return t, (st.exp_mdH, st.cg_converged)
        return jax.lax.scan(body, th, idx)

    th = jax.random.uniform(key, (C, 2, N, N), minval=-np.pi, maxval=np.pi,
                            dtype=jnp.float32)
    th, _ = run(th, jnp.arange(40))
    _, (emh, conv) = run(th, jnp.arange(40, 80))
    x = np.asarray(emh, np.float64).reshape(-1)
    assert bool(np.asarray(conv).all())
    err = x.std(ddof=1) / np.sqrt(x.size)
    assert abs(x.mean() - 1.0) <= 4 * max(err, 5e-3), (x.mean(), err)
