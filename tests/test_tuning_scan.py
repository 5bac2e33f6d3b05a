"""Step-size autotuning (hmc/autotune.py) and beta-scan driver (scan.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.hmc import autotune as at
from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.runner import hot_start, run_hmc
from schwingermodel_tpu.scan import exact_quenched_plaquette, run_beta_scan
from schwingermodel_tpu.utils import prng


def _model(quenched=True, md_steps=10, beta=2.0, dt64=True, **kw):
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
    kw.setdefault("cg", CGParams(tol=1e-10, max_iter=10000))
    kw.setdefault("trajectory_length", 1.0)
    hmc = HMCParams(beta=beta, m0=0.1, md_steps=md_steps,
                    quenched=quenched, **kw)
    return SchwingerModel(lattice=lat, hmc=hmc)


def test_dynamic_beta_matches_static():
    """A traced beta override must produce bit-identical trajectories to a
    model with that beta baked in statically."""
    m_static = _model(quenched=False, beta=3.5, even_odd=True)
    m_tmpl = _model(quenched=False, beta=1.0, even_odd=True)
    key = prng.root_key(7)
    theta = hot_start(m_static.lattice, key)
    k = prng.trajectory_key(key, 0)
    th_s, st_s = jax.jit(lambda t, kk: sampler.hmc_trajectory(m_static, t, kk))(theta, k)
    th_d, st_d = jax.jit(
        lambda t, kk, b: sampler.hmc_trajectory(m_tmpl, t, kk, beta=b)
    )(theta, k, jnp.float64(3.5))
    np.testing.assert_array_equal(np.asarray(th_s), np.asarray(th_d))
    np.testing.assert_array_equal(np.asarray(st_s.delta_H), np.asarray(st_d.delta_H))


def test_dynamic_dt_matches_static():
    m_static = _model(md_steps=10)  # dt = 0.1
    key = prng.root_key(3)
    theta = hot_start(m_static.lattice, key)
    k = prng.trajectory_key(key, 1)
    th_s, st_s = jax.jit(lambda t, kk: sampler.hmc_trajectory(m_static, t, kk))(theta, k)
    th_d, st_d = jax.jit(
        lambda t, kk, dt: sampler.hmc_trajectory(m_static, t, kk, dt=dt)
    )(theta, k, jnp.float64(0.1))
    np.testing.assert_allclose(np.asarray(th_s), np.asarray(th_d), rtol=1e-14)
    np.testing.assert_allclose(
        np.asarray(st_s.delta_H), np.asarray(st_d.delta_H), rtol=1e-10, atol=1e-12)


def test_dual_averaging_converges_to_target():
    """On the quenched 8x8 model, a 150-trajectory warmup must land the
    pooled acceptance probability near the target."""
    model = _model(quenched=True, md_steps=8)
    key = prng.root_key(11)
    theta = hot_start(model.lattice, key, n_chains=4)
    res = jax.jit(
        lambda th, k: at.tune_step_size(model, th, k, n_tune=150, target=0.7)
    )(theta, prng.trajectory_key(key, 99))
    eps = float(res.eps)
    assert 0.0 < eps < 1.0
    # measure acceptance at the tuned step over fresh trajectories
    def step(th, k):
        ks = jax.random.split(k, th.shape[0])
        th, st = jax.vmap(
            lambda t, kk: sampler.hmc_trajectory(model, t, kk, dt=eps))(th, ks)
        return th, jnp.mean(jnp.minimum(1.0, st.exp_mdH))
    th = res.theta
    ps = []
    for i in range(30):
        th, p = jax.jit(step)(th, prng.trajectory_key(key, 1000 + i))
        ps.append(float(p))
    assert abs(np.mean(ps) - 0.7) < 0.12, f"acceptance {np.mean(ps)} far from 0.7"


def test_finalize_quantizes_md_steps():
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=10, trajectory_length=1.0)
    tuned = at.finalize(hmc, eps=0.052)
    assert tuned.md_steps == 19
    assert tuned.trajectory_length == 1.0
    assert at.finalize(hmc, eps=2.0).md_steps == 2   # floor
    assert at.finalize(hmc, eps=1e-9).md_steps == 1000  # ceiling


@pytest.mark.slow
def test_runner_autotune_end_to_end(tmp_path):
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=1.0,
                    quenched=True)
    run = RunParams(n_therm=80, n_meas=30, n_chains=2, seed=5,
                    out_dir=str(tmp_path), autotune=True, n_tune=60)
    msgs = []
    result = run_hmc(lat, hmc, run, progress=msgs.append)
    assert any("autotune" in m for m in msgs)
    # quenched 8x8 beta=2: <P> = I1(2)/I0(2) = 0.6977746579640079
    assert abs(result.Ep - 0.69777) < 5 * max(result.dEp, 0.01)
    assert 0.4 < result.acceptance_rate <= 1.0


def test_exact_quenched_plaquette_values():
    # I1(b)/I0(b) reference values (scipy-independent check)
    np.testing.assert_allclose(
        float(exact_quenched_plaquette(2.0)), 0.6977746579640079, rtol=1e-6)
    np.testing.assert_allclose(
        float(exact_quenched_plaquette(1.0)), 0.4463899658965891, rtol=1e-6)


def test_beta_scan_quenched_matches_exact():
    """3-point quenched scan on 8x8 agrees with I1/I0 within errors."""
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
    hmc = HMCParams(beta=1.0, m0=0.1, md_steps=12, trajectory_length=1.0,
                    quenched=True)
    res = run_beta_scan(lat, hmc, [1.0, 2.0, 4.0],
                        n_therm=150, n_meas=150, n_chains=2, seed=2)
    assert res.exact is not None
    for i, b in enumerate(res.betas):
        tol = 4 * max(res.dEp[i], 0.004)
        assert abs(res.Ep[i] - res.exact[i]) < tol, (
            f"beta={b}: Ep={res.Ep[i]:.5f} exact={res.exact[i]:.5f} "
            f"dEp={res.dEp[i]:.1e}")


@pytest.mark.slow
def test_beta_scan_two_flavor_runs():
    """Dynamical-fermion scan executes and fermions raise <P> above quenched."""
    lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=10, trajectory_length=1.0,
                    quenched=False, even_odd=True)
    res = run_beta_scan(lat, hmc, [2.0], n_therm=60, n_meas=60, seed=4)
    assert res.exact is None
    assert res.Ep[0] > 0.6977  # dynamical fermions raise the plaquette
    assert res.acceptance[0] > 0.5


def test_betascan_range_parsing():
    from schwingermodel_tpu.tools.betascan import parse_betas

    np.testing.assert_allclose(parse_betas("1,2,3.5"), [1.0, 2.0, 3.5])
    np.testing.assert_allclose(parse_betas("0.5:2:0.5"), [0.5, 1.0, 1.5, 2.0])
    with pytest.raises(ValueError):
        parse_betas("1:2")


@pytest.mark.slow
def test_cg_forecast_saves_iterations_same_physics():
    """Chronological forecasting cuts CG iterations while leaving the
    accept/reject decision unchanged at solver tolerance.

    The forecast quality scales with the MD step size (theta moves O(dt)
    between solves): at the flagship config (64x64, dt=0.01, tol 1e-6 f32)
    the measured saving is ~28% of all iterations. Here we use the same dt=0.01 at 8x8."""
    m_fc = _model(quenched=False, even_odd=True,
                  trajectory_length=0.1,   # dt = 0.01 like the bench config
                  cg=CGParams(tol=1e-6, max_iter=10000))
    m_no = dataclasses.replace(
        m_fc, hmc=dataclasses.replace(m_fc.hmc, cg_forecast=False))
    key = prng.root_key(21)
    theta = hot_start(m_fc.lattice, key)
    # thermalize a little (without forecasting) so iteration counts are typical
    s_no = jax.jit(lambda t, k: sampler.hmc_trajectory(m_no, t, k))
    for i in range(10):
        theta, _ = s_no(theta, prng.trajectory_key(key, i))
    s_fc = jax.jit(lambda t, k: sampler.hmc_trajectory(m_fc, t, k))
    it_no = it_fc = 0
    for i in range(5):
        k = prng.trajectory_key(key, 100 + i)
        th_no, st_no = s_no(theta, k)
        th_fc, st_fc = s_fc(theta, k)
        it_no += int(st_no.cg_iters)
        it_fc += int(st_fc.cg_iters)
        # same trajectory up to solver tolerance: dH agrees closely
        assert abs(float(st_no.delta_H) - float(st_fc.delta_H)) < 1e-3
        assert bool(st_no.accepted) == bool(st_fc.accepted)
    assert it_fc < 0.88 * it_no, f"forecast {it_fc} vs restart {it_no} iters"
