"""Detailed-balance and integrator-order gates (SURVEY.md section 4;
reference validation = HMC_doc.pdf).

The exact HMC identity <exp(-dH)> = 1 (over refreshed momenta/pseudofermions
from a thermalized ensemble) is the sharpest end-to-end detector of any
detailed-balance violation: solver-tolerance bias, forecasting
history-dependence, precision loss in dH. It is asserted here AT THE SHIPPED
GPU OPERATING POINTS: f32 + cg_forecast + mixed-precision refinement (the
default), and f32 + loose 1e-6 solves (the --no-cg-refine fast mode).

The O(dt^2) leapfrog order and full-D (non-even-odd) reversibility round out
the integrator gates the reference validates only by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.hmc.integrators import leapfrog
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.utils import prng
from tests.conftest import random_theta


def _model(dtype, *, refine, tol, md_steps=8, even_odd=True,
           forecast=True, tau=1.0):
    return SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype=dtype),
        hmc=HMCParams(beta=2.0, m0=0.1, md_steps=md_steps,
                      trajectory_length=tau, even_odd=even_odd,
                      cg_forecast=forecast,
                      cg=CGParams(tol=tol, max_iter=10000, refine=refine)),
    )


def _run_chain(model, n_therm, n_meas, seed=7):
    key = prng.root_key(seed)
    dtype = model.lattice.rdtype
    theta = jax.random.uniform(key, (2, 8, 8), minval=-np.pi, maxval=np.pi,
                               dtype=dtype)

    @jax.jit
    def block(th, ks):
        return jax.lax.scan(lambda t, k: sampler.hmc_trajectory(model, t, k),
                            th, ks)

    ks = jax.vmap(lambda i: prng.trajectory_key(key, i))(jnp.arange(n_therm))
    theta, _ = block(theta, ks)
    ks = jax.vmap(lambda i: prng.trajectory_key(key, i))(
        jnp.arange(n_therm, n_therm + n_meas))
    theta, st = block(theta, ks)
    return theta, st


def _assert_expmdh_unity(st, n_sigma=4.0, floor=5e-3):
    x = np.asarray(st.exp_mdH, dtype=np.float64)
    mean = x.mean()
    err = x.std(ddof=1) / np.sqrt(len(x))
    assert bool(np.asarray(st.cg_converged).all())
    assert abs(mean - 1.0) <= n_sigma * max(err, floor), (mean, err)


@pytest.mark.slow
def test_expmdh_unity_f32_refined_forecast():
    """Shipped GPU default: f32 + refinement to 1e-10 + forecasting."""
    model = _model("float32", refine=True, tol=1e-10)
    _, st = _run_chain(model, 100, 600)
    assert st.delta_H.dtype == jnp.float64
    _assert_expmdh_unity(st)


@pytest.mark.slow
def test_expmdh_unity_f32_loose_forecast():
    """The --no-cg-refine fast mode (f32, tol 1e-6, forecasting): validates
    that chronological forecasting does not bias detailed balance at the
    loose tolerance (VERDICT round-1 concern)."""
    model = _model("float32", refine=False, tol=1e-6)
    _, st = _run_chain(model, 100, 600)
    _assert_expmdh_unity(st)


@pytest.mark.slow
def test_dH_scales_as_dt_squared(rng):
    """Leapfrog is O(dt^2): fixed trajectory length, md_steps 8->16->32
    contracts |dH| ~4x per doubling (reference HMC_doc.pdf validation)."""
    theta = jnp.asarray(random_theta(rng, 8, 8))
    key = jax.random.PRNGKey(11)
    dHs = []
    for md in (8, 16, 32):
        model = _model("float64", refine=False, tol=1e-12, md_steps=md)
        pi, chi, _ = sampler.draw_noise(model, theta.shape, key)
        phi = model.pseudofermion(theta, chi)
        th1, pi1, _, psi = leapfrog(model, theta, pi, phi)
        from schwingermodel_tpu.models.schwinger import SolveStats
        sf_new, _ = model.fermion_action(th1, phi, SolveStats.zero(), x0=psi)
        sf_old = float(jnp.sum(jnp.abs(chi) ** 2))
        H_old = float(model.kinetic(pi) + model.gauge_action(theta)) + sf_old
        H_new = float(model.kinetic(pi1) + model.gauge_action(th1) + sf_new)
        dHs.append(abs(H_new - H_old))
    r1 = dHs[0] / dHs[1]
    r2 = dHs[1] / dHs[2]
    # effective trajectory length varies slightly with md_steps (the
    # reference's MD_steps-1 convention), so allow slack around 4
    assert 2.5 < r1 < 6.5, (dHs, r1)
    assert 2.5 < r2 < 6.5, (dHs, r2)


def test_full_d_reversibility(rng):
    """Reversibility of the full-D (non-even-odd) leapfrog: integrate,
    negate momenta, integrate back -> identity (the EO analog lives in
    tests/test_eo.py)."""
    model = _model("float64", refine=False, tol=1e-12, even_odd=False,
                   md_steps=12, tau=0.6)
    theta = jnp.asarray(random_theta(rng, 8, 8))
    key = jax.random.PRNGKey(3)
    pi, chi, _ = sampler.draw_noise(model, theta.shape, key)
    phi = model.pseudofermion(theta, chi)
    th1, pi1, _, _ = leapfrog(model, theta, pi, phi)
    th0, pi0, _, _ = leapfrog(model, th1, -pi1, phi)
    np.testing.assert_allclose(np.asarray(th0), np.asarray(theta), atol=1e-9)
    np.testing.assert_allclose(np.asarray(-pi0), np.asarray(pi), atol=1e-9)


@pytest.mark.slow
def test_omelyan_beats_leapfrog_at_equal_force_budget():
    """2MN with md_steps=5 (10 force evals, full tau) vs leapfrog
    md_steps=11 (10 force evals, tau*10/11 effective): |dH| must be
    substantially smaller -- the integrator's selling point."""
    import dataclasses

    m_lf = _model("float64", refine=False, tol=1e-12, md_steps=11)
    m_om = dataclasses.replace(
        m_lf, hmc=dataclasses.replace(m_lf.hmc, md_steps=5,
                                      integrator="omelyan"))
    theta, _ = _run_chain(m_lf, 40, 1, seed=3)

    def dHs(model, n=10):
        out = []
        key = prng.root_key(17)
        for i in range(n):
            k = prng.trajectory_key(key, i)
            _, st = jax.jit(
                lambda t, kk: sampler.hmc_trajectory(model, t, kk))(theta, k)
            out.append(abs(float(st.delta_H)))
        return np.mean(out)

    a_lf = dHs(m_lf)
    a_om = dHs(m_om)
    assert a_om < 0.5 * a_lf, (a_om, a_lf)


@pytest.mark.slow
def test_expmdh_unity_omelyan_f32_refined():
    """<exp(-dH)> = 1 for the Omelyan 2MN integrator AT THE SHIPPED f32
    OPERATING POINT (refinement to 1e-10, forecasting through both force
    solves per step) -- the statistical detailed-balance gate the
    |dH|-superiority and reversibility tests cannot substitute for."""
    import dataclasses

    model = _model("float32", refine=True, tol=1e-10, md_steps=4)
    model = dataclasses.replace(
        model, hmc=dataclasses.replace(model.hmc, integrator="omelyan"))
    _, st = _run_chain(model, 100, 600)
    assert st.delta_H.dtype == jnp.float64
    _assert_expmdh_unity(st)


def test_finalize_accounts_for_omelyan_force_cost():
    """autotune.finalize treats max_md_steps as a FORCE-EVAL budget: an
    Omelyan step runs two force solves, so its step-count cap is half
    leapfrog's; both reproduce the tuned eps below the cap."""
    import dataclasses

    from schwingermodel_tpu.hmc.autotune import finalize

    hmc_lf = _model("float32", refine=False, tol=1e-6).hmc
    hmc_om = dataclasses.replace(hmc_lf, integrator="omelyan")

    # below the cap: both quantize md = round(tau/eps)
    assert finalize(hmc_lf, 0.1).md_steps == 10
    assert finalize(hmc_om, 0.1).md_steps == 10
    # tiny eps: the cap binds, omelyan at half the step count
    assert finalize(hmc_lf, 1e-5, max_md_steps=100).md_steps == 100
    assert finalize(hmc_om, 1e-5, max_md_steps=100).md_steps == 50
    # omelyan is valid at a single step; leapfrog needs two
    assert finalize(hmc_lf, 10.0).md_steps == 2
    assert finalize(hmc_om, 10.0).md_steps == 1


def test_omelyan_reversibility():
    """Integrate forward, negate momenta, integrate back: identity to
    roundoff (time-reversibility of the 2MN scheme)."""
    import dataclasses

    from schwingermodel_tpu.hmc.integrators import omelyan

    model = _model("float64", refine=False, tol=1e-13, md_steps=6)
    model = dataclasses.replace(
        model, hmc=dataclasses.replace(model.hmc, integrator="omelyan"))
    key = prng.root_key(5)
    theta = jax.random.uniform(key, (2, 8, 8), minval=-np.pi, maxval=np.pi,
                               dtype=jnp.float64)
    pi, chi, _ = sampler.draw_noise(model, theta.shape, key)
    phi = model.pseudofermion(theta, chi)

    th1, pi1, _, _ = omelyan(model, theta, pi, phi)
    th2, pi2, _, _ = omelyan(model, th1, -pi1, phi)
    np.testing.assert_allclose(np.asarray(th2), np.asarray(theta),
                               atol=5e-9)
    np.testing.assert_allclose(np.asarray(-pi2), np.asarray(pi),
                               atol=5e-9)
