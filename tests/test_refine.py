"""Mixed-precision CG refinement: the f32 GPU path must meet the reference's
f64 solver contract ||r|| < 1e-10 ||b|| (src/main.cpp:26-27,
src/conjugate_gradient.cpp:45). See solvers/refine.py.

All residuals here are computed INDEPENDENTLY in f64 from the f64-folded
links -- the test does not trust the solver's own convergence flag alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import dirac as dops
from schwingermodel_tpu.ops import eo
from tests.conftest import random_theta

TOL = 1e-10


def _model(Nx=8, Nt=8, dtype="float32", refine=True, even_odd=True,
           inner_tol=1e-5):
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=dtype),
        hmc=HMCParams(
            beta=2.0, m0=0.1, even_odd=even_odd,
            cg=CGParams(tol=TOL, max_iter=10000, refine=refine,
                        inner_tol=inner_tol),
        ),
    )


def _true_rel_residual_eo(model, theta, b, x):
    """f64 ||b - Dhat Dhat^+ x|| / ||b|| from independently built f64 ops."""
    ops_hi = eo.EOOperators(model.geom, model.fermion_links_hi(theta),
                            model.hmc.m0)
    r = b.astype(jnp.complex128) - ops_hi.normal(x.astype(jnp.complex128))
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b.astype(jnp.complex128)))


def _true_rel_residual_full(model, theta, b, x):
    Uf_hi = model.fermion_links_hi(theta)
    Ax = dops.dirac_normal(model.geom, Uf_hi, x.astype(jnp.complex128),
                           model.hmc.m0)
    r = b.astype(jnp.complex128) - Ax
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b.astype(jnp.complex128)))


def test_refine_meets_contract_eo(rng):
    """Refined even-odd solve from f32 working fields: true f64 residual
    below 1e-10 (the reference's tolerance), impossible for plain f32 CG."""
    model = _model()
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    ops = model.eo_ops(theta)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 4)) + 1j * rng.standard_normal((2, 8, 4))),
        dtype=jnp.complex64)

    res = model._solve_eo(theta, ops, b)
    assert bool(res.converged)
    assert res.x.dtype == jnp.complex128
    rel = _true_rel_residual_eo(model, theta, b, res.x)
    assert rel < 2 * TOL, rel


def test_plain_f32_cannot_meet_contract(rng):
    """Sanity: the f32-only solver at tol 1e-10 stalls far above it --
    refinement is load-bearing, not decorative."""
    model = _model(refine=False)
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    ops = model.eo_ops(theta)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 4)) + 1j * rng.standard_normal((2, 8, 4))),
        dtype=jnp.complex64)
    res = model._solve_eo(theta, ops, b)
    rel = _true_rel_residual_eo(model, theta, b, res.x.astype(jnp.complex64))
    assert rel > 10 * TOL  # typically ~1e-7


def test_refine_matches_f64_solver(rng):
    """Refined f32 solution agrees with the all-f64 solver's solution."""
    theta64 = random_theta(rng, 8, 8)
    b64 = (rng.standard_normal((2, 8, 4))
           + 1j * rng.standard_normal((2, 8, 4))).astype(np.complex128)

    m64 = _model(dtype="float64", refine=False)
    th64 = jnp.asarray(theta64)
    x64 = m64._solve_eo(th64, m64.eo_ops(th64), jnp.asarray(b64)).x

    m32 = _model()
    th32 = jnp.asarray(theta64, dtype=jnp.float32)
    x32 = m32._solve_eo(th32, m32.eo_ops(th32),
                        jnp.asarray(b64, dtype=jnp.complex64)).x

    # the two systems differ by the f32 rounding of theta itself
    # (O(1e-7) in the links); solutions agree to that level
    rel = float(jnp.linalg.norm(x32 - x64) / jnp.linalg.norm(x64))
    assert rel < 5e-6, rel


def test_refine_full_d(rng):
    """Non-even-odd (full DD^+) refinement path."""
    model = _model(even_odd=False)
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 8)) + 1j * rng.standard_normal((2, 8, 8))),
        dtype=jnp.complex64)
    Uf = model.fermion_links(theta)
    res = model._solve_full(theta, Uf, b)
    assert bool(res.converged)
    rel = _true_rel_residual_full(model, theta, b, res.x)
    assert rel < 2 * TOL, rel


def test_refine_uses_forecast_guess(rng):
    """A good x0 (the forecasting path) cuts inner iterations."""
    model = _model()
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    ops = model.eo_ops(theta)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 4)) + 1j * rng.standard_normal((2, 8, 4))),
        dtype=jnp.complex64)
    cold = model._solve_eo(theta, ops, b)
    warm = model._solve_eo(theta, ops, b, x0=cold.x)
    assert bool(warm.converged)
    assert int(warm.iters) < int(cold.iters) // 2
    rel = _true_rel_residual_eo(model, theta, b, warm.x)
    assert rel < 2 * TOL


@pytest.mark.slow
def test_refined_trajectory_dH_matches_f64(rng):
    """End-to-end: one HMC trajectory at the refined-f32 operating point
    reproduces the all-f64 trajectory's dH to MD (f32-force) accuracy."""
    from schwingermodel_tpu.hmc.sampler import trajectory_given_noise

    theta64 = random_theta(rng, 8, 8)
    pi64 = rng.standard_normal((2, 8, 8))
    chi64 = ((rng.standard_normal((2, 8, 4))
              + 1j * rng.standard_normal((2, 8, 4))) / np.sqrt(2.0))

    m64 = _model(dtype="float64", refine=False)
    _, st64 = trajectory_given_noise(
        m64, jnp.asarray(theta64), jnp.asarray(pi64), jnp.asarray(chi64),
        jnp.asarray(0.5))

    m32 = _model()
    _, st32 = trajectory_given_noise(
        m32, jnp.asarray(theta64, jnp.float32), jnp.asarray(pi64, jnp.float32),
        jnp.asarray(chi64, jnp.complex64), jnp.asarray(0.5, jnp.float32))

    assert st32.delta_H.dtype == jnp.float64  # Metropolis-grade energies
    assert abs(float(st32.delta_H) - float(st64.delta_H)) < 5e-4


# ---------- conditioning-envelope fallback (cg.fallback) ----------
#
# A deterministic near-singular fixture: for the conftest rng's first
# random 8x8 configuration, the full Wilson operator has a real eigenvalue
# crossing at m0 = -0.53215006 (dense-eig of -H/2; D = (m0+2) - H/2 is
# singular when m0+2 meets a real eigenvalue of H/2). At m0 = that + 1e-2
# kappa(Dhat Dhat^+) ~ 2e5: far beyond the f32 inner solves' envelope
# (refinement stagnates ~1e-4) yet comfortably inside f64's -- exactly the
# near-critical exceptional-configuration regime (PERF.md).

M0_SING = -0.53215006


def _ill_model(refine_impl, fallback, delta):
    return SchwingerModel(
        lattice=LatticeParams(Nx=8, Nt=8, real_dtype="float32"),
        hmc=HMCParams(
            beta=2.0, m0=M0_SING + delta, even_odd=True,
            cg=CGParams(tol=TOL, max_iter=4000, refine=True,
                        refine_impl=refine_impl, fallback=fallback),
        ),
    )


# (refine_impl, mass offset from the singular point, the residual bar the
# fallback must beat). dfloat's envelope breaks first (its XLA-level x
# accumulation floors near f32 grade on this backend), so kappa ~ 2e5
# already separates off/on, and the df recursion fully certifies 1e-10.
# The x64 refinement survives to kappa ~ 2e7; at kappa ~ 2e8 (delta 3e-4)
# its f32 inner solves get nowhere (rel ~ 1) and the f64 CG continuation
# reaches the honest f64 drift floor ~ eps_f64 * kappa ~ 3e-9 -- the same
# depth the reference's f64 CG attains there (its recursive criterion
# would *report* 1e-10, ours certifies the true residual and says False).
@pytest.mark.parametrize("refine_impl,delta,bar,want_conv", [
    ("dfloat", 1e-2, 2 * TOL, True),
    ("x64", 3e-4, 1e-8, False),
])
def test_fallback_lifts_conditioning_envelope(rng, refine_impl, delta, bar,
                                              want_conv):
    """Without cg.fallback the f32-inner refinement stagnates far above
    the 1e-10 contract on the near-singular fixture; with it the df/f64 CG
    continuation reaches f64-grade depth -- certified against the
    independent f64 operator. Matches the reference's own f64 CG
    capability (src/conjugate_gradient.cpp:4-66)."""
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 4)) + 1j * rng.standard_normal((2, 8, 4))),
        dtype=jnp.complex64)

    off = _ill_model(refine_impl, False, delta)
    res_off = off._solve_eo(theta, off.eo_ops(theta), b)
    assert not bool(res_off.converged)
    assert _true_rel_residual_eo(off, theta, b, res_off.x) > 1e-6

    on = _ill_model(refine_impl, True, delta)
    res_on = on._solve_eo(theta, on.eo_ops(theta), b)
    assert bool(res_on.converged) == want_conv
    if refine_impl == "dfloat":
        # certify the df pair (the c64 round of x alone cannot carry 1e-10)
        _, x_df = on._solve_eo_refined(theta, on.eo_ops(theta), b)
        x = (x_df.re[0].astype(jnp.float64) + x_df.re[1].astype(jnp.float64)
             ) + 1j * (x_df.im[0].astype(jnp.float64)
                       + x_df.im[1].astype(jnp.float64))
    else:
        x = res_on.x
    assert _true_rel_residual_eo(on, theta, b, x) < bar


def test_fallback_costs_nothing_when_converged(rng):
    """On a well-conditioned system the fallback recursion never iterates:
    same certified result, no iteration-count blowup."""
    theta = jnp.asarray(random_theta(rng, 8, 8), dtype=jnp.float32)
    b = jnp.asarray(
        (rng.standard_normal((2, 8, 4)) + 1j * rng.standard_normal((2, 8, 4))),
        dtype=jnp.complex64)
    on = _model()          # m0 = 0.1, fallback defaults True
    off = SchwingerModel(
        lattice=on.lattice,
        hmc=HMCParams(beta=2.0, m0=0.1, even_odd=True,
                      cg=CGParams(tol=TOL, max_iter=10000, refine=True,
                                  fallback=False)))
    res_on = on._solve_eo(theta, on.eo_ops(theta), b)
    res_off = off._solve_eo(theta, off.eo_ops(theta), b)
    assert bool(res_on.converged) and bool(res_off.converged)
    assert _true_rel_residual_eo(on, theta, b, res_on.x) < 2 * TOL
    # identical convergence path: the fallback loop body never executed
    assert int(res_on.iters) <= int(res_off.iters) + 4
