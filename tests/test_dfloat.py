"""Double-float arithmetic and the dfloat refinement backend.

Every claim in solvers/dfloat.py is checked here against REAL f64 (CPU).
XLA:CPU's LLVM backend contracts mul+add into FMA inside fused loops,
which breaks error-free transforms; tests that jit df code therefore
compile with xla_backend_optimization_level=0 (the CLI gates the dfloat
impl on dfloat.eft_selfcheck(); the default refinement is the x64 impl).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import eo, eo_df
from schwingermodel_tpu.solvers import dfloat as D

OPT0 = {"xla_backend_optimization_level": "0"}

jit0 = partial(jax.jit, compiler_options=OPT0)


def _val(p):
    return np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)


def _cval(z):
    return _val(z.re) + 1j * _val(z.im)


def _model32(Nx=8, Nt=8, m0=0.1, beta=2.0, **cg_kw):
    cg = CGParams(tol=1e-10, max_iter=2000, refine=True,
                  refine_impl="dfloat", **cg_kw)
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype="float32"),
        hmc=HMCParams(beta=beta, m0=m0, even_odd=True, md_steps=8,
                      trajectory_length=1.0, cg=cg),
    )


def test_two_prod_exact_jitted():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(2048), jnp.float32)
    b = jnp.asarray(rng.standard_normal(2048), jnp.float32)
    p, e = jit0(D.two_prod)(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    assert np.abs(_val((p, e)) - exact).max() == 0.0


def test_two_sum_exact_jitted():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(2048) * 100, jnp.float32)
    b = jnp.asarray(rng.standard_normal(2048), jnp.float32)
    s, e = jit0(D.two_sum)(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    assert np.abs(_val((s, e)) - exact).max() == 0.0


def test_df_sincos_vs_f64():
    rng = np.random.default_rng(2)
    th = jnp.asarray(rng.uniform(-np.pi, np.pi, 8192), jnp.float32)
    s, c = jit0(D.df_sincos)(th)
    th64 = np.asarray(th, np.float64)
    assert np.abs(_val(s) - np.sin(th64)).max() < 1e-13
    assert np.abs(_val(c) - np.cos(th64)).max() < 1e-13


def test_df_sum_all_vs_f64():
    rng = np.random.default_rng(3)
    hi = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    lo = jnp.asarray(rng.standard_normal(4096) * 1e-8, jnp.float32)
    s = jit0(D.df_sum_all)((hi, lo))
    exact = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64)).sum()
    assert abs(_val(s) - exact) < 1e-10 * abs(exact) + 1e-12


def test_eft_selfcheck_detects_backend():
    """On this CPU backend (default opt level) the FMA contraction breaks
    EFTs -- the selfcheck must say so (the CLI gates dfloat refinement on
    it)."""
    assert D.eft_selfcheck() is False


def test_df_eo_normal_matches_f64_operator():
    """Dhat Dhat^+ in df equals the complex128 operator to ~1e-13."""
    rng = np.random.default_rng(4)
    model = _model32()
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, 8, 8)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 8, 4))
                    + 1j * rng.standard_normal((2, 8, 4)), jnp.complex64)
    ops_hi = eo.EOOperators(model.geom, model.fermion_links_hi(theta), 0.1)
    ref = np.asarray(ops_hi.normal(v.astype(jnp.complex128)))
    dfops = eo_df.EOOperatorsDF(model.geom, theta, 0.1, 8)
    got = _cval(jit0(dfops.normal)(D.dfc_from_c(v)))
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max() + 1e-13


def test_df_fold_2pi_exact_large_angles():
    """The Cody-Waite fold is df-exact far beyond any MD drift."""
    rng = np.random.default_rng(40)
    th = jnp.asarray(rng.uniform(-100.0, 100.0, 8192), jnp.float32)
    s, lo = jit0(D.df_fold_2pi)(th)
    th64 = np.asarray(th, np.float64)
    k = np.round(th64 / (2 * np.pi))
    exact = th64 - k * (2 * np.pi)
    assert np.abs(_val((s, lo)) - exact).max() < 2e-13
    assert np.abs(np.asarray(s)).max() <= np.pi * (1 + 1e-6)
    # bitwise identity where no fold is needed (|theta| <= pi -> k == 0)
    thb = jnp.asarray(rng.uniform(-np.pi, np.pi, 1024), jnp.float32)
    sb, lob = jit0(D.df_fold_2pi)(thb)
    assert np.array_equal(np.asarray(sb), np.asarray(thb))
    assert np.abs(np.asarray(lob)).max() == 0.0


def test_df_eo_normal_drifted_theta_matches_f64():
    """EOOperatorsDF with mid-trajectory MD drift (|theta| well beyond the
    bare quadrant-reduction bound ~5pi/4) still equals the complex128
    operator -- the link angles are folded df-exactly (ADVICE r2 item 3)."""
    rng = np.random.default_rng(41)
    model = _model32()
    theta = jnp.asarray(rng.uniform(-4 * np.pi, 4 * np.pi, (2, 8, 8)),
                        jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 8, 4))
                    + 1j * rng.standard_normal((2, 8, 4)), jnp.complex64)
    ops_hi = eo.EOOperators(model.geom, model.fermion_links_hi(theta), 0.1)
    ref = np.asarray(ops_hi.normal(v.astype(jnp.complex128)))
    dfops = eo_df.EOOperatorsDF(model.geom, theta, 0.1, 8)
    got = _cval(jit0(dfops.normal)(D.dfc_from_c(v)))
    assert np.abs(got - ref).max() < 1e-11 * np.abs(ref).max() + 1e-12


def test_df_full_normal_matches_f64_operator():
    """D D^+ (full lattice) in df equals the complex128 operator, incl.
    drifted angles -- the non-even-odd refinement path's evaluator."""
    from schwingermodel_tpu.ops import dirac as dops

    rng = np.random.default_rng(42)
    model = _model32()
    theta = jnp.asarray(rng.uniform(-4 * np.pi, 4 * np.pi, (2, 8, 8)),
                        jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 8, 8))
                    + 1j * rng.standard_normal((2, 8, 8)), jnp.complex64)
    Uf_hi = model.fermion_links_hi(theta)
    ref = np.asarray(dops.dirac_normal(
        model.geom, Uf_hi, v.astype(jnp.complex128), 0.1))
    dfops = eo_df.FullOperatorsDF(model.geom, theta, 0.1, 8)
    got = _cval(jit0(dfops.normal)(D.dfc_from_c(v)))
    assert np.abs(got - ref).max() < 1e-11 * np.abs(ref).max() + 1e-12


def test_refine_df_full_meets_1e10_contract():
    """Full-D (no even-odd) dfloat refinement: the returned solution's TRUE
    complex128 residual meets the reference's 1e-10 contract. Before round 3
    this path silently used the x64 evaluator (broken without x64 --
    ADVICE r2 item 2); it now runs FullOperatorsDF."""
    from schwingermodel_tpu.ops import dirac as dops

    rng = np.random.default_rng(43)
    model = _model32()
    model = dataclasses.replace(
        model, hmc=dataclasses.replace(model.hmc, even_odd=False))
    theta = _thermalized_theta(model)
    Uf = model.fermion_links(theta)
    v = jnp.asarray(rng.standard_normal((2, 8, 8))
                    + 1j * rng.standard_normal((2, 8, 8)), jnp.complex64)
    b = model.D(theta, v)

    res, x_df = jit0(partial(model._solve_full_refined, theta, Uf))(b)
    assert bool(res.converged)
    x128 = jnp.asarray(_cval(x_df))
    Uf_hi = model.fermion_links_hi(theta)
    r = np.asarray(dops.dirac_normal(model.geom, Uf_hi, x128, model.hmc.m0)
                   ) - np.asarray(b, np.complex128)
    rel = np.linalg.norm(r.ravel()) / np.linalg.norm(
        np.asarray(b, np.complex128).ravel())
    assert rel < 1e-10, rel


def test_refine_df_sharded_fermion_action_matches_single():
    """S_f (and hence dH) under a 2x2 lattice mesh with dfloat refinement
    equals the single-device value: the df action dot must be psum'd across
    shards (ADVICE r2 item 1 -- shard-local S_f broke Metropolis)."""
    from functools import partial as _p

    from jax.sharding import PartitionSpec as P

    from schwingermodel_tpu.models.schwinger import SolveStats
    from schwingermodel_tpu.parallel.mesh import lattice_mesh
    from schwingermodel_tpu.parallel.sharded import sharded_model

    rng = np.random.default_rng(44)
    model = _model32()
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, 8, 8)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 8, 4))
                    + 1j * rng.standard_normal((2, 8, 4)), jnp.complex64)

    def sf(m, th, v):
        phi = m.eo_ops(th).dhat(v)
        s, stats = m.fermion_action(th, phi, SolveStats.zero())
        return s, stats.all_converged

    s1, c1 = jit0(_p(sf, model))(theta, v)

    mesh = lattice_mesh((2, 2))
    inner = sharded_model(model)
    sh = jax.shard_map(
        _p(sf, inner), mesh=mesh,
        in_specs=(P(None, "x", "t"), P(None, "x", "t")),
        out_specs=(P(), P()),
        check_vma=False)
    s2, c2 = jit0(sh)(theta, v)

    assert bool(c1) and bool(c2)
    assert abs(float(s2) - float(s1)) < 1e-5 * abs(float(s1)) + 1e-6, (
        float(s1), float(s2))


def test_gauge_action_df_drifted_matches_f64():
    """gauge_action_df on MD-drifted angles (plaquette angle |k| > 2) still
    matches f64 -- the robust 2pi fold covers the Hamiltonian-of-proposal
    case where per-link drift stacks four-fold."""
    import schwingermodel_tpu.ops.gauge as gops

    rng = np.random.default_rng(45)
    model = _model32(Nx=16, Nt=16)
    theta = jnp.asarray(rng.uniform(-4 * np.pi, 4 * np.pi, (2, 16, 16)),
                        jnp.float32)
    S64 = float(gops.gauge_action(
        model.geom, gops.links(theta.astype(jnp.float64), jnp.complex128),
        2.7))
    # eager: EFTs hold per-op, and the opt-level-0 compile of this jaxpr
    # is pathological on XLA:CPU (~4 min)
    with jax.disable_jit():
        Sdf = float(eo_df.gauge_action_df(model.geom, theta, 2.7))
    assert abs(Sdf - S64) < 1e-6 * abs(S64)


def test_gauge_action_df_matches_f64():
    import schwingermodel_tpu.ops.gauge as gops

    rng = np.random.default_rng(5)
    model = _model32(Nx=16, Nt=16)
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, 16, 16)), jnp.float32)
    S64 = float(gops.gauge_action(
        model.geom, gops.links(theta.astype(jnp.float64), jnp.complex128),
        2.7))
    with jax.disable_jit():
        Sdf = float(eo_df.gauge_action_df(model.geom, theta, 2.7))
    assert abs(Sdf - S64) < 1e-6 * abs(S64)


def _thermalized_theta(model, n=60, seed=6):
    from schwingermodel_tpu.hmc import sampler
    from schwingermodel_tpu.utils import prng

    # thermalize with the PLAIN f32 path (refine off) to keep this cheap
    plain = dataclasses.replace(
        model, hmc=dataclasses.replace(
            model.hmc, cg=dataclasses.replace(
                model.hmc.cg, refine=False, tol=1e-6)))
    key = prng.root_key(seed)
    theta = jax.random.uniform(key, (2, model.lattice.Nx, model.lattice.Nt),
                               minval=-np.pi, maxval=np.pi, dtype=jnp.float32)

    @jax.jit
    def block(th, ks):
        return jax.lax.scan(
            lambda t, k: sampler.hmc_trajectory(plain, t, k), th, ks)[0]

    ks = jax.vmap(lambda i: prng.trajectory_key(key, i))(jnp.arange(n))
    return block(theta, ks)


def test_refine_df_meets_1e10_contract():
    """The headline claim: on an f32-only compute path, the returned df
    solution's TRUE residual -- measured in complex128 -- satisfies
    ||b - A x|| < 1e-10 ||b|| on a thermalized configuration (the
    reference's solver contract, src/main.cpp:26-27)."""
    rng = np.random.default_rng(7)
    model = _model32()
    theta = _thermalized_theta(model)
    ops = model.eo_ops(theta)
    v = jnp.asarray(rng.standard_normal((2, 8, 4))
                    + 1j * rng.standard_normal((2, 8, 4)), jnp.complex64)
    b = ops.dhat(v)

    res, x_df = jit0(partial(model._solve_eo_refined, theta, ops))(b)
    assert bool(res.converged)

    # TRUE f64 residual of the df solution
    x128 = jnp.asarray(_cval(x_df))
    ops_hi = eo.EOOperators(model.geom, model.fermion_links_hi(theta),
                            model.hmc.m0)
    r = np.asarray(ops_hi.normal(x128)) - np.asarray(b, np.complex128)
    rel = np.linalg.norm(r.ravel()) / np.linalg.norm(
        np.asarray(b, np.complex128).ravel())
    assert rel < 1e-10, rel
    # and the f32-grade rounding of x matches the f64 solve
    assert np.abs(np.asarray(res.x, np.complex128) - x128).max() < 1e-6


@pytest.mark.slow
def test_refine_df_trajectory_dH_matches_x64():
    """A full HMC trajectory with dfloat refinement produces the same dH as
    the x64-refined trajectory to f32-noise accuracy (same noise fields)."""
    from schwingermodel_tpu.hmc import sampler
    from schwingermodel_tpu.utils import prng

    model_df = _model32()
    model_x64 = dataclasses.replace(
        model_df, hmc=dataclasses.replace(
            model_df.hmc, cg=dataclasses.replace(
                model_df.hmc.cg, refine_impl="x64")))
    theta = _thermalized_theta(model_df, n=30)
    key = prng.trajectory_key(prng.root_key(9), 0)

    _, st_df = jit0(partial(sampler.hmc_trajectory, model_df))(theta, key)
    _, st_x64 = jax.jit(partial(sampler.hmc_trajectory, model_x64))(
        theta, key)
    assert bool(st_df.cg_converged)
    assert abs(float(st_df.delta_H) - float(st_x64.delta_H)) < 2e-3, (
        float(st_df.delta_H), float(st_x64.delta_H))
    assert bool(st_df.accepted) == bool(st_x64.accepted)


def test_refine_df_sharded_matches_single_device():
    """The df refinement path under a 2x2 lattice mesh (df hops ppermute
    their four planes, df reductions psum hi/lo) equals the single-device
    solve."""
    from jax.sharding import PartitionSpec as P

    from schwingermodel_tpu.parallel.mesh import lattice_mesh
    from schwingermodel_tpu.parallel.sharded import sharded_model

    rng = np.random.default_rng(12)
    model = _model32()
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, 8, 8)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 8, 4))
                    + 1j * rng.standard_normal((2, 8, 4)), jnp.complex64)

    def solve(m, th, v):
        ops = m.eo_ops(th)
        b = ops.dhat(v)
        res, _ = m._solve_eo_refined(th, ops, b)
        return res.x, res.converged, res.iters

    x1, c1, i1 = jit0(partial(solve, model))(theta, v)

    mesh = lattice_mesh((2, 2))
    inner = sharded_model(model)
    sh = jax.shard_map(
        partial(solve, inner), mesh=mesh,
        in_specs=(P(None, "x", "t"), P(None, "x", "t")),
        out_specs=(P(None, "x", "t"), P(), P()),
        check_vma=False)
    x2, c2, i2 = jit0(sh)(theta, v)

    assert bool(c1) and bool(c2)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=1e-6, atol=1e-8)
