"""Mixed-precision CG: f32 inner solves + f64 iterative refinement.

The reference's solver contract is a relative residual of 1e-10 in double
precision (src/main.cpp:26-27; criterion ||r|| < tol*||b||,
src/conjugate_gradient.cpp:45). A plain f32 CG cannot reach that: the
attainable relative residual is floored near kappa(A) * eps_f32 ~ 1e-6.
Running the whole solve in f64 doubles the bytes every CG iteration moves
(the stencil is bandwidth-bound) and, on GPUs, runs at a fraction of the
f32 rate. Standard mixed-precision iterative refinement gets both:

    x_0 = x0 (f64);  repeat:
        r_k = b - A x_k          computed in f64   (the TRUE residual)
        solve A d = r_k          in f32 to a loose inner tolerance
                                 (the jnp CG -- hundreds of fast
                                 iterations)
        x_{k+1} = x_k + d        accumulated in f64
    until ||r|| < tol * ||b||  (measured in f64)

Each pass contracts the true residual by ~max(inner_tol, kappa * eps_f32),
so 2-4 passes reach 1e-10; the f64 work is two operator applies and a few
axpys per pass -- negligible next to the f32 inner iterations. The
returned convergence flag is measured on the f64
residual, i.e. it certifies the reference's own criterion.

Requires jax_enable_x64 (the CLI enables it when --cg-refine is active on
an f32 run; tests always run with x64 on).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from schwingermodel_tpu.solvers.cg import CGResult


def to_c128(v: jax.Array) -> jax.Array:
    """complex64 -> complex128 via split real/imag casts (f32->f64 converts
    of the real planes; identity-cheap if v is already complex128)."""
    return jax.lax.complex(jnp.real(v).astype(jnp.float64),
                           jnp.imag(v).astype(jnp.float64))


def to_c64(v: jax.Array) -> jax.Array:
    """complex128 -> complex64 via split real/imag casts."""
    return jax.lax.complex(jnp.real(v).astype(jnp.float32),
                           jnp.imag(v).astype(jnp.float32))


def _f64_cg_finish(apply_A_hi, b_hi, x, r, rho, stop2, dot_re_hi,
                   max_iter: int):
    """Plain f64 CG continuation from (x, r): the conditioning-envelope
    fallback of cg_refine. Engaged only while rho >= stop2 -- when the
    refinement already converged the loop body never executes and this
    costs nothing. Lifts the attainable residual from the f32 inner-solve
    floor (~kappa * eps_f32) to the reference's own f64 floor, i.e. the
    refined contract converges wherever the reference's plain f64 CG does
    (src/conjugate_gradient.cpp:4-66, tol criterion :45)."""

    def cond(carry):
        _, _, _, rho, k = carry
        return jnp.logical_and(rho >= stop2, k < max_iter)

    def body(carry):
        x, r, d, rho, k = carry
        Ad = apply_A_hi(d)
        dAd = dot_re_hi(d, Ad)
        alpha = rho / dAd
        x = x + alpha * d
        r = r - alpha * Ad
        rho_new = dot_re_hi(r, r)
        beta = rho_new / rho
        d = r + beta * d
        return (x, r, d, rho_new, k + 1)

    x, r, _, rho, k = lax.while_loop(cond, body, (x, r, r, rho, jnp.int32(0)))
    # certify on the true residual whenever the recursion actually ran
    # (k iterations of recursive-residual drift are otherwise unchecked)
    def certify(args):
        x, _, _ = args
        r = b_hi - apply_A_hi(x)
        return x, r, dot_re_hi(r, r)

    x, r, rho = lax.cond(k > 0, certify, lambda a: a, (x, r, rho))
    return x, r, rho, k


def cg_refine(
    apply_A_hi: Callable[[jax.Array], jax.Array],
    inner_solve: Callable[[jax.Array, jax.Array], Tuple[jax.Array, jax.Array]],
    b: jax.Array,
    dot_re_hi: Callable[[jax.Array, jax.Array], jax.Array],
    *,
    tol: float = 1e-10,
    max_outer: int = 8,
    x0: jax.Array | None = None,
    fallback_max_iter: int = 0,
) -> CGResult:
    """Solve A x = b to f64 relative tolerance `tol` via iterative refinement.

    apply_A_hi : the operator in f64 (complex128 in / complex128 out).
    inner_solve: (rhs_lo, x0_lo) -> (dx_lo, inner_iters); an f32 solver for
                 A d = rhs to its own (loose) relative tolerance. rhs_lo and
                 x0_lo are complex64; dx_lo may be any precision (cast here).
    b          : right-hand side (any complex dtype; promoted to f64).
    dot_re_hi  : Re<x,y> global reduction (geometry-aware), f64 operands.

    Returns CGResult with x in complex128, iters = total inner iterations,
    converged/rel_residual measured on the f64 true residual. Stagnation
    (a pass contracting the residual by < 2x) terminates early with
    converged=False rather than burning max_outer passes -- unless
    fallback_max_iter > 0, in which case a plain f64 CG recursion finishes
    the solve from the refined state (_f64_cg_finish): the refined contract
    then converges wherever the reference's own f64 CG does, at any
    conditioning the f32 inner solves cannot handle.
    """
    b_hi = to_c128(b)
    if x0 is None:
        x0 = jnp.zeros_like(b_hi)
    x = to_c128(x0)

    b_norm2 = dot_re_hi(b_hi, b_hi)
    stop2 = (tol * tol) * b_norm2

    r = b_hi - apply_A_hi(x)
    rho = dot_re_hi(r, r)

    def cond(carry):
        _, _, rho, rho_prev, k, iters = carry
        active = jnp.logical_and(rho >= stop2, k < max_outer)
        # stagnation: the last pass failed to contract ||r||^2 by >= 4x
        progressing = jnp.logical_or(k == 0, rho * 4.0 <= rho_prev)
        return jnp.logical_and(active, progressing)

    def body(carry):
        x, r, rho, _, k, iters = carry
        r_lo = to_c64(r)
        d_lo, inner_iters = inner_solve(r_lo, jnp.zeros_like(r_lo))
        x = x + to_c128(d_lo)
        r = b_hi - apply_A_hi(x)
        rho_new = dot_re_hi(r, r)
        return (x, r, rho_new, rho, k + 1, iters + inner_iters)

    x, r, rho, _, k, iters = lax.while_loop(
        cond, body,
        (x, r, rho, jnp.full_like(rho, jnp.inf), jnp.int32(0), jnp.int32(0)))

    if fallback_max_iter > 0:
        x, r, rho, k_fb = _f64_cg_finish(
            apply_A_hi, b_hi, x, r, rho, stop2, dot_re_hi, fallback_max_iter)
        iters = iters + k_fb

    rel = jnp.sqrt(rho) * lax.rsqrt(
        jnp.maximum(b_norm2, jnp.finfo(rho.dtype).tiny))
    return CGResult(x=x, iters=iters, converged=rho < stop2, rel_residual=rel)


def _df_cg_finish(normal_df, b_df, x, r, rho, stop2, b_norm2, dot_re,
                  max_iter: int, tau: float = 1e-5):
    """Double-float CG continuation from the refined state x (DFComplex):
    the conditioning-envelope fallback of cg_refine_df.

    The recursion's VECTOR state runs at df grade (unit roundoff ~2^-49 ~
    1.8e-15, solvers/dfloat.py) while the search direction d and the scalar
    coefficients stay f32 -- harmless, because x and r are updated with the
    SAME rounded alpha*d / alpha*Ad pair, so the invariant r = b - A x
    holds to the df vector precision regardless of scalar precision. That
    lifts the attainable relative residual from ~kappa * eps_f32 (where the
    f32 inner solves of the refinement stagnate, PERF.md
    envelope note) to ~kappa * eps_df -- f64 grade, matching the
    reference's plain double CG (src/conjugate_gradient.cpp:4-66).

    COMPILATION HAZARD (the reason for this function's flat shape): df
    arithmetic placed inside a lax.cond branch or in the body of an OUTER
    while_loop that nests an inner one was observed to lose its error-free
    transforms on XLA:CPU -- the "true residual" computed there came out
    f32-grade (~1e-4 relative) while the identical expression at top level
    (or inside a single non-nested while body) was df-exact (~1e-15).
    Everything here is therefore a fixed number of FLAT while_loops (the
    recursion) with the df TRUE-residual certifications at top level
    between them; tests/test_refine.py's ill-conditioned gate locks the
    achieved accuracy.

    Each round runs the recursion toward its certified target, then a
    top-level df true residual replaces/certifies and restarts the
    direction; the exit rho is always df-certified. When the refinement
    already converged the recursion loops never execute and only the
    _CERT_ROUNDS certification applies run -- a few df applies, small next
    to any real solve. Breakdown (non-positive f32 curvature / overflow)
    or certified stagnation (a round contracting < 4x) freezes the state
    -> converged=False upstream.
    """
    from schwingermodel_tpu.solvers.dfloat import (
        dfc_from_c, dfc_scale_f, dfc_sub, dfc_to_c, DFComplex, two_prod,
    )

    def axpy_df(xd: DFComplex, alpha, d_c):
        # x += alpha * d, error-free: two_prod products, df accumulate
        from schwingermodel_tpu.solvers.dfloat import df_add

        return DFComplex(
            df_add(xd.re, two_prod(alpha, jnp.real(d_c))),
            df_add(xd.im, two_prod(alpha, jnp.imag(d_c))))

    def round_loop(x, r, d, rho, tgt, need, k):
        """One flat recursion round: guarded df-CG steps while need and
        rho >= tgt. Returns the advanced state (dead chains frozen)."""

        def cond(c):
            _, _, _, rho, k, dead = c
            return jnp.logical_and(
                jnp.logical_and(rho >= tgt, k < max_iter),
                jnp.logical_not(dead))

        def body(c):
            x, r, d, rho, k, _ = c
            Ad = normal_df(dfc_from_c(d))
            Ad_c = dfc_to_c(Ad)
            dAd = dot_re(d, Ad_c)
            alpha = rho / dAd
            broke = jnp.logical_or(
                jnp.logical_not(dAd > 0.0),
                jnp.logical_not(jnp.isfinite(alpha)))
            alpha = jnp.where(broke, jnp.zeros_like(alpha), alpha)
            x = axpy_df(x, alpha, d)
            r = dfc_sub(r, dfc_scale_f(Ad, alpha))
            r_c = dfc_to_c(r)
            rho_new = dot_re(r_c, r_c)
            broke = jnp.logical_or(
                broke, jnp.logical_not(jnp.isfinite(rho_new)))
            rho_new = jnp.where(broke, rho, rho_new)
            beta = jnp.where(broke, jnp.zeros_like(rho), rho_new / rho)
            d = jnp.where(broke, d, r_c + beta * d)
            return (x, r, d, rho_new, k + 1, broke)

        dead0 = jnp.logical_not(need)
        return lax.while_loop(cond, body, (x, r, d, rho, k, dead0))

    tau2 = jnp.asarray(tau * tau, rho.dtype)
    # a df recursion can be trusted ~as deep as its eps allows without
    # intermediate replacements (the drift floor IS the attainable floor),
    # so each round chases tau^2 below the last certified residual (floored
    # a little under the final target) and two rounds reach any reachable
    # target.
    _CERT_ROUNDS = 2
    # re-certify the handoff state at top level: the refinement loop's own
    # carried (r, rho) can be inconsistent with x by O(its stall level)
    # under the compilation hazard above, and a CG recursion started from
    # an inconsistent residual converges to a correspondingly wrong
    # solution (observed: round-1 certification contracting < 4x -> false
    # stagnation). One extra df apply, paid unconditionally.
    r = dfc_sub(b_df, normal_df(x))
    r_c = dfc_to_c(r)
    rho = dot_re(r_c, r_c)
    # zero-restart when the handoff solution is worse than x = 0 (a
    # diverged refinement): x = 0 has residual exactly b
    bad0 = rho > b_norm2

    def z(p):
        return jnp.where(bad0, jnp.zeros_like(p), p)

    x = DFComplex((z(x.re[0]), z(x.re[1])), (z(x.im[0]), z(x.im[1])))
    r = DFComplex(
        (jnp.where(bad0, b_df.re[0], r.re[0]),
         jnp.where(bad0, b_df.re[1], r.re[1])),
        (jnp.where(bad0, b_df.im[0], r.im[0]),
         jnp.where(bad0, b_df.im[1], r.im[1])))
    r_c = dfc_to_c(r)
    rho = jnp.where(bad0, b_norm2, rho)
    need = rho >= stop2
    d = r_c
    k = jnp.int32(0)
    for _ in range(_CERT_ROUNDS):
        tgt = jnp.maximum(stop2 * 0.0625, tau2 * rho)
        x_n, r_n, d_n, rho_n, k, _ = round_loop(x, r, d, rho, tgt, need, k)
        # top-level df certification (see hazard note); `need` masks the
        # state update so converged/poisoned entries keep their state
        rt = dfc_sub(b_df, normal_df(x_n))
        rt_c = dfc_to_c(rt)
        rho_t = dot_re(rt_c, rt_c)
        stalled = jnp.logical_and(need, rho_t * 4.0 > rho)
        # adopt the round's result only if it IMPROVED the certified
        # residual: a diverged recursion (possible before the breakdown
        # guards trip at extreme kappa) must not poison the caller's x
        adopt = jnp.logical_and(need, rho_t < rho)

        def sel(a, b):
            return jax.tree.map(lambda u, v: jnp.where(adopt, u, v), a, b)

        x = sel(x_n, x)
        r = sel(rt, r)
        d = jnp.where(adopt, rt_c, d)
        rho = jnp.where(adopt, rho_t, rho)
        need = jnp.logical_and(
            need, jnp.logical_and(rho >= stop2, jnp.logical_not(stalled)))
    return x, rho, k


def cg_refine_df(
    normal_df: Callable,
    inner_solve: Callable[[jax.Array, jax.Array], Tuple[jax.Array, jax.Array]],
    b: jax.Array,
    dot_re: Callable[[jax.Array, jax.Array], jax.Array],
    *,
    tol: float = 1e-10,
    max_outer: int = 8,
    x0: jax.Array | None = None,
    fallback_max_iter: int = 0,
):
    """Iterative refinement with the TRUE residual in double-float (df)
    arithmetic -- f64-grade accuracy with only f32 ops, for backends without
    usable f64 (solvers/dfloat.py rationale; the backend must preserve
    error-free transforms -- dfloat.eft_selfcheck).

    normal_df  : DFComplex -> DFComplex apply of A (ops/eo_df.EOOperatorsDF
                 .normal) at ~1e-14 relative accuracy.
    inner_solve: (rhs_c64, x0_c64) -> (dx_c64, iters); the f32 jnp CG at
                 its loose tolerance.
    b          : complex64 right-hand side (exact f32 values).
    dot_re     : geometry-aware Re<x,y> on complex64 (residual norms only
                 need f32 relative accuracy; the STATE is what must be df).

    Returns (CGResult with x = complex64 round of the df solution, x_df).
    The convergence flag certifies ||r||_df < tol ||b|| -- the reference's
    own criterion (src/conjugate_gradient.cpp:45) measured at ~1e-15
    resolution. Same stagnation early-exit as cg_refine, unless
    fallback_max_iter > 0: then a double-float CG recursion
    (_df_cg_finish) continues from the refined state, lifting the
    conditioning envelope from ~kappa*eps_f32 to ~kappa*eps_df (f64 grade)
    so the contract converges wherever the reference's f64 CG does.
    """
    from schwingermodel_tpu.solvers.dfloat import (
        DFComplex, dfc_from_c, dfc_sub, dfc_to_c, dfc_add,
    )

    b_df = dfc_from_c(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    x = dfc_from_c(x0)

    b_norm2 = dot_re(b, b)
    stop2 = jnp.asarray(tol * tol, b_norm2.dtype) * b_norm2

    r = dfc_sub(b_df, normal_df(x))
    r_c = dfc_to_c(r)
    rho = dot_re(r_c, r_c)

    def cond(carry):
        _, _, rho, rho_prev, k, iters = carry
        active = jnp.logical_and(rho >= stop2, k < max_outer)
        progressing = jnp.logical_or(k == 0, rho * 4.0 <= rho_prev)
        return jnp.logical_and(active, progressing)

    def body(carry):
        x, r, rho, _, k, iters = carry
        r_c = dfc_to_c(r)
        d, inner_iters = inner_solve(r_c, jnp.zeros_like(r_c))
        x = dfc_add(x, dfc_from_c(d))
        r = dfc_sub(b_df, normal_df(x))
        r_c2 = dfc_to_c(r)
        rho_new = dot_re(r_c2, r_c2)
        return (x, r, rho_new, rho, k + 1, iters + inner_iters)

    x, r, rho, _, k, iters = lax.while_loop(
        cond, body,
        (x, r, rho, jnp.full_like(rho, jnp.inf), jnp.int32(0), jnp.int32(0)))

    if fallback_max_iter > 0:
        # r is the df TRUE residual of x here (recomputed each pass above)
        x, rho, k_fb = _df_cg_finish(
            normal_df, b_df, x, r, rho, stop2, b_norm2, dot_re,
            fallback_max_iter)
        iters = iters + k_fb

    rel = jnp.sqrt(rho) * lax.rsqrt(
        jnp.maximum(b_norm2, jnp.finfo(rho.dtype).tiny))
    res = CGResult(x=dfc_to_c(x), iters=iters, converged=rho < stop2,
                   rel_residual=rel)
    return res, x
