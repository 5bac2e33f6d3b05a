"""Double-float (two-float, "df") arithmetic: f64-grade values from f32 ops.

The reference's solver contract is a relative residual of 1e-10 measured in
double precision (src/main.cpp:26-27, src/conjugate_gradient.cpp:45). On a
backend without usable f64 the x64 refinement (solvers/refine.py) cannot
run; the answer there is classical double-single arithmetic (Dekker 1971,
Knuth TAOCP 4.2.2): represent a value as an unevaluated sum hi + lo of two
f32s (|lo| <= ulp(hi)/2, ~48 significand bits, unit roundoff ~2^-49
~ 1.8e-15), built from error-free transformations that use only f32
add/mul -- no x64 mode anywhere. The default refinement (utils/device.py)
is the x64 impl; this one stays selectable with --cg-refine-impl dfloat.

Used by solvers/refine.py's df backend: the iterative-refinement TRUE
residual r = b - A x is computed in df (A's links evaluated by the df
sin/cos below), while the inner solves stay plain f32. Three or four refinement passes then reach 1e-10 exactly as with
f64 accumulation; tests/test_dfloat.py checks every claim against real f64
on CPU.

A df array is an ordinary pytree pair (hi, lo); a df complex is
((re_hi, re_lo), (im_hi, im_lo)). Everything here is elementwise jnp -- it
jits, vmaps, shard_maps, and ppermutes like any other array math.

NOTE on compiler float semantics: error-free transforms require strict
IEEE f32 per op (no fusing a*b-p into an FMA with a different rounding, no
reassociation). two_prod below uses the Dekker split, which stays exact
under fused multiply-add as well; XLA does not reassociate floating-point
adds. Verified numerically against f64 in tests on CPU; eft_selfcheck()
reports whether a backend's compiled code keeps the transforms exact.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import math

import numpy as np

_F32 = jnp.float32


def _c(x: float):
    """Trace-time f32 constant."""
    return jnp.float32(x)


def _df_const(x: float) -> Tuple[jax.Array, jax.Array]:
    """Split a python float (f64) into an exact df constant pair."""
    hi = np.float32(x)
    lo = np.float32(x - float(hi))
    return jnp.float32(hi), jnp.float32(lo)


# ---------- error-free transforms ----------

def _eft_guard(x):
    """Hide an EFT intermediate from XLA's algebraic simplifier.

    The error-free transforms are exact floating-point identities whose
    error terms look algebraically like zero; XLA's simplifier rewrites
    e.g. (a + b) - a -> b and t - (t - a) -> a, silently zeroing the
    captured rounding error (observed under jit; tests/test_dfloat.py
    locks the jitted accuracy). One barrier on the first rounded
    intermediate per transform stops every such rewrite."""
    return jax.lax.optimization_barrier(x)


def two_sum(a, b):
    """a + b = s + e exactly (Knuth). 6 flops, no magnitude assumption."""
    s = _eft_guard(a + b)
    v = _eft_guard(s - a)
    e = (a - _eft_guard(s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """a + b = s + e exactly, REQUIRES |a| >= |b| (Dekker). 3 flops."""
    s = _eft_guard(a + b)
    e = b - _eft_guard(s - a)
    return s, e


_SPLIT = 4097.0  # 2^12 + 1 for f32 (24-bit significand splits 12 + 12)


def _split(a):
    t = _eft_guard(_c(_SPLIT) * a)
    hi = _eft_guard(t - (t - a))
    return hi, a - hi


def two_prod(a, b):
    """a * b = p + e exactly (Dekker split; FMA-safe)."""
    p = _eft_guard(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------- df scalars/arrays: value = hi + lo ----------

def df(hi, lo=None):
    return (hi, jnp.zeros_like(hi) if lo is None else lo)


def df_add(x, y):
    """df + df (Dekker/QD add, ~0.5 ulp df)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def df_add_f(x, b):
    """df + f32."""
    s, e = two_sum(x[0], b)
    e = e + x[1]
    return fast_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    """df * df."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_mul_f(x, b):
    """df * f32."""
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return fast_two_sum(p, e)


def df_from_prod(a, b):
    """exact f32 * f32 as df."""
    return two_prod(a, b)


def df_to_f32(x):
    return x[0] + x[1]


# ---------- df complex: z = (re_df, im_df) ----------

class DFComplex(NamedTuple):
    re: tuple
    im: tuple


def dfc(re_hi, im_hi, re_lo=None, im_lo=None):
    return DFComplex(df(re_hi, re_lo), df(im_hi, im_lo))


def dfc_from_c(z):
    """complex64 array -> df complex (lo = 0)."""
    return DFComplex(df(jnp.real(z)), df(jnp.imag(z)))


def dfc_to_c(z: DFComplex):
    return jax.lax.complex(df_to_f32(z.re), df_to_f32(z.im))


def dfc_add(a: DFComplex, b: DFComplex) -> DFComplex:
    return DFComplex(df_add(a.re, b.re), df_add(a.im, b.im))


def dfc_sub(a: DFComplex, b: DFComplex) -> DFComplex:
    return DFComplex(df_sub(a.re, b.re), df_sub(a.im, b.im))


def dfc_neg(a: DFComplex) -> DFComplex:
    return DFComplex(df_neg(a.re), df_neg(a.im))


def dfc_mul(a: DFComplex, b: DFComplex) -> DFComplex:
    re = df_sub(df_mul(a.re, b.re), df_mul(a.im, b.im))
    im = df_add(df_mul(a.re, b.im), df_mul(a.im, b.re))
    return DFComplex(re, im)


def dfc_mulc(a: DFComplex, b: DFComplex) -> DFComplex:
    """conj(a) * b."""
    re = df_add(df_mul(a.re, b.re), df_mul(a.im, b.im))
    im = df_sub(df_mul(a.re, b.im), df_mul(a.im, b.re))
    return DFComplex(re, im)


def dfc_muli(a: DFComplex) -> DFComplex:
    """i * a (exact)."""
    return DFComplex(df_neg(a.im), a.re)


def dfc_scale_f(a: DFComplex, s) -> DFComplex:
    """a * real f32 scalar."""
    return DFComplex(df_mul_f(a.re, s), df_mul_f(a.im, s))


# ---------- df sin/cos of an f32 angle ----------

# pi/2 split into three f32 pieces (~72 bits total) for exact reduction
_PIO2_HI_F = np.float32(np.pi / 2)
_PIO2_LO_F = np.float32(np.pi / 2 - float(_PIO2_HI_F))
_PIO2_LO2_F = np.float32(np.pi / 2 - float(_PIO2_HI_F) - float(_PIO2_LO_F))

# Taylor coefficients split into df pairs (f64 python floats at trace time)
_SIN_COEFFS = [(-1.0) ** k / float(math.factorial(2 * k + 1))
               for k in range(1, 8)]     # y^3 .. y^15 terms
_COS_COEFFS = [(-1.0) ** k / float(math.factorial(2 * k))
               for k in range(1, 9)]     # y^2 .. y^16 terms


def _opaque(x):
    """Hide a compile-time constant from XLA's algebraic simplifier.

    The error-free transforms above are exact floating-point identities,
    but XLA rewrites patterns like (c + x) - c -> x when one operand is a
    CONSTANT, which silently zeroes the captured rounding error (verified:
    jit of two_sum(1.0, p) loses the lo part; with the barrier it is exact,
    tests/test_dfloat.py). Every constant that enters a two_sum chain must
    pass through here. Runtime values are never rewritten."""
    return jax.lax.optimization_barrier(x)


def _poly_df(y2: tuple, coeffs) -> tuple:
    """Horner sum_k c_k * y2^k (k >= 1) in df; coeffs python floats."""
    def bc(c):
        hi, lo = _df_const(c)
        return (_opaque(jnp.broadcast_to(hi, y2[0].shape)),
                _opaque(jnp.broadcast_to(lo, y2[0].shape)))

    acc = bc(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = df_mul(acc, y2)
        acc = df_add(acc, bc(c))
    return df_mul(acc, y2)


def df_sincos(theta: jax.Array, theta_lo: jax.Array | None = None,
              ) -> Tuple[tuple, tuple]:
    """(sin, cos) of an f32 (or df: pass theta_lo) angle, as df pairs
    (~1e-14 abs).

    theta must be bounded (the sampler keeps angles in [-pi, pi]; callers
    with sums of a few angles fold to [-pi, pi] first), so the quadrant
    index k is in {-2..2} and the reductions below are exact.
    """
    inv_pio2 = _c(float(1.0 / (np.pi / 2)))
    k = jnp.round(theta * inv_pio2)
    # y = theta - k*pi/2 in df: k is a small integer, k*hi/k*lo/k*lo2 are
    # exact f32 products; accumulate with two_sum chains
    y, e1 = two_sum(theta, -k * _c(float(_PIO2_HI_F)))
    y, e2 = two_sum(y, -k * _c(float(_PIO2_LO_F)))
    ylo = e1 + e2 - k * _c(float(_PIO2_LO2_F))
    if theta_lo is not None:
        ylo = ylo + theta_lo
    ydf = fast_two_sum(y, ylo)

    y2 = df_mul(ydf, ydf)
    # sin(y) = y + y * P_sin(y^2); cos(y) = 1 + P_cos(y^2)
    sin_y = df_add(ydf, df_mul(ydf, _poly_df(y2, _SIN_COEFFS)))
    one = (_opaque(jnp.ones_like(theta)), jnp.zeros_like(theta))
    cos_y = df_add(one, _poly_df(y2, _COS_COEFFS))

    km = jnp.mod(k.astype(jnp.int32), 4)

    def sel(q, a, b, c, d):
        """pick a/b/c/d for quadrant 0/1/2/3, per df component."""
        return tuple(
            jnp.where(q == 0, w,
                      jnp.where(q == 1, x, jnp.where(q == 2, yv, z)))
            for w, x, yv, z in zip(a, b, c, d))

    sin_t = sel(km, sin_y, cos_y, df_neg(sin_y), df_neg(cos_y))
    cos_t = sel(km, cos_y, df_neg(sin_y), df_neg(cos_y), sin_y)
    return sin_t, cos_t


# Cody-Waite split of 2*pi into three 12-significand-bit f32 pieces plus an
# f32 tail: k * piece is an exact f32 product for |k| <= 2^11, so the fold
# below is df-exact (~2^-46 abs) for |theta| up to ~1.2e4 -- far beyond any
# MD drift -- instead of the |theta| <= 5pi/4 bound of the bare quadrant
# reduction in df_sincos (the hazard flagged for mid-trajectory angles).
def _cw_pieces_2pi():
    rem = 2.0 * math.pi
    out = []
    for _ in range(3):
        f = np.float32(rem)
        p = (f.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
        out.append(float(p))
        rem -= float(p)
    out.append(float(np.float32(rem)))
    return out


_TWO_PI_PIECES = _cw_pieces_2pi()


def df_fold_2pi(theta: jax.Array, theta_lo: jax.Array | None = None) -> tuple:
    """theta - round(theta / 2pi) * 2pi as a df pair in [-pi, pi].

    The fold is exact to ~2^-46 absolute for |theta| < 2^11 * 2pi (each
    k * piece product is exact; the captured two_sum errors carry the rest).
    Identity (bitwise) for |theta| <= pi, where k == 0. Optional theta_lo
    threads a df input angle through the fold.
    """
    k = jnp.round(theta * _c(1.0 / (2.0 * math.pi)))
    s, e = two_sum(theta, -k * _c(_TWO_PI_PIECES[0]))
    lo = e
    for p in _TWO_PI_PIECES[1:3]:
        s, e = two_sum(s, -k * _c(p))
        lo = lo + e
    lo = lo - k * _c(_TWO_PI_PIECES[3])
    if theta_lo is not None:
        lo = lo + theta_lo
    return fast_two_sum(s, lo)


def dfc_expi(theta: jax.Array) -> DFComplex:
    """exp(i theta) as a df complex, from an f32 angle array.

    Valid for ANY angle magnitude reachable by MD drift: theta is folded to
    [-pi, pi] with the df-exact 2pi reduction before the sin/cos quadrant
    step (mid-trajectory theta routinely exceeds df_sincos's bare |theta|
    <= 5pi/4 validity bound; the sampler folds only between trajectories).
    """
    s, c = df_sincos(*df_fold_2pi(theta))
    return DFComplex(c, s)


# ---------- reductions ----------

def df_sum_all(x: tuple) -> tuple:
    """Sum a df array over ALL axes by pairwise df_add tree (exact to df)."""
    hi = x[0].reshape(-1)
    lo = x[1].reshape(-1)
    n = hi.shape[0]
    while n > 1:
        if n % 2:
            hi = jnp.concatenate([hi, jnp.zeros((1,), hi.dtype)])
            lo = jnp.concatenate([lo, jnp.zeros((1,), lo.dtype)])
            n += 1
        h = n // 2
        hi, lo = df_add((hi[:h], lo[:h]), (hi[h:], lo[h:]))
        n = h
    return hi[0], lo[0]


def df_dot_re(a_c, x: "DFComplex") -> tuple:
    """Re<a, x> = sum(re(a) re(x) + im(a) im(x)) in df; a complex64 (exact),
    x a df complex field."""
    ar, ai = jnp.real(a_c), jnp.imag(a_c)
    t = df_add(df_mul((ar, jnp.zeros_like(ar)), x.re),
               df_mul((ai, jnp.zeros_like(ai)), x.im))
    return df_sum_all(t)


# ---------- backend self-check ----------

def eft_selfcheck() -> bool:
    """True iff the CURRENT backend's compiled code preserves the error-free
    transforms this module is built on.

    XLA:CPU's LLVM backend CONTRACTS mul+add into FMA inside fused loops, which changes two_sum's
    captured error (s becomes fma(a,c,e) != round(p+e)); there
    `--xla_backend_optimization_level=0` -- or the per-function
    jax.jit(..., compiler_options={"xla_backend_optimization_level": "0"})
    -- restores exactness. Callers enabling the df refinement should gate
    on this once at startup (the CLI does).
    """
    import numpy as np

    def probe(x):
        p, e = two_prod(x, jnp.float32(np.float32(2.1)))
        ed = df_mul((x, jnp.zeros_like(x)), _df_const(2.1))
        s, e2 = fast_two_sum(p, e)
        return p, e, ed[0], ed[1]

    x = jnp.asarray(np.linspace(0.7, 1.3, 64, dtype=np.float32))
    p, e, mh, ml = jax.jit(probe)(x)
    x64 = np.asarray(x).astype(np.float64)
    exact_p = x64 * float(np.float32(2.1))
    ok_prod = bool(np.max(np.abs(
        np.asarray(p).astype(np.float64) + np.asarray(e).astype(np.float64)
        - exact_p)) == 0.0)
    ok_mul = bool(np.max(np.abs(
        np.asarray(mh).astype(np.float64) + np.asarray(ml).astype(np.float64)
        - x64 * 2.1)) < 1e-12)
    return ok_prod and ok_mul
