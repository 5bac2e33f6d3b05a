"""Even-odd Wilson operator in double-float (df) arithmetic.

The f64-grade TRUE-residual evaluator of the dfloat refinement impl, for
backends without usable f64 (solvers/dfloat.py has the full rationale). Mirrors
ops/eo.py term by term -- same packed layout, same gathers, same spin
structure -- but every complex multiply/add runs in double-single
arithmetic (~48-bit significands), and the links are evaluated from the
exact f32 angles by the df sin/cos, so Dhat here equals the f64 operator
of models.SchwingerModel.fermion_links_hi to ~1e-14 (tests/test_dfloat.py
checks this against real f64 on CPU).

A df spinor/link field is a DFComplex of plane arrays shaped like the f32
field ([..., 2, Nx, Nth]); geometry shifts apply to the four planes stacked
as one array, so a sharded df hop still costs 4 ppermutes. Used once per
refinement pass (2 applies per pass) -- ~10x the flops of an f32 apply,
negligible next to the hundreds of f32 inner CG iterations.

Reference mapping: the math is Eqs (34)-(36) of HMC_doc.pdf restricted to
the even sublattice (see ops/eo.py docstring); the reference itself runs
everything in native f64 (src/dirac_operator.cpp) -- this module is how a
f32-native machine reproduces that.
"""

from __future__ import annotations

import jax.numpy as jnp

from schwingermodel_tpu.ops import dirac as dops
from schwingermodel_tpu.ops import eo
from schwingermodel_tpu.ops.geometry import Geometry, T_AXIS, X_AXIS
from schwingermodel_tpu.solvers.dfloat import (
    DFComplex,
    dfc_add,
    dfc_expi,
    dfc_mulc,
    dfc_muli,
    dfc_sub,
    dfc_to_c,
)


def _planes(z: DFComplex):
    return (z.re[0], z.re[1], z.im[0], z.im[1])


def _from_planes(p) -> DFComplex:
    return DFComplex((p[0], p[1]), (p[2], p[3]))


def _shift(geom: Geometry, z: DFComplex, axis: int, delta: int) -> DFComplex:
    """Shift all four df planes with ONE geometry shift (one ppermute)."""
    sh = geom.shift(jnp.stack(_planes(z), axis=0), axis, delta)
    return _from_planes((sh[0], sh[1], sh[2], sh[3]))


def _where(mask, a: DFComplex, b: DFComplex) -> DFComplex:
    return DFComplex(
        (jnp.where(mask, a.re[0], b.re[0]), jnp.where(mask, a.re[1], b.re[1])),
        (jnp.where(mask, a.im[0], b.im[0]), jnp.where(mask, a.im[1], b.im[1])),
    )


def _idx(z: DFComplex, i: int) -> DFComplex:
    """Select index i of the axis at -3 (spin or direction)."""
    return DFComplex(
        (z.re[0][..., i, :, :], z.re[1][..., i, :, :]),
        (z.im[0][..., i, :, :], z.im[1][..., i, :, :]),
    )


def _stack2(a: DFComplex, b: DFComplex) -> DFComplex:
    """Stack two per-site DFComplex fields along a new -3 axis."""
    return DFComplex(
        (jnp.stack([a.re[0], b.re[0]], axis=-3),
         jnp.stack([a.re[1], b.re[1]], axis=-3)),
        (jnp.stack([a.im[0], b.im[0]], axis=-3),
         jnp.stack([a.im[1], b.im[1]], axis=-3)),
    )


def _gather_pt(geom, s: DFComplex, off_tgt) -> DFComplex:
    return _where(off_tgt == 1, _shift(geom, s, T_AXIS, +1), s)


def _gather_mt(geom, w: DFComplex, off_tgt) -> DFComplex:
    return _where(off_tgt == 1, w, _shift(geom, w, T_AXIS, -1))


def hop_df(geom, U_tgt: DFComplex, U_src: DFComplex, S: DFComplex,
           off_tgt) -> DFComplex:
    """eo.hop in df arithmetic (one df shift per direction)."""
    u0t, u1t = _idx(U_tgt, 0), _idx(U_tgt, 1)
    u0s, u1s = _idx(U_src, 0), _idx(U_src, 1)
    s0, s1 = _idx(S, 0), _idx(S, 1)

    S_pt = _gather_pt(geom, S, off_tgt)
    p0_pt, p1_pt = _idx(S_pt, 0), _idx(S_pt, 1)
    bt = _gather_mt(geom, dfc_mulc(u0s, dfc_add(s0, s1)), off_tgt)
    S_px = _shift(geom, S, X_AXIS, +1)
    p0_px, p1_px = _idx(S_px, 0), _idx(S_px, 1)
    bx = _shift(
        geom,
        _stack2(dfc_mulc(u1s, dfc_sub(s0, dfc_muli(s1))),
                dfc_mulc(u1s, dfc_add(dfc_muli(s0), s1))),
        X_AXIS, -1)
    bx0, bx1 = _idx(bx, 0), _idx(bx, 1)

    h0 = dfc_add(
        dfc_add(_mul(u0t, dfc_sub(p0_pt, p1_pt)),
                _mul(u1t, dfc_add(p0_px, dfc_muli(p1_px)))),
        dfc_add(bt, bx0))
    h1 = dfc_add(
        dfc_add(_mul(u0t, dfc_sub(p1_pt, p0_pt)),
                _mul(u1t, dfc_sub(p1_px, dfc_muli(p0_px)))),
        dfc_add(bt, bx1))
    return _stack2(h0, h1)


def hop_dag_df(geom, U_tgt: DFComplex, U_src: DFComplex, S: DFComplex,
               off_tgt) -> DFComplex:
    """eo.hop_dag in df arithmetic."""
    u0t, u1t = _idx(U_tgt, 0), _idx(U_tgt, 1)
    u0s, u1s = _idx(U_src, 0), _idx(U_src, 1)
    s0, s1 = _idx(S, 0), _idx(S, 1)

    S_pt = _gather_pt(geom, S, off_tgt)
    p0_pt, p1_pt = _idx(S_pt, 0), _idx(S_pt, 1)
    fwd_t = _mul(u0t, dfc_add(p0_pt, p1_pt))
    bt0 = _gather_mt(geom, dfc_mulc(u0s, dfc_sub(s0, s1)), off_tgt)
    bt1 = DFComplex((-bt0.re[0], -bt0.re[1]), (-bt0.im[0], -bt0.im[1]))
    S_px = _shift(geom, S, X_AXIS, +1)
    p0_px, p1_px = _idx(S_px, 0), _idx(S_px, 1)
    bx = _shift(
        geom,
        _stack2(dfc_mulc(u1s, dfc_add(s0, dfc_muli(s1))),
                dfc_mulc(u1s, dfc_sub(s1, dfc_muli(s0)))),
        X_AXIS, -1)
    bx0, bx1 = _idx(bx, 0), _idx(bx, 1)

    h0 = dfc_add(dfc_add(bt0, bx0),
                 dfc_add(fwd_t, _mul(u1t, dfc_sub(p0_px, dfc_muli(p1_px)))))
    h1 = dfc_add(dfc_add(bt1, bx1),
                 dfc_add(fwd_t, _mul(u1t, dfc_add(p1_px, dfc_muli(p0_px)))))
    return _stack2(h0, h1)


def _mul(a: DFComplex, b: DFComplex) -> DFComplex:
    from schwingermodel_tpu.solvers.dfloat import dfc_mul

    return dfc_mul(a, b)


def _scale_f(z: DFComplex, s: float) -> DFComplex:
    """z * real python-float constant, the CONSTANT ITSELF in df.

    m = m0 + 2 and c = 1/(4m) are not f32-representable in general;
    rounding them to single would reintroduce a 1e-7 relative error on the
    diagonal term (the f64 reference uses them at double).
    """
    from schwingermodel_tpu.solvers.dfloat import _df_const, df_mul

    c_hi, c_lo = _df_const(float(s))
    cd = (c_hi, c_lo)
    return DFComplex(df_mul(z.re, cd), df_mul(z.im, cd))


def folded_links_df(geom: Geometry, theta, global_Nt: int) -> DFComplex:
    """df fermion links [..., 2, Nx, Nt]: exp(i theta) with the antiperiodic
    time-boundary sign folded into mu=0 (the df analog of
    models.SchwingerModel.fermion_links_hi; sign flip is exact in df)."""
    *_, Nx, Nt = theta.shape
    U = dfc_expi(theta)                       # df links (fold-safe angles)
    sign = dops.make_sign_mask(geom, Nx, Nt, global_Nt, jnp.float32)
    neg = sign < 0
    mask = jnp.stack([neg, jnp.zeros_like(neg)], axis=-3)
    return DFComplex(
        (jnp.where(mask, -U.re[0], U.re[0]),
         jnp.where(mask, -U.re[1], U.re[1])),
        (jnp.where(mask, -U.im[0], U.im[0]),
         jnp.where(mask, -U.im[1], U.im[1])),
    )


class EOOperatorsDF:
    """Dhat / Dhat^+ / normal in df arithmetic for one configuration.

    theta: the f32 angle field [..., 2, Nx, Nt] (EXACT binary values --
    they define the gauge configuration; the df links are exp(i theta)
    evaluated to ~1e-14, the same definition models.fermion_links_hi uses
    with complex128).
    """

    def __init__(self, geom: Geometry, theta, m0: float, global_Nt: int):
        *_, Nx, Nt = theta.shape
        self.geom = geom
        Uf = folded_links_df(geom, theta, global_Nt)
        pk = lambda p, parity: eo.pack(geom, p, parity)  # noqa: E731
        self.Ue = DFComplex(
            (pk(Uf.re[0], eo.EVEN), pk(Uf.re[1], eo.EVEN)),
            (pk(Uf.im[0], eo.EVEN), pk(Uf.im[1], eo.EVEN)))
        self.Uo = DFComplex(
            (pk(Uf.re[0], eo.ODD), pk(Uf.re[1], eo.ODD)),
            (pk(Uf.im[0], eo.ODD), pk(Uf.im[1], eo.ODD)))
        self.off_e = eo.row_offset(geom, Nx, Nt // 2, eo.EVEN)
        self.off_o = eo.row_offset(geom, Nx, Nt // 2, eo.ODD)
        self.m = float(m0) + 2.0
        self.c = 1.0 / (4.0 * self.m)

    def dhat(self, v: DFComplex) -> DFComplex:
        w = hop_df(self.geom, self.Uo, self.Ue, v, self.off_o)
        h = hop_df(self.geom, self.Ue, self.Uo, w, self.off_e)
        return dfc_sub(_scale_f(v, self.m), _scale_f(h, self.c))

    def dhat_dag(self, v: DFComplex) -> DFComplex:
        w = hop_dag_df(self.geom, self.Uo, self.Ue, v, self.off_o)
        h = hop_dag_df(self.geom, self.Ue, self.Uo, w, self.off_e)
        return dfc_sub(_scale_f(v, self.m), _scale_f(h, self.c))

    def normal(self, v: DFComplex) -> DFComplex:
        return self.dhat(self.dhat_dag(v))

    def normal_c(self, v_c64):
        """complex64 in -> complex64 out (df internally); for tests."""
        from schwingermodel_tpu.solvers.dfloat import dfc_from_c

        return dfc_to_c(self.normal(dfc_from_c(v_c64)))


def dirac_df(geom: Geometry, Uf: DFComplex, phi: DFComplex, m0: float,
             ) -> DFComplex:
    """D phi on the FULL lattice in df arithmetic (ops/dirac.dirac term by
    term; reference D_phi, src/dirac_operator.cpp:24-45, doc Eq (34))."""
    u0, u1 = _idx(Uf, 0), _idx(Uf, 1)
    p0, p1 = _idx(phi, 0), _idx(phi, 1)
    p_pt = _shift(geom, phi, T_AXIS, +1)
    p0_pt, p1_pt = _idx(p_pt, 0), _idx(p_pt, 1)
    p_px = _shift(geom, phi, X_AXIS, +1)
    p0_px, p1_px = _idx(p_px, 0), _idx(p_px, 1)
    bt = _shift(geom, dfc_mulc(u0, dfc_add(p0, p1)), T_AXIS, -1)
    bx = _shift(
        geom,
        _stack2(dfc_mulc(u1, dfc_sub(p0, dfc_muli(p1))),
                dfc_mulc(u1, dfc_add(dfc_muli(p0), p1))),
        X_AXIS, -1)
    bx0, bx1 = _idx(bx, 0), _idx(bx, 1)

    h0 = dfc_add(
        dfc_add(_mul(u0, dfc_sub(p0_pt, p1_pt)),
                _mul(u1, dfc_add(p0_px, dfc_muli(p1_px)))),
        dfc_add(bt, bx0))
    h1 = dfc_add(
        dfc_add(_mul(u0, dfc_sub(p1_pt, p0_pt)),
                _mul(u1, dfc_sub(p1_px, dfc_muli(p0_px)))),
        dfc_add(bt, bx1))
    m = float(m0) + 2.0
    d0 = dfc_sub(_scale_f(p0, m), dfc_scale_half(h0))
    d1 = dfc_sub(_scale_f(p1, m), dfc_scale_half(h1))
    return _stack2(d0, d1)


def dirac_dagger_df(geom: Geometry, Uf: DFComplex, phi: DFComplex, m0: float,
                    ) -> DFComplex:
    """D^+ phi on the FULL lattice in df (ops/dirac.dirac_dagger; reference
    D_dagger_phi, src/dirac_operator.cpp:247-269, doc Eqs (35)-(36))."""
    u0, u1 = _idx(Uf, 0), _idx(Uf, 1)
    p0, p1 = _idx(phi, 0), _idx(phi, 1)
    p_pt = _shift(geom, phi, T_AXIS, +1)
    p0_pt, p1_pt = _idx(p_pt, 0), _idx(p_pt, 1)
    p_px = _shift(geom, phi, X_AXIS, +1)
    p0_px, p1_px = _idx(p_px, 0), _idx(p_px, 1)
    bt0 = _shift(geom, dfc_mulc(u0, dfc_sub(p0, p1)), T_AXIS, -1)
    bt1 = dfc_neg_local(bt0)                  # exact: (p1-p0) = -(p0-p1)
    bx = _shift(
        geom,
        _stack2(dfc_mulc(u1, dfc_add(p0, dfc_muli(p1))),
                dfc_mulc(u1, dfc_sub(p1, dfc_muli(p0)))),
        X_AXIS, -1)
    bx0, bx1 = _idx(bx, 0), _idx(bx, 1)

    fwd_t = _mul(u0, dfc_add(p0_pt, p1_pt))
    h0 = dfc_add(dfc_add(bt0, bx0),
                 dfc_add(fwd_t, _mul(u1, dfc_sub(p0_px, dfc_muli(p1_px)))))
    h1 = dfc_add(dfc_add(bt1, bx1),
                 dfc_add(fwd_t, _mul(u1, dfc_add(p1_px, dfc_muli(p0_px)))))
    m = float(m0) + 2.0
    d0 = dfc_sub(_scale_f(p0, m), dfc_scale_half(h0))
    d1 = dfc_sub(_scale_f(p1, m), dfc_scale_half(h1))
    return _stack2(d0, d1)


def dfc_neg_local(a: DFComplex) -> DFComplex:
    return DFComplex((-a.re[0], -a.re[1]), (-a.im[0], -a.im[1]))


def dfc_scale_half(z: DFComplex) -> DFComplex:
    """z * 0.5 -- exact in f32, no df product needed."""
    h = jnp.float32(0.5)
    return DFComplex((z.re[0] * h, z.re[1] * h), (z.im[0] * h, z.im[1] * h))


class FullOperatorsDF:
    """D / D^+ / D D^+ on the full lattice in df arithmetic.

    The f64-grade true-residual evaluator for iterative refinement when
    even-odd preconditioning is OFF (--no-even-odd, or odd lattice extents
    where the CLI auto-disables it) -- the full-D twin of EOOperatorsDF, so
    the dfloat refinement contract holds on every solver path, not only the
    packed one.
    """

    def __init__(self, geom: Geometry, theta, m0: float, global_Nt: int):
        self.geom = geom
        self.Uf = folded_links_df(geom, theta, global_Nt)
        self.m0 = float(m0)

    def d(self, v: DFComplex) -> DFComplex:
        return dirac_df(self.geom, self.Uf, v, self.m0)

    def d_dag(self, v: DFComplex) -> DFComplex:
        return dirac_dagger_df(self.geom, self.Uf, v, self.m0)

    def normal(self, v: DFComplex) -> DFComplex:
        return self.d(self.d_dag(v))

    def normal_c(self, v_c64):
        """complex64 in -> complex64 out (df internally); for tests."""
        from schwingermodel_tpu.solvers.dfloat import dfc_from_c

        return dfc_to_c(self.normal(dfc_from_c(v_c64)))


def gauge_action_df(geom: Geometry, theta, beta: float):
    """Plaquette gauge action in df: beta * sum(1 - cos(dtheta_P)).

    The plaquette ANGLE is a sum of four f32 angles -- accumulated with
    two_sum chains it is df-exact, and 1 - cos runs through df_sincos, so
    S_g reaches the Metropolis at ~1e-13 absolute instead of f32's ~1e-2
    at 64x64. Used by the refined Hamiltonian under the dfloat impl (the
    x64 impl upcasts to f64 instead, models/schwinger.py gauge_action)."""
    from schwingermodel_tpu.solvers.dfloat import df_sincos, two_sum

    t0 = theta[..., 0, :, :]
    t1 = theta[..., 1, :, :]
    # dtheta_P = t0(n) + t1(n+0) - t0(n+1) - t1(n)  (gops.plaquette_field)
    t1_p0 = geom.shift(t1, T_AXIS, +1)
    t0_p1 = geom.shift(t0, X_AXIS, +1)
    s, e = two_sum(t0, t1_p0)
    s2, e2 = two_sum(s, -t0_p1)
    s3, e3 = two_sum(s2, -t1)
    ang = (s3, e + e2 + e3)
    # fold ang into df_sincos's valid range with the df-exact Cody-Waite
    # 2pi reduction: ang is a sum of four angles that may each carry
    # mid-trajectory MD drift beyond [-pi, pi] (this is the Hamiltonian of
    # the PROPOSED config), so no small-|k| assumption is safe here
    from schwingermodel_tpu.solvers.dfloat import df_fold_2pi

    _, cos_a = df_sincos(*df_fold_2pi(ang[0], ang[1]))
    # sum(1 - cos) with a df pairwise tree: S_g reaches the Metropolis at
    # ~1e-7 relative (f32 collapse of the df total) instead of the ~1e-5
    # relative of a plain f32 pairwise sum at 64x64
    from schwingermodel_tpu.solvers.dfloat import (
        _df_const, _opaque, df_mul, df_sub, df_sum_all,
    )

    one = (_opaque(jnp.ones_like(cos_a[0])), jnp.zeros_like(cos_a[0]))
    # df-exact cross-shard gather reduction (identity unsharded): keeps the
    # pair's sub-ulp information across the mesh (geometry.gsum_df)
    s_hi, s_lo = geom.gsum_df(*df_sum_all(df_sub(one, cos_a)))
    if isinstance(beta, (int, float)):
        total = df_mul((s_hi, s_lo), _df_const(float(beta)))
        return total[0] + total[1]
    # traced beta (beta scans): one f32 multiply on the collapsed total
    return (s_hi + s_lo) * beta


__all__ = ["EOOperatorsDF", "FullOperatorsDF", "folded_links_df",
           "dirac_df", "dirac_dagger_df", "hop_df", "hop_dag_df",
           "gauge_action_df"]
