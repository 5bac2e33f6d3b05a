"""Even-odd (Schur-complement) preconditioning of the Wilson-Dirac operator.

The reference solves (D D^+) psi = Phi with plain CG on the full lattice
(src/conjugate_gradient.cpp:4-66 on src/dirac_operator.cpp:477-480). This
module implements the standard asymmetric even-odd reduction the reference
lacks. Writing sites by checkerboard parity p(n) = (x + t) mod 2, the Wilson
operator D = (m0+2) - H/2 (hopping term H connects only opposite parities,
ops/dirac.py) is block 2x2:

    D = [[ m I ,  -H_eo/2 ],          m = m0 + 2
         [ -H_oe/2 ,  m I  ]]

Because the Wilson diagonal blocks are *gauge-independent* scalars (m I), the
Schur complement on the even sublattice,

    Dhat = m - H_eo H_oe / (4 m),

satisfies det D = m^(2 N_odd) det Dhat with a constant prefactor, so HMC with
pseudofermions of Dhat (half-size fields) samples exactly the same gauge
distribution as the reference's full-D pseudofermions -- while kappa^2-
suppressing the hopping term: the condition number of Dhat Dhat^+ is ~4x
smaller than D D^+, halving CG iteration counts, and every CG vector op runs
on half the sites.

Packed layout (static shapes, no gathers): an even-parity field
is stored as E[x, k] = a[x, 2k + off_e(x)] with off_e(x) = x mod 2 (row x's
even-parity sites sit at t = x mod 2 (mod 2)); odd fields use
off_o(x) = (x+1) mod 2. Shape (..., Nx, Nt/2). A hop to the neighbor at
t+-1 is then a per-row select between the identity and a one-slot roll of
the packed axis -- both plain shifts through the Geometry abstraction, so the
same code runs single-device (jnp.roll) and sharded (lax.ppermute halo),
exactly like the full-lattice stencil.

Requires Nx, Nt even (and, under sharding, an even local Nt per shard).

The fermion force for the Dhat action is obtained with jax.grad of
g(theta) = 2 Re<psi, Dhat(theta) chi'> at fixed psi = (Dhat Dhat^+)^{-1} Phi,
chi' = Dhat^+ psi -- the exact identity dS_f = -2 Re<psi, dDhat chi'> (the
even-odd analog of reference Eqs (37)-(38), src/dirac_operator.cpp:486-505);
autodiff transposes the packed stencil (and its ppermute halos) for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from schwingermodel_tpu.ops.geometry import (
    Geometry,
    T_AXIS,
    shift_m_x,
    shift_p_x,
)

EVEN = 0
ODD = 1


def row_offset(geom: Geometry, Nx: int, Nth: int, parity: int) -> jax.Array:
    """(Nx, 1) int32: t-subindex (0/1) of `parity` sites in each row x.

    Built from *global* x coordinates so it is shard-oblivious (Nx/Nth are
    the local extents under shard_map).
    """
    x, _ = geom.global_coords(Nx, Nth)
    return ((x[:, :1] + parity) % 2).astype(jnp.int32)


def pack(geom: Geometry, a: jax.Array, parity: int) -> jax.Array:
    """Extract the `parity` checkerboard of a[..., Nx, Nt] -> [..., Nx, Nt/2]."""
    *lead, Nx, Nt = a.shape
    ar = a.reshape(*lead, Nx, Nt // 2, 2)
    off = row_offset(geom, Nx, Nt // 2, parity)
    return jnp.where(off == 1, ar[..., 1], ar[..., 0])


def unpack(geom: Geometry, even: jax.Array, odd: jax.Array) -> jax.Array:
    """Interleave packed parities back to the full lattice [..., Nx, Nt]."""
    *lead, Nx, Nth = even.shape
    off_e = row_offset(geom, Nx, Nth, EVEN)
    sub0 = jnp.where(off_e == 0, even, odd)   # content of t-subindex 0
    sub1 = jnp.where(off_e == 0, odd, even)
    return jnp.stack([sub0, sub1], axis=-1).reshape(*lead, Nx, 2 * Nth)


def _gather_pt(geom: Geometry, s: jax.Array, off_tgt: jax.Array) -> jax.Array:
    """Source-parity packed field at the target site's t+1 neighbor.

    Target site (x, t=2k+off) has neighbor t+1 at packed source index
    k' = k + off (wraparound via the periodic packed shift).
    """
    sp = geom.shift(s, T_AXIS, +1)
    return jnp.where(off_tgt == 1, sp, s)


def _gather_mt(geom: Geometry, w: jax.Array, off_tgt: jax.Array) -> jax.Array:
    """Source-parity packed field at the target site's t-1 neighbor
    (packed index k' = k + off - 1)."""
    wm = geom.shift(w, T_AXIS, -1)
    return jnp.where(off_tgt == 1, w, wm)


def hop(geom: Geometry, U_tgt: jax.Array, U_src: jax.Array,
        S: jax.Array, off_tgt: jax.Array) -> jax.Array:
    """Wilson hopping term H restricted source-parity -> target-parity, packed.

    The spin structure is the off-diagonal part of ops.dirac.dirac
    (D = (m0+2) - H/2): forward hops use links at the target site (U_tgt),
    backward hops ship the link-multiplied spin-projected product formed at
    the source site (U_src) -- the same quantity the reference sends through
    its halos (src/dirac_operator.cpp:49-52).

    U_tgt/U_src: packed fermion links [..., 2, Nx, Nth] at target/source
    parity sites (antiperiodic time sign already folded, ops/dirac.py).
    """
    u0t = U_tgt[..., 0, :, :]
    u1t = U_tgt[..., 1, :, :]
    u0s = U_src[..., 0, :, :]
    u1s = U_src[..., 1, :, :]
    s0 = S[..., 0, :, :]
    s1 = S[..., 1, :, :]

    # one shift per direction: same-direction operands are stacked so a
    # sharded hop costs exactly 4 ppermutes (one halo slab each for +t, -t,
    # +x, -x) instead of 7 -- the collective count, not bandwidth, is what
    # dominates small-shard halo exchange
    S_pt = _gather_pt(geom, S, off_tgt)
    p0_pt = S_pt[..., 0, :, :]
    p1_pt = S_pt[..., 1, :, :]
    bt = _gather_mt(geom, jnp.conj(u0s) * (s0 + s1), off_tgt)
    S_px = shift_p_x(geom, S)
    p0_px = S_px[..., 0, :, :]
    p1_px = S_px[..., 1, :, :]
    bx = shift_m_x(geom, jnp.stack(
        [jnp.conj(u1s) * (s0 - 1j * s1), jnp.conj(u1s) * (1j * s0 + s1)],
        axis=-3))
    bx0 = bx[..., 0, :, :]
    bx1 = bx[..., 1, :, :]

    h0 = u0t * (p0_pt - p1_pt) + u1t * (p0_px + 1j * p1_px) + bt + bx0
    h1 = u0t * (p1_pt - p0_pt) + u1t * (p1_px - 1j * p0_px) + bt + bx1
    return jnp.stack([h0, h1], axis=-3)


def hop_dag(geom: Geometry, U_tgt: jax.Array, U_src: jax.Array,
            S: jax.Array, off_tgt: jax.Array) -> jax.Array:
    """Adjoint hopping H^+ restricted source-parity -> target-parity, packed.

    Spin structure mirrors ops.dirac.dirac_dagger (D^+ = (m0+2) - H^+/2).
    hop_dag(tgt<-src) is the adjoint of hop(src<-tgt): verified by the
    packed adjointness test in tests/test_eo.py.
    """
    u0t = U_tgt[..., 0, :, :]
    u1t = U_tgt[..., 1, :, :]
    u0s = U_src[..., 0, :, :]
    u1s = U_src[..., 1, :, :]
    s0 = S[..., 0, :, :]
    s1 = S[..., 1, :, :]

    # one shift per direction (4 ppermutes sharded) -- see hop()
    S_pt = _gather_pt(geom, S, off_tgt)
    p0_pt = S_pt[..., 0, :, :]
    p1_pt = S_pt[..., 1, :, :]
    fwd_t = u0t * (p0_pt + p1_pt)
    bt01 = jnp.conj(u0s) * (s0 - s1)
    bt = _gather_mt(geom, bt01, off_tgt)
    bt0, bt1 = bt, -bt
    S_px = shift_p_x(geom, S)
    p0_px = S_px[..., 0, :, :]
    p1_px = S_px[..., 1, :, :]
    bx = shift_m_x(geom, jnp.stack(
        [jnp.conj(u1s) * (s0 + 1j * s1), jnp.conj(u1s) * (s1 - 1j * s0)],
        axis=-3))
    bx0 = bx[..., 0, :, :]
    bx1 = bx[..., 1, :, :]

    h0 = bt0 + bx0 + fwd_t + u1t * (p0_px - 1j * p1_px)
    h1 = bt1 + bx1 + fwd_t + u1t * (p1_px + 1j * p0_px)
    return jnp.stack([h0, h1], axis=-3)


class EOOperators:
    """Dhat / Dhat^+ on the even sublattice for one gauge configuration."""

    def __init__(self, geom: Geometry, Uf: jax.Array, m0):
        *_, Nx, Nt = Uf.shape
        self.geom = geom
        self.Uf = Uf                    # kept for the wide-halo CG operator
        self.Ue = pack(geom, Uf, EVEN)
        self.Uo = pack(geom, Uf, ODD)
        self.off_e = row_offset(geom, Nx, Nt // 2, EVEN)
        self.off_o = row_offset(geom, Nx, Nt // 2, ODD)
        self.m0 = m0
        self.m = m0 + 2.0
        self.c = 1.0 / (4.0 * self.m)

    def dhat(self, v: jax.Array) -> jax.Array:
        """Dhat v = m v - H_eo H_oe v / (4m), v even-packed."""
        w = hop(self.geom, self.Uo, self.Ue, v, self.off_o)      # H_oe v
        return self.m * v - self.c * hop(self.geom, self.Ue, self.Uo, w, self.off_e)

    def dhat_dag(self, v: jax.Array) -> jax.Array:
        """Dhat^+ v = m v - (H_oe)^+ (H_eo)^+ v / (4m)."""
        w = hop_dag(self.geom, self.Uo, self.Ue, v, self.off_o)  # (H_eo)^+ v
        return self.m * v - self.c * hop_dag(self.geom, self.Ue, self.Uo, w, self.off_e)

    def normal(self, v: jax.Array) -> jax.Array:
        """(Dhat Dhat^+) v -- the CG operator."""
        return self.dhat(self.dhat_dag(v))


def eo_fermion_force(fermion_links_of, geom: Geometry, m0,
                     theta: jax.Array, psi: jax.Array,
                     chi_p: jax.Array) -> jax.Array:
    """F_mu(n) = -dS_f/dtheta_mu(n) for S_f = Phi^+(Dhat Dhat^+)^{-1}Phi.

    Exact identity: dS_f = -2 Re<psi, dDhat chi'> with psi = (Dhat Dhat^+)^-1
    Phi and chi' = Dhat^+ psi held fixed, so the force is the theta-gradient
    of g(theta) = 2 Re<psi, Dhat(theta) chi'>. The gradient of the *local*
    sum is taken; under shard_map the transposed ppermutes of the packed
    stencil route the cross-shard cotangents, so the result equals the
    gradient of the global sum on every shard.

    fermion_links_of: theta -> antiperiodic-folded links (model method).
    """
    psi = jax.lax.stop_gradient(psi)
    chi_p = jax.lax.stop_gradient(chi_p)

    def g(th):
        ops = EOOperators(geom, fermion_links_of(th), m0)
        return 2.0 * jnp.sum(jnp.real(jnp.conj(psi) * ops.dhat(chi_p)))

    return jax.grad(g)(theta)


def eo_ratio_force(fermion_links_of, geom: Geometry, m0, m1,
                   theta: jax.Array, psi: jax.Array, chi_p: jax.Array,
                   phi2: jax.Array) -> jax.Array:
    """Force of the Hasenbusch RATIO pseudofermion term (even-odd form).

    For S2 = (Dhat_1 phi2)^+ (Dhat_0 Dhat_0^+)^{-1} (Dhat_1 phi2) with
    Dhat_i the Schur operator at mass m_i (config.HMCParams.hasenbusch_dm),
    the exact variation at fixed
        psi   = (Dhat_0 Dhat_0^+)^{-1} Dhat_1 phi2,
        chi_p = Dhat_0^+ psi
    is  dS2 = 2 Re<psi, dDhat_1 phi2> - 2 Re<psi, dDhat_0 chi_p>,
    so F = -dS2/dtheta is the theta-gradient of
        g(theta) = 2 Re<psi, Dhat_0(theta) chi_p> - 2 Re<psi, Dhat_1(theta) phi2>.
    Same autodiff-transposed-stencil mechanism (and shard_map behavior) as
    eo_fermion_force; the links are built once -- only the 1/(4m) Schur
    prefactors differ between the two bilinears.
    """
    psi = jax.lax.stop_gradient(psi)
    chi_p = jax.lax.stop_gradient(chi_p)
    phi2 = jax.lax.stop_gradient(phi2)

    def g(th):
        Uf = fermion_links_of(th)
        ops0 = EOOperators(geom, Uf, m0)
        ops1 = EOOperators(geom, Uf, m1)
        return 2.0 * jnp.sum(jnp.real(
            jnp.conj(psi) * (ops0.dhat(chi_p) - ops1.dhat(phi2))))

    return jax.grad(g)(theta)
