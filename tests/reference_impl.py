"""Independent per-site NumPy oracle for the Wilson-Dirac operator and forces.

Hand-written from the equations in the reference (src/dirac_operator.cpp:24
Eq (34), :247 Eqs (35)-(36), :486 Eqs (37)-(38); staples gauge_conf.cpp:89),
using explicit mod-indexing loops -- deliberately naive and structured
differently from the JAX implementation so that agreement is meaningful.

Conventions: site (x, t); mu=0 hops t -> t+1, mu=1 hops x -> x+1; fermions
antiperiodic in time (sign -1 when a hop crosses the t boundary), links
periodic.
"""

import numpy as np


def _sgn_fwd_t(t, Nt):
    return -1.0 if t == Nt - 1 else 1.0


def _sgn_bwd_t(t, Nt):
    return -1.0 if t == 0 else 1.0


def dirac_ref(U, phi, m0):
    """U complex[2,Nx,Nt] plain links (no folded signs), phi complex[2,Nx,Nt]."""
    _, Nx, Nt = phi.shape
    out = np.zeros_like(phi)
    for x in range(Nx):
        for t in range(Nt):
            tp, tm = (t + 1) % Nt, (t - 1) % Nt
            xp, xm = (x + 1) % Nx, (x - 1) % Nx
            sR0 = _sgn_fwd_t(t, Nt)
            sL0 = _sgn_bwd_t(t, Nt)
            p0, p1 = phi[0], phi[1]
            out[0, x, t] = (m0 + 2) * p0[x, t] - 0.5 * (
                U[0, x, t] * sR0 * (p0[x, tp] - p1[x, tp])
                + U[1, x, t] * (p0[xp, t] + 1j * p1[xp, t])
                + np.conj(U[0, x, tm]) * sL0 * (p0[x, tm] + p1[x, tm])
                + np.conj(U[1, xm, t]) * (p0[xm, t] - 1j * p1[xm, t])
            )
            out[1, x, t] = (m0 + 2) * p1[x, t] - 0.5 * (
                U[0, x, t] * sR0 * (-p0[x, tp] + p1[x, tp])
                + U[1, x, t] * (-1j * p0[xp, t] + p1[xp, t])
                + np.conj(U[0, x, tm]) * sL0 * (p0[x, tm] + p1[x, tm])
                + np.conj(U[1, xm, t]) * (1j * p0[xm, t] + p1[xm, t])
            )
    return out


def dirac_dagger_ref(U, phi, m0):
    _, Nx, Nt = phi.shape
    out = np.zeros_like(phi)
    for x in range(Nx):
        for t in range(Nt):
            tp, tm = (t + 1) % Nt, (t - 1) % Nt
            xp, xm = (x + 1) % Nx, (x - 1) % Nx
            sR0 = _sgn_fwd_t(t, Nt)
            sL0 = _sgn_bwd_t(t, Nt)
            p0, p1 = phi[0], phi[1]
            out[0, x, t] = (m0 + 2) * p0[x, t] - 0.5 * (
                np.conj(U[0, x, tm]) * sL0 * (p0[x, tm] - p1[x, tm])
                + np.conj(U[1, xm, t]) * (p0[xm, t] + 1j * p1[xm, t])
                + U[0, x, t] * sR0 * (p0[x, tp] + p1[x, tp])
                + U[1, x, t] * (p0[xp, t] - 1j * p1[xp, t])
            )
            out[1, x, t] = (m0 + 2) * p1[x, t] - 0.5 * (
                np.conj(U[0, x, tm]) * sL0 * (-p0[x, tm] + p1[x, tm])
                + np.conj(U[1, xm, t]) * (-1j * p0[xm, t] + p1[xm, t])
                + U[0, x, t] * sR0 * (p0[x, tp] + p1[x, tp])
                + U[1, x, t] * (1j * p0[xp, t] + p1[xp, t])
            )
    return out


def fermion_force_ref(U, left, right):
    """Im-parts force field per reference Eqs (37)-(38)."""
    _, Nx, Nt = left.shape
    out = np.zeros((2, Nx, Nt), dtype=np.float64)
    l0, l1 = left[0], left[1]
    r0, r1 = right[0], right[1]
    for x in range(Nx):
        for t in range(Nt):
            tp = (t + 1) % Nt
            xp = (x + 1) % Nx
            s0 = _sgn_fwd_t(t, Nt)
            out[0, x, t] = np.imag(
                U[0, x, t] * s0 * np.conj(l0[x, t] - l1[x, t]) * (r0[x, tp] - r1[x, tp])
                - np.conj(U[0, x, t]) * s0 * np.conj(l0[x, tp] + l1[x, tp]) * (r0[x, t] + r1[x, t])
            )
            out[1, x, t] = np.imag(
                U[1, x, t] * (np.conj(l0[x, t]) - 1j * np.conj(l1[x, t])) * (r0[xp, t] + 1j * r1[xp, t])
                + np.conj(U[1, x, t]) * (np.conj(l0[xp, t]) + 1j * np.conj(l1[xp, t])) * (-r0[x, t] + 1j * r1[x, t])
            )
    return out


def staples_ref(U):
    _, Nx, Nt = U.shape
    out = np.zeros_like(U)
    for x in range(Nx):
        for t in range(Nt):
            tp, tm = (t + 1) % Nt, (t - 1) % Nt
            xp, xm = (x + 1) % Nx, (x - 1) % Nx
            out[0, x, t] = (
                U[1, x, t] * U[0, xp, t] * np.conj(U[1, x, tp])
                + np.conj(U[1, xm, t]) * U[0, xm, t] * U[1, xm, tp]
            )
            out[1, x, t] = (
                U[0, x, t] * U[1, x, tp] * np.conj(U[0, xp, t])
                + np.conj(U[0, x, tm]) * U[1, x, tm] * U[0, xp, tm]
            )
    return out


def plaquette_ref(U):
    _, Nx, Nt = U.shape
    out = np.zeros((Nx, Nt), dtype=complex)
    for x in range(Nx):
        for t in range(Nt):
            tp = (t + 1) % Nt
            xp = (x + 1) % Nx
            out[x, t] = (
                U[0, x, t] * U[1, x, tp] * np.conj(U[0, xp, t]) * np.conj(U[1, x, t])
            )
    return out


def links_ref(theta):
    """U = exp(i theta) in complex128 from (possibly f32) angles."""
    return np.exp(1j * np.asarray(theta, dtype=np.float64))


def even_sites(Nx, Nt):
    """Boolean (Nx, Nt) mask of the even sites, (x + t) even."""
    x, t = np.meshgrid(np.arange(Nx), np.arange(Nt), indexing="ij")
    return (x + t) % 2 == 0


def schur_ref(U, w, m0, dagger=False):
    """Dhat w (or Dhat^+ w) for a full-lattice spinor w supported on the
    even sites, from the full Wilson operator in (even, odd) blocks:
    D = [[m, -H_eo/2], [-H_oe/2, m]], m = m0 + 2, so the odd part of
    D w_e is -H_oe w_e / 2, the even part of D u_o is -H_eo u_o / 2, and
    Dhat = m - H_eo H_oe / (4m). Returns a field supported on even sites."""
    apply = dirac_dagger_ref if dagger else dirac_ref
    even = even_sites(*w.shape[1:])
    m = m0 + 2.0
    w = np.where(even, w, 0)
    u = np.where(even, 0, apply(U, w, m0))
    s = np.where(even, apply(U, u, m0), 0)
    return m * w - s / m


def schur_normal_ref(U, w, m0):
    """(Dhat Dhat^+) w on the even sites (see schur_ref)."""
    return schur_ref(U, schur_ref(U, w, m0, dagger=True), m0)


def normal_ref(U, w, m0):
    """(D D^+) w on the full lattice."""
    return dirac_ref(U, dirac_dagger_ref(U, w, m0), m0)
