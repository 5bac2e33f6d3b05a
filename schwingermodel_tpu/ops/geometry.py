"""Lattice geometry: periodic shifts and global reductions.

This is the device-mesh replacement for the reference's entire distributed
runtime (include/mpi_setup.h, the halo buffers TopRow/BottomRow/RightCol/
LeftCol in src/variables.cpp:71-74, and the ~80% of src/dirac_operator.cpp /
src/gauge_conf.cpp devoted to interior/edge/corner case splits around blocking
MPI_Send/MPI_Recv). All stencil math in this package is written against two
primitives:

  shift(a, axis, delta) -> array whose site n holds a(n + delta * hat_axis)
  gsum(a)               -> scalar sum over the *global* lattice

On a single device ``Geometry`` implements shift as jnp.roll and gsum as
jnp.sum. Under ``shard_map`` over a 2D device mesh, ``ShardedGeometry``
implements shift as a local roll plus a one-slice ``lax.ppermute`` halo fix
across the mesh axis (the moral equivalent of the reference's 8 Send/Recv
pairs per Dirac apply, dirac_operator.cpp:66-88, but deadlock-free and
overlappable by XLA), and gsum as local sum + ``lax.psum`` (the reference's
MPI_Allreduce, include/variables.h:190). Diagonal (corner) neighbor exchanges
used by the staple computation (gauge_conf.cpp:226-227, :359-360) fall out of
composing two shifts, so no special corner path exists.

Axis convention: x is axis -2, t is axis -1 of every field array; leading
axes (spin/direction, chain batch) are untouched by shifts.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

X_AXIS = -2
T_AXIS = -1


class Geometry:
    """Single-device (or GSPMD-auto-partitioned) periodic lattice geometry."""

    is_sharded = False

    def shift(self, a: jax.Array, axis: int, delta: int) -> jax.Array:
        """Return array b with b[..., n] = a[..., n + delta*hat(axis)].

        Gathering the value at n+1 means rolling contents backwards, hence
        the sign flip (reference neighbor tables RightPB/LeftPB,
        include/dirac_operator.h:35-62, are replaced by this whole-array op).
        """
        return jnp.roll(a, -delta, axis=axis)

    def gsum(self, a: jax.Array) -> jax.Array:
        """Global scalar sum over lattice axes (keeps leading batch axes)."""
        return jnp.sum(a, axis=(X_AXIS, T_AXIS))

    def gsum_all(self, a: jax.Array) -> jax.Array:
        """Global sum over *all* axes of a (incl. spin/direction axis)."""
        return jnp.sum(a)

    def gsum_stack(self, locals_: list) -> jax.Array:
        """Globally reduce a LIST of already-lattice-summed local scalars
        with ONE collective: returns them stacked along a new axis 0.

        Single-device: the locals are already global -- just stack. Sharded:
        one psum on the stacked array replaces one collective per scalar
        (the reference pays one MPI_Allreduce per dot, variables.h:190)."""
        return jnp.stack(locals_)

    def global_coords(self, Nx: int, Nt: int):
        """(x, t) global integer coordinate grids of shape (Nx, Nt)."""
        x = lax.broadcasted_iota(jnp.int32, (Nx, Nt), 0)
        t = lax.broadcasted_iota(jnp.int32, (Nx, Nt), 1)
        return x, t

    def gsum_df(self, hi: jax.Array, lo: jax.Array):
        """Reduce a per-shard double-float scalar pair (hi, lo) across the
        lattice mesh at df accuracy. Identity on a single device; see
        ShardedGeometry (a plain per-component psum would round the hi
        parts in f32 and lose the sub-ulp information the pair carries)."""
        return hi, lo

    def sync_any(self, pred: jax.Array) -> jax.Array:
        """OR a boolean predicate across *independent* device groups that run
        the same program (the data-parallel chain axis). Identity here; see
        ShardedGeometry. Used by iterative solvers so every group executes
        the same number of collective ops -- mismatched while_loop trip
        counts across groups would desynchronize the ppermute schedule."""
        return pred


@dataclasses.dataclass(frozen=True)
class ShardedGeometry(Geometry):
    """Geometry for use *inside* shard_map over a Mesh with axes (x_name, t_name).

    Each device owns a contiguous (Nx/rx, Nt/rt) block, mirroring the
    reference's 2D Cartesian block decomposition (include/mpi_setup.h:20-22,
    :39-71). Shifts move one slice across the mesh axis with lax.ppermute.
    """

    x_name: str = "x"
    t_name: str = "t"
    # Data-parallel chain axis name when the mesh also shards independent
    # chains (parallel.mesh.CHAIN_AXIS_NAME); None on a pure lattice mesh.
    # Reductions stay per-chain-group; only solver termination crosses it.
    chain_name: str | None = None

    is_sharded = True

    def _mesh_axis(self, axis: int) -> str:
        return self.x_name if axis % 2 == 0 else self.t_name
        # fields are [..., x, t]: axis -2 (even) -> x, axis -1 (odd) -> t

    def shift(self, a: jax.Array, axis: int, delta: int) -> jax.Array:
        name = self._mesh_axis(axis)
        n_shards = lax.axis_size(name)
        rolled = jnp.roll(a, -delta, axis=axis)
        if n_shards == 1:
            return rolled
        if delta == 1:
            # need neighbor's first slice in our last slot; every shard sends
            # its first slice to the *previous* shard along the ring.
            edge = lax.slice_in_dim(a, 0, 1, axis=axis)
            perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            recv = lax.ppermute(edge, name, perm)
            return _set_slice(rolled, recv, axis, -1)
        elif delta == -1:
            edge = lax.slice_in_dim(a, -1, None, axis=axis)
            perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            recv = lax.ppermute(edge, name, perm)
            return _set_slice(rolled, recv, axis, 0)
        else:
            raise NotImplementedError("only unit shifts are used by the stencils")

    def gsum(self, a: jax.Array) -> jax.Array:
        local = jnp.sum(a, axis=(X_AXIS, T_AXIS))
        return lax.psum(local, (self.x_name, self.t_name))

    def gsum_all(self, a: jax.Array) -> jax.Array:
        return lax.psum(jnp.sum(a), (self.x_name, self.t_name))

    def gsum_stack(self, locals_: list) -> jax.Array:
        return lax.psum(jnp.stack(locals_), (self.x_name, self.t_name))

    def sync_any(self, pred: jax.Array) -> jax.Array:
        """OR across chain groups: keeps iterative-solver while_loops running
        in lockstep on all device groups of the mesh (a group whose collective
        -permute schedule diverges from its neighbors deadlocks the program;
        the vmap analog is JAX's own freezing of converged lanes).

        On a chain-ONLY mesh (both lattice axes unsharded) the loop body
        contains no genuine collectives, so groups cannot desynchronize and
        the lockstep psum -- which would be the loop's only cross-group
        (cross-host in the multihost layout) traffic -- is skipped: chains on
        different hosts then iterate fully independently."""
        if self.chain_name is None:
            return pred
        if (lax.axis_size(self.x_name) == 1
                and lax.axis_size(self.t_name) == 1):
            return pred
        return lax.psum(pred.astype(jnp.int32), self.chain_name) > 0

    def global_coords(self, Nx: int, Nt: int):
        """Global coordinates of this shard's sites; Nx/Nt are *local* extents.

        Used to build the antiperiodic-time sign mask shard-obliviously
        (the reference equivalent conditions on rank position in the
        Cartesian grid, include/dirac_operator.h:53-58).
        """
        ix = lax.axis_index(self.x_name)
        it = lax.axis_index(self.t_name)
        x = lax.broadcasted_iota(jnp.int32, (Nx, Nt), 0) + ix * Nx
        t = lax.broadcasted_iota(jnp.int32, (Nx, Nt), 1) + it * Nt
        return x, t

    def gsum_df(self, hi: jax.Array, lo: jax.Array):
        """df-exact cross-shard reduction of a double-float pair: all_gather
        the per-shard (hi, lo) scalars (2 * n_shards floats -- negligible
        traffic) and tree-combine them with error-free two_sum adds, so the
        reduced pair is the correctly-rounded df sum of all shard
        contributions. This is the reduction the 1e-10 dH contract needs on
        lattice-sharded refined runs; separate f32 psums of hi and lo would
        cap S_f/kinetic accuracy at f32 grade (uncaptured psum rounding)."""
        from schwingermodel_tpu.solvers.dfloat import df_sum_all

        hi_g = lax.all_gather(hi, (self.x_name, self.t_name))
        lo_g = lax.all_gather(lo, (self.x_name, self.t_name))
        # df_sum_all reduces over ALL axes; per-shard pairs land on the new
        # leading gather axis while any batch axes must be preserved -- the
        # callers pass plain scalars, so a flat tree-sum is exact here.
        return df_sum_all((hi_g, lo_g))


def _set_slice(a: jax.Array, val: jax.Array, axis: int, index: int) -> jax.Array:
    """a with the single slice at `index` along `axis` replaced by val."""
    axis = axis % a.ndim
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(-1, None) if index == -1 else slice(0, 1)
    return a.at[tuple(idx)].set(val)


def shift_p_t(geom: Geometry, a):
    return geom.shift(a, T_AXIS, +1)


def shift_m_t(geom: Geometry, a):
    return geom.shift(a, T_AXIS, -1)


def shift_p_x(geom: Geometry, a):
    return geom.shift(a, X_AXIS, +1)


def shift_m_x(geom: Geometry, a):
    return geom.shift(a, X_AXIS, -1)
