"""Lattice sharding over device meshes.

The JAX replacement for the reference's MPI runtime (include/mpi_setup.h):
the 2D Cartesian rank grid becomes a jax.sharding.Mesh, halo exchange becomes
lax.ppermute inside shard_map (schwingermodel_tpu.ops.geometry.ShardedGeometry),
and MPI_Allreduce becomes lax.psum.
"""

from schwingermodel_tpu.parallel.mesh import lattice_mesh, choose_mesh_shape
from schwingermodel_tpu.parallel.multihost import (
    gather_global,
    is_primary,
    maybe_initialize,
    multihost_mesh,
)
from schwingermodel_tpu.parallel.sharded import make_sharded_step, theta_sharding

__all__ = [
    "lattice_mesh",
    "choose_mesh_shape",
    "make_sharded_step",
    "theta_sharding",
    "maybe_initialize",
    "is_primary",
    "multihost_mesh",
    "gather_global",
]
