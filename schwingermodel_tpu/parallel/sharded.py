"""shard_map execution of the HMC trajectory over a 2D device mesh.

This is the device-mesh counterpart of running the reference under
`mpirun -n ranks_x*ranks_t` (run.sh:37): the same trajectory math from
schwingermodel_tpu.hmc.sampler runs inside `shard_map` with a
ShardedGeometry, so every shift performs a lax.ppermute halo exchange
(replacing the 8 blocking MPI_Send/Recv per Dirac apply,
src/dirac_operator.cpp:66-88) and every global reduction is a lax.psum
(replacing MPI_Allreduce, include/variables.h:190).

Determinism contract: the noise fields (pi, chi) and the Metropolis uniform
are drawn *outside* shard_map from the global trajectory key, then sharded
by GSPMD like any other jit intermediate. Sharded and single-device
execution therefore consume identical random fields and agree bit-for-bit
in the same dtype (test: tests/test_sharded.py). The reference needs an
explicit MPI_Bcast to keep the accept decision coherent (src/hmc.cpp:166-169)
and has rank-dependent field RNG; here coherence is structural.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from schwingermodel_tpu.hmc import sampler
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops.geometry import ShardedGeometry
from schwingermodel_tpu.parallel.mesh import (
    CHAIN_AXIS_NAME, T_AXIS_NAME, X_AXIS_NAME,
)


def _has_chain_axis(mesh: Mesh) -> bool:
    return CHAIN_AXIS_NAME in mesh.axis_names


def theta_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of field arrays: [mu/spin, x, t] on a 2D mesh, or
    [chain, mu/spin, x, t] on a 3D ('chain', 'x', 't') mesh."""
    if _has_chain_axis(mesh):
        return NamedSharding(
            mesh, P(CHAIN_AXIS_NAME, None, X_AXIS_NAME, T_AXIS_NAME))
    return NamedSharding(mesh, P(None, X_AXIS_NAME, T_AXIS_NAME))


def sharded_model(model: SchwingerModel, chained: bool = False) -> SchwingerModel:
    """The same model with a ppermute/psum geometry (for use inside shard_map).

    chained=True additionally names the data-parallel chain mesh axis so the
    CG termination predicate is OR-synced across chain groups (mismatched
    iteration counts would desynchronize the groups' ppermute schedules)."""
    return dataclasses.replace(
        model, geom=ShardedGeometry(
            x_name=X_AXIS_NAME, t_name=T_AXIS_NAME,
            chain_name=CHAIN_AXIS_NAME if chained else None)
    )


def make_sharded_traj_fn(
    model: SchwingerModel, mesh: Mesh
) -> Callable[[jax.Array, jax.Array], Tuple[jax.Array, sampler.TrajectoryStats]]:
    """Un-jitted sharded HMC step (theta, key) -> (theta', stats), suitable
    for embedding in lax.scan blocks (see runner) or jitting directly.

    theta is the *global* [2, Nx, Nt] angle field (sharded or not; the
    function constrains it to the lattice sharding). On a 3D
    ('chain', 'x', 't') mesh theta is [n_chains, 2, Nx, Nt], `key` is a
    [n_chains] batch of trajectory keys, chains are sharded over the 'chain'
    axis (locally vmapped), and the returned stats carry a leading chain
    axis -- combined data parallelism over chains with lattice domain
    decomposition, the reference's MPI grid being only the latter.
    """
    if model.hmc.even_odd:
        rt = mesh.shape[T_AXIS_NAME]
        if (model.lattice.Nt // rt) % 2:
            raise ValueError(
                f"even-odd mode needs an even local Nt per shard; "
                f"Nt={model.lattice.Nt} over {rt} t-shards gives "
                f"{model.lattice.Nt // rt}")
    chained = _has_chain_axis(mesh)
    inner_model = sharded_model(model, chained=chained)
    field_spec = (P(CHAIN_AXIS_NAME, None, X_AXIS_NAME, T_AXIS_NAME)
                  if chained else P(None, X_AXIS_NAME, T_AXIS_NAME))
    # chi carries a leading (chi1, chi2) pair axis under Hasenbusch
    chi_spec = field_spec
    if model.hasenbusch_active:
        chi_spec = (P(CHAIN_AXIS_NAME, None, None, X_AXIS_NAME, T_AXIS_NAME)
                    if chained else P(None, None, X_AXIS_NAME, T_AXIS_NAME))
    stat_spec = P(CHAIN_AXIS_NAME) if chained else P()

    body = partial(sampler.trajectory_given_noise, inner_model)
    if chained:
        # vmap over this shard's local chains; dt/beta broadcast
        body = jax.vmap(body, in_axes=(0, 0, 0, 0, None, None))

    traj = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(field_spec, field_spec, chi_spec, stat_spec, P(), P()),
        out_specs=(field_spec, stat_spec),
        check_vma=False,
    )

    sharding = theta_sharding(mesh)

    def step(theta: jax.Array, key: jax.Array, dt=None, beta=None):
        """dt/beta: optional traced scalar overrides (autotuning, beta scans);
        None bakes the static hmc values in as compile-time constants."""
        theta = jax.lax.with_sharding_constraint(theta, sharding)
        if chained:
            pi, chi, r = jax.vmap(
                lambda k: sampler.draw_noise(model, theta.shape[1:], k))(key)
        else:
            pi, chi, r = sampler.draw_noise(model, theta.shape, key)
        dt = model.hmc.step_size if dt is None else dt
        beta = model.hmc.beta if beta is None else beta
        return traj(theta, pi, chi, r, dt, beta)

    return step


def make_sharded_step(model: SchwingerModel, mesh: Mesh):
    """jit-compiled sharded HMC step: (theta, key) -> (theta', stats)."""
    return jax.jit(make_sharded_traj_fn(model, mesh))


def make_sharded_observables(model: SchwingerModel, mesh: Mesh):
    """jit-compiled sharded measurement: theta -> dict of scalar observables
    (per-chain scalars on a 3D chain mesh)."""
    chained = _has_chain_axis(mesh)
    inner_model = sharded_model(model, chained=chained)
    field_spec = (P(CHAIN_AXIS_NAME, None, X_AXIS_NAME, T_AXIS_NAME)
                  if chained else P(None, X_AXIS_NAME, T_AXIS_NAME))

    def _measure(theta):
        return {
            "plaquette_sum": inner_model.plaquette_sum(theta),
            "gauge_action": inner_model.gauge_action(theta),
        }

    measure = jax.shard_map(
        jax.vmap(_measure) if chained else _measure,
        mesh=mesh, in_specs=(field_spec,),
        out_specs=P(CHAIN_AXIS_NAME) if chained else P(),
        check_vma=False,
    )
    return jax.jit(measure)
