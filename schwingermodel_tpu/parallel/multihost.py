"""Multi-host (multi-process) execution support.

The reference scales across nodes with one flat MPI world: `mpirun -n N`
launches N ranks, `MPI_Init` + the 2D Cartesian topology span nodes
transparently, and every halo message may cross the network
(include/mpi_setup.h:39-71, src/main.cpp:13-15). The JAX equivalent is
`jax.distributed` + one global `jax.sharding.Mesh` spanning all processes —
but, unlike MPI, the interconnect is *tiered*: the GPUs of one host talk over
NVLink (fast), hosts talk over the network (slow). The mesh layout below is
chosen so that the only traffic that crosses hosts is embarrassingly
parallel:

  - lattice axes ('x', 't')  -> local devices of each process  [halo ppermutes
                                 stay inside the host]
  - chain axis ('chain')     -> across processes               [no halo
                                 traffic; only the acceptance-pooling psum of
                                 the autotuner crosses hosts, once per tuning
                                 step]

This is the scaling-book recipe: put the communication-heavy parallelism on
the fast interconnect and the embarrassingly parallel axis on the slow one.
A user who really wants to domain-decompose one huge lattice across hosts can
still build any mesh by hand with `lattice_mesh`; `multihost_mesh` is the
opinionated default.

I/O discipline mirrors the reference's rank-0 pattern (gauge configs gathered
to rank 0 with MPI_Gatherv before writing, gauge_conf.cpp:378-419): every
process computes identically, but only process 0 touches the filesystem —
gate writers with `is_primary()`, and use `gather_global(x)` to materialize a
fully addressable copy of a sharded array on every host before writing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from schwingermodel_tpu.parallel.mesh import (
    CHAIN_AXIS_NAME,
    T_AXIS_NAME,
    X_AXIS_NAME,
    choose_mesh_shape,
)

_initialized = False


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed if (and only if) a multi-process launch is
    detected or fully specified. Idempotent; returns True when running (or
    already running) in distributed mode.

    Detection: explicit args win; otherwise standard cluster env vars that
    jax.distributed.initialize auto-detects (SLURM, Open MPI's OMPI_*) or
    the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID triple. A plain single-process run
    returns False and leaves JAX untouched — so every CLI path can call this
    unconditionally (the reference has no such luxury: it must always
    MPI_Init, main.cpp:13).
    """
    global _initialized
    if _initialized:
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        v = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("JAX_PROCESS_ID")
        process_id = int(v) if v else None
    # A cluster signal must imply MULTIPLE tasks: a bare SLURM_JOB_ID (any
    # single-task job on a SLURM-managed box) must not flip the CLI into
    # distributed mode and silently reshard the lattice.
    def _multi(var):
        v = os.environ.get(var)
        try:
            return v is not None and int(v) > 1
        except ValueError:
            return False
    auto = _multi("SLURM_NTASKS") or _multi("OMPI_COMM_WORLD_SIZE")
    if coordinator_address is None and not auto:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # Env vars looked like a cluster but jax could not resolve a
        # coordinator (e.g. a SLURM-managed box running a single-process
        # job): behave like the single-process case instead of dying.
        if coordinator_address is not None:
            raise
        return False
    _initialized = True
    return True


def is_primary() -> bool:
    """True on the process allowed to write files (reference: rank==0)."""
    return jax.process_index() == 0


def multihost_mesh(
    Nx: int,
    Nt: int,
    *,
    chains_per_host_group: int = 1,
) -> Mesh:
    """Global mesh with lattice axes on local (NVLink-connected) devices and
    the chain axis across processes.

    Shape: ('chain', 'x', 't') = (num_processes * chains_per_host_group,
    rx, rt) where (rx, rt) tiles the lattice over
    local_device_count // chains_per_host_group devices. With one process the
    result degenerates to an ordinary single-host chain mesh.
    """
    n_local = jax.local_device_count()
    if chains_per_host_group < 1 or n_local % chains_per_host_group:
        raise ValueError(
            f"chains_per_host_group={chains_per_host_group} must divide the "
            f"local device count ({n_local})")
    per_chain = n_local // chains_per_host_group
    rx, rt = choose_mesh_shape(per_chain, Nx, Nt)
    rc = jax.process_count() * chains_per_host_group
    # Group devices explicitly by owning process (NOT by relying on
    # jax.devices() being process-major): each (rx, rt) lattice plane is
    # built from a single process's devices, so halo ppermutes never cross
    # hosts.
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    by_proc = {}
    for d in devs:
        by_proc.setdefault(d.process_index, []).append(d)
    grids = [np.asarray(ds).reshape(chains_per_host_group, rx, rt)
             for _, ds in sorted(by_proc.items())]
    dev_grid = np.concatenate(grids, axis=0)
    for c in range(rc):
        owners = {d.process_index for d in dev_grid[c].flat}
        assert len(owners) == 1, (
            f"lattice plane {c} spans processes {owners}; halo traffic "
            f"would cross hosts")
    return Mesh(dev_grid, (CHAIN_AXIS_NAME, X_AXIS_NAME, T_AXIS_NAME))


def gather_global(x) -> np.ndarray:
    """Materialize a (possibly sharded, possibly non-addressable) array as a
    plain numpy copy on every host, for I/O on the primary.

    Replaces the reference's MPI_Gatherv + resized-block-datatype
    reassembly (gauge_conf.cpp:378-395): with a NamedSharding the layout math
    is carried by the sharding itself, so 'gather' is just a resharding to
    fully-replicated.
    """
    x = jax.numpy.asarray(x)
    if _initialized or jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def broadcast_scalar(value: float) -> float:
    """Agree on one host-generated scalar across processes (reference:
    the Metropolis uniform draw is drawn on rank 0 and MPI_Bcast to all,
    hmc.cpp:166-169). In-device Metropolis draws make this unnecessary on the
    hot path; it exists for host-side decisions (e.g. tuned step sizes
    computed from host RNG)."""
    if not (_initialized or jax.process_count() > 1):
        return float(value)
    from jax.experimental import multihost_utils

    arr = np.asarray([value], dtype=np.float64)
    out = multihost_utils.broadcast_one_to_all(arr)
    return float(out[0])


def describe() -> Tuple[int, int, int]:
    """(process_index, process_count, local_device_count) for banners."""
    return jax.process_index(), jax.process_count(), jax.local_device_count()
