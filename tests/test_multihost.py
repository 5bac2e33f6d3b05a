"""Multi-host support (parallel/multihost.py), exercised single-process.

A real multi-process run needs N hosts; what CI can pin down is (a) the
degenerate single-process semantics every code path relies on, (b) that the
host-aware mesh layout puts lattice axes on local devices, and (c) that the
no-cluster detection never initializes jax.distributed by accident.
"""

import numpy as np
import pytest

import jax

from schwingermodel_tpu.parallel import multihost
from schwingermodel_tpu.parallel.mesh import (
    CHAIN_AXIS_NAME, T_AXIS_NAME, X_AXIS_NAME,
)


def test_maybe_initialize_noop_without_cluster(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "SLURM_JOB_ID", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize() is False
    assert jax.process_count() == 1


def test_is_primary_single_process():
    assert multihost.is_primary() is True


def test_multihost_mesh_single_process_layout():
    mesh = multihost.multihost_mesh(8, 8)
    assert mesh.axis_names == (CHAIN_AXIS_NAME, X_AXIS_NAME, T_AXIS_NAME)
    # one process -> chain axis of size process_count * 1 == 1, lattice axes
    # over all 8 local fake devices
    assert mesh.shape[CHAIN_AXIS_NAME] == 1
    assert mesh.shape[X_AXIS_NAME] * mesh.shape[T_AXIS_NAME] == 8
    # each (x, t) plane must live inside one process (host-local halos)
    procs = {d.process_index for d in mesh.devices.flat}
    assert procs == {0}


def test_multihost_mesh_chain_groups():
    mesh = multihost.multihost_mesh(8, 8, chains_per_host_group=2)
    assert mesh.shape[CHAIN_AXIS_NAME] == 2
    assert mesh.shape[X_AXIS_NAME] * mesh.shape[T_AXIS_NAME] == 4
    with pytest.raises(ValueError):
        multihost.multihost_mesh(8, 8, chains_per_host_group=3)


def test_gather_global_identity_single_process():
    x = jax.numpy.arange(12.0).reshape(3, 4)
    out = multihost.gather_global(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(12.0).reshape(3, 4))


def test_gather_global_on_sharded_array():
    mesh = multihost.multihost_mesh(8, 8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.numpy.arange(2 * 8 * 8, dtype=jax.numpy.float32).reshape(2, 8, 8)
    sh = NamedSharding(mesh, P(None, X_AXIS_NAME, T_AXIS_NAME))
    xs = jax.device_put(x, sh)
    np.testing.assert_array_equal(multihost.gather_global(xs), np.asarray(x))


def test_broadcast_scalar_single_process():
    assert multihost.broadcast_scalar(0.125) == 0.125


def test_describe():
    pi, pc, ld = multihost.describe()
    assert (pi, pc) == (0, 1)
    assert ld == 8  # conftest pins 8 virtual CPU devices
