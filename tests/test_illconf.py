"""Failure-time ill-configuration capture (reference src/hmc.cpp:48-56).

The reference dumps the gauge configuration from inside Force the moment CG
fails. The runner's scanned phases instead capture the pre-trajectory
configuration + trajectory index of the first failure per phase; with the
deterministic key discipline (seed, traj_index) that pair reproduces the
failing solve exactly. These tests starve CG (max_iter=1) and prove the
dumped file IS the offending configuration.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.hmc.sampler import hmc_trajectory
from schwingermodel_tpu.io import ctxt
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.runner import hot_start, run_hmc
from schwingermodel_tpu.utils import prng

LAT = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
STARVED = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.5,
                    even_odd=True, cg=CGParams(tol=1e-12, max_iter=1))


def test_dump_is_the_offending_configuration(tmp_path):
    run = RunParams(n_therm=2, n_meas=2, n_steps=0, out_dir=str(tmp_path),
                    seed=3)
    res = run_hmc(LAT, STARVED, run)
    assert res.n_ill >= 1
    rec = res.ill_records[0]
    assert rec["traj_index"] == 0  # every solve fails -> first trajectory

    # the dumped configuration must equal the pre-trajectory theta of
    # trajectory 0 = the deterministic hot start
    key = prng.root_key(run.seed)
    k_init, k_run = jax.random.split(key)
    theta0 = np.asarray(hot_start(LAT, k_init))
    U = ctxt.read_conf(os.path.join(tmp_path, rec["file"]), 8, 8)
    dumped = np.asarray(ctxt.theta_from_links(U))
    np.testing.assert_allclose(dumped, theta0, atol=1e-12)

    # and replaying that trajectory from the dump with its recorded index
    # reproduces the non-convergence
    model = SchwingerModel(lattice=LAT, hmc=STARVED)
    tkey = prng.trajectory_key(k_run, rec["traj_index"])
    _, st = hmc_trajectory(model, jnp.asarray(dumped), tkey)
    assert not bool(st.cg_converged)


def test_fast_path_captures_with_trajectory_indices(tmp_path):
    """The fused measurement phase (one device program for all blocks)
    still reports failure-time capture with correct global indices."""
    run = RunParams(n_therm=0, n_meas=6, n_steps=1, out_dir=str(tmp_path),
                    seed=5)
    res = run_hmc(LAT, STARVED, run)
    # phase structure: [1 traj] (first measurement block) then the scanned
    # remainder -> one capture per host-visible phase = 2 dumps
    assert res.n_ill == 2
    assert [r["traj_index"] for r in res.ill_records] == [0, 1]
    for r in res.ill_records:
        assert os.path.exists(os.path.join(tmp_path, r["file"]))


@pytest.mark.slow
def test_healthy_run_dumps_nothing(tmp_path):
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.5,
                    even_odd=True, cg=CGParams(tol=1e-10, max_iter=10000))
    run = RunParams(n_therm=2, n_meas=2, n_steps=0, out_dir=str(tmp_path),
                    seed=3)
    res = run_hmc(LAT, hmc, run)
    assert res.n_ill == 0 and res.ill_records == []
    assert not [f for f in os.listdir(tmp_path) if "illConf" in f]
