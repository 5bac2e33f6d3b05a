"""Runner and CLI tests (small lattices, f64, CPU)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.io import ctxt
from schwingermodel_tpu.parallel import lattice_mesh
from schwingermodel_tpu.runner import run_hmc

LAT = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
HMC = HMCParams(beta=2.0, m0=0.1, md_steps=8, trajectory_length=0.8,
                cg=CGParams(tol=1e-10, max_iter=10000))


def test_run_basic(tmp_path):
    run = RunParams(n_therm=5, n_meas=8, n_steps=0, seed=1,
                    out_dir=str(tmp_path))
    res = run_hmc(LAT, HMC, run)
    assert 0.4 < res.Ep < 0.95
    assert res.chains["plaquette"].shape == (8,)
    assert res.n_ill == 0
    assert res.traj_index == 13
    assert 0.0 <= res.acceptance_rate <= 1.0


@pytest.mark.slow
def test_fast_and_slow_paths_agree(tmp_path):
    """save_conf toggles the host-loop path; observables must be identical."""
    r_fast = run_hmc(LAT, HMC, RunParams(n_therm=3, n_meas=5, n_steps=1,
                                         seed=2, out_dir=str(tmp_path)))
    r_slow = run_hmc(LAT, HMC, RunParams(n_therm=3, n_meas=5, n_steps=1,
                                         seed=2, save_conf=True,
                                         out_dir=str(tmp_path)))
    np.testing.assert_allclose(r_fast.chains["plaquette"],
                               r_slow.chains["plaquette"], rtol=1e-12)
    assert r_fast.acceptance_rate == r_slow.acceptance_rate
    # and save_conf wrote reference-named files readable by our reader
    f0 = tmp_path / ctxt.conf_filename(8, 8, 2.0, 0.1, 0)
    assert f0.exists()
    U = ctxt.read_conf(str(f0), 8, 8)
    np.testing.assert_allclose(np.abs(U), 1.0, atol=1e-12)


def test_chains_vmapped(tmp_path):
    run = RunParams(n_therm=3, n_meas=4, n_steps=0, n_chains=3, seed=3,
                    out_dir=str(tmp_path))
    res = run_hmc(LAT, HMC, run)
    assert res.chains["plaquette"].shape == (4, 3)
    assert res.theta.shape == (3, 2, 8, 8)
    # chains must differ (independent noise)
    p = res.chains["plaquette"][-1]
    assert len(np.unique(p)) == 3


@pytest.mark.slow
def test_sharded_runner_matches_single_device(tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = lattice_mesh((2, 2))
    run = RunParams(n_therm=3, n_meas=4, n_steps=0, seed=4,
                    out_dir=str(tmp_path), mesh_shape=(2, 2))
    r1 = run_hmc(LAT, HMC, RunParams(n_therm=3, n_meas=4, n_steps=0, seed=4,
                                     out_dir=str(tmp_path)))
    r2 = run_hmc(LAT, HMC, run, mesh=mesh)
    np.testing.assert_allclose(r1.chains["plaquette"],
                               r2.chains["plaquette"], rtol=0, atol=1e-10)


def test_quenched_run(tmp_path):
    hmc = HMCParams(beta=2.0, m0=0.0, md_steps=10, trajectory_length=1.0,
                    quenched=True)
    run = RunParams(n_therm=50, n_meas=100, n_steps=0, seed=5,
                    out_dir=str(tmp_path))
    res = run_hmc(LAT, hmc, run)
    # exact 2D U(1): <P> = I1(2)/I0(2) = 0.69777; 8x8 with 100 meas ~ 1% err
    assert abs(res.Ep - 0.697775) < 5 * max(res.dEp, 0.01)
    assert res.cg_iters_total == 0


def test_simdata_written(tmp_path):
    run = RunParams(n_therm=2, n_meas=3, n_steps=0, seed=6,
                    out_dir=str(tmp_path))
    res = run_hmc(LAT, HMC, run, write_simdata=True, host="testhost")
    p = tmp_path / "2D_U1_8x8_m00.10000000000000001_SimData.txt"
    assert p.exists()
    text = p.read_text()
    assert "#Ep" in text and "#Execution time" in text and "testhost" in text


CLI_ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}


@pytest.mark.slow
def test_cli_parameter_pipe(tmp_path):
    """The reference's piped-parameter workflow must work verbatim."""
    params = "1\n1\n0.1\n8\n0.8\n2\n2\n3\n0\n0"
    out = subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu", "--nx", "8", "--nt", "8",
         "--platform", "cpu", "--out-dir", str(tmp_path), "--no-simdata"],
        input=params, capture_output=True, text=True, env=CLI_ENV,
        cwd=str(tmp_path), timeout=600,
    )
    assert out.returncode == 0, out.stderr
    assert "Average plaquette value / volume: Ep =" in out.stdout
    assert "Acceptance rate:" in out.stdout


def test_cli_bad_mesh_rejected(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "schwingermodel_tpu", "--nx", "8", "--nt", "8",
         "--platform", "cpu", "--beta", "2", "--m0", "0.1", "--md-steps", "4",
         "--tau", "0.4", "--ntherm", "1", "--nmeas", "1", "--nsteps", "0",
         "--ranks-x", "3", "--ranks-t", "1", "--no-simdata"],
        capture_output=True, text=True, env=CLI_ENV, cwd=str(tmp_path),
        timeout=600,
    )
    assert out.returncode == 1
    assert "not divisible" in out.stderr or "needs" in out.stderr
