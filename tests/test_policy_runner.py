"""The runner under the GPU precision policy (utils/device.py): float32
fields, x64 true-residual refinement to 1e-10. Both integrators, one and
two pseudofermions (Hasenbusch) -- every solve converged and <exp(-dH)>
finite. Single chains here, vmapped chains in test_policy_runner_chains.py
(one file each, so parallel workers share the compile time)."""

import math

import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.runner import run_hmc
from schwingermodel_tpu.utils.device import device_policy


def check_runner_gpu_policy(out_dir, chains, integrator, hasenbusch_dm):
    p = device_policy("gpu")
    lattice = LatticeParams(Nx=8, Nt=8, real_dtype=p.real_dtype)
    hmc = HMCParams(beta=2.0, m0=0.1, md_steps=4, trajectory_length=0.4,
                    even_odd=True, integrator=integrator,
                    hasenbusch_dm=hasenbusch_dm,
                    cg=CGParams(tol=1e-10, max_iter=10000, refine=p.refine,
                                refine_impl=p.refine_impl))
    res = run_hmc(lattice, hmc, RunParams(n_therm=1, n_meas=2,
                                          n_chains=chains, seed=chains,
                                          out_dir=str(out_dir)))
    assert res.all_converged
    assert res.n_ill == 0
    assert math.isfinite(res.exp_mdH_mean) and res.exp_mdH_mean > 0
    assert res.cg_iters_total > 0
    assert res.theta.dtype.name == "float32"
    assert 0.0 <= res.acceptance_rate <= 1.0


@pytest.mark.parametrize("hasenbusch_dm", [None, 0.3], ids=["1pf", "hb"])
@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
def test_runner_gpu_policy_single_chain(tmp_path, integrator, hasenbusch_dm):
    check_runner_gpu_policy(tmp_path, 1, integrator, hasenbusch_dm)
