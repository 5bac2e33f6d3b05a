"""The runner under the GPU precision policy with vmapped chains (the
single-chain cases and the checks live in test_policy_runner.py)."""

import pytest

from tests.test_policy_runner import check_runner_gpu_policy


@pytest.mark.parametrize("hasenbusch_dm", [None, 0.3], ids=["1pf", "hb"])
@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
def test_runner_gpu_policy_vmapped_chains(tmp_path, integrator,
                                          hasenbusch_dm):
    check_runner_gpu_policy(tmp_path, 3, integrator, hasenbusch_dm)
