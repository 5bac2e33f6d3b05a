"""chip_smoke.py's pieces that run without a GPU: its last line, its phase
selection, its reading of the CLI's output, and its refusal to report
anything where there is no GPU or no repository."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_line_is_the_contract():
    line = chip_smoke.device_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("four_cards", [False, True])
def test_phase_selection(four_cards):
    phases = chip_smoke.select_phases(four_cards)
    mesh = {"cli_lattice_2x2", "cli_chains_4x1x1", "one_card_vs_2x2",
            "one_card_vs_4x1x1"}
    if four_cards:
        # only the sharded path and what it is compared with
        assert set(phases) == mesh
    else:
        assert not set(phases) & mesh
        assert {"gpu_tests", "cli_demo_c1", "cli_demo_c32", "oracle_solve",
                "same_noise_dh", "cg_us_per_iter"} <= set(phases)
    # child phases come before any phase of this process (one JAX process
    # per card at a time)
    kinds = [p in chip_smoke.CHILD for p in phases]
    assert kinds == sorted(kinds, reverse=True)
    for p in phases:
        assert (hasattr(chip_smoke, "phase_" + p)
                or p.startswith("one_card_vs_"))


def test_parse_cli_output():
    out = "\n".join([
        "perf: thermalize: 1.00 s  10.0 traj/s  300 CG iters/traj",
        "Average plaquette value / volume: Ep = 0.85 dEp = 0.01",
        "Acceptance rate: 0.96666666666666667",
        "<exp(-dH)> = 1.0012",
        "CG iterations per trajectory = 412.5",
        "All CG solves converged: True",
        "Execution time = 3.500000 s"])
    r = chip_smoke.parse_cli(out)
    assert r["acceptance"] == pytest.approx(0.9666666666666667)
    assert r["all_converged"] is True and r["cg_iters_per_traj"] == 412.5
    assert r["Ep"] == 0.85 and r["perf"][0].startswith("thermalize")
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.parse_cli("Acceptance rate: 1.0")


def test_init_refuses_cpu():
    with pytest.raises(chip_smoke.PhaseError, match="no GPU"):
        chip_smoke.init_jax(1)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_script_fails_without_gpu_or_repo(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
