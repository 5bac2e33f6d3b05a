"""Full-fidelity checkpoint/resume.

The reference can save gauge configurations (src/hmc.cpp:201-208) and has
library routines to reload them (src/gauge_conf.cpp:453-546), but main()
never wires resume up, and RNG state is never persisted (SURVEY.md section 5:
"make resume-from-config and PRNG-key checkpointing real"). This module
saves everything a run needs to continue exactly: the gauge angles, the
base PRNG key, the trajectory counter, accumulated observable chains, and
the run configuration -- one portable .npz per checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams, RunParams

FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    *,
    theta,
    key,
    traj_index: int,
    lattice: LatticeParams,
    hmc: HMCParams,
    run: RunParams,
    chains: dict | None = None,
    extra: dict | None = None,
) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "traj_index": int(traj_index),
        "lattice": dataclasses.asdict(lattice),
        "hmc": dataclasses.asdict(hmc),
        "run": dataclasses.asdict(run),
        "extra": extra or {},
    }
    arrays: dict[str, Any] = {
        "theta": np.asarray(theta),
        "key": np.asarray(key),
        "meta_json": np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        ),
    }
    for name, chain in (chains or {}).items():
        arrays[f"chain_{name}"] = np.asarray(chain, dtype=np.float64)
    np.savez(path, **arrays)


def _known(cls, kw: dict) -> dict:
    """The entries of `kw` that are fields of dataclass `cls`: options that
    a later version removed (kernel-routing flags) are dropped on load."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names}


def load_checkpoint(path: str) -> dict:
    """Returns dict with theta, key, traj_index, lattice, hmc, run, chains."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint from a newer format ({meta['format_version']})"
            )
        hmc_kw = _known(HMCParams, meta["hmc"])
        hmc_kw["cg"] = CGParams(**_known(CGParams, hmc_kw.pop("cg")))
        run_kw = dict(meta["run"])
        if run_kw.get("mesh_shape") is not None:
            run_kw["mesh_shape"] = tuple(run_kw["mesh_shape"])
        return {
            "theta": z["theta"],
            "key": z["key"],
            "traj_index": meta["traj_index"],
            "lattice": LatticeParams(**meta["lattice"]),
            "hmc": HMCParams(**hmc_kw),
            "run": RunParams(**run_kw),
            "chains": {
                k[len("chain_"):]: z[k] for k in z.files if k.startswith("chain_")
            },
            "extra": meta.get("extra", {}),
        }
