"""One answer to "which device is this, and what precision does it run?".

Every entry point (CLI, tools, benches, the chip smoke test) asks this
module instead of testing `jax.default_backend()` itself:

  - gpu: float32 working precision, with mixed-precision refinement whose
    true residual runs in native f64 (`cg.refine_impl="x64"`), so every
    solve meets the reference's 1e-10 contract on an f64 residual
    (src/main.cpp:26-27) while the CG sweeps run in f32;
  - cpu: float64 throughout (the reference's own arithmetic), no
    refinement needed.

Any other platform is an error, never a default.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """Precision policy that follows from the platform."""

    platform: str          # "gpu" | "cpu"
    real_dtype: str        # working real dtype of angles, momenta, fields
    refine: bool           # f32 inner solves + f64 true-residual refinement
    refine_impl: str       # true-residual arithmetic under `refine`

    @property
    def needs_x64(self) -> bool:
        """jax_enable_x64 must be on: for float64 fields, or for the f64
        true residual of the x64 refinement."""
        return self.real_dtype == "float64" or (
            self.refine and self.refine_impl == "x64")


_POLICIES = {
    "gpu": DevicePolicy("gpu", "float32", True, "x64"),
    "cpu": DevicePolicy("cpu", "float64", False, "x64"),
}


def device_policy(platform: Optional[str] = None) -> DevicePolicy:
    """The precision policy of `platform` (default: JAX's default backend,
    which initializes it). Raises ValueError for any platform other than
    gpu or cpu."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return _POLICIES[platform]
    except KeyError:
        raise ValueError(
            f"unsupported JAX platform {platform!r}: this program runs on "
            f"'gpu' (NVIDIA, CUDA) or 'cpu'") from None


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`, one line per card), or "" where nvidia-smi is
    absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return ""
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def require_gpu() -> dict:
    """What every measured row names -- platform, device kind, device count
    and the card's name and power limit (nvidia-smi) -- for the GPU this
    process runs on; SystemExit when JAX finds no GPU. Measurement paths
    call this: a time taken on the CPU is never reported under a device
    metric."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {devs[0].platform!r}; device measurements "
            f"need an NVIDIA GPU")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": power_limit()}
