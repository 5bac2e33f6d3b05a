"""On-card test tier: tests that mean something only on an NVIDIA GPU.

Run on the card, in its own process (the default tier, tests/, pins the
CPU at conftest import, so the two cannot share one pytest run):

    python -m pytest tests_gpu -q

`python chip_smoke.py` runs this tier as one of its phases. Every test
takes the `gpu` fixture, which skips the test when JAX finds no GPU; the
check happens inside the fixture, never at import or collection time.
"""

import os
import sys

import numpy as np
import pytest

# the NumPy f64 oracle, tests/reference_impl.py, imported by file location
# (another installed package may own the top-level name `tests`)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))


@pytest.fixture(scope="session")
def gpu():
    """The GPU precision policy with x64 enabled; skips off-GPU."""
    import jax

    from schwingermodel_tpu.utils.cache import enable_compilation_cache
    from schwingermodel_tpu.utils.device import device_policy

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on "
                    f"{jax.default_backend()!r}")
    enable_compilation_cache()
    policy = device_policy()
    jax.config.update("jax_enable_x64", policy.needs_x64)
    return policy


@pytest.fixture
def rng():
    return np.random.default_rng(2024)
