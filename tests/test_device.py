"""The device policy (utils/device.py) and the compile-cache location
(utils/cache.py): one answer to "which device is this?", and a cache that
lives exactly where JAX_COMPILATION_CACHE_DIR says, else inside the
checkout."""

import os

import jax
import pytest

from schwingermodel_tpu.utils import cache
from schwingermodel_tpu.utils.device import DevicePolicy, device_policy


@pytest.mark.parametrize("platform,dtype,refine,needs_x64", [
    ("gpu", "float32", True, True),
    ("cpu", "float64", False, True),
])
def test_policy_per_platform(platform, dtype, refine, needs_x64):
    """gpu: f32 working precision with the x64 true-residual refinement;
    cpu: f64 throughout."""
    p = device_policy(platform)
    assert p == DevicePolicy(platform, dtype, refine, "x64")
    assert p.needs_x64 is needs_x64


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_policy_rejects_other_platforms(platform):
    """Any other platform is an error, never a default."""
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        device_policy(platform)


def test_policy_defaults_to_the_running_backend():
    assert device_policy() == device_policy(jax.default_backend())
    assert device_policy().platform == "cpu"      # conftest pins the CPU


def test_policy_x64_only_where_needed():
    """A float32 policy without the x64 impl would not need x64."""
    assert not DevicePolicy("gpu", "float32", True, "dfloat").needs_x64
    assert not DevicePolicy("gpu", "float32", False, "x64").needs_x64


def test_cache_dir_is_env_var_exactly(monkeypatch, tmp_path):
    want = str(tmp_path / "some" / "cache")
    monkeypatch.setenv(cache.ENV_VAR, want)
    assert cache.cache_dir("cpu") == want
    assert cache.cache_dir(None) == want


@pytest.mark.parametrize("platforms,sub", [
    (None, False), ("", False), ("cuda", False), ("cpu", True)])
def test_cache_dir_unset_is_inside_checkout(monkeypatch, platforms, sub):
    """Unset: the fixed <repo>/.jax_cache; XLA:CPU artifacts one level down
    in a per-CPU-signature subdirectory."""
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.join(repo, ".jax_cache")
    d = cache.cache_dir(platforms)
    if sub:
        assert os.path.dirname(d) == base
        assert os.path.basename(d).startswith("cpu-")
    else:
        assert d == base


def test_enable_sets_no_other_directory(monkeypatch, tmp_path):
    """enable_compilation_cache() points JAX at the env var's directory and
    creates nothing else (no ~/.cache, nothing under HOME)."""
    home = tmp_path / "home"
    home.mkdir()
    want = tmp_path / "jcache"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv(cache.ENV_VAR, str(want))
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cache.enable_compilation_cache()
        assert got == str(want)
        assert jax.config.jax_compilation_cache_dir == str(want)
        assert want.is_dir()
        assert list(home.iterdir()) == []
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
