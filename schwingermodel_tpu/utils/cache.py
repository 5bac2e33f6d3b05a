"""Persistent XLA compilation cache.

Compiling the HMC trajectory program takes tens of seconds; with the
persistent cache a later process with the same program loads it instead.
Called by the CLI, the benches and the test configuration before any jit
executes.

Where the cache lives:
  - `JAX_COMPILATION_CACHE_DIR`, exactly, when it is set;
  - otherwise a fixed directory inside the checkout, `<repo>/.jax_cache`
    (listed in .gitignore). XLA:CPU artifacts go one level further down,
    into a subdirectory keyed by the host CPU (see _host_key).
"""

from __future__ import annotations

import hashlib
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def _host_key() -> str:
    """Subdirectory key tied to this host's CPU capabilities.

    XLA:CPU AOT artifacts embed the compile machine's feature set (AVX512
    variants etc.); loading one on a host missing a feature risks SIGILL
    (cpu_aot_loader warns exactly this). Keying the directory by the CPU
    model + flags keeps caches from different machines separate."""
    try:
        with open("/proc/cpuinfo") as f:
            txt = f.read()
        lines = [ln for ln in txt.splitlines()
                 if ln.startswith(("model name", "flags"))]
        sig = lines[0] + (lines[1] if len(lines) > 1 else "")
    except (OSError, IndexError):
        import platform

        sig = platform.processor() or platform.machine()
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


def cache_dir(platforms: str | None = None) -> str:
    """The compilation-cache directory for a process whose JAX platform
    list is `platforms` (jax_platforms, e.g. "cpu"; None or "" = JAX's
    default choice)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if platforms == "cpu":
        return os.path.join(REPO_CACHE, "cpu-" + _host_key())
    return REPO_CACHE


def enable_compilation_cache() -> str:
    """Point JAX's persistent cache at cache_dir(); returns the directory.
    Does not initialize a backend (multi-process runs must still be able to
    call jax.distributed.initialize afterwards)."""
    import jax

    path = cache_dir(jax.config.jax_platforms)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
