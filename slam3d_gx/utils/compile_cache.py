"""Persistent XLA compile cache, shared by every entry point.

Two rules:
- `JAX_COMPILATION_CACHE_DIR` set: jax reads it itself and this module
  sets nothing;
- otherwise the cache lives at the fixed in-checkout path
  `<repo>/.xla_cache/<backend>_<hash>` (git ignores `.xla_cache/`). The
  hash keys the directory on the backend's platform version — and, for
  the CPU backend, on the host CPU's model and feature flags, because
  an executable compiled for one CPU can fault on another with the same
  jax build — so an entry made elsewhere misses instead of loading.

The minimum compile time is 0 so the small eager-op programs are cached
too: the CLIs run as separate processes and each would otherwise
compile them again.
"""

from __future__ import annotations

import hashlib
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ROOT = os.path.join(REPO_ROOT, ".xla_cache")


def _host_fingerprint() -> str:
    """Machine arch + CPU model name + feature flags (the bits that
    decide which ISA extensions XLA:CPU codegen may emit)."""
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k = line.split(":", 1)[0].strip()
                if k in ("model name", "flags", "Features"):
                    parts.append(line.split(":", 1)[1].strip())
                    if len(parts) >= 3:
                        break
    except OSError:
        parts.append(platform.processor() or "unknown")
    return "|".join(parts)


def default_dir(backend: str, platform_version: str) -> str:
    """The in-checkout cache directory for one backend build."""
    key = platform_version
    if backend == "cpu":
        key += "|" + _host_fingerprint()
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join(CACHE_ROOT, f"{backend}_{digest}")


def enable(jax=None) -> str:
    """Point jax's persistent compile cache at its directory (see the
    module docstring) and return that directory. Call it before the
    first compilation."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if jax is None:
        import jax
    backend = jax.default_backend()
    path = default_dir(backend, jax.devices()[0].client.platform_version)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
