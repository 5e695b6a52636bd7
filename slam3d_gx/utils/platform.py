"""Backend override for the CLI surface.

`SLAM3D_PLATFORM=cpu|gpu` forces the jax backend; unset or empty keeps
jax's own choice. It is applied through the config API
(`jax.config.update("jax_platforms", ...)`) because an environment that
imports jax before user code (a sitecustomize, a test harness) has
already read `JAX_PLATFORMS`; the config API still works as long as it
runs before the first device query, which is why the package applies it
at import.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")


def select_platform(jax=None) -> str | None:
    """Apply SLAM3D_PLATFORM; returns the platform applied, or None when
    it is unset. An unknown value raises ValueError."""
    plat = os.environ.get("SLAM3D_PLATFORM", "").strip().lower()
    if not plat:
        return None
    if plat not in PLATFORMS:
        raise ValueError(
            f"SLAM3D_PLATFORM={plat!r}: expected one of {PLATFORMS}")
    if jax is None:
        import jax
    jax.config.update("jax_platforms", plat)
    return plat
