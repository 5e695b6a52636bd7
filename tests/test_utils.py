"""Tests for the debug-check and profiling aux subsystems."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from slam3d_gx.utils import debug, profiling


def test_checked_catches_nan():
    def f(x):
        return jnp.log(x)  # NaN for negative input

    err, out = debug.checked(f)(jnp.asarray([-1.0]))
    with pytest.raises(Exception):
        err.throw()


def test_checked_passes_clean():
    def f(x):
        return x * 2.0

    err, out = debug.checked(f)(jnp.asarray([1.0, 2.0]))
    err.throw()  # no error
    np.testing.assert_allclose(np.asarray(out), [2.0, 4.0])


def test_strict_raises():
    def f(x):
        return jnp.sqrt(x)

    with pytest.raises(Exception):
        debug.strict(f)(jnp.asarray([-4.0]))


def test_strict_on_pipeline_op():
    """Sanity: a real kernel (matcher) runs clean under strict checks."""
    from slam3d_gx.ops import match

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))
    v = jnp.ones(32, bool)
    out = debug.strict(lambda x: match.match_nn(x, v, x, v)[1])(a)
    assert np.isfinite(np.asarray(out)).all()


def test_stage_timer_schema(tmp_path):
    log = str(tmp_path / "time.log")
    t = profiling.StageTimer(log)
    with t.stage("ExtractPlane"):
        _ = sum(range(1000))
    t.start("RANSAC")
    t.stop(sync_array=jnp.ones(4))
    t.write()
    rows = open(log).read().strip().splitlines()
    assert len(rows) == 2
    name, secs = rows[0].split()
    assert name == "ExtractPlane" and float(secs) >= 0


def test_trace_noop_or_works(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        _ = jnp.ones(8) * 2
    assert d  # context manager yielded a directory either way


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable() returns it and sets
    nothing in code."""
    import jax

    from slam3d_gx.utils import compile_cache

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable(jax) == str(tmp_path)
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


def test_compile_cache_default_is_fixed_and_in_checkout():
    from slam3d_gx.utils import compile_cache

    a = compile_cache.default_dir("gpu", "cuda 12.8")
    assert a == compile_cache.default_dir("gpu", "cuda 12.8")
    assert a != compile_cache.default_dir("gpu", "cuda 12.9")
    assert os.path.dirname(a) == os.path.join(compile_cache.REPO_ROOT,
                                              ".xla_cache")
    assert os.path.basename(a).startswith("gpu_")
    # git ignores every entry, whatever the backend
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()


@pytest.mark.parametrize("value", ["rocm", "cuda", "gpu0"])
def test_platform_override_rejects_unknown(monkeypatch, value):
    from slam3d_gx.utils import platform

    monkeypatch.setenv("SLAM3D_PLATFORM", value)
    with pytest.raises(ValueError, match="SLAM3D_PLATFORM"):
        platform.select_platform()


def test_platform_override_unset_is_noop(monkeypatch):
    from slam3d_gx.utils import platform

    monkeypatch.delenv("SLAM3D_PLATFORM", raising=False)
    assert platform.select_platform() is None
