"""Contract tests for __graft_entry__.

dryrun_multichip must pass *regardless* of the calling process's JAX
platform state: it once failed because the dryrun attached to the
process's accelerator. The fix runs the dryrun body in a spawned
subprocess that forces the CPU platform before any device use; this
test exercises the public wrapper exactly as the driver does.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_dryrun_multichip_contract():
    import __graft_entry__ as g

    g.dryrun_multichip(8)  # raises on any failure


def test_dryrun_subprocess_forces_cpu(monkeypatch):
    """The wrapper must strip any stale device-count flag and force CPU
    even when the caller's env points at another platform."""
    import __graft_entry__ as g

    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    g.dryrun_multichip(4)


def test_entry_shape_contract():
    """entry() returns (jittable fn, example args) and the fn traces."""
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    # trace only (driver compile-checks on hardware); CPU lowering here
    lowered = jax.jit(fn).lower(*args)
    assert lowered is not None
