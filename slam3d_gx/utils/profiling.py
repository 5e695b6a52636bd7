"""Stage timing and device tracing (SURVEY.md §5.1).

The reference instruments its pipeline with gettimeofday pairs writing
`stage seconds` rows to data/time.log (reference
src/exp1/exp1_2.cpp:397-428,466-470). Equivalents here:

- StageTimer: host wall-clock timers emitting the same time.log schema
  (stop() waits for the given device array, since dispatch is
  asynchronous);
- trace(): context manager around jax.profiler for device-level traces
  viewable in TensorBoard/XProf (gated: some backends don't support it).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional



class StageTimer:
    """Accumulates `stage seconds` rows; write() appends to time.log."""

    def __init__(self, path: str = "./data/time.log"):
        self.path = path
        self.rows = []
        self._t0 = None
        self._stage = None

    def start(self, stage: str):
        self._stage = stage
        self._t0 = time.time()

    def stop(self, sync_array=None):
        """Ends the stage; pass a device array (or pytree) to wait for
        its completion first."""
        if sync_array is not None:
            import jax

            jax.block_until_ready(sync_array)
        self.rows.append((self._stage, time.time() - self._t0))
        self._stage = None

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(sync() if callable(sync) else sync)

    def write(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            for stage, secs in self.rows:
                f.write(f"{stage} {secs:g}\n")
        self.rows = []


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace if the backend supports it; no-op otherwise."""
    import jax

    log_dir = log_dir or os.environ.get(
        "SLAM3D_TRACE_DIR", os.path.join(tempfile.gettempdir(), "slam3d_trace"))
    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass
    try:
        yield log_dir
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
