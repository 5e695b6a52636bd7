"""run_SLAM_streaming [loops] [chunk] [planes|imageonly]: chunked
on-device SLAM.

Extension with no reference counterpart: same outputs as run_SLAM /
run_SLAM_imageonly (reference src/run_SLAM*.cpp), but the tracking
state machine runs `chunk` frames per device launch with ONE host
readback per chunk (frontend/streaming.py), so wall-clock throughput
is not capped by a per-frame host-device sync.
Default pipeline: imageonly (the reference's own real-time variant).
"""

from __future__ import annotations

import os
import sys

from ..backend import SLAMEnd
from ..config import ParameterReader
from ..frontend.streaming import StreamingGraphicEnd, StreamingGraphicEnd2


def run(argv=None):
    """The CLI's body; returns the finished frontend."""
    argv = list(sys.argv[1:] if argv is None else argv)
    loops = int(argv[0]) if argv else 3
    chunk = int(argv[1]) if len(argv) > 1 else 8
    pipeline_kind = argv[2] if len(argv) > 2 else "imageonly"

    params = ParameterReader("./parameters.yaml")
    cls = (StreamingGraphicEnd if pipeline_kind == "planes"
           else StreamingGraphicEnd2)
    ge = cls(params, chunk=chunk)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)

    done = ge.run_streaming(loops)
    print(f"processed {done} frames in chunks of {chunk}")

    print(f"keyframes: {len(ge.keyframes)}")
    os.makedirs("./data", exist_ok=True)
    ge.drain_pending_loop_closures()
    slam.globalOptimizer.save("./data/final.g2o")
    ge.save_final_result("./data/result.pcd")
    return ge


def main(argv=None) -> int:
    from ..utils import compile_cache

    compile_cache.enable()
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
