"""run_SLAM [loops]: the main plane-based SLAM entry point.

Parity target: reference src/run_SLAM.cpp:11-44 — construct frontend +
backend, cross-init, run `loops` frames (default 3), print keyframe count,
save ./data/final.g2o (pre-optimization), then saveFinalResult (findMoreLoops
-> optimize -> keyframe.txt + final_after.g2o).
"""

from __future__ import annotations

import os
import sys

from ..backend import SLAMEnd
from ..config import ParameterReader
from ..frontend import GraphicEnd


def run(graphic_end_cls, argv=None):
    """The CLI's body; returns the finished frontend."""
    argv = list(sys.argv[1:] if argv is None else argv)
    loops = int(argv[0]) if argv else 3

    params = ParameterReader("./parameters.yaml")
    ge = graphic_end_cls(params)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)

    for i in range(loops):
        print("***************************")
        print(f"loop {i}")
        ge.run()

    print(f"keyframes: {len(ge.keyframes)}")
    os.makedirs("./data", exist_ok=True)
    # resolve any still-in-flight loop-closure round so final.g2o
    # (pre-optimization checkpoint) carries every edge, like the
    # reference's synchronous loop would
    ge.drain_pending_loop_closures()
    slam.globalOptimizer.save("./data/final.g2o")
    ge.save_final_result("./data/result.pcd")
    return ge


def main(argv=None) -> int:
    from ..utils import compile_cache

    compile_cache.enable()
    run(GraphicEnd, argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
