"""run_SLAM_imageonly [loops]: image-only SLAM (GraphicEnd2).

Parity target: reference src/run_SLAM_imageonly.cpp (identical skeleton to
run_SLAM with the GraphicEnd2 frontend at line 21).
"""

from __future__ import annotations

from ..frontend import GraphicEnd2
from .run_slam import run


def main(argv=None) -> int:
    from ..utils import compile_cache

    compile_cache.enable()
    run(GraphicEnd2, argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
