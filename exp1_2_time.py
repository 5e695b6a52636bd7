#!/usr/bin/env python3
"""Stage-timing sweep over the detector zoo.

Parity target: reference exp1_2_time.py:14-37 — runs the planar
experiment for each detector (GridFAST/SIFT/STAR/ORB/GFTT/SURF in the
reference; this framework's registry set here) so data/time.log
accumulates `stage seconds` rows per detector.

Usage: exp1_2_time.py [--pairs N] [--detectors A,B,...]
"""

from __future__ import annotations

import argparse
import os
import random
import sys

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

DEFAULT_DETECTORS = "GFTT,FAST,HARRIS,SIFT"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--detectors", default=DEFAULT_DETECTORS)
    p.add_argument("--descriptor", default="SIFT")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from slam3d_gx.cli import exp1_2 as exp_cli
    from slam3d_gx.config import ParameterReader

    params = ParameterReader("./parameters.yaml")
    with open(os.path.join(params.GetPara("data_source"), "associate.txt")) as f:
        n_frames = sum(1 for line in f if line.strip())
    rng = random.Random(args.seed)

    os.makedirs("./data", exist_ok=True)
    for det in args.detectors.split(","):
        with open("./data/time.log", "a") as f:
            f.write(f"# detector {det}\n")
        for _ in range(args.pairs):
            a = rng.randrange(1, n_frames)
            b = min(a + rng.randrange(1, 5), n_frames)
            rc = exp_cli.main([str(a), str(b), det, args.descriptor, "p"])
            if rc != 0:
                print(f"{det} pair {a},{b} failed rc={rc}", file=sys.stderr)
        print(f"{det}: {args.pairs} pairs timed", flush=True)
    print("timing rows -> data/time.log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
