#!/usr/bin/env python3
"""Bulk pairwise-registration experiment sweep.

Parity target: reference exp1_2.py:14-27 — 100 random anchor frames x
offsets 1..19, each pair registered with the planar ('p') and normal
('n') pipelines, errors appended to data/exp1/error.log by the exp1_2
binary.

Default: pairs run in-process (one Python VM, jit caches
reused across pairs — the reference's one-process-per-pair layout would
recompile the pipeline hundreds of times). `--subprocess` restores the
reference's process-per-pair behavior.

Usage: exp1_2.py [--anchors N] [--offsets K] [--detector D]
                 [--descriptor S] [--modes pn] [--subprocess] [--seed S]
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def count_frames(data_source: str) -> int:
    with open(os.path.join(data_source, "associate.txt")) as f:
        return sum(1 for line in f if line.strip())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--anchors", type=int, default=100)
    p.add_argument("--offsets", type=int, default=19)
    p.add_argument("--detector", default="GFTT")
    p.add_argument("--descriptor", default="SIFT")
    p.add_argument("--modes", default="pn",
                   help="p=planar, n=normal, pn=both (reference sweeps both)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--subprocess", action="store_true",
                   help="one process per pair (reference layout)")
    args = p.parse_args(argv)

    from slam3d_gx.config import ParameterReader

    params = ParameterReader("./parameters.yaml")
    n_frames = count_frames(params.GetPara("data_source"))
    rng = random.Random(args.seed)

    pairs = []
    for _ in range(args.anchors):
        a = rng.randrange(1, max(2, n_frames - args.offsets))
        for off in range(1, args.offsets + 1):
            if a + off <= n_frames:
                pairs.append((a, a + off))

    if args.subprocess:
        binary = os.path.join(_REPO, "bin", "exp1_2")
        for a, b in pairs:
            for mode in args.modes:
                subprocess.run(
                    [binary, str(a), str(b), args.detector, args.descriptor, mode],
                    check=False,
                )
    else:
        from slam3d_gx.cli import exp1_2 as exp_cli
        for i, (a, b) in enumerate(pairs):
            for mode in args.modes:
                rc = exp_cli.main([str(a), str(b), args.detector,
                                   args.descriptor, mode])
                if rc != 0:
                    print(f"pair {a},{b} mode {mode} failed rc={rc}",
                          file=sys.stderr)
            if (i + 1) % 20 == 0:
                print(f"{i + 1}/{len(pairs)} pairs done", flush=True)
    print(f"swept {len(pairs)} pairs -> data/exp1/error.log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
