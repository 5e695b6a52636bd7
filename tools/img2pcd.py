#!/usr/bin/env python3
"""Backproject indexed rgb+depth pairs to pcd/N.pcd point clouds.

Parity target: reference tools/img2pcd.py:52-109 (which goes through an
intermediate PLY + pcl_ply2pcd) and src/convert2PCD.cpp:45-81. This
implementation writes binary PCD directly with the framework's codec —
no PCL dependency. Intrinsics default to the reference tool's hardcoded
values (fx=fy=525, cx=319.5, cy=235.5, factor=1000,
reference src/convert2PCD.cpp:19-23); override via flags.

Usage: img2pcd.py [root] [--start N] [--end N] [--fx --fy --cx --cy --factor]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from slam3d_gx.io import images, pcd as pcd_io  # noqa: E402


def convert(root: str, start: int, end: int,
            fx: float, fy: float, cx: float, cy: float, factor: float) -> int:
    out_dir = os.path.join(root, "pcd")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i in range(start, end + 1):
        rgb_p = os.path.join(root, "rgb_index", f"{i}.png")
        dep_p = os.path.join(root, "dep_index", f"{i}.png")
        if not (os.path.exists(rgb_p) and os.path.exists(dep_p)):
            break
        gray = images.load_gray(rgb_p)
        depth = images.load_depth(dep_p)
        vv, uu = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
        z = depth.astype(np.float64) / factor
        valid = depth > 0
        x = (uu - cx) * z / fx
        y = (vv - cy) * z / fy
        xyz = np.stack([x[valid], y[valid], z[valid]], -1).astype(np.float32)
        g = gray[valid].astype(np.uint32)
        # rgba packs r<<16|g<<8|b (reference src/convert2PCD.cpp:65)
        rgba = (g << 16) | (g << 8) | g
        pcd_io.write_pcd(os.path.join(out_dir, f"{i}.pcd"), xyz, rgba,
                         binary=True)
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=".")
    p.add_argument("--start", type=int, default=1)
    p.add_argument("--end", type=int, default=10**6)
    p.add_argument("--fx", type=float, default=525.0)
    p.add_argument("--fy", type=float, default=525.0)
    p.add_argument("--cx", type=float, default=319.5)
    p.add_argument("--cy", type=float, default=235.5)
    p.add_argument("--factor", type=float, default=1000.0)
    args = p.parse_args(argv)
    n = convert(args.root, args.start, args.end,
                args.fx, args.fy, args.cx, args.cy, args.factor)
    print(f"wrote {n} pcd files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
