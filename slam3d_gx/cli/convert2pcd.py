"""convert2PCD: batch depth+rgb -> pcd/N.pcd backprojection.

Parity target: reference src/convert2PCD.cpp:31-84 —
- hardcoded default intrinsics 525/525/319.5/235.5, factor 1000
  (src/convert2PCD.cpp:19-23; the SLAM core uses the yaml intrinsics
  instead — keep both behaviors);
- reads ./rgb_index/N.png (color) and ./dep_index/N.png (16-bit),
  writes ./pcd/N.pcd for N in [start, end);
- skips zero-depth pixels; packs rgba = r<<16 | g<<8 | b (line 65);
- savePCDFile default => ASCII data.

The pinhole backprojection runs as one jitted kernel per frame
(ops/pointcloud.backproject); host does decode + compaction + PCD encode.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np

from ..io import images, pcd
from ..ops import pointcloud


def convert_one(
    rgb_path: str,
    dep_path: str,
    out_path: str,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 319.5,
    cy: float = 235.5,
    factor: float = 1000.0,
    binary: bool = False,
) -> int:
    rgb = images.load_color(rgb_path)
    dep = images.load_depth(dep_path)
    xyz, valid = pointcloud.backproject(jnp.asarray(dep), fx, fy, cx, cy, factor)
    xyz_h, rgb_h = pointcloud.compact(
        np.asarray(xyz).reshape(-1, 3), valid.reshape(-1), rgb.reshape(-1, 3)
    )
    rgba = pcd.pack_rgba(rgb_h[:, 0], rgb_h[:, 1], rgb_h[:, 2])
    pcd.write_pcd(out_path, xyz_h, rgba, binary=binary)
    return xyz_h.shape[0]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("Usage: convert2pcd start_index end_index")
        return -1
    start, end = int(argv[0]), int(argv[1])
    os.makedirs("./pcd", exist_ok=True)
    for i in range(start, end):
        n = convert_one(
            f"./rgb_index/{i}.png", f"./dep_index/{i}.png", f"./pcd/{i}.pcd"
        )
        print(f"{i} of {end - start} files ok. ({n} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
