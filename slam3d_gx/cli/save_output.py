"""saveOutput keyframe.txt final.g2o [pass_z]: global map fusion.

Parity target: reference src/saveOutput.cpp:18-98 — per keyframe row
(id, frame): load pcd/frame.pcd, voxel-grid filter, z passthrough
(0..pass_z, default 5.0), transform by the optimized vertex estimate,
accumulate; final voxel filter -> result.pcd (ASCII, savePCDFile default).

Fusion runs on HOST numpy (pointcloud.voxel_downsample_host, the numpy
twin of the jitted kernel with identical centroid/ordering semantics):
the workload is one ~300k-point cloud per keyframe, read from disk on
the host, so a device round-trip per keyframe would only add transfers.
Equivalence of the two implementations is asserted in
tests/test_pointcloud.py.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..backend import PoseGraphOptimizer
from ..config import ParameterReader
from ..io import pcd as pcd_io, tum
from ..ops import pointcloud


def fuse_map(
    keyframe_path: str,
    g2o_path: str,
    pass_z: float = 5.0,
    params: ParameterReader | None = None,
    out_path: str = "result.pcd",
) -> int:
    params = params or ParameterReader("./parameters.yaml")
    grid_leaf = params.get_float("grid_leaf")
    _, _, pcl_path = tum.dataset_paths(params.GetPara("data_source"))

    opt = PoseGraphOptimizer()
    opt.load(g2o_path)

    out_xyz = []
    out_rgb = []
    for kid, frame in tum.read_keyframes(keyframe_path):
        if kid not in opt.graph.vertices:
            print(f"cannot find vertex: {kid}")
            continue
        path = os.path.join(pcl_path, f"{frame}.pcd")
        print(f"loading {path}")
        xyz, rgba = pcd_io.read_pcd(path)
        r, g, b = pcd_io.unpack_rgba(rgba)
        rgb = np.stack([r, g, b], -1).astype(np.float32)

        vx, vc = pointcloud.voxel_downsample_host(
            xyz, rgb, np.ones(xyz.shape[0], bool), grid_leaf)
        z = vx[:, 2]
        keep = (z >= 0.0) & (z <= pass_z) & (z > 0)  # passthrough_z
        vx, vc = vx[keep], vc[keep]
        pos = np.asarray(opt.vertex_estimate(kid), np.float32)
        vx = vx @ pos[:3, :3].T + pos[:3, 3]  # transform_points
        out_xyz.append(vx)
        out_rgb.append(vc)

    if not out_xyz:
        print("no keyframes fused")
        return -1
    all_xyz = np.concatenate(out_xyz)
    all_rgb = np.concatenate(out_rgb)
    # final voxel filter over the fused map
    xyz_h, rgb_h = pointcloud.voxel_downsample_host(
        all_xyz, all_rgb, np.ones(all_xyz.shape[0], bool), grid_leaf)
    rgb_u8 = np.clip(np.round(rgb_h), 0, 255).astype(np.uint8)
    rgba = pcd_io.pack_rgba(rgb_u8[:, 0], rgb_u8[:, 1], rgb_u8[:, 2])
    pcd_io.write_pcd(out_path, xyz_h, rgba, binary=False)
    print("final result saved.")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("saveOutput keyframe.txt final.g2o [ pass_z ]")
        return -1
    pass_z = float(argv[2]) if len(argv) >= 3 else 5.0
    return fuse_map(argv[0], argv[1], pass_z)


if __name__ == "__main__":
    raise SystemExit(main())
