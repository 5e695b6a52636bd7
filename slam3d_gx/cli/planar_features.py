"""planarFeatures: classify FAST keypoints as planar via micro plane RANSAC.

Parity target: reference src/planarFeatures.cpp:26-136 — FAST keypoints on
the rgb image, drop zero-depth ones, take the 7x7 depth patch around each,
backproject, fit a plane with RANSAC (0.01 m threshold), call the keypoint
planar iff > 40 of the 49 patch points are inliers (isPlanar, lines 88-136).
Headless variant: prints the verdicts and writes a visualization PNG
(planar keypoints bright squares, non-planar dark).

All keypoints' 7x7 patches are gathered at once and the micro
RANSACs run as one vmapped batch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ParameterReader
from ..io import images
from ..ops import plane_ransac
from ..ops.features import fast


def classify_planar(
    gray, depth, intr, max_kp: int = 256, patch: int = 7,
    dist_thresh: float = 0.01, min_inliers: int = 40, seed: int = 0,
):
    """Returns (Keypoints, planar (K,) bool)."""
    kps = fast.detect_fast(jnp.asarray(gray), threshold=20.0, max_kp=max_kp)
    depth_j = jnp.asarray(depth)
    H, W = depth.shape
    r = patch // 2

    u0 = jnp.clip(jnp.round(kps.uv[:, 0]).astype(jnp.int32), r, W - 1 - r)
    v0 = jnp.clip(jnp.round(kps.uv[:, 1]).astype(jnp.int32), r, H - 1 - r)
    du, dv = jnp.meshgrid(jnp.arange(-r, r + 1), jnp.arange(-r, r + 1))
    uu = u0[:, None] + du.reshape(-1)[None, :]  # (K,49)
    vv = v0[:, None] + dv.reshape(-1)[None, :]
    d = depth_j[vv, uu].astype(jnp.float32)
    z = d / intr.factor
    x = (uu.astype(jnp.float32) - intr.cx) * z / intr.fx
    y = (vv.astype(jnp.float32) - intr.cy) * z / intr.fy
    pts = jnp.stack([x, y, z], -1)  # (K,49,3)
    valid = d > 0

    center_d = depth_j[v0, u0]
    kps = kps._replace(valid=kps.valid & (center_d > 0))

    keys = jax.random.split(jax.random.PRNGKey(seed), kps.capacity)

    def one(p, m, k):
        coeff, inl, cnt = plane_ransac.fit_plane(p, m, k, dist_thresh=dist_thresh)
        return cnt

    counts = jax.vmap(one)(pts, valid, keys)
    planar = kps.valid & (counts > min_inliers)
    return kps, planar


def main(argv=None) -> int:
    from ..utils import compile_cache

    compile_cache.enable()
    argv = list(sys.argv[1:] if argv is None else argv)
    rgb_path = argv[0] if len(argv) > 0 else "./rgb_1.png"
    dep_path = argv[1] if len(argv) > 1 else "./dep_1.png"
    params = ParameterReader("./parameters.yaml") if os.path.exists("./parameters.yaml") else ParameterReader(None)
    intr = params.intrinsics

    gray = images.load_gray(rgb_path)
    depth = images.load_depth(dep_path)
    kps, planar = classify_planar(gray, depth, intr)

    uv = np.asarray(kps.uv)
    val = np.asarray(kps.valid)
    pl = np.asarray(planar)
    print(f"keypoints: {val.sum()}, planar: {pl.sum()}")

    vis = np.stack([gray] * 3, -1)
    for i in range(len(uv)):
        if not val[i]:
            continue
        u, v = int(uv[i, 0]), int(uv[i, 1])
        color = (0, 255, 0) if pl[i] else (255, 0, 0)
        vis[max(v - 2, 0) : v + 3, max(u - 2, 0) : u + 3] = color
    images.save_color("planar_features.png", vis)
    print("visualization saved to planar_features.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
