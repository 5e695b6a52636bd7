"""Point-cloud kernels: backprojection, passthrough, voxel grid, transform.

Replacements for the PCL surface the reference consumes
(SURVEY.md §2.2):
- pinhole backprojection (convert2PCD / img2pcd semantics,
  reference src/convert2PCD.cpp:53-70);
- PassThrough z-filter (reference src/GraphicEnd.cpp:283-293) as an
  elementwise mask;
- VoxelGrid downsample (reference src/GraphicEnd.cpp:287-295,
  src/saveOutput.cpp:35-37) via voxel-id sort + segment means over
  fixed-capacity padded arrays (no compaction — masks thread through);
- transformPointCloud (reference src/saveOutput.cpp:87) as one einsum.

All functions are jit-safe: static shapes, masks for validity. Invalid
slots carry zeros and mask=False.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# backprojection
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("flip_uv",))
def backproject(depth_raw, fx, fy, cx, cy, factor, flip_uv=False):
    """Raw uint16 depth (H,W) -> xyz (H,W,3) float32 + valid (H,W) bool.

    z = d/factor; x = (u-cx) z/fx; y = (v-cy) z/fy with u=col, v=row
    (reference src/convert2PCD.cpp:66-70). d==0 marks invalid.
    """
    depth = depth_raw.astype(jnp.float32)
    H, W = depth.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    z = depth / factor
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    xyz = jnp.stack([x, y, z], axis=-1)
    valid = depth_raw > 0
    return xyz, valid


@jax.jit
def project(xyz, fx, fy, cx, cy):
    """(…,3) camera-frame points -> (…,2) pixel coords (u,v)."""
    z = xyz[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = xyz[..., 0] * fx / safe_z + cx
    v = xyz[..., 1] * fy / safe_z + cy
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


@jax.jit
def passthrough_z(xyz, mask, z_min, z_max):
    """PCL PassThrough on z: keep z_min < z <= z_max (open lower bound
    matches PCL's default limit behavior with (0, z_filter))."""
    z = xyz[..., 2]
    return mask & (z >= z_min) & (z <= z_max) & (z > 0)


@jax.jit
def transform_points(T, xyz):
    """(4,4) @ (…,3): points @ R^T + t."""
    return xyz @ T[:3, :3].T + T[:3, 3]


# ---------------------------------------------------------------------------
# voxel grid
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(xyz, rgb, mask, leaf, capacity=None):
    """VoxelGrid downsample: per-voxel centroid of position and color.

    Args:
      xyz: (N,3) float32; rgb: (N,3) float32 (pass zeros if uncolored);
      mask: (N,) bool; leaf: scalar voxel edge.
    Returns:
      (C,3) xyz, (C,3) rgb, (C,) bool mask with C=capacity (default N).
      Valid voxels are packed to the front, ordered by voxel id (PCL's
      sorted-leaf order). The centroid includes color, matching PCL's
      downsample_all_data default.
    """
    N = xyz.shape[0]
    C = capacity or N

    inv_leaf = 1.0 / leaf
    ijk = jnp.floor(xyz * inv_leaf).astype(jnp.int32)
    # shift to non-negative using masked minima so ids order like PCL's
    lo = jnp.min(jnp.where(mask[:, None], ijk, jnp.iinfo(jnp.int32).max), axis=0)
    ijk = ijk - lo
    # int32 linear ids: span per axis stays < ~1200 for SLAM-scale clouds
    # (z-filtered Kinect frames, leaf >= 0.01), so span products fit easily
    span = jnp.max(jnp.where(mask[:, None], ijk, -1), axis=0) + 1
    ids = ijk[:, 0] * (span[1] * span[2]) + ijk[:, 1] * span[2] + ijk[:, 2]
    BIG = jnp.int32(jnp.iinfo(jnp.int32).max)
    ids = jnp.where(mask, ids, BIG)

    order = jnp.argsort(ids)
    ids_s = ids[order]
    xyz_s = xyz[order]
    rgb_s = rgb[order]
    valid_s = ids_s != BIG

    is_start = jnp.concatenate([jnp.ones(1, bool), ids_s[1:] != ids_s[:-1]]) & valid_s
    seg = jnp.cumsum(is_start.astype(jnp.int32)) - 1  # segment index per point
    seg = jnp.where(valid_s, seg, C)  # park invalid in overflow bucket

    ones = valid_s.astype(jnp.float32)
    cnt = jax.ops.segment_sum(ones, seg, num_segments=C + 1)[:C]
    sum_xyz = jax.ops.segment_sum(xyz_s * ones[:, None], seg, num_segments=C + 1)[:C]
    sum_rgb = jax.ops.segment_sum(rgb_s * ones[:, None], seg, num_segments=C + 1)[:C]

    out_mask = cnt > 0
    denom = jnp.where(out_mask, cnt, 1.0)[:, None]
    return sum_xyz / denom, sum_rgb / denom, out_mask


def voxel_downsample_host(xyz, rgb, mask, leaf):
    """Numpy twin of voxel_downsample for host-side offline tools.

    Same semantics (per-voxel centroid of position and color, voxels
    emitted in sorted-leaf order, f32 accumulation) without the device
    round-trip: saveOutput fuses one ~300k-point cloud per keyframe,
    read from disk on the host. Returns packed ((V,3) xyz, (V,3) rgb) — no padding or
    mask, V = number of occupied voxels.
    """
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    m = np.asarray(mask, bool)
    pts, col = xyz[m], rgb[m]
    if pts.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    inv_leaf = np.float32(1.0) / np.float32(leaf)
    ijk = np.floor(pts * inv_leaf).astype(np.int32)
    ijk -= ijk.min(axis=0)
    span = ijk.max(axis=0) + 1
    ids = ijk[:, 0] * (span[1] * span[2]) + ijk[:, 1] * span[2] + ijk[:, 2]
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    starts = np.flatnonzero(
        np.concatenate([[True], ids_s[1:] != ids_s[:-1]]))
    cnt = np.diff(np.concatenate([starts, [ids_s.size]]))
    sum_xyz = np.add.reduceat(pts[order], starts, axis=0)
    sum_rgb = np.add.reduceat(col[order], starts, axis=0)
    denom = cnt.astype(np.float32)[:, None]
    return sum_xyz / denom, sum_rgb / denom


def compact(xyz, mask, *extras):
    """Host helper: drop masked-out rows (device arrays -> numpy)."""
    import numpy as np

    m = np.asarray(mask)
    outs = [np.asarray(xyz)[m]]
    outs.extend(np.asarray(e)[m] for e in extras)
    return outs[0] if not extras else tuple(outs)


def estimate_depth_scale(xyz, depth, fx, fy, cx, cy, factor,
                         stride: int = 8, min_samples: int = 100):
    """Host helper: median ratio between a PCD cloud's z and the depth
    image's z at the pixels the cloud points project to.

    The reference's dataset tools disagree on the depth factor —
    convert2PCD hardcodes 1000 (src/convert2PCD.cpp:19-23) while the
    active fr1 yaml preset uses 5000 — and the reference silently mixes
    the two unit systems (its plane-image splat is projectively
    invariant, so it never notices; compute3dPosition's plane-ray
    fallback at src/GraphicEnd.cpp:440-450 does mix them). Returns the
    scale s with cloud_z ~ s * depth_z, or 1.0 when there aren't enough
    co-visible samples to tell.
    """
    import numpy as np

    xyz = np.asarray(xyz)[::stride]
    depth = np.asarray(depth)
    H, W = depth.shape
    z = xyz[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    u = np.round(xyz[:, 0] * fx / zs + cx).astype(int)
    v = np.round(xyz[:, 1] * fy / zs + cy).astype(int)
    inb = ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    if inb.sum() < min_samples:
        return 1.0
    zd = depth[v[inb], u[inb]].astype(np.float64) / factor
    zc = z[inb]
    sel = zd > 1e-6
    if sel.sum() < min_samples:
        return 1.0
    return float(np.median(zc[sel] / zd[sel]))
