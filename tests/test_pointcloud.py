import os

import jax.numpy as jnp
import numpy as np

from slam3d_gx.io import images, pcd
from slam3d_gx.ops import pointcloud


def test_backproject_matches_reference_fixture(reference_dir):
    """Backprojecting the fixture depth with convert2PCD's hardcoded
    intrinsics (reference src/convert2PCD.cpp:19-23, 525/319.5/235.5/1000)
    reproduces the shipped pcd bytes."""
    dep = images.load_depth(os.path.join(reference_dir, "data/exp1/dep/1.png"))
    xyz, valid = pointcloud.backproject(jnp.asarray(dep), 525.0, 525.0, 319.5, 235.5, 1000.0)
    ours = pointcloud.compact(xyz.reshape(-1, 3), valid.reshape(-1))
    ref_xyz, _ = pcd.read_pcd(os.path.join(reference_dir, "data/exp1/pcd/1.pcd"))
    assert ours.shape == ref_xyz.shape
    np.testing.assert_allclose(ours, ref_xyz, atol=2e-5)


def test_project_backproject_inverse(rng):
    depth = rng.integers(1, 5000, size=(48, 64)).astype(np.uint16)
    fx, fy, cx, cy, factor = 500.0, 510.0, 32.0, 24.0, 1000.0
    xyz, valid = pointcloud.backproject(jnp.asarray(depth), fx, fy, cx, cy, factor)
    uv = np.asarray(pointcloud.project(xyz, fx, fy, cx, cy))
    v, u = np.mgrid[0:48, 0:64]
    np.testing.assert_allclose(uv[..., 0], u, atol=1e-3)
    np.testing.assert_allclose(uv[..., 1], v, atol=1e-3)


def test_passthrough(rng):
    xyz = rng.normal(size=(100, 3)).astype(np.float32) * 5
    mask = np.ones(100, bool)
    out = np.asarray(pointcloud.passthrough_z(jnp.asarray(xyz), jnp.asarray(mask), 0.0, 7.0))
    expect = (xyz[:, 2] > 0) & (xyz[:, 2] <= 7.0)
    np.testing.assert_array_equal(out, expect)


def test_transform_points(rng):
    from slam3d_gx.geometry import se3
    from scipy.spatial.transform import Rotation

    R = Rotation.random(random_state=np.random.RandomState(3)).as_matrix()
    T = se3.make_isometry(R, [1.0, -2.0, 0.5])
    pts = rng.normal(size=(50, 3))
    ours = np.asarray(pointcloud.transform_points(jnp.asarray(T, dtype=jnp.float32), jnp.asarray(pts, dtype=jnp.float32)))
    np.testing.assert_allclose(ours, se3.transform_points(T, pts), atol=1e-5)


def _voxel_oracle(xyz, rgb, leaf):
    """numpy oracle: centroid per voxel, sorted by (ix,iy,iz) id."""
    ijk = np.floor(xyz / leaf).astype(np.int64)
    ijk -= ijk.min(axis=0)
    span = ijk.max(axis=0) + 1
    ids = ijk[:, 0] * span[1] * span[2] + ijk[:, 1] * span[2] + ijk[:, 2]
    out_xyz, out_rgb = [], []
    for uid in np.unique(ids):
        sel = ids == uid
        out_xyz.append(xyz[sel].mean(axis=0))
        out_rgb.append(rgb[sel].mean(axis=0))
    return np.array(out_xyz), np.array(out_rgb)


def test_voxel_downsample(rng):
    xyz = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    vx, vc, vm = pointcloud.voxel_downsample(
        jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask), 0.25
    )
    got_xyz, got_rgb = pointcloud.compact(vx, vm, vc)
    exp_xyz, exp_rgb = _voxel_oracle(xyz, rgb, 0.25)
    assert got_xyz.shape == exp_xyz.shape
    np.testing.assert_allclose(got_xyz, exp_xyz, atol=1e-4)
    np.testing.assert_allclose(got_rgb, exp_rgb, atol=1e-2)


def test_voxel_downsample_respects_mask(rng):
    xyz = rng.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    rgb = np.zeros((100, 3), np.float32)
    mask = np.zeros(100, bool)
    mask[:10] = True
    vx, vc, vm = pointcloud.voxel_downsample(
        jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask), 0.05
    )
    got = pointcloud.compact(vx, vm)
    exp_xyz, _ = _voxel_oracle(xyz[:10], rgb[:10], 0.05)
    assert got.shape == exp_xyz.shape
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(exp_xyz, axis=0), atol=1e-4)


def test_voxel_downsample_host_matches_device(rng):
    """saveOutput fuses with the numpy twin (cli/save_output.py); the
    two implementations must agree voxel-for-voxel in emit order."""
    xyz = rng.uniform(-2, 2, size=(3000, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, size=(3000, 3)).astype(np.float32)
    mask = rng.uniform(size=3000) < 0.8
    vx, vc, vm = pointcloud.voxel_downsample(
        jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask), 0.1
    )
    dev_xyz, dev_rgb = pointcloud.compact(vx, vm, vc)
    host_xyz, host_rgb = pointcloud.voxel_downsample_host(xyz, rgb, mask, 0.1)
    assert host_xyz.shape == dev_xyz.shape
    np.testing.assert_allclose(host_xyz, dev_xyz, atol=1e-4)
    np.testing.assert_allclose(host_rgb, dev_rgb, atol=1e-2)


def test_voxel_downsample_host_empty():
    out_xyz, out_rgb = pointcloud.voxel_downsample_host(
        np.zeros((10, 3), np.float32), np.zeros((10, 3), np.float32),
        np.zeros(10, bool), 0.1)
    assert out_xyz.shape == (0, 3) and out_rgb.shape == (0, 3)
