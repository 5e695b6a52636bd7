import os

import numpy as np
import pytest

from slam3d_gx.io import pcd


def test_read_reference_binary_fixture(reference_dir):
    path = os.path.join(reference_dir, "data/exp1/pcd/1.pcd")
    xyz, rgba = pcd.read_pcd(path)
    assert xyz.shape == (221202, 3)
    assert rgba.shape == (221202,)
    # first point from the raw bytes
    np.testing.assert_allclose(xyz[0], [-1.466697, -0.972251, 2.496], atol=1e-6)
    assert rgba[0] == 2700661
    assert xyz.dtype == np.float32


def test_roundtrip_binary(tmp_path, rng):
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    rgba = rng.integers(0, 2**24, size=100).astype(np.uint32)
    p = str(tmp_path / "t.pcd")
    pcd.write_pcd(p, xyz, rgba, binary=True)
    xyz2, rgba2 = pcd.read_pcd(p)
    np.testing.assert_array_equal(xyz, xyz2)
    np.testing.assert_array_equal(rgba, rgba2)


def test_roundtrip_ascii(tmp_path, rng):
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgba = rng.integers(0, 2**24, size=50).astype(np.uint32)
    p = str(tmp_path / "t.pcd")
    pcd.write_pcd(p, xyz, rgba, binary=False)
    xyz2, rgba2 = pcd.read_pcd(p)
    np.testing.assert_allclose(xyz, xyz2, rtol=1e-6)
    np.testing.assert_array_equal(rgba, rgba2)


def test_header_matches_pcl_layout(tmp_path):
    p = str(tmp_path / "t.pcd")
    pcd.write_pcd(p, np.zeros((3, 3), np.float32), np.zeros(3, np.uint32), binary=True)
    with open(p, "rb") as f:
        header = f.read().split(b"DATA binary\n")[0].decode()
    assert "FIELDS x y z rgba" in header
    assert "SIZE 4 4 4 4" in header
    assert "TYPE F F F U" in header
    assert "WIDTH 3" in header
    assert "POINTS 3" in header
    assert "VIEWPOINT 0 0 0 1 0 0 0" in header


def test_binary_is_packed_16_bytes(tmp_path):
    p = str(tmp_path / "t.pcd")
    n = 7
    pcd.write_pcd(p, np.zeros((n, 3), np.float32), np.zeros(n, np.uint32), binary=True)
    with open(p, "rb") as f:
        raw = f.read()
    body = raw.split(b"DATA binary\n", 1)[1]
    assert len(body) == n * 16


def test_pack_unpack_rgba():
    r = np.array([255, 1], np.uint8)
    g = np.array([0, 2], np.uint8)
    b = np.array([7, 3], np.uint8)
    packed = pcd.pack_rgba(r, g, b)
    assert packed[0] == (255 << 16) | 7
    r2, g2, b2 = pcd.unpack_rgba(packed)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(g, g2)
    np.testing.assert_array_equal(b, b2)


def test_xyz_only(tmp_path, rng):
    xyz = rng.normal(size=(10, 3)).astype(np.float32)
    p = str(tmp_path / "t.pcd")
    pcd.write_pcd(p, xyz, None, binary=True)
    xyz2, rgba2 = pcd.read_pcd(p)
    np.testing.assert_array_equal(xyz, xyz2)
    assert (rgba2 == 0).all()
