"""Native C++ runtime tests: PNG/PCD codecs + prefetch loader vs the
pure-Python io modules (oracle)."""

import os

import numpy as np
import pytest

from slam3d_gx import native_io
from slam3d_gx.io import images, pcd as pcd_io

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native library not built")


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    depth = rng.integers(0, 60000, (48, 64), dtype=np.uint16)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    from PIL import Image
    pg = os.path.join(root, "gray.png")
    pd = os.path.join(root, "depth.png")
    pc = os.path.join(root, "rgb.png")
    Image.fromarray(gray).save(pg)
    Image.fromarray(depth).save(pd)
    Image.fromarray(rgb).save(pc)
    return (pg, gray), (pd, depth), (pc, rgb)


def test_png_gray8(png_files):
    (pg, gray), _, _ = png_files
    out = native_io.png_decode(pg)
    np.testing.assert_array_equal(out, gray)


def test_png_depth16(png_files):
    _, (pd, depth), _ = png_files
    out = native_io.png_decode(pd, to_gray=False)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, depth)


def test_png_rgb_to_gray(png_files):
    _, _, (pc, rgb) = png_files
    out = native_io.png_decode(pc, to_gray=True)
    ref = np.round(
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    )
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_pcd_binary_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(0, 1, (1000, 3)).astype(np.float32)
    rgba = rng.integers(0, 2**24, 1000, dtype=np.uint32)
    p = str(tmp_path / "a.pcd")
    pcd_io.write_pcd(p, xyz, rgba, binary=True)
    nx, nr = native_io.pcd_read(p)
    np.testing.assert_array_equal(nx, xyz)
    np.testing.assert_array_equal(nr, rgba)


def test_pcd_ascii_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    xyz = rng.normal(0, 1, (100, 3)).astype(np.float32)
    rgba = rng.integers(0, 2**24, 100, dtype=np.uint32)
    p = str(tmp_path / "a.pcd")
    pcd_io.write_pcd(p, xyz, rgba, binary=False)
    nx, nr = native_io.pcd_read(p)
    np.testing.assert_allclose(nx, xyz, rtol=1e-4, atol=1e-5)


def test_prefetch_loader_order_and_content(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    frames = []
    paths = []
    for i in range(10):
        img = rng.integers(0, 256, (32, 40), dtype=np.uint8)
        p = str(tmp_path / f"{i}.png")
        Image.fromarray(img).save(p)
        frames.append(img)
        paths.append(p)
    loader = native_io.PrefetchLoader(
        paths, native_io.MODE_GRAY8, height=32, width=40,
        queue_depth=3, threads=2)
    for i in range(10):
        out = loader.next()
        np.testing.assert_array_equal(out, frames[i])
    with pytest.raises(StopIteration):
        loader.next()
    loader.close()


def test_prefetch_loader_pcd(tmp_path):
    rng = np.random.default_rng(4)
    clouds = []
    paths = []
    for i in range(4):
        n = 50 + 30 * i
        xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
        rgba = rng.integers(0, 2**24, n, dtype=np.uint32)
        p = str(tmp_path / f"{i}.pcd")
        pcd_io.write_pcd(p, xyz, rgba, binary=True)
        clouds.append((xyz, rgba))
        paths.append(p)
    loader = native_io.PrefetchLoader(paths, native_io.MODE_PCD,
                                      max_points=4096, queue_depth=2,
                                      threads=2)
    for i in range(4):
        xyz, rgba = loader.next()
        np.testing.assert_array_equal(xyz, clouds[i][0])
        np.testing.assert_array_equal(rgba, clouds[i][1])
    loader.close()


def test_prefetch_loader_bad_file(tmp_path):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    loader = native_io.PrefetchLoader([bad], native_io.MODE_GRAY8,
                                      height=8, width=8)
    assert loader.next() is None
    loader.close()


def test_prefetch_loader_rejects_format_mismatch(tmp_path):
    """A file whose actual channels/bitdepth don't match the loader mode
    must fail the item (status 2 -> None), not decode past the slot."""
    from PIL import Image
    rng = np.random.default_rng(5)
    depth16 = rng.integers(0, 60000, (16, 16), dtype=np.uint16)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    ga = rng.integers(0, 256, (16, 16, 2), dtype=np.uint8)  # gray+alpha
    p16 = str(tmp_path / "d.png")
    prgb = str(tmp_path / "c.png")
    pga = str(tmp_path / "ga.png")
    Image.fromarray(depth16).save(p16)
    Image.fromarray(rgb).save(prgb)
    Image.fromarray(ga, mode="LA").save(pga)

    # 16-bit and gray+alpha under GRAY8 -> rejected; RGB is fine (to_gray)
    loader = native_io.PrefetchLoader(
        [p16, pga, prgb], native_io.MODE_GRAY8, height=16, width=16)
    assert loader.next() is None
    assert loader.next() is None
    assert loader.next() is not None
    loader.close()

    # 8-bit RGB under DEPTH16 -> rejected
    loader = native_io.PrefetchLoader(
        [prgb, p16], native_io.MODE_DEPTH16, height=16, width=16)
    assert loader.next() is None
    np.testing.assert_array_equal(loader.next(), depth16)
    loader.close()


def test_prefetch_loader_rejects_dim_mismatch(tmp_path):
    """A differently-sized frame must fail its item instead of being
    silently reshaped into garbage by the consumer."""
    from PIL import Image
    rng = np.random.default_rng(6)
    good = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    small = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    pg = str(tmp_path / "g.png")
    ps = str(tmp_path / "s.png")
    Image.fromarray(good).save(pg)
    Image.fromarray(small).save(ps)
    loader = native_io.PrefetchLoader(
        [ps, pg], native_io.MODE_GRAY8, height=16, width=16)
    assert loader.next() is None
    np.testing.assert_array_equal(loader.next(), good)
    loader.close()
