import jax.numpy as jnp
import numpy as np

from slam3d_gx.ops import imageproc
from slam3d_gx.testing import oracles


def splat_oracle(xyz, mask, gray, fx, fy, cx, cy, H, W, slope=-1.0, offset=10.0):
    """Direct numpy port of the reference painting loop
    (src/GraphicEnd.cpp:397-416)."""
    img = np.zeros((H, W), np.uint8)
    m = np.zeros((H, W), np.uint8)
    for p, ok in zip(xyz, mask):
        if not ok or p[2] <= 0:
            continue
        block = int(slope * p[2] + offset)
        block = max(block, 0)
        u = round(float(p[0] * fx / p[2] + cx))
        v = round(float(p[1] * fy / p[2] + cy))
        for k in range(-block, block + 1):
            for l in range(-block, block + 1):
                if v + k < 0 or v + k >= H or u + l < 0 or u + l >= W:
                    continue
                img[v + k, u + l] = gray[v + k, u + l]
                m[v + k, u + l] = 1
    return img, m


def test_splat_matches_reference_loop(rng):
    H, W = 120, 160
    fx = fy = 100.0
    cx, cy = 80.0, 60.0
    gray = rng.integers(1, 255, (H, W)).astype(np.uint8)
    n = 200
    # depths 2..7 -> blocks 3..8; points that project inside the image
    z = rng.uniform(2.0, 7.0, n)
    u = rng.uniform(5, W - 5, n)
    v = rng.uniform(5, H - 5, n)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    xyz = np.column_stack([x, y, z]).astype(np.float32)
    mask = rng.random(n) > 0.1
    img, m = imageproc.splat_plane_image(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(gray), fx, fy, cx, cy,
        height=H, width=W,
    )
    exp_img, exp_m = splat_oracle(xyz, mask, gray, fx, fy, cx, cy, H, W)
    np.testing.assert_array_equal(np.asarray(m).astype(np.uint8), exp_m)
    np.testing.assert_array_equal(np.asarray(img), exp_img)


def test_splat_empty():
    img, m = imageproc.splat_plane_image(
        jnp.zeros((10, 3)), jnp.zeros(10, bool), jnp.ones((48, 64), jnp.uint8),
        100.0, 100.0, 32.0, 24.0, height=48, width=64,
    )
    assert not np.asarray(m).any()
    assert (np.asarray(img) == 0).all()


def test_equalize_hist_matches_opencv_semantics():
    local = np.random.default_rng(11)
    img = local.integers(0, 256, (64, 96)).astype(np.uint8)
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(got, oracles.equalize_hist(img))


def test_equalize_hist_masked_image():
    # typical plane image: mostly zeros + a bright patch
    local = np.random.default_rng(12)
    img = np.zeros((64, 96), np.uint8)
    img[10:30, 10:50] = local.integers(50, 200, (20, 40)).astype(np.uint8)
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(got, oracles.equalize_hist(img))


def test_equalize_hist_constant():
    img = np.full((16, 16), 77, np.uint8)
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(got, img)
