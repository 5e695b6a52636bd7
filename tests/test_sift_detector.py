import jax.numpy as jnp
import numpy as np

from slam3d_gx.ops.features import dog, registry


def blob_image(h=128, w=128, blobs=((40, 40, 4), (90, 60, 8), (60, 100, 6))):
    """Gaussian blobs of different scales on a flat background."""
    img = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for (cy, cx, s) in blobs:
        img += 200.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_sift_detects_blobs_at_scale():
    img = blob_image()
    kps = dog.detect_sift(jnp.asarray(img), max_kp=64)
    valid = np.asarray(kps.valid)
    uv = np.asarray(kps.uv)[valid]
    sizes = np.asarray(kps.size)[valid]
    assert valid.sum() >= 3
    for (cy, cx, s) in ((40, 40, 4), (90, 60, 8), (60, 100, 6)):
        d = np.linalg.norm(uv - np.array([cx, cy])[None], axis=1)
        i = d.argmin()
        assert d[i] <= 2.5, f"blob at ({cx},{cy}) missed: {d[i]}"
        # detected scale should grow with blob scale (loose check)
        assert sizes[i] > 2.0


def test_sift_flat_image_empty():
    img = np.full((96, 96), 90, np.uint8)
    kps = dog.detect_sift(jnp.asarray(img), max_kp=32)
    assert int(kps.count()) == 0


def test_sift_repeatability_under_shift():
    rng = np.random.default_rng(5)
    from scipy.ndimage import gaussian_filter, shift as ndshift

    img = gaussian_filter(rng.random((128, 160)) * 255, 1.2).astype(np.float32)
    img2 = ndshift(img, (6, -9), order=1, mode="nearest")
    k1 = dog.detect_sift(jnp.asarray(img), max_kp=128)
    k2 = dog.detect_sift(jnp.asarray(img2), max_kp=128)
    uv1 = np.asarray(k1.uv)[np.asarray(k1.valid)]
    uv2 = np.asarray(k2.uv)[np.asarray(k2.valid)]
    assert len(uv1) >= 20 and len(uv2) >= 20
    # repeatability: most uv1 + (dx,dy) have a nearby uv2
    pred = uv1 + np.array([-9.0, 6.0])
    inside = (
        (pred[:, 0] > 10) & (pred[:, 0] < 150) & (pred[:, 1] > 10) & (pred[:, 1] < 118)
    )
    pred = pred[inside]
    d = np.linalg.norm(pred[:, None] - uv2[None], axis=-1).min(axis=1)
    assert (d <= 2.0).mean() > 0.7, f"repeatability {(d <= 2.0).mean()}"


def test_registry_names():
    img = jnp.asarray(blob_image())
    for name in ("SIFT", "GFTT", "HARRIS", "FAST", "GridFAST", "ORB", "SURF", "STAR"):
        det = registry.create_detector(name, max_kp=32)
        kps = det(img)
        assert kps.capacity == 32
    run = registry.detect_and_describe("GFTT", "SIFT", max_kp=32)
    kps, desc = run(img)
    assert desc.shape == (32, 128)
    import pytest

    with pytest.raises(ValueError):
        registry.create_detector("NOPE")
