import jax.numpy as jnp
import numpy as np

from slam3d_gx.ops.features import common, fast, harris, sift_desc


def checkerboard(h=120, w=160, sq=20):
    img = np.zeros((h, w), np.uint8)
    for i in range(0, h, sq):
        for j in range(0, w, sq):
            if ((i // sq) + (j // sq)) % 2 == 0:
                img[i : i + sq, j : j + sq] = 200
    return img


def test_gftt_finds_checkerboard_corners():
    img = checkerboard()
    kps = harris.detect_gftt(jnp.asarray(img), max_kp=128)
    uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
    assert len(uv) >= 20
    # every detection should be near a lattice corner (multiples of 20)
    offs_u = np.minimum(uv[:, 0] % 20, 20 - uv[:, 0] % 20)
    offs_v = np.minimum(uv[:, 1] % 20, 20 - uv[:, 1] % 20)
    assert (offs_u <= 2).mean() > 0.9
    assert (offs_v <= 2).mean() > 0.9


def test_gftt_no_corners_on_flat():
    img = np.full((64, 64), 128, np.uint8)
    kps = harris.detect_gftt(jnp.asarray(img), max_kp=32)
    assert int(kps.count()) == 0


def test_fast_detects_blob_corners(rng):
    img = np.full((100, 100), 30, np.uint8)
    img[40:60, 40:60] = 220  # a bright square: 4 strong corners
    kps = fast.detect_fast(jnp.asarray(img), threshold=20.0, max_kp=64)
    uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
    assert len(uv) >= 4
    corners = np.array([[40, 40], [40, 59], [59, 40], [59, 59]], float)
    for c in corners:
        d = np.linalg.norm(uv - c[None, ::-1], axis=1).min()
        assert d <= 3.0, f"corner {c} missed (min dist {d})"


def test_fast_flat_image_is_empty():
    img = np.full((64, 64), 100, np.uint8)
    kps = fast.detect_fast(jnp.asarray(img), max_kp=32)
    assert int(kps.count()) == 0


def test_grid_fast_budget(rng):
    img = (rng.random((128, 128)) * 255).astype(np.uint8)
    kps = fast.detect_grid_fast(jnp.asarray(img), threshold=10.0, max_kp=64, grid=4)
    valid = np.asarray(kps.valid)
    uv = np.asarray(kps.uv)[valid]
    # per-cell count <= budget
    per_cell = 64 // 16
    cells = (uv[:, 1] // 32).astype(int) * 4 + (uv[:, 0] // 32).astype(int)
    counts = np.bincount(cells, minlength=16)
    assert (counts <= per_cell).all()


def test_apply_mask():
    img = checkerboard()
    kps = harris.detect_gftt(jnp.asarray(img), max_kp=64)
    mask = np.zeros(img.shape, bool)
    mask[:, :80] = True
    masked = common.apply_mask(kps, jnp.asarray(mask))
    valid = np.asarray(masked.valid)
    uv = np.asarray(masked.uv)
    assert valid.sum() > 0
    assert (uv[valid][:, 0] < 80.5).all()


def _warp_points(uv, angle_deg, center, scale=1.0, shift=(0, 0)):
    a = np.deg2rad(angle_deg)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * scale
    return (uv - center) @ R.T + center + shift


def test_sift_descriptor_invariances(rng):
    """Descriptors of the same patch under translation stay close; under
    90-degree rotation stay close (orientation normalization); and differ
    from unrelated patches."""
    base = (rng.random((96, 96)) * 255).astype(np.float32)
    from scipy.ndimage import gaussian_filter, rotate, shift as ndshift

    img = gaussian_filter(base, 2.0)
    img = (img - img.min()) / (np.ptp(img) + 1e-9) * 255

    def desc_at(image, u, v):
        kps = common.Keypoints(
            uv=jnp.asarray([[u, v]], jnp.float32),
            response=jnp.ones(1, jnp.float32),
            size=jnp.full((1,), 12.0, jnp.float32),
            angle=jnp.zeros(1, jnp.float32),
            valid=jnp.ones(1, bool),
        )
        return np.asarray(sift_desc.sift_descriptors(jnp.asarray(image), kps))[0]

    d0 = desc_at(img, 48, 48)
    assert d0.sum() > 0

    shifted = ndshift(img, (5, -3), order=1, mode="nearest")
    d_shift = desc_at(shifted, 48 - 3, 48 + 5)
    rot = rotate(img, 90, reshape=False, order=1, mode="nearest")
    d_rot = desc_at(rot, 48, 48)
    d_other = desc_at(img, 20, 70)

    def dist(a, b):
        return np.linalg.norm(a - b)

    assert dist(d0, d_shift) < 0.5 * dist(d0, d_other)
    assert dist(d0, d_rot) < 0.7 * dist(d0, d_other)


def test_sift_descriptor_invalid_kp_is_zero():
    img = jnp.zeros((64, 64), jnp.float32)
    kps = common.empty_keypoints(4)
    d = np.asarray(sift_desc.sift_descriptors(img, kps))
    assert (d == 0).all()


def test_descriptors_match_across_views(rng):
    """Integration: GFTT+SIFT descriptors match between a frame and its
    translated copy via NN matching."""
    from scipy.ndimage import gaussian_filter, shift as ndshift
    from slam3d_gx.ops import match

    img = gaussian_filter((rng.random((120, 160)) * 255), 1.5).astype(np.float32)
    img2 = ndshift(img, (4, 7), order=1, mode="nearest")

    kps1 = harris.detect_gftt(jnp.asarray(img), max_kp=64)
    kps2 = harris.detect_gftt(jnp.asarray(img2), max_kp=64)
    d1 = sift_desc.sift_descriptors(jnp.asarray(img), kps1)
    d2 = sift_desc.sift_descriptors(jnp.asarray(img2), kps2)
    idx, dist, ok = match.match_nn(d1, kps1.valid, d2, kps2.valid)
    idx, ok = np.asarray(idx), np.asarray(ok)
    uv1 = np.asarray(kps1.uv)
    uv2 = np.asarray(kps2.uv)
    good = 0
    total = 0
    for i in range(len(idx)):
        if not ok[i]:
            continue
        total += 1
        pred = uv2[idx[i]]
        expect = uv1[i] + np.array([7, 4])
        if np.linalg.norm(pred - expect) < 2.5:
            good += 1
    assert total >= 20
    assert good / total > 0.6, f"{good}/{total} correct matches"


def test_descriptor_dim_matches_descriptor_output():
    """registry.descriptor_dim must agree with the (K,D) shape each
    create_descriptor function actually returns — shape-exact dummy
    features (state.empty_frame) are built from it, and a mismatch
    compiles a second program for the real ones."""
    from slam3d_gx.ops.features import registry

    img = jnp.asarray(checkerboard())
    for name in ("SIFT", "SURF", "SURF_SIFT", "ORB"):
        kps = harris.detect_gftt(img, max_kp=16)
        d = registry.create_descriptor(name)(img, kps)
        assert d.shape == (16, registry.descriptor_dim(name)), name
