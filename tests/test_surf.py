"""SURF fast-Hessian detector tests against analytic blob scenes."""

import numpy as np
import jax.numpy as jnp
import scipy.ndimage as ndi

from slam3d_gx.ops.features import surf, registry
from slam3d_gx.ops import match


def _blob_image(centers_sigmas, h=240, w=320):
    img = np.zeros((h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    for (cy, cx, s) in centers_sigmas:
        img += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def test_detects_blobs_at_location():
    blobs = [(60, 80, 4.0), (120, 200, 6.0), (180, 100, 8.0)]
    img = _blob_image(blobs)
    kps = surf.detect_surf(jnp.asarray(img), max_kp=32)
    uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
    assert len(uv) >= 3
    for (cy, cx, s) in blobs:
        d = np.min(np.hypot(uv[:, 0] - cx, uv[:, 1] - cy))
        assert d < 3.0, f"blob at ({cx},{cy}) missed by {d:.1f}px"


def test_scale_ordering():
    """Bigger blobs must fire at bigger filter sizes."""
    small = _blob_image([(120, 160, 3.0)])
    big = _blob_image([(120, 160, 9.0)])
    k_small = surf.detect_surf(jnp.asarray(small), max_kp=8)
    k_big = surf.detect_surf(jnp.asarray(big), max_kp=8)
    s_small = float(np.asarray(k_small.size)[np.asarray(k_small.valid)][0])
    s_big = float(np.asarray(k_big.size)[np.asarray(k_big.valid)][0])
    assert s_big > s_small


def test_registry_and_matching():
    """SURF detector + SIFT descriptor match a blurred textured pair."""
    rng = np.random.default_rng(0)
    base = ndi.gaussian_filter(rng.random((240, 320)) * 255, 2.5)
    shifted = np.roll(base, (0, 9), axis=(0, 1))
    run = registry.detect_and_describe("SURF", "SIFT", max_kp=128)
    k0, d0 = run(jnp.asarray(base, jnp.float32))
    k1, d1 = run(jnp.asarray(shifted, jnp.float32))
    assert int(np.asarray(k0.valid).sum()) > 20
    idx, dist, ok = match.match_nn(d0, k0.valid, d1, k1.valid)
    good = np.asarray(match.good_match_filter(dist, ok))
    uv0 = np.asarray(k0.uv)[good]
    uv1 = np.asarray(k1.uv)[np.asarray(idx)[good]]
    sel = (uv0[:, 0] < 300)  # ignore wraparound columns
    disp = (uv1 - uv0)[sel]
    med = np.median(disp, axis=0)
    assert abs(med[0] - 9) < 1.5 and abs(med[1]) < 1.5


def _np_surf_oracle(mag, ori, rx, ry, s):
    """Independent numpy SURF-64: sliding-window orientation + oriented
    4x4 Haar-sum subregions, straight from the SURF paper formulas."""
    K = mag.shape[0]
    out = np.zeros((K, 64), np.float64)
    for k in range(K):
        m, o = mag[k], ori[k]
        x, y = rx[k], ry[k]
        sk = s[k]
        # orientation: best pi/3 window over 36 centers
        r2 = x * x + y * y
        w = np.exp(-r2 / (2 * (2.5 * sk) ** 2)) * (r2 <= (6 * sk) ** 2)
        vx, vy = m * np.cos(o) * w, m * np.sin(o) * w
        best, bx, by = -1.0, 1.0, 0.0
        for c in np.linspace(-np.pi, np.pi, 36, endpoint=False):
            d = np.abs(np.mod(o - c + np.pi, 2 * np.pi) - np.pi)
            ind = d < np.pi / 6
            sx, sy = vx[ind].sum(), vy[ind].sum()
            if sx * sx + sy * sy > best:
                best, bx, by = sx * sx + sy * sy, sx, sy
        ang = np.arctan2(by, bx)
        ca, sa = np.cos(ang), np.sin(ang)
        u = (x * ca + y * sa) / sk
        v = (-x * sa + y * ca) / sk
        g = np.exp(-(u * u + v * v) / (2 * 3.3**2))
        gdx, gdy = m * np.cos(o), m * np.sin(o)
        dxr = (gdx * ca + gdy * sa) * g
        dyr = (-gdx * sa + gdy * ca) * g
        vec = []
        for iv in range(4):
            lov = -10 + 5 * iv
            for iu in range(4):
                lou = -10 + 5 * iu
                ind = (v >= lov) & (v < lov + 5) & (u >= lou) & (u < lou + 5)
                vec += [dxr[ind].sum(), np.abs(dxr[ind]).sum(),
                        dyr[ind].sum(), np.abs(dyr[ind]).sum()]
        vec = np.asarray(vec)
        out[k] = vec / (np.linalg.norm(vec) + 1e-12)
    return out


def test_surf_descriptor_numpy_oracle(rng):
    """surf_desc's batched analytic math == a per-keypoint numpy
    reimplementation on the same gradient patches."""
    from slam3d_gx.ops.features import common, surf_desc
    from slam3d_gx.ops.features.sift_desc import _patch_data

    img = ndi.gaussian_filter(rng.random((96, 128)) * 255, 1.5).astype(
        np.float32)
    uv = np.array([[40.0, 40.0], [70.0, 50.0], [100.0, 60.0]], np.float32)
    kps = common.Keypoints(
        uv=jnp.asarray(uv),
        response=jnp.ones(3, jnp.float32),
        size=jnp.asarray([8.0, 12.0, 10.0], jnp.float32),
        angle=jnp.zeros(3, jnp.float32),
        valid=jnp.ones(3, bool),
    )
    got = np.asarray(surf_desc.surf_descriptors(jnp.asarray(img), kps))
    mag, ori, rx, ry = (np.asarray(a, np.float64)
                        for a in _patch_data(jnp.asarray(img), kps))
    s = np.maximum(np.asarray(kps.size, np.float64) / 6.0, 1.0 / 3.0)
    want = _np_surf_oracle(mag, ori, rx, ry, s)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert got.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)


def test_surf_descriptor_invariances(rng):
    """Translation keeps the descriptor close; 90-degree rotation stays
    closer than an unrelated patch (orientation normalization works)."""
    from slam3d_gx.ops.features import common, surf_desc

    base = (rng.random((96, 96)) * 255).astype(np.float32)
    img = ndi.gaussian_filter(base, 2.0)
    img = (img - img.min()) / (np.ptp(img) + 1e-9) * 255

    def desc_at(image, u, v):
        kps = common.Keypoints(
            uv=jnp.asarray([[u, v]], jnp.float32),
            response=jnp.ones(1, jnp.float32),
            size=jnp.full((1,), 12.0, jnp.float32),
            angle=jnp.zeros(1, jnp.float32),
            valid=jnp.ones(1, bool),
        )
        return np.asarray(
            surf_desc.surf_descriptors(jnp.asarray(image), kps))[0]

    d0 = desc_at(img, 48, 48)
    assert np.linalg.norm(d0) > 0.99

    shifted = ndi.shift(img, (5, -3), order=1, mode="nearest")
    d_shift = desc_at(shifted, 48 - 3, 48 + 5)
    rot = ndi.rotate(img, 90, reshape=False, order=1, mode="nearest")
    d_rot = desc_at(rot, 48, 48)
    d_other = desc_at(img, 20, 70)

    def dist(a, b):
        return np.linalg.norm(a - b)

    assert dist(d0, d_shift) < 0.5 * dist(d0, d_other)
    assert dist(d0, d_rot) < 0.8 * dist(d0, d_other)


def test_surf_surf_matching_across_views():
    """Registry SURF/SURF (real 64-d descriptor) matches a shifted pair —
    the parity config `descriptor_name: SURF` now runs real SURF."""
    rng = np.random.default_rng(1)
    base = ndi.gaussian_filter(rng.random((240, 320)) * 255, 2.5)
    shifted = np.roll(base, (0, 9), axis=(0, 1))
    run = registry.detect_and_describe("SURF", "SURF", max_kp=128)
    k0, d0 = run(jnp.asarray(base, jnp.float32))
    k1, d1 = run(jnp.asarray(shifted, jnp.float32))
    assert np.asarray(d0).shape[1] == 64
    idx, dist, ok = match.match_nn(d0, k0.valid, d1, k1.valid)
    good = np.asarray(match.good_match_filter(dist, ok))
    uv0 = np.asarray(k0.uv)[good]
    uv1 = np.asarray(k1.uv)[np.asarray(idx)[good]]
    sel = (uv0[:, 0] < 300)
    disp = (uv1 - uv0)[sel]
    med = np.median(disp, axis=0)
    assert abs(med[0] - 9) < 1.5 and abs(med[1]) < 1.5


def test_star_detects_blobs():
    from slam3d_gx.ops.features import star

    blobs = [(60, 80, 3.0), (120, 200, 5.0), (180, 100, 7.0)]
    img = _blob_image(blobs)
    kps = star.detect_star(jnp.asarray(img), max_kp=32)
    uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
    assert len(uv) >= 3
    for (cy, cx, s) in blobs:
        d = np.min(np.hypot(uv[:, 0] - cx, uv[:, 1] - cy))
        assert d < 3.0, f"blob at ({cx},{cy}) missed by {d:.1f}px"


def test_star_suppresses_lines():
    from slam3d_gx.ops.features import star

    img = np.zeros((240, 320), np.float32)
    img[:, 150:170] = 200.0  # vertical bar: strong center-surround on edges
    kps = star.detect_star(jnp.asarray(img), max_kp=64)
    uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
    # edge responses along the bar must be suppressed (only bar ends or
    # nothing may fire)
    mid = uv[(uv[:, 1] > 40) & (uv[:, 1] < 200)] if len(uv) else uv
    on_edges = [p for p in mid if abs(p[0] - 150) < 4 or abs(p[0] - 170) < 4]
    assert len(on_edges) <= 2, on_edges
