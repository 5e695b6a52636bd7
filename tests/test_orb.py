"""ORB descriptor tests: rotation-aware binary matching quality."""

import numpy as np
import jax.numpy as jnp
import pytest

from slam3d_gx.ops import match
from slam3d_gx.ops.features import orb, registry
from slam3d_gx.testing import synthetic
from slam3d_gx.config import CameraIntrinsics
from slam3d_gx.geometry import se3

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)


@pytest.fixture(scope="module")
def frame_pair():
    scene = synthetic.RoomScene(seed=5)
    # the default walls tile their texture every ~1.2 m; binary
    # descriptors (unlike float SIFT) can't disambiguate exact texture
    # repeats, so stretch the tiles for an unambiguous match test
    for p in scene.planes:
        p.tex_scale = 3.0
    T0 = np.eye(4)
    T1 = se3.make_isometry(
        se3.rodrigues(np.array([0.0, 0.06, 0.02])), np.array([0.05, 0.01, 0.0]))
    g0, d0 = synthetic.render_frame(scene, T0, INTR, 240, 320)
    g1, d1 = synthetic.render_frame(scene, T1, INTR, 240, 320)
    rng = np.random.default_rng(0)
    g0 = np.clip(g0 + rng.normal(0, 2, g0.shape), 0, 255).astype(np.uint8)
    g1 = np.clip(g1 + rng.normal(0, 2, g1.shape), 0, 255).astype(np.uint8)
    return g0, g1, d0, T1


def test_descriptor_is_binary(frame_pair):
    g0 = frame_pair[0]
    run = registry.detect_and_describe("ORB", "ORB", max_kp=128)
    kps, desc = run(jnp.asarray(g0, jnp.float32))
    d = np.asarray(desc)
    assert d.shape == (128, 256)
    assert set(np.unique(d)).issubset({0.0, 1.0})
    v = np.asarray(kps.valid)
    assert v.sum() > 30


def test_matching_across_viewpoint(frame_pair):
    """Count matches consistent with the ground-truth reprojection.

    NB the synthetic scene tiles its wall texture, so some visually
    identical keypoints legitimately collide — judge match quality by
    the fraction that lands on the true correspondence, not by spread.
    """
    g0, g1, dep0, T1 = frame_pair
    run = registry.detect_and_describe("ORB", "ORB", max_kp=256)
    k0, d0 = run(jnp.asarray(g0, jnp.float32))
    k1, d1 = run(jnp.asarray(g1, jnp.float32))
    idx, dist, ok = match.match_nn(d0, k0.valid, d1, k1.valid)
    good = np.asarray(match.good_match_filter(
        dist, ok, floor=registry.match_floor("ORB")))
    uv0 = np.asarray(k0.uv)[good]
    uv1 = np.asarray(k1.uv)[np.asarray(idx)[good]]
    assert len(uv0) >= 20

    # ground-truth projection of kp0 into frame 1
    u = np.clip(np.round(uv0[:, 0]).astype(int), 0, 319)
    v = np.clip(np.round(uv0[:, 1]).astype(int), 0, 239)
    z = dep0[v, u].astype(np.float64) / INTR.factor
    has_z = z > 0
    x = (uv0[:, 0] - INTR.cx) * z / INTR.fx
    y = (uv0[:, 1] - INTR.cy) * z / INTR.fy
    pts = np.stack([x, y, z], axis=1)
    Tcw = se3.inverse(T1)
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    gt_u = INTR.fx * pc[:, 0] / pc[:, 2] + INTR.cx
    gt_v = INTR.fy * pc[:, 1] / pc[:, 2] + INTR.cy
    err = np.hypot(uv1[:, 0] - gt_u, uv1[:, 1] - gt_v)[has_z]
    inlier_frac = float(np.mean(err < 4.0))
    assert inlier_frac > 0.4, f"only {inlier_frac:.0%} of matches correct"
    assert (err < 4.0).sum() > 15


def test_orientation_consistency():
    """A rotated copy of a patch should produce a similar descriptor."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (240, 320)).astype(np.float64)
    import scipy.ndimage as ndi
    sm = ndi.gaussian_filter(base, 3.0)
    rot = ndi.rotate(sm, angle=30.0, reshape=False, order=1, mode="nearest")

    from slam3d_gx.ops.features.common import Keypoints
    uv = jnp.asarray([[160.0, 120.0]], jnp.float32)
    kp = Keypoints(uv=uv, response=jnp.ones(1), size=jnp.full((1,), 7.0),
                   angle=jnp.zeros(1), valid=jnp.ones(1, bool))
    d0 = np.asarray(orb.orb_descriptors(jnp.asarray(sm, jnp.float32), kp))[0]
    d1 = np.asarray(orb.orb_descriptors(jnp.asarray(rot, jnp.float32), kp))[0]
    hamming = np.sum(d0 != d1)
    # far better than chance (128) for a rotation-invariant descriptor
    assert hamming < 80, hamming
