import jax
import jax.numpy as jnp
import numpy as np

from slam3d_gx.ops import plane_ransac


def make_scene(rng, n_noise=200):
    """Three axis-ish planes + uniform noise, known memberships."""
    pts = []
    labels = []
    # floor z=2 within x,y in [-1,1]
    n0 = 800
    xy = rng.uniform(-1, 1, (n0, 2))
    pts.append(np.column_stack([xy[:, 0], xy[:, 1], np.full(n0, 2.0)]))
    labels += [0] * n0
    # wall x=0.5
    n1 = 500
    yz = rng.uniform(-1, 1, (n1, 2))
    pts.append(np.column_stack([np.full(n1, 0.5), yz[:, 0], yz[:, 1] + 2.5]))
    labels += [1] * n1
    # slanted plane x+y+z=4
    n2 = 300
    xy = rng.uniform(-1, 1, (n2, 2))
    pts.append(np.column_stack([xy[:, 0], xy[:, 1], 4.0 - xy[:, 0] - xy[:, 1]]))
    labels += [2] * n2
    noise = rng.uniform(-2, 2, (n_noise, 3)) + [0, 0, 3]
    pts.append(noise)
    labels += [-1] * n_noise
    xyz = np.concatenate(pts).astype(np.float32)
    xyz += rng.normal(scale=0.005, size=xyz.shape).astype(np.float32)
    return xyz, np.array(labels)


def test_extract_three_planes(rng):
    xyz, labels = make_scene(rng)
    mask = np.ones(len(xyz), bool)
    coeffs, masks, valids, remaining = plane_ransac.extract_planes(
        jnp.asarray(xyz), jnp.asarray(mask), jax.random.PRNGKey(0),
        max_planes=3, dist_thresh=0.03, percent=0.1,
    )
    coeffs, masks, valids = map(np.asarray, (coeffs, masks, valids))
    assert valids.all()
    # d >= 0 convention
    assert (coeffs[:, 3] >= 0).all()
    # normals unit
    np.testing.assert_allclose(np.linalg.norm(coeffs[:, :3], axis=1), 1.0, atol=1e-5)
    # biggest plane found first: floor (z=2) => |c| ~ 1, d ~ 2
    expected = [
        np.array([0, 0, 1, -2.0]),   # will be sign-normalized
        np.array([1, 0, 0, -0.5]),
        np.array([1, 1, 1, -4.0]) / np.sqrt(3),
    ]
    for i, exp in enumerate(expected):
        if exp[3] < 0:
            exp = -exp
        np.testing.assert_allclose(coeffs[i], exp, atol=0.02)
    # memberships: each plane mask mostly covers its generator points
    for i in range(3):
        gen = labels == i
        recall = masks[i][gen].mean()
        assert recall > 0.95, f"plane {i} recall {recall}"
    # planes don't claim each other's points
    assert not (masks[0] & masks[1]).any()


def test_percent_stopping(rng):
    xyz, _ = make_scene(rng, n_noise=0)
    mask = np.ones(len(xyz), bool)
    # with percent=0.9 only the first (largest) plane may be extracted:
    # after removing plane 0 (~800 of 1600 pts) the loop condition fails
    coeffs, masks, valids, remaining = plane_ransac.extract_planes(
        jnp.asarray(xyz), jnp.asarray(mask), jax.random.PRNGKey(1),
        max_planes=3, dist_thresh=0.03, percent=0.9,
    )
    valids = np.asarray(valids)
    assert valids[0] and not valids[1] and not valids[2]


def test_respects_input_mask(rng):
    xyz, labels = make_scene(rng)
    mask = labels == 1  # only the wall is valid
    coeffs, masks, valids, _ = plane_ransac.extract_planes(
        jnp.asarray(xyz), jnp.asarray(mask), jax.random.PRNGKey(2),
        max_planes=1, dist_thresh=0.03, percent=0.1,
    )
    coeffs = np.asarray(coeffs)
    exp = np.array([1, 0, 0, -0.5])
    if exp[3] < 0:
        exp = -exp
    got = coeffs[0] if coeffs[0, 3] >= 0 else -coeffs[0]
    np.testing.assert_allclose(np.abs(got @ exp), 1.0 + 0.5 * 0.5, atol=0.03)
    assert not np.asarray(masks)[0][~mask].any()


def test_fit_plane_micro(rng):
    """49-point micro RANSAC (planarFeatures analog)."""
    xy = rng.uniform(-0.05, 0.05, (49, 2))
    z = 1.0 + 0.1 * xy[:, 0]
    xyz = np.column_stack([xy[:, 0], xy[:, 1], z]).astype(np.float32)
    xyz[:5] += rng.normal(scale=0.5, size=(5, 3))  # outliers
    coeff, inl, cnt = plane_ransac.fit_plane(
        jnp.asarray(xyz), jnp.ones(49, bool), jax.random.PRNGKey(3), dist_thresh=0.01
    )
    assert int(cnt) >= 40
    d = np.abs(np.asarray(xyz[5:]) @ np.asarray(coeff[:3]) + float(coeff[3]))
    assert d.max() < 0.015
