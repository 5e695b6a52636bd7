import jax.numpy as jnp
import numpy as np

from slam3d_gx.ops import match


def test_l2_distance_matrix(rng):
    a = rng.normal(size=(20, 16)).astype(np.float32)
    b = rng.normal(size=(30, 16)).astype(np.float32)
    d = np.asarray(match.l2_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    exp = np.linalg.norm(a[:, None] - b[None], axis=-1)
    np.testing.assert_allclose(d, exp, atol=1e-4)


def test_match_nn_exact(rng):
    b = rng.normal(size=(50, 8)).astype(np.float32) * 10
    perm = rng.permutation(50)[:20]
    a = b[perm] + rng.normal(scale=0.01, size=(20, 8)).astype(np.float32)
    idx, dist, ok = match.match_nn(
        jnp.asarray(a), jnp.ones(20, bool), jnp.asarray(b), jnp.ones(50, bool)
    )
    np.testing.assert_array_equal(np.asarray(idx), perm)
    assert np.asarray(ok).all()


def test_match_nn_respects_masks(rng):
    a = rng.normal(size=(4, 8)).astype(np.float32)
    b = np.vstack([a, a]).astype(np.float32)  # duplicates at 0..3 and 4..7
    valid2 = np.array([False] * 4 + [True] * 4)
    idx, dist, ok = match.match_nn(
        jnp.asarray(a), jnp.asarray(np.array([True, True, False, True])),
        jnp.asarray(b), jnp.asarray(valid2),
    )
    np.testing.assert_array_equal(np.asarray(idx)[:2], [4, 5])
    assert not bool(np.asarray(ok)[2])


def test_good_match_filter_reference_quirk():
    # min_dist is capped at 100 even if all distances exceed it
    dist = jnp.asarray(np.array([250.0, 320.0, 900.0, 299.0], np.float32))
    valid = jnp.ones(4, bool)
    keep = np.asarray(match.good_match_filter(dist, valid))
    # min_dist = min(100, 250) = 100 -> bound 300
    np.testing.assert_array_equal(keep, [True, False, False, True])


def test_good_match_filter_normal_case():
    dist = jnp.asarray(np.array([10.0, 25.0, 31.0, 90.0], np.float32))
    keep = np.asarray(match.good_match_filter(dist, jnp.ones(4, bool)))
    # min_dist = 10 -> bound 30
    np.testing.assert_array_equal(keep, [True, True, False, False])


def test_good_match_filter_floor():
    dist = jnp.asarray(np.array([1.0, 4.0, 6.0], np.float32))
    keep = np.asarray(match.good_match_filter(dist, jnp.ones(3, bool), floor=5.0))
    # bound = max(3*1, 5) = 5
    np.testing.assert_array_equal(keep, [True, True, False])
