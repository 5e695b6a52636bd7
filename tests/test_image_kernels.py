"""Histogram, equalization LUT and Shi-Tomasi response against the numpy
references in slam3d_gx.testing.oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from slam3d_gx.ops import imageproc
from slam3d_gx.ops.features import harris
from slam3d_gx.testing import oracles


@pytest.mark.parametrize("shape", [(5000,), (37, 53), (480, 640)])
def test_histogram_matches_bincount(rng, shape):
    vals = rng.integers(0, 256, shape)
    h = np.asarray(imageproc.histogram256(jnp.asarray(vals, jnp.int32)))
    np.testing.assert_array_equal(
        h, np.bincount(vals.reshape(-1), minlength=256))


def test_histogram_empty_bins():
    h = np.asarray(imageproc.histogram256(jnp.full((1000,), 7, jnp.int32)))
    assert h[7] == 1000 and h.sum() == 1000


def test_equalize_hist_exact_at_640x480(rng):
    img = np.clip(rng.normal(110, 35, (480, 640)), 0, 255).astype(np.uint8)
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(got, oracles.equalize_hist(img))


def test_equalize_hist_lut_on_few_levels(rng):
    """Few distinct grey levels: every pixel of one level maps to the
    same LUT entry, and the levels keep their order."""
    levels = np.array([3, 40, 41, 200, 255], np.uint8)
    img = levels[rng.integers(0, len(levels), (61, 77))]
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(got, oracles.equalize_hist(img))
    mapped = [np.unique(got[img == v]) for v in levels]
    assert all(len(m) == 1 for m in mapped)
    assert mapped[0][0] == 0 and mapped[-1][0] == 255
    assert np.all(np.diff([m[0] for m in mapped]) > 0)


@pytest.mark.parametrize("shape", [(48, 200), (120, 160)])
def test_min_eig_response_matches_numpy(rng, shape):
    img = rng.normal(size=shape).astype(np.float32) * 50
    got = np.asarray(harris.min_eig_response(jnp.asarray(img)))
    ref = oracles.min_eig_response(img)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
