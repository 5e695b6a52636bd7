"""Batched-hypothesis plane RANSAC + iterative multi-plane extraction.

A replacement for PCL SACSegmentation<PointXYZRGBA> as used by the
reference (src/GraphicEnd.cpp:353-430): fit up to `max_planes` planes while
more than `percent` of the original points remain, distance threshold
`dist_thresh` (0.08 m default), coefficients normalized so d >= 0
(src/GraphicEnd.cpp:383-387), inliers removed between rounds
(ExtractIndices -> boolean masks here, SURVEY.md §2.2).

Re-architecture for batched hardware: instead of PCL's sequential hypothesis loop,
sample B triplets at once, score all B planes against all N points with one
(B,3)x(3,N) matmul + compare + reduce, take the argmax, then refine the
winner with two masked least-squares passes (PCL's optimizeCoefficients
analog). The multi-plane loop is a lax.scan over `max_planes` steps with
per-step validity flags instead of data-dependent iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _plane_lsq(xyz, w):
    """Weighted total-least-squares plane through masked points.

    Returns (4,) [n, d] with |n|=1: smallest eigenvector of the weighted
    covariance (centered), d = -n . centroid.
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    c = jnp.sum(xyz * w[:, None], axis=0) / wsum
    x = (xyz - c) * w[:, None]
    cov = jnp.matmul(x.T, (xyz - c), precision=_HI) / wsum
    # eigh is ascending: first eigenvector has the smallest eigenvalue
    _, vecs = jnp.linalg.eigh(cov)
    n = vecs[:, 0]
    d = -jnp.dot(n, c)
    return jnp.concatenate([n, jnp.array([d], dtype=xyz.dtype)])


def _point_plane_abs_dist(xyz, coeff):
    return jnp.abs(xyz @ coeff[:3] + coeff[3])


@functools.partial(
    jax.jit, static_argnames=("max_planes", "hypotheses", "min_inliers")
)
def extract_planes(
    xyz,
    mask,
    key,
    max_planes: int = 3,
    dist_thresh: float = 0.08,
    percent: float = 0.2,
    hypotheses: int = 256,
    min_inliers: int = 3,
):
    """Iterative RANSAC plane extraction over a fixed-size masked cloud.

    Args:
      xyz: (N,3) float32; mask: (N,) bool valid points; key: PRNG key.
    Returns:
      coeffs: (P,4) plane [a,b,c,d] with d>=0; plane_masks: (P,N) bool
      inlier sets; valid: (P,) bool which plane slots are real;
      remaining: (N,) bool points never claimed by a plane.
    """
    N = xyz.shape[0]
    n_total = jnp.sum(mask).astype(jnp.float32)
    xyz = xyz.astype(jnp.float32)

    def step(remaining, key_p):
        k_idx = key_p
        logits = jnp.where(remaining, 0.0, -1e30)
        idx = jax.random.categorical(k_idx, logits, shape=(hypotheses, 3))
        p0 = xyz[idx[:, 0]]
        p1 = xyz[idx[:, 1]]
        p2 = xyz[idx[:, 2]]
        n = jnp.cross(p1 - p0, p2 - p0)
        nn = jnp.linalg.norm(n, axis=-1)
        ok = nn > 1e-9
        n = n / jnp.where(ok, nn, 1.0)[:, None]
        d = -jnp.sum(n * p0, axis=-1)

        # score all hypotheses: one (B,3)x(3,N) matmul
        dist = jnp.abs(jnp.matmul(n, xyz.T, precision=_HI) + d[:, None])
        inl = (dist < dist_thresh) & remaining[None, :]
        counts = jnp.where(ok, inl.sum(axis=1), -1)
        best = jnp.argmax(counts)

        # two refine rounds (PCL optimizeCoefficients analog)
        m = inl[best]
        coeff = _plane_lsq(xyz, m.astype(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining
        coeff = _plane_lsq(xyz, m.astype(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining

        # d >= 0 normalization (reference src/GraphicEnd.cpp:383-387)
        coeff = jnp.where(coeff[3] < 0, -coeff, coeff)

        count = m.sum()
        enough_left = jnp.sum(remaining).astype(jnp.float32) > percent * n_total
        valid = enough_left & (count >= min_inliers)
        new_remaining = jnp.where(valid, remaining & ~m, remaining)
        return new_remaining, (coeff, m & valid, valid)

    keys = jax.random.split(key, max_planes)
    remaining, (coeffs, masks, valids) = jax.lax.scan(step, mask, keys)
    return coeffs, masks, valids, remaining


@functools.partial(jax.jit, static_argnames=("hypotheses",))
def fit_plane(xyz, mask, key, dist_thresh: float = 0.01, hypotheses: int = 64):
    """Single-plane RANSAC (SampleConsensusModelPlane analog,
    reference src/planarFeatures.cpp:118-125). Returns (coeff, inlier_mask,
    inlier_count)."""
    coeffs, masks, valids, _ = extract_planes(
        xyz,
        mask,
        key,
        max_planes=1,
        dist_thresh=dist_thresh,
        percent=0.0,
        hypotheses=hypotheses,
    )
    return coeffs[0], masks[0], masks[0].sum()
