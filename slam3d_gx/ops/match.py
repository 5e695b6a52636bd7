"""Brute-force descriptor matching as one matmul.

Parity target: cv::FlannBasedMatcher::match as used by the reference for
both descriptors (src/GraphicEnd.cpp:486-520) and plane-coefficient
matching (src/GraphicEnd.cpp:459-484), plus the reference's good-match
filter: keep matches with distance <= 3 * min_dist where min_dist starts
at 100 (src/GraphicEnd.cpp:496-517); the exp1 variant floors the bound at
5.0 (src/exp1/exp1.cpp:315-321).

Exact nearest neighbour via one (M,D)x(D,N) matmul + argmin — exact
beats approximate FLANN at SLAM sizes (M,N <= 1k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


@jax.jit
def l2_distance_matrix(a, b):
    """(M,D),(N,D) -> (M,N) Euclidean distances.

    Precision: HIGHEST. At DEFAULT or HIGH a float32 matmul runs in
    TF32 on the GPU: exact for SIFT's integer-valued descriptors, but on
    SURF's float descriptors it moved 13 of 512 nearest neighbours
    against a float64 oracle on an H100, where HIGHEST moved none for
    about 1 us more per 512x512x128 call (benchmarks/frontend_kernels.py).
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    aa = jnp.sum(a * a, axis=1, keepdims=True)
    bb = jnp.sum(b * b, axis=1, keepdims=True)
    d2 = aa + bb.T - 2.0 * jnp.matmul(a, b.T, precision=_HI)
    return jnp.sqrt(jnp.clip(d2, 0.0, None))


@jax.jit
def match_nn(desc1, valid1, desc2, valid2):
    """Nearest neighbour in desc2 for every desc1 row.

    Returns (train_idx (M,) int32, distance (M,) f32, valid (M,) bool).
    Invalid queries/trains are excluded; a query with no valid train gets
    valid=False.
    """
    d = l2_distance_matrix(desc1, desc2)
    d = jnp.where(valid2[None, :], d, jnp.inf)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    # min, not take_along_axis(argmin): identical values, and the min
    # fuses into the same reduction pass as the argmin instead of
    # re-reading the distance matrix
    dist = jnp.min(d, axis=1)
    ok = valid1 & jnp.isfinite(dist)
    return idx, jnp.where(ok, dist, jnp.inf), ok


@functools.partial(jax.jit, static_argnames=())
def good_match_filter(dist, valid, ratio: float = 3.0, init_min: float = 100.0,
                      floor: float = 0.0):
    """The reference's min-dist ratio gate.

    min_dist = min(init_min, min(valid distances)); keep
    dist <= max(ratio * min_dist, floor). init_min=100 reproduces the
    reference's quirk that min_dist never exceeds 100.
    """
    min_dist = jnp.min(jnp.where(valid, dist, jnp.inf))
    min_dist = jnp.minimum(min_dist, init_min)
    bound = jnp.maximum(ratio * min_dist, floor)
    return valid & (dist <= bound)


def gather_rows_onehot(idx, rows):
    """rows[idx] via one-hot matmul: (M,) int32 x (N,D) -> (M,D).

    Exact: the contraction runs at HIGHEST precision, so each output row
    is one input row times 1.0."""
    oh = (idx[:, None] == jnp.arange(rows.shape[0], dtype=idx.dtype)[None, :])
    return jnp.matmul(oh.astype(rows.dtype), rows,
                      precision=_HI)


@jax.jit
def match_planes(coeffs1, valid1, coeffs2, valid2):
    """Plane-set matcher: 4-vector (a,b,c,d) coefficients as descriptors
    (reference src/GraphicEnd.cpp:459-484; no ratio filter there)."""
    return match_nn(coeffs1, valid1, coeffs2, valid2)
