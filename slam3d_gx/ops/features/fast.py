"""FAST-9/16 corner detector as a pure stencil kernel.

Parity target: cv::FastFeatureDetector (reference sweeps "FAST"/"GridFAST",
exp1_2_time.py:24-37; planarFeatures uses FAST at src/planarFeatures.cpp:47).
Defaults mirror OpenCV: threshold=10, nonmax suppression on, arc length 9
on the 16-pixel Bresenham circle.

The 16 circle taps become 16 rolled copies of the image; the
"9 contiguous" test is an OR over 16 cyclic AND-windows — all elementwise
work, no gathers. Score is the sum of threshold-exceeding differences
(OpenCV's nonmax score is the max threshold; this keeps the same ordering
for NMS purposes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import Keypoints, topk_keypoints

# OpenCV's circle of radius 3 (dx = col offset, dy = row offset)
_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
_ARC = 9


@functools.partial(jax.jit, static_argnames=("max_kp", "arc"))
def detect_fast(img, threshold: float = 10.0, max_kp: int = 512, arc: int = _ARC) -> Keypoints:
    """img: (H,W) uint8/float. Fixed-capacity Keypoints, border-3 excluded."""
    x = img.astype(jnp.float32)
    # 16 circle taps via rolls: tap[i][p] = x[p + (dy,dx)]
    taps = jnp.stack(
        [jnp.roll(x, shift=(-dy, -dx), axis=(0, 1)) for (dx, dy) in _CIRCLE]
    )
    diff = taps - x[None]
    bright = diff > threshold
    dark = diff < -threshold

    def has_arc(m):
        # OR over the 16 cyclic windows of `arc` consecutive taps
        out = jnp.zeros_like(m[0])
        for s in range(16):
            run = m[s]
            for j in range(1, arc):
                run = run & m[(s + j) % 16]
            out = out | run
        return out

    corner = has_arc(bright) | has_arc(dark)
    # score: total excess over threshold on the stronger side
    score_b = jnp.sum(jnp.maximum(diff - threshold, 0.0), axis=0)
    score_d = jnp.sum(jnp.maximum(-diff - threshold, 0.0), axis=0)
    score = jnp.where(corner, jnp.maximum(score_b, score_d), -jnp.inf)
    return topk_keypoints(score, max_kp, threshold=0.0, nms_radius=1, border=3, size=7.0)


@functools.partial(jax.jit, static_argnames=("max_kp", "grid", "arc"))
def detect_grid_fast(
    img, threshold: float = 10.0, max_kp: int = 512, grid: int = 4, arc: int = _ARC
) -> Keypoints:
    """GridAdaptedFeatureDetector(FAST) analog: per-cell keypoint budget.

    Splits the image into grid x grid cells and keeps max_kp/grid^2 top
    corners in each, so coverage is uniform (OpenCV GridFAST semantics).
    """
    x = img.astype(jnp.float32)
    H, W = x.shape
    kps = detect_fast(x, threshold=threshold, max_kp=max_kp, arc=arc)
    # rank keypoints within their cell, keep per-cell budget
    per_cell = max(1, max_kp // (grid * grid))
    cu = jnp.clip((kps.uv[:, 0] * grid / W).astype(jnp.int32), 0, grid - 1)
    cv_ = jnp.clip((kps.uv[:, 1] * grid / H).astype(jnp.int32), 0, grid - 1)
    cell = cv_ * grid + cu
    # order within cell: counting sort by (cell, -response) via lexsort
    order = jnp.lexsort((-kps.response, jnp.where(kps.valid, cell, grid * grid)))
    sorted_cell = jnp.where(kps.valid, cell, -1)[order]
    same_as_prev = jnp.concatenate(
        [jnp.zeros(1, bool), sorted_cell[1:] == sorted_cell[:-1]]
    )
    # rank within run of equal cells
    def body(carry, same):
        rank = jnp.where(same, carry + 1, 0)
        return rank, rank
    _, ranks = jax.lax.scan(body, jnp.int32(0), same_as_prev)
    keep_sorted = ranks < per_cell
    keep = jnp.zeros_like(kps.valid).at[order].set(keep_sorted)
    return kps._replace(valid=kps.valid & keep)
