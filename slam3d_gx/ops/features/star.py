"""STAR (CenSurE) center-surround detector.

Parity target: cv::StarDetector (swept by the reference experiments,
exp1_2_time.py). CenSurE approximates a Laplacian with bi-level
center-surround filters evaluated at every pixel and scale; the OpenCV
STAR filter is a star-shaped union of a box and a rotated box — this
implementation uses the box bi-level variant of the CenSurE paper
(inner nxn box positive, surrounding 3nx3n ring negative, area
normalized), which shares its response characteristics and is pure
static-slice integral-image work on the VPU (no gathers).

Scale ladder n = 1,2,3,4 (block sizes 3..9 / rings 9..27), scale NMS,
fixed-k top-k; line responses suppressed with the same min-eigenvalue
gate OpenCV applies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import surf
from .common import Keypoints, nms, sobel_gradients, box_filter

_NS = (1, 2, 3, 4)  # inner half-sizes; outer = 3x


@functools.partial(jax.jit, static_argnames=("max_kp",))
def detect_star(img, max_kp: int = 512, threshold: float = 3.0,
                line_thresh: float = 10.0) -> Keypoints:
    H, W = img.shape
    ii = surf._integral(img)
    pad = 3 * _NS[-1] + 2
    iip = surf._pad_integral(ii, pad)
    b = functools.partial(surf._box, iip, pad=pad, H=H, W=W)

    resps = []
    for n in _NS:
        inner = b(-n, -n, n + 1, n + 1)
        outer = b(-3 * n, -3 * n, 3 * n + 1, 3 * n + 1)
        a_in = (2 * n + 1) ** 2
        a_out = (6 * n + 1) ** 2 - a_in
        resp = inner / a_in - (outer - inner) / a_out
        resps.append(jnp.abs(resp))
    resp = jnp.stack(resps)  # (S,H,W)

    up = jnp.concatenate([resp[1:], jnp.full((1, H, W), -jnp.inf)], axis=0)
    down = jnp.concatenate([jnp.full((1, H, W), -jnp.inf), resp[:-1]], axis=0)
    spatial = jnp.stack([nms(resp[s]) for s in range(len(_NS))])
    keep = (spatial > -jnp.inf) & (resp >= up) & (resp >= down)
    r = jnp.where(keep, resp, -jnp.inf)

    # line suppression: reject edge-like maxima (ratio of structure-tensor
    # eigenvalues, cv::StarDetector lineThresholdProjected analog)
    dx, dy = sobel_gradients(img.astype(jnp.float32))
    sxx = box_filter(dx * dx, 2)
    syy = box_filter(dy * dy, 2)
    sxy = box_filter(dx * dy, 2)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    edge_like = tr * tr >= line_thresh * jnp.maximum(det, 1e-9)
    r = jnp.where(edge_like[None], -jnp.inf, r)

    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    border = 3 * _NS[-1] + 1
    inside = ((row >= border) & (row < H - border)
              & (col >= border) & (col < W - border))
    r = jnp.where(inside[None], r, -jnp.inf)

    flat = r.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_kp)
    s_idx = idx // (H * W)
    v = ((idx % (H * W)) // W).astype(jnp.float32)
    u = (idx % W).astype(jnp.float32)
    sizes = jnp.asarray([2.0 * (3 * n + 1) for n in _NS], jnp.float32)[s_idx]
    valid = vals > threshold
    return Keypoints(
        uv=jnp.stack([u, v], axis=-1),
        response=jnp.where(valid, vals, 0.0),
        size=jnp.where(valid, sizes, 7.0),
        angle=jnp.zeros((max_kp,), jnp.float32),
        valid=valid,
    )
