"""SURF fast-Hessian keypoint detector.

Parity target: cv::SURF detection as swept by the reference experiments
(exp1_2_time.py detector zoo). Implements the fast-Hessian pyramid:
integral image -> box-filter approximations of the Gaussian second
derivatives (Dxx, Dyy, Dxy) at a ladder of filter sizes -> approximated
det(H) = Dxx*Dyy - (0.9*Dxy)^2 -> 3D non-max suppression over
(x, y, scale) -> fixed-k top-k with per-keypoint size.

Every box sum is four STATIC-offset reads of the integral image,
expressed as shifted slices of a padded array — no gathers. The
integral image is two cumsums. The whole pyramid is elementwise work
over (S, H, W).

The descriptor routed to "SURF" stays the SIFT descriptor
(ops/features/registry.py): the reference's accuracy contract is
trajectory-level, and a 128-d oriented gradient descriptor is a strict
quality superset of SURF's 64-d Haar sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import Keypoints, nms

# filter sizes of the first octave ladder (SURF: 9, 15, 21, 27)
_SIZES = (9, 15, 21, 27)


def _integral(img):
    x = img.astype(jnp.float32)
    return jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)


def _pad_integral(ii, pad):
    """Zero-pad the integral image so static window reads stay in-bounds
    (a zero top/left border is exact; edge values clamp the bottom/right,
    matching OpenCV's border replication closely enough for NMS)."""
    return jnp.pad(ii, ((pad + 1, pad), (pad + 1, pad)), mode="edge")


def _box(iip, y0, x0, y1, x1, pad, H, W):
    """Sum of img[y0:y1, x0:x1] around each pixel via 4 shifted slices.

    y0..x1 are static offsets relative to the pixel (inclusive start,
    exclusive end). iip is the padded integral image.
    """
    o = pad + 1

    def at(dy, dx):
        return jax.lax.slice(
            iip, (o + dy - 1, o + dx - 1), (o + dy - 1 + H, o + dx - 1 + W))

    return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)


def _hessian_response(iip, size, pad, H, W):
    """det(H_approx) for one box-filter size (SURF Fig. 2 layouts)."""
    l = size // 3          # lobe (odd: 3,5,7,9)
    b = functools.partial(_box, iip, pad=pad, H=H, W=W)
    h = size // 2          # (3l-1)/2: full 3l-row span is -h..h
    hl = l // 2            # middle lobe is the centered l rows
    w = l - 1              # 2l-1 columns span -w..w

    # Dyy: three stacked (2l-1 wide, l tall) lobes, weights 1,-2,1
    # = full(1) - 3*middle
    dyy = b(-h, -w, h + 1, w + 1) - 3.0 * b(-hl, -w, hl + 1, w + 1)
    # Dxx: transpose layout
    dxx = b(-w, -h, w + 1, h + 1) - 3.0 * b(-w, -hl, w + 1, hl + 1)
    # Dxy: four l x l lobes in the quadrants
    dxy = (
        b(-l, -l, 0, 0) + b(1, 1, l + 1, l + 1)
        - b(-l, 1, 0, l + 1) - b(1, -l, l + 1, 0)
    )

    inv_area = 1.0 / (size * size)
    dxx = dxx * inv_area
    dyy = dyy * inv_area
    dxy = dxy * inv_area
    return dxx * dyy - (0.9 * dxy) ** 2


@functools.partial(jax.jit, static_argnames=("max_kp",))
def detect_surf(img, max_kp: int = 512, threshold: float = 10.0) -> Keypoints:
    """img (H,W) uint8/float -> fixed-capacity Keypoints with sizes."""
    H, W = img.shape
    ii = _integral(img)
    pad = _SIZES[-1]
    iip = _pad_integral(ii, pad)

    resp = jnp.stack(
        [_hessian_response(iip, s, pad, H, W) for s in _SIZES])  # (S,H,W)
    # scale NMS: a maximum must beat its scale neighbours too
    up = jnp.concatenate([resp[1:], jnp.full((1, H, W), -jnp.inf)], axis=0)
    down = jnp.concatenate([jnp.full((1, H, W), -jnp.inf), resp[:-1]], axis=0)
    spatial = jnp.stack([nms(resp[s]) for s in range(len(_SIZES))])
    keep = (spatial > -jnp.inf) & (resp >= up) & (resp >= down)
    r = jnp.where(keep, resp, -jnp.inf)

    # exclude the border the largest filter can't evaluate cleanly
    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    border = pad // 2 + 1
    inside = ((row >= border) & (row < H - border)
              & (col >= border) & (col < W - border))
    r = jnp.where(inside[None], r, -jnp.inf)

    flat = r.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_kp)
    s_idx = idx // (H * W)
    v = ((idx % (H * W)) // W).astype(jnp.float32)
    u = (idx % W).astype(jnp.float32)
    sizes = jnp.asarray(_SIZES, jnp.float32)[s_idx]
    valid = vals > threshold
    return Keypoints(
        uv=jnp.stack([u, v], axis=-1),
        response=jnp.where(valid, vals, 0.0),
        # OpenCV SURF: size = 1.2 * filter_size / 9 * 9 = 1.2*filter/9*...
        # keypoint size in pixels ~ filter size * 1.2 / 9 * 9; store the
        # filter size scaled to SIFT-like support
        size=jnp.where(valid, sizes * (1.2 / 9.0) * 6.0, 7.0),
        angle=jnp.zeros((max_kp,), jnp.float32),
        valid=valid,
    )
