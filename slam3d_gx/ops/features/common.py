"""Shared feature machinery: fixed-K keypoint container, NMS, top-k."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (padded, masked).

    uv: (K,2) float32 — (u=x=col, v=y=row), OpenCV KeyPoint.pt order;
    response: (K,) float32; size: (K,) float32 (diameter, px);
    angle: (K,) float32 radians (0 when undefined);
    valid: (K,) bool.
    """

    uv: jnp.ndarray
    response: jnp.ndarray
    size: jnp.ndarray
    angle: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def count(self):
        return self.valid.sum()


def empty_keypoints(k: int) -> Keypoints:
    return Keypoints(
        uv=jnp.zeros((k, 2), jnp.float32),
        response=jnp.zeros((k,), jnp.float32),
        size=jnp.zeros((k,), jnp.float32),
        angle=jnp.zeros((k,), jnp.float32),
        valid=jnp.zeros((k,), bool),
    )


def nms(response, radius: int = 1):
    """Keep strict local maxima within a (2r+1)^2 window."""
    w = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        response, -jnp.inf, jax.lax.max, (w, w), (1, 1), "SAME"
    )
    return jnp.where(response >= pooled, response, -jnp.inf)


def topk_flat(flat, k: int, block: int = 128):
    """Exact top-k over a 1D array via a block-max prefilter.

    lax.top_k over a full response map (307k-921k elements here) is a
    large sort-like pass in every detector's selection stage. This
    reduces it to top_k over n/block block maxima plus top_k over k*block
    survivors.

    Exactness: any block containing one of the true top-k elements has
    a block max >= the k-th largest value, so it ranks within the top k
    blocks (at most k blocks can beat it, and blocks holding a top-k
    element cannot all be beaten by k OTHER blocks — each beating block
    contributes an element larger than the k-th value, a contradiction
    beyond k blocks). Hence the k selected blocks cover all true top-k
    elements and pass 2 is exact. Tie order among equal values can
    differ from plain top_k (both are valid top-k sets).

    Returns (values, flat_indices), each (k,).
    """
    n = flat.shape[0]
    nb = -(-n // block)
    if nb <= 4 * k:  # prefilter smaller than its own overhead
        return jax.lax.top_k(flat, k)
    if nb * block != n:
        flat = jnp.concatenate(
            [flat, jnp.full((nb * block - n,), -jnp.inf, flat.dtype)])
    rows = flat.reshape(nb, block)
    bv, bi = jax.lax.top_k(rows.max(axis=1), k)
    cand = jnp.take(rows, bi, axis=0, indices_are_sorted=False)  # (k,block)
    cv, ci = jax.lax.top_k(cand.reshape(-1), k)
    gidx = bi[ci // block] * block + (ci % block)
    return cv, jnp.minimum(gidx, n - 1)


def topk_keypoints(
    response, k: int, threshold=0.0, nms_radius: int = 1, border: int = 0,
    size: float = 7.0,
) -> Keypoints:
    """Response map (H,W) -> top-k keypoints above threshold after NMS."""
    H, W = response.shape
    r = nms(response, nms_radius)
    if border > 0:
        row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        inside = (
            (row >= border) & (row < H - border) & (col >= border) & (col < W - border)
        )
        r = jnp.where(inside, r, -jnp.inf)
    flat = r.reshape(-1)
    vals, idx = topk_flat(flat, k)
    v = (idx // W).astype(jnp.float32)
    u = (idx % W).astype(jnp.float32)
    valid = vals > threshold
    return Keypoints(
        uv=jnp.stack([u, v], axis=-1),
        response=jnp.where(valid, vals, 0.0),
        size=jnp.full((k,), size, jnp.float32),
        angle=jnp.zeros((k,), jnp.float32),
        valid=valid,
    )


def apply_mask(kps: Keypoints, mask_img) -> Keypoints:
    """Restrict keypoints to a binary image mask (detector mask argument,
    reference src/GraphicEnd.h:105-111)."""
    H, W = mask_img.shape
    u = jnp.clip(jnp.round(kps.uv[:, 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(kps.uv[:, 1]).astype(jnp.int32), 0, H - 1)
    inside = mask_img[v, u]
    return kps._replace(valid=kps.valid & inside)


def sobel_gradients(img):
    """Sobel 3x3 dx, dy (OpenCV kernel, no scaling). img float32 (H,W)."""
    kx = jnp.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    ky = kx.T
    pad = jnp.pad(img, 1, mode="edge")
    dx = _conv2(pad, kx)
    dy = _conv2(pad, ky)
    return dx, dy


def _conv2(img, kernel):
    """Valid-mode 2D correlation of a small static kernel.

    A small stencil is unrolled into shifted multiply-adds over static
    slices — elementwise work that XLA fuses into one bandwidth-bound
    pass, where a 1-channel lax.conv would be a poor fit for the
    convolution libraries.
    """
    kh, kw = kernel.shape
    H = img.shape[0] - kh + 1
    W = img.shape[1] - kw + 1
    out = jnp.zeros((H, W), img.dtype)
    for dy in range(kh):
        for dx in range(kw):
            out = out + kernel[dy, dx] * jax.lax.slice(
                img, (dy, dx), (dy + H, dx + W)
            )
    return out


def box_filter(img, radius: int):
    """Mean filter over (2r+1)^2, edge-padded (separable shift-add)."""
    w = 2 * radius + 1
    pad = jnp.pad(img, ((radius, radius), (0, 0)), mode="edge")
    H = img.shape[0]
    s = jnp.zeros_like(img)
    for dy in range(w):
        s = s + jax.lax.slice(pad, (dy, 0), (dy + H, img.shape[1]))
    pad = jnp.pad(s, ((0, 0), (radius, radius)), mode="edge")
    W = img.shape[1]
    s = jnp.zeros_like(img)
    for dx in range(w):
        s = s + jax.lax.slice(pad, (0, dx), (img.shape[0], dx + W))
    return s / (w * w)


def gaussian_kernel1d(sigma: float, radius: int):
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float, radius: int | None = None):
    """Separable Gaussian blur, edge-padded (cv::GaussianBlur analog)."""
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    k = gaussian_kernel1d(sigma, radius)
    pad = jnp.pad(img, ((radius, radius), (0, 0)), mode="edge")
    img = _conv2(pad, k[:, None])
    pad = jnp.pad(img, ((0, 0), (radius, radius)), mode="edge")
    return _conv2(pad, k[None, :])
