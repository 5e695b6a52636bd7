"""SIFT descriptor + orientation assignment on arbitrary keypoints.

Parity target: cv::SIFT descriptors (the reference's default descriptor,
parameters.yaml:9), including the OpenCV conventions that shape FLANN
distances downstream: 4x4 spatial bins x 8 orientations, Gaussian window,
0.2 clipping, renormalize, scale by 512 and saturate to [0,255].

Re-architecture: instead of random-access bilinear gathers, the
descriptor is computed the way OpenCV itself does — by iterating the *integer pixels* of
a window around the keypoint — but batched: one (K, P, P) patch slice out
of the global gradient maps per keypoint (vmapped dynamic_slice = efficient
contiguous-slice gather), then every weight (rotated spatial trilinear,
Gaussian window, orientation hat) is computed *analytically* from the
patch coordinates — dense elementwise math, no gathers — and the
histogram accumulation becomes 16 small batched matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .common import Keypoints, gaussian_blur, sobel_gradients

_HI = jax.lax.Precision.HIGHEST

D = 4        # spatial bins per axis
NBINS = 8    # orientation bins
SCL_FCTR = 3.0  # bin width = SCL_FCTR * scl (OpenCV SIFT_DESCR_SCL_FCTR)
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS_BINS = 3.0  # radius = 3 * 1.5 * scl
PATCH = 32   # static patch side; window pixels beyond it carry ~zero
             # Gaussian weight at the default keypoint sizes


def _grad_maps(img, blur_sigma: float = 1.6):
    x = gaussian_blur(img.astype(jnp.float32), blur_sigma)
    dx, dy = sobel_gradients(x)
    return dx, dy


def _patch_corners(uv, H, W):
    """Top-left integer corners, clamped so the patch stays in-bounds."""
    u0 = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32) - PATCH // 2,
                  0, W - PATCH)
    v0 = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32) - PATCH // 2,
                  0, H - PATCH)
    return u0, v0


def _extract_patches(maps, u0, v0):
    """maps (C,H,W), corners (K,) -> (K,C,PATCH,PATCH)."""

    def one(v, u):
        return jax.lax.dynamic_slice(
            maps, (0, v, u), (maps.shape[0], PATCH, PATCH))

    return jax.vmap(one)(v0, u0)


def _rel_offsets(uv, u0, v0):
    """Pixel offsets of each patch cell relative to the (float) keypoint.

    Returns rx, ry with shape (K, PATCH, PATCH).
    """
    lin = jnp.arange(PATCH, dtype=jnp.float32)
    rx = (u0[:, None].astype(jnp.float32) + lin[None, :]) - uv[:, 0:1]
    ry = (v0[:, None].astype(jnp.float32) + lin[None, :]) - uv[:, 1:2]
    return (jnp.broadcast_to(rx[:, None, :], (uv.shape[0], PATCH, PATCH)),
            jnp.broadcast_to(ry[:, :, None], (uv.shape[0], PATCH, PATCH)))


def _patch_data(img, kps: Keypoints):
    """Shared prep: gradient patches + relative offsets. All dense ops."""
    dx, dy = _grad_maps(img)
    H, W = img.shape
    u0, v0 = _patch_corners(kps.uv, H, W)
    patches = _extract_patches(jnp.stack([dx, dy]), u0, v0)
    gdx = patches[:, 0].reshape(-1, PATCH * PATCH)
    gdy = patches[:, 1].reshape(-1, PATCH * PATCH)
    rx, ry = _rel_offsets(kps.uv, u0, v0)
    rx = rx.reshape(-1, PATCH * PATCH)
    ry = ry.reshape(-1, PATCH * PATCH)
    mag = jnp.sqrt(gdx * gdx + gdy * gdy)
    ori = jnp.arctan2(gdy, gdx)  # [-pi, pi]
    return mag, ori, rx, ry


def _orientations_from_patch(mag, ori, rx, ry, size):
    """cv::SIFT calcOrientationHist on the patch: 36-bin Gaussian-weighted
    histogram within radius 3*1.5*scl, circular smoothing, parabolic peak."""
    scl = 0.5 * size  # (K,)
    sig = ORI_SIG_FCTR * scl
    radius = ORI_RADIUS_BINS * sig
    r2 = rx * rx + ry * ry
    w = jnp.exp(-r2 / (2.0 * (sig * sig)[:, None]))
    w = jnp.where(r2 <= (radius * radius)[:, None], w, 0.0)
    mw = mag * w

    binf = (ori + jnp.pi) / (2 * jnp.pi) * ORI_BINS  # [0, 36]
    hist = []
    for b in range(ORI_BINS):
        d = jnp.abs(jnp.mod(binf - b + ORI_BINS / 2, ORI_BINS) - ORI_BINS / 2)
        hist.append(jnp.sum(mw * jnp.maximum(0.0, 1.0 - d), axis=1))
    hist = jnp.stack(hist, axis=1)  # (K,36)

    # circular [1,4,6,4,1]/16 smoothing
    k = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    idx = (jnp.arange(ORI_BINS)[:, None] + jnp.arange(-2, 3)[None, :]) % ORI_BINS
    hist = jnp.sum(hist[:, idx] * k[None, None, :], axis=2)

    peak = jnp.argmax(hist, axis=1)
    gather = lambda off: jnp.take_along_axis(
        hist, ((peak + off) % ORI_BINS)[:, None], axis=1)[:, 0]
    l, c, r = gather(-1), gather(0), gather(1)
    denom = l - 2 * c + r
    off = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (l - r) / denom, 0.0)
    off = jnp.clip(off, -0.5, 0.5)
    return (peak.astype(jnp.float32) + off + 0.5) / ORI_BINS * 2 * jnp.pi - jnp.pi


@functools.partial(jax.jit, static_argnames=())
def compute_orientations(img, kps: Keypoints) -> jnp.ndarray:
    """Dominant gradient orientation per keypoint (radians)."""
    mag, ori, rx, ry = _patch_data(img, kps)
    return _orientations_from_patch(mag, ori, rx, ry, kps.size)


def _descriptors_from_patch(mag, ori, rx, ry, size, angles):
    """cv::SIFT calcSIFTDescriptor, batched: rotated bin coords and all
    interpolation weights computed analytically per patch pixel; the
    (spatial x orientation) histogram is accumulated with 16 batched
    (K,1,P^2)x(K,P^2,8) matmuls (one per spatial bin)."""
    scl = 0.5 * size
    hist_width = SCL_FCTR * scl  # (K,) pixels per spatial bin
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    inv_hw = (1.0 / hist_width)[:, None]

    # rotate offsets into the descriptor frame, in bin units
    cbin = (rx * ca + ry * sa) * inv_hw + (D / 2 - 0.5)
    rbin = (-rx * sa + ry * ca) * inv_hw + (D / 2 - 0.5)

    # Gaussian window over the descriptor (sigma = 0.5*D bins)
    gx = cbin - (D / 2 - 0.5)
    gy = rbin - (D / 2 - 0.5)
    gwin = jnp.exp(-(gx * gx + gy * gy) / (2 * (0.5 * D) ** 2))
    mw = mag * gwin  # (K, P^2)

    # orientation weights (K, P^2, 8): circular hat
    obinf = jnp.mod((ori - angles[:, None]) / (2 * jnp.pi) * NBINS, NBINS)
    wo = []
    for o in range(NBINS):
        d = jnp.abs(jnp.mod(obinf - o + NBINS / 2, NBINS) - NBINS / 2)
        wo.append(jnp.maximum(0.0, 1.0 - d))
    wo = jnp.stack(wo, axis=2)

    # spatial trilinear hats per axis, accumulated as ONE batched matmul
    # (K,16,P^2)x(K,P^2,8): 16 separate (K,1,P^2) matmuls each re-read
    # the 16 MB `wo` operand — ~270 MB of memory traffic for 67 MFLOPs;
    # stacking the spatial-bin weights reads it once
    ws = jnp.stack([
        jnp.maximum(0.0, 1.0 - jnp.abs(rbin - by)) * mw
        * jnp.maximum(0.0, 1.0 - jnp.abs(cbin - bx))
        for by in range(D) for bx in range(D)
    ], axis=1)  # (K,16,P^2)
    desc = jnp.matmul(ws, wo, precision=_HI).reshape(
        mag.shape[0], D * D * NBINS)  # (K,128), layout (by,bx,o)

    # OpenCV post-processing: L2 -> clip 0.2 -> L2 -> 512x saturate
    n = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    desc = jnp.clip(desc / n, 0.0, 0.2)
    n = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    return jnp.clip(jnp.round(desc / n * 512.0), 0.0, 255.0)


@functools.partial(jax.jit, static_argnames=("use_orientation",))
def sift_descriptors(img, kps: Keypoints, use_orientation: bool = True):
    """(K,128) float32 descriptors (OpenCV value convention: 512x, saturated).

    Invalid keypoints get zero descriptors.
    """
    mag, ori, rx, ry = _patch_data(img, kps)
    angles = (
        _orientations_from_patch(mag, ori, rx, ry, kps.size)
        if use_orientation
        else jnp.zeros_like(kps.response)
    )
    desc = _descriptors_from_patch(mag, ori, rx, ry, kps.size, angles)
    return jnp.where(kps.valid[:, None], desc, 0.0)
