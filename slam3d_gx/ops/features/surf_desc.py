"""SURF-64 descriptor + sliding-window orientation on arbitrary keypoints.

Parity target: cv::SURF descriptors (reference factory surface
DescriptorExtractor::create("SURF"), src/GraphicEnd.cpp:65 +
src/GraphicEnd.h:114-119), non-extended 64-d variant: per keypoint, a
20s x 20s oriented window split into 4x4 subregions; each subregion
contributes (sum dx, sum |dx|, sum dy, sum |dy|) of Gaussian-weighted
(sigma 3.3s) Haar-wavelet responses rotated into the dominant
orientation; the 64-vector is L2-normalized (OpenCV SURF leaves it unit
norm — no SIFT-style 512x saturation). Orientation is SURF's sliding
pi/3 window over Gaussian-weighted (sigma 2.5s) responses within
radius 6s.

Re-architecture: same patch strategy as sift_desc.py — one
contiguous (K, P, P) dynamic-slice per keypoint out of global response
maps, every weight computed *analytically* from patch coordinates
(dense elementwise math, no gathers). The Haar responses of size 2s are
approximated by the Gaussian-derivative responses of the shared
gradient maps: a Haar box pair is a first-derivative box filter, and at
these scales the smoothed central difference is within a few percent of
it (both frames see the same operator, so matching is unaffected).
Samples OpenCV would take outside the static PATCH window fall where
the Gaussian weight is negligible at the detector's default sizes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import Keypoints
from .sift_desc import _patch_data

D_SUB = 4        # subregions per axis
UNITS = 20.0     # descriptor window span in units of s (SURF: 20s)
DESC_SIGMA = 3.3  # Gaussian weight over the window, in units of s
ORI_SIGMA = 2.5   # orientation weight sigma, units of s
ORI_RADIUS = 6.0  # orientation support radius, units of s
ORI_WINDOWS = 36  # sliding-window centers (OpenCV steps 0.1 rad ~ 60;
                  # 36 keeps the same pi/3 coverage at 10 deg spacing)
ORI_HALF = jnp.pi / 6  # half-width of the pi/3 sliding window


def _unit_scale(size):
    """SURF scale s from the keypoint diameter.

    The fast-Hessian detector (surf.py) stores size = 6s (OpenCV SURF's
    drawn diameter convention); floor at 1/3 px so tiny keypoints keep a
    non-degenerate window.
    """
    return jnp.maximum(size / 6.0, 1.0 / 3.0)


def _orientation(mag, ori, rx, ry, s):
    """SURF dominant orientation: the pi/3 window of Gaussian-weighted
    response vectors with the largest resultant, swept over ORI_WINDOWS
    centers (SURF paper §3.2; cv::SURF invoker)."""
    sig = ORI_SIGMA * s
    r2 = rx * rx + ry * ry
    w = jnp.exp(-r2 / (2.0 * (sig * sig)[:, None]))
    w = jnp.where(r2 <= ((ORI_RADIUS * s) ** 2)[:, None], w, 0.0)
    vx = mag * jnp.cos(ori) * w  # (K, P^2) weighted response vectors
    vy = mag * jnp.sin(ori) * w

    centers = jnp.linspace(-jnp.pi, jnp.pi, ORI_WINDOWS, endpoint=False)
    sums_x = []
    sums_y = []
    for k in range(ORI_WINDOWS):
        d = jnp.abs(jnp.mod(ori - centers[k] + jnp.pi, 2 * jnp.pi) - jnp.pi)
        ind = d < ORI_HALF
        sums_x.append(jnp.sum(jnp.where(ind, vx, 0.0), axis=1))
        sums_y.append(jnp.sum(jnp.where(ind, vy, 0.0), axis=1))
    sx = jnp.stack(sums_x, axis=1)  # (K, W)
    sy = jnp.stack(sums_y, axis=1)
    best = jnp.argmax(sx * sx + sy * sy, axis=1)
    bx = jnp.take_along_axis(sx, best[:, None], axis=1)[:, 0]
    by = jnp.take_along_axis(sy, best[:, None], axis=1)[:, 0]
    return jnp.arctan2(by, bx)


def _descriptors(gdx, gdy, rx, ry, s, angles):
    """64-d SURF vector per keypoint from gradient patches.

    gdx/gdy/rx/ry: (K, P^2); s, angles: (K,).
    """
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    inv_s = (1.0 / s)[:, None]

    # patch coordinates in the rotated descriptor frame, units of s
    u = (rx * ca + ry * sa) * inv_s
    v = (-rx * sa + ry * ca) * inv_s

    # responses rotated into the frame, Gaussian-weighted about the kp
    g = jnp.exp(-(u * u + v * v) / (2.0 * DESC_SIGMA**2))
    dxr = (gdx * ca + gdy * sa) * g
    dyr = (-gdx * sa + gdy * ca) * g

    half = UNITS / 2.0
    sub = UNITS / D_SUB  # 5 units per subregion
    cells = []
    for iv in range(D_SUB):
        lo_v = -half + iv * sub
        ind_v = (v >= lo_v) & (v < lo_v + sub)
        for iu in range(D_SUB):
            lo_u = -half + iu * sub
            ind = ind_v & (u >= lo_u) & (u < lo_u + sub)
            dx_c = jnp.where(ind, dxr, 0.0)
            dy_c = jnp.where(ind, dyr, 0.0)
            cells.append(jnp.stack([
                jnp.sum(dx_c, axis=1),
                jnp.sum(jnp.abs(dx_c), axis=1),
                jnp.sum(dy_c, axis=1),
                jnp.sum(jnp.abs(dy_c), axis=1),
            ], axis=1))  # (K,4)
    desc = jnp.concatenate(cells, axis=1)  # (K,64), (v,u) row-major
    n = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    return desc / n


@functools.partial(jax.jit, static_argnames=("use_orientation",))
def surf_descriptors(img, kps: Keypoints, use_orientation: bool = True):
    """(K,64) float32 unit-norm SURF descriptors; invalid keypoints zero."""
    mag, ori, rx, ry = _patch_data(img, kps)
    s = _unit_scale(kps.size)
    angles = (
        _orientation(mag, ori, rx, ry, s)
        if use_orientation
        else jnp.zeros_like(kps.response)
    )
    gdx = mag * jnp.cos(ori)
    gdy = mag * jnp.sin(ori)
    desc = _descriptors(gdx, gdy, rx, ry, s, angles)
    return jnp.where(kps.valid[:, None], desc, 0.0)
