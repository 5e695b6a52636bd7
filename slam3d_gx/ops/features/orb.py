"""ORB: oriented FAST + rotated BRIEF.

Parity target: cv::ORB as created by the reference's detector/descriptor
factories (swept in exp1_2 harnesses, reference exp1_2.py / exp1_2_time.py).
Pipeline parity with OpenCV's ORB_Impl:
- keypoints: (grid-)FAST with Harris-style ranking (fast.py);
- orientation: intensity centroid over a radius-15 circular patch
  (atan2(m01, m10), IC_Angle);
- descriptor: 256 pairwise intensity tests on a blurred image, with the
  test pattern rotated by the keypoint orientation.

Re-architecture (no data-dependent gathers on the hot path):
- the test pattern is OUR OWN deterministic pseudo-random pattern
  (seeded Gaussian pairs, sigma = patch/5, the distribution OpenCV's
  learned table was drawn from) — matching quality is equivalent, bits
  are not byte-identical to OpenCV's;
- rotation is discretized to 30 bins (12 deg, the granularity OpenCV
  uses for its pattern LUT); for each bin the 512 nearest-pixel sample
  taps become a STATIC one-hot matrix, so sampling every keypoint at
  every orientation is one (K,1024)x(1024, 30*512) matmul,
  and per-keypoint bin selection is an einsum against a one-hot of the
  bin index — no data-dependent gathers anywhere;
- bits are stored as float32 0/1, so brute-force L2 matching computes
  sqrt(Hamming) distances and the existing matcher stack (ops/match.py,
  the 3*min_dist filter) applies unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .common import Keypoints, gaussian_blur

_HI = jax.lax.Precision.HIGHEST

PATCH = 32          # sampling patch side (covers OpenCV's 31x31)
HALF = PATCH // 2
N_BITS = 256
N_BINS = 30         # orientation discretization (12 degrees)
ORI_RADIUS = 15     # intensity-centroid radius (OpenCV HARRIS_BLOCK..31/2)


def _make_pattern(seed: int = 7):
    """(512, 2) test-point offsets (pairs are rows 2i, 2i+1), clipped to
    the patch. Gaussian sigma = patch/5 like the BRIEF paper."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(2 * N_BITS, 2))
    return np.clip(pts, -(HALF - 2), HALF - 3)


_PATTERN = _make_pattern()


def _rotated_onehots():
    """(N_BINS, PATCH*PATCH, 2*N_BITS) static one-hot sampling matrices:
    column j of bin b selects the nearest patch pixel of pattern point j
    rotated by angle_b."""
    mats = np.zeros((N_BINS, PATCH * PATCH, 2 * N_BITS), np.float32)
    for b in range(N_BINS):
        a = 2 * np.pi * b / N_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = ca * _PATTERN[:, 0] - sa * _PATTERN[:, 1]
        ry = sa * _PATTERN[:, 0] + ca * _PATTERN[:, 1]
        ix = np.clip(np.round(rx).astype(int) + HALF, 0, PATCH - 1)
        iy = np.clip(np.round(ry).astype(int) + HALF, 0, PATCH - 1)
        mats[b, iy * PATCH + ix, np.arange(2 * N_BITS)] = 1.0
    return mats


_ONEHOTS = jnp.asarray(
    _rotated_onehots().reshape(N_BINS * PATCH * PATCH, 2 * N_BITS)
    .reshape(N_BINS, PATCH * PATCH, 2 * N_BITS)
)

# circular mask + per-pixel offsets for the intensity centroid
_YY, _XX = np.mgrid[0:PATCH, 0:PATCH]
_OFF_X = jnp.asarray((_XX - HALF).astype(np.float32))
_OFF_Y = jnp.asarray((_YY - HALF).astype(np.float32))
_CIRC = jnp.asarray(
    (((_XX - HALF) ** 2 + (_YY - HALF) ** 2) <= ORI_RADIUS**2).astype(np.float32)
)


def _extract_patches(img, uv):
    H, W = img.shape
    u0 = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32) - HALF, 0, W - PATCH)
    v0 = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32) - HALF, 0, H - PATCH)

    def one(v, u):
        return jax.lax.dynamic_slice(img, (v, u), (PATCH, PATCH))

    return jax.vmap(one)(v0, u0)


@functools.partial(jax.jit, static_argnames=())
def orb_descriptors(img, kps: Keypoints):
    """(K, 256) float32 descriptors with values in {0,1} (sqrt-Hamming
    under L2). Invalid keypoints get zeros."""
    x = gaussian_blur(img.astype(jnp.float32), 2.0)
    patches = _extract_patches(x, kps.uv)  # (K,P,P)

    # --- orientation: intensity centroid (IC_Angle) ----------------------
    w = patches * _CIRC[None]
    m10 = jnp.sum(w * _OFF_X[None], axis=(1, 2))
    m01 = jnp.sum(w * _OFF_Y[None], axis=(1, 2))
    angle = jnp.arctan2(m01, m10)  # [-pi, pi]
    bin_idx = jnp.round(
        jnp.mod(angle, 2 * jnp.pi) / (2 * jnp.pi) * N_BINS
    ).astype(jnp.int32) % N_BINS

    # --- rotated BRIEF: all bins via one matmul contraction ---------------
    flat = patches.reshape(-1, PATCH * PATCH)  # (K, 1024)
    # (K,1024) x (B,1024,512) -> (K,B,512)
    samples = jnp.einsum("kp,bps->kbs", flat, _ONEHOTS, precision=_HI)
    onehot_bin = jax.nn.one_hot(bin_idx, N_BINS, dtype=samples.dtype)
    sel = jnp.einsum("kbs,kb->ks", samples, onehot_bin, precision=_HI)
    p1 = sel[:, 0::2]
    p2 = sel[:, 1::2]
    bits = (p1 < p2).astype(jnp.float32)
    return jnp.where(kps.valid[:, None], bits, 0.0)
