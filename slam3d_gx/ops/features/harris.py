"""GFTT (Shi-Tomasi min-eigenvalue) and Harris corner detectors.

Parity target: cv::GFTTDetector as created by FeatureDetector::create("GFTT")
(reference sweeps it, exp1_2_time.py:24-37; OpenCV defaults maxCorners=1000,
qualityLevel=0.01, minDistance=1, blockSize=3). The quality gate is relative
to the image's max response, as in cv::goodFeaturesToTrack; minDistance is
enforced by the NMS pooling radius (grid-free, batched) instead of OpenCV's
sequential greedy pass — equivalent suppression at these settings.

Pure stencil ops (Sobel + box filter + eigenvalue closed form), fused by
XLA into a few elementwise passes over the image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import Keypoints, box_filter, sobel_gradients, topk_keypoints


def _structure_tensor(img, block_radius: int = 1):
    dx, dy = sobel_gradients(img)
    sxx = box_filter(dx * dx, block_radius)
    syy = box_filter(dy * dy, block_radius)
    sxy = box_filter(dx * dy, block_radius)
    return sxx, syy, sxy


def min_eig_response(img, block_radius: int = 1):
    """Shi-Tomasi: smaller eigenvalue of the 2x2 structure tensor."""
    sxx, syy, sxy = _structure_tensor(img, block_radius)
    tr_half = (sxx + syy) * 0.5
    det_part = jnp.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return tr_half - det_part


def harris_response(img, k: float = 0.04, block_radius: int = 1):
    sxx, syy, sxy = _structure_tensor(img, block_radius)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


@functools.partial(
    jax.jit, static_argnames=("max_kp", "use_harris", "nms_radius"))
def detect_gftt(
    img,
    max_kp: int = 512,
    quality_level: float = 0.01,
    use_harris: bool = False,
    harris_k: float = 0.04,
    nms_radius: int = 1,
) -> Keypoints:
    """img: (H,W) uint8/float. Returns fixed-capacity Keypoints."""
    x = img.astype(jnp.float32)
    with jax.named_scope("response"):
        if use_harris:
            resp = harris_response(x, harris_k)
        else:
            resp = min_eig_response(x)
    resp = jnp.clip(resp, 0.0, None)
    thresh = jnp.max(resp) * quality_level
    kps = topk_keypoints(resp, max_kp, threshold=0.0, nms_radius=nms_radius, border=2)
    return kps._replace(valid=kps.valid & (kps.response > thresh))
