"""Image-space kernels: plane-image splat, dilation, histogram equalization.

Parity targets:
- the plane image/mask splat of extractPlanesAndGenerateImage (reference
  src/GraphicEnd.cpp:397-416): each plane point projects through the
  pinhole and paints a (2*block+1)^2 square, block = int(-1.0*z + 10.0)
  clamped at 0, image = masked grayscale, mask = binary coverage;
- cv::equalizeHist (reference src/GraphicEnd.cpp:418).

The variable-radius splat is a scatter-max of the radius into
the pixel grid followed by a cascade of 3x3 max-pool dilations — radius-r
stamps appear after r pooling rounds, so a single sweep r=R_MAX..0 unions
all dilations in R_MAX pools instead of a per-point scatter loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# block = int(-1.0*z + 10.0) with z > 0, so the radius never exceeds 10
# (z -> 0). exp1_2 uses slope -1.2 (src/exp1/exp1_2.cpp:556) — same bound.
_R_MAX = 10


def _maxpool3(x):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )


@functools.partial(jax.jit, static_argnames=("height", "width"))
def splat_plane_image(
    xyz, mask, gray, fx, fy, cx, cy, height: int = 480, width: int = 640,
    block_slope: float = -1.0, block_offset: float = 10.0,
):
    """Project masked plane points and paint depth-adaptive squares.

    Returns (image uint8 (H,W), mask_img bool (H,W)): image is the
    grayscale frame under the coverage mask (zero elsewhere).
    """
    z = xyz[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = jnp.round(xyz[:, 0] * fx / safe_z + cx).astype(jnp.int32)
    v = jnp.round(xyz[:, 1] * fy / safe_z + cy).astype(jnp.int32)
    r = jnp.trunc(block_slope * z + block_offset).astype(jnp.int32)
    r = jnp.clip(r, 0, _R_MAX)

    # NB: the reference paints the square clipped to bounds even when the
    # center pixel is outside the image; centers more than R_MAX outside
    # can't contribute, so clamping to a 1-pixel border and keeping only
    # centers within [-R_MAX, dim+R_MAX) matches its behavior.
    in_reach = (
        mask
        & (z > 0)
        & (u >= -_R_MAX)
        & (u < width + _R_MAX)
        & (v >= -_R_MAX)
        & (v < height + _R_MAX)
    )
    # shrink radius by the overhang when clamping the center into bounds
    uc = jnp.clip(u, 0, width - 1)
    vc = jnp.clip(v, 0, height - 1)
    overhang = jnp.maximum(jnp.abs(u - uc), jnp.abs(v - vc))
    r_eff = r - overhang
    ok = in_reach & (r_eff >= 0)

    flat = vc * width + uc
    stamp = jnp.where(ok, r_eff + 1, 0)  # 0 = empty, k = radius k-1
    rmap = (
        jnp.zeros(height * width, dtype=jnp.int32)
        .at[flat]
        .max(stamp, mode="drop")
        .reshape(height, width)
    )

    acc = (rmap >= _R_MAX + 1).astype(jnp.float32)
    for rr in range(_R_MAX - 1, -1, -1):
        acc = jnp.maximum(_maxpool3(acc), (rmap >= rr + 1).astype(jnp.float32))
    mask_img = acc > 0.5
    image = jnp.where(mask_img, gray.astype(jnp.uint8), 0)
    return image, mask_img


@jax.jit
def plane_membership_images(xyz_img, valid_img, coeffs, plane_valid,
                            gray, dist_thresh):
    """Per-plane coverage masks computed analytically in image space.

    A replacement for the reference's point-splatting
    (src/GraphicEnd.cpp:390-430, which scatters voxelized plane inliers
    back into a 640x480 image with depth-adaptive blocks): a pixel
    belongs to plane p iff its backprojected 3D point lies within
    `dist_thresh` of the plane — dense elementwise math, no scatter —
    with earlier planes claiming pixels first (the reference removes
    inliers between iterations, ExtractIndices semantics).

    Args:
      xyz_img: (H,W,3) backprojected points; valid_img: (H,W) bool;
      coeffs: (P,4); plane_valid: (P,); gray: (H,W).
    Returns:
      images (P,H,W) uint8 (gray under mask), masks (P,H,W) bool.
    """
    dists = jnp.abs(
        jnp.tensordot(xyz_img, coeffs[:, :3], axes=((2,), (1,)))
        + coeffs[None, None, :, 3]
    )  # (H,W,P)
    member = (dists < dist_thresh) & valid_img[..., None] & plane_valid[None, None, :]
    # exclusive claim by plane order
    prior = jnp.cumsum(member.astype(jnp.int32), axis=-1) - member
    member = member & (prior == 0)
    masks = jnp.moveaxis(member, -1, 0)  # (P,H,W)
    images = jnp.where(masks, gray.astype(jnp.uint8)[None], 0)
    return images, masks


def histogram256(values):
    """256-bin histogram of integer values in [0, 255] (any shape)
    -> (256,) int32."""
    return jnp.zeros(256, jnp.int32).at[values.reshape(-1)].add(1)


@jax.jit
def equalize_hist(image):
    """cv::equalizeHist clone: 256-bin histogram -> CDF LUT.

    OpenCV semantics: the first non-empty bin maps to 0, the rest follow
    the cumulative histogram scaled by 255/(total - hist[first]) in
    float32 and rounded to nearest; a constant image is returned
    unchanged.
    """
    img = image.astype(jnp.int32)
    with jax.named_scope("histogram"):
        hist = histogram256(img)
    total = img.size
    nonzero = hist > 0
    i0 = jnp.argmax(nonzero)
    h0 = hist[i0]
    scale = jnp.float32(255.0) / jnp.maximum(total - h0, 1).astype(jnp.float32)
    csum = jnp.cumsum(hist)
    rel = (csum - csum[i0]).astype(jnp.float32)
    lut = jnp.clip(jnp.round(rel * scale), 0, 255)
    idx = jnp.arange(256)
    lut = jnp.where(idx <= i0, 0.0, lut).astype(jnp.uint8)
    with jax.named_scope("lut"):
        out = lut[img]
    # constant image: equalization is the identity
    constant = h0 == total
    return jnp.where(constant, image.astype(jnp.uint8), out)
