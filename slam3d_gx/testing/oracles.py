"""Plain numpy references for the frontend's image and matching kernels.

Each function restates the semantics of one jitted kernel without JAX,
so the tests (on the CPU) and `chip_smoke.py` (on the GPU) can compare
the compiled kernel against it at real widths.
"""

from __future__ import annotations

import numpy as np


def equalize_hist(image: np.ndarray) -> np.ndarray:
    """cv::equalizeHist on a uint8 image, in OpenCV's own arithmetic:
    float32 scale 255/(total - hist[first]), cvRound of sum*scale."""
    hist = np.bincount(image.reshape(-1), minlength=256)
    i0 = int(np.nonzero(hist)[0][0])
    total = image.size
    if hist[i0] == total:
        return image.copy()
    scale = np.float32(255.0) / np.float32(total - hist[i0])
    lut = np.zeros(256, np.uint8)
    s = 0
    for i in range(i0 + 1, 256):
        s += int(hist[i])
        lut[i] = np.clip(np.rint(np.float32(s) * scale), 0, 255)
    return lut[image]


def _edge_pad_correlate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    r = kernel.shape[0] // 2
    pad = np.pad(img, r, mode="edge")
    h, w = img.shape
    out = np.zeros_like(img)
    for dy in range(kernel.shape[0]):
        for dx in range(kernel.shape[1]):
            out += kernel[dy, dx] * pad[dy:dy + h, dx:dx + w]
    return out


def min_eig_response(img: np.ndarray, block_radius: int = 1) -> np.ndarray:
    """Shi-Tomasi response: smaller eigenvalue of the box-filtered 2x2
    structure tensor of 3x3 Sobel gradients (edge-replicated borders)."""
    x = np.asarray(img, np.float64)
    kx = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    dx = _edge_pad_correlate(x, kx)
    dy = _edge_pad_correlate(x, kx.T)
    w = 2 * block_radius + 1
    box = np.full((w, w), 1.0 / (w * w))
    sxx = _edge_pad_correlate(dx * dx, box)
    syy = _edge_pad_correlate(dy * dy, box)
    sxy = _edge_pad_correlate(dx * dy, box)
    return (sxx + syy) / 2 - np.sqrt(((sxx - syy) / 2) ** 2 + sxy**2)


def l2_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M,D),(N,D) -> (M,N) Euclidean distances, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))


# Bounds on the median and the 99th percentile of quartic_root_error per
# case kind. float32 resolves a root of multiplicity m only to
# ~eps^(1/m) (eps = 6e-8): ~1e-7 for simple roots, times their
# conditioning; 2.4e-4 for a double root; 4e-3 for a triple root.
QUARTIC_TOLERANCES = {
    "distinct": (1e-5, 1e-3),
    "complex_pairs": (1e-5, 1e-4),
    "double": (2e-3, 1e-2),
    "triple": (2e-2, 5e-2),
    "near_zero_leading": (1e-5, 1e-3),
}


def quartic_cases(kind: str, n: int, rng) -> np.ndarray:
    """(n,5) float32 coefficients [c4..c0] of quartics of one root kind
    (a key of QUARTIC_TOLERANCES)."""
    if kind == "near_zero_leading":
        # c4 ~ 1e-6: one root near 1e6 beside three of order one
        cubic = np.stack([np.poly(r) for r in rng.normal(size=(n, 3))])
        c4 = 1e-6 * rng.choice([-1.0, 1.0], size=(n, 1))
        return np.concatenate([c4, cubic], axis=1).astype(np.float32)
    a, b = rng.normal(size=(2, n))
    far = a + rng.choice([-1.0, 1.0], size=n) * rng.uniform(0.5, 2.0, n)
    if kind == "distinct":
        roots = rng.normal(size=(n, 4)) * 3
    elif kind == "complex_pairs":
        im = rng.uniform(0.1, 2.0, (n, 2))
        re = rng.normal(size=(n, 2))
        roots = np.concatenate([re + 1j * im, re - 1j * im], axis=1)
    elif kind == "double":
        roots = np.stack([a, a, b, far], axis=1)
    elif kind == "triple":  # the fourth root kept apart from the cluster
        roots = np.stack([a, a, a, far], axis=1)
    else:
        raise ValueError(f"unknown quartic case kind {kind!r}")
    scale = rng.uniform(0.5, 2.0, (n, 1))
    return (np.stack([np.real(np.poly(r)) for r in roots])
            * scale).astype(np.float32)


def quartic_root_error(coeffs: np.ndarray, roots: np.ndarray) -> np.ndarray:
    """Per-quartic worst distance, relative to 1 + |root|, between the
    roots np.roots finds and the given ones, paired greedily nearest
    first. coeffs (B,5) [c4..c0]; roots (B,4) complex. -> (B,)."""
    errs = np.zeros(len(coeffs))
    for b, (c, got) in enumerate(zip(coeffs, roots)):
        left = list(got)
        worst = 0.0
        for r in np.roots(np.asarray(c, np.float64)):
            d = [abs(r - x) for x in left]
            k = int(np.argmin(d))
            worst = max(worst, d[k] / (1.0 + abs(r)))
            left.pop(k)
        errs[b] = worst
    return errs
