"""Detector/descriptor factory behind the reference's config names.

Parity surface: cv::FeatureDetector::create / DescriptorExtractor::create
(reference src/GraphicEnd.cpp:63-65). Name mapping:

  SIFT     -> DoG detector / SIFT descriptor (the parity defaults)
  SURF     -> fast-Hessian box-filter detector (surf.py) / real SURF-64
              descriptor (surf_desc.py: Haar-response sums over oriented
              4x4 subregions, unit-norm like cv::SURF). The name
              SURF_SIFT selects the 128-d SIFT descriptor on SURF
              keypoints instead (documented fallback: a quality superset
              of the 64-d Haar sums when descriptor power matters more
              than parity)
  GFTT     -> Shi-Tomasi; HARRIS -> Harris
  FAST     -> FAST-9/16; GridFAST -> grid-budgeted FAST
  STAR     -> CenSurE bi-level center-surround detector (star.py)
  ORB      -> grid FAST detector / rotated-BRIEF binary descriptor
              (orb.py; bits stored as 0/1 floats so L2 = sqrt Hamming)
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax.numpy as jnp

from . import dog, fast, harris, orb, sift_desc
from .common import Keypoints, apply_mask

DetectorFn = Callable[..., Keypoints]


def create_detector(name: str, max_kp: int = 512) -> DetectorFn:
    """Returns detect(img, mask=None) -> Keypoints."""
    key = name.strip().upper()

    if key == "SIFT":
        base = functools.partial(dog.detect_sift, max_kp=max_kp)
    elif key == "SURF":
        from . import surf

        base = functools.partial(surf.detect_surf, max_kp=max_kp)
    elif key == "STAR":
        from . import star

        base = functools.partial(star.detect_star, max_kp=max_kp)
    elif key == "GFTT":
        base = functools.partial(harris.detect_gftt, max_kp=max_kp)
    elif key == "HARRIS":
        base = functools.partial(harris.detect_gftt, max_kp=max_kp, use_harris=True)
    elif key == "FAST":
        base = functools.partial(fast.detect_fast, max_kp=max_kp)
    elif key in ("GRIDFAST", "ORB"):
        base = functools.partial(fast.detect_grid_fast, max_kp=max_kp)
    else:
        raise ValueError(f"unknown detector name: {name!r}")

    def detect(img, mask: Optional[jnp.ndarray] = None) -> Keypoints:
        kps = base(img)
        if mask is not None:
            kps = apply_mask(kps, mask)
        return kps

    return detect


def create_descriptor(name: str):
    """Returns describe(img, kps) -> (K,D) float32 descriptors."""
    key = name.strip().upper()
    if key in ("SIFT", "SURF_SIFT", "SURF-SIFT"):
        return sift_desc.sift_descriptors
    if key == "SURF":
        from . import surf_desc

        return surf_desc.surf_descriptors
    if key in ("ORB", "BRIEF"):
        return orb.orb_descriptors
    raise ValueError(f"unknown descriptor name: {name!r}")


def descriptor_dim(descriptor_name: str) -> int:
    """Descriptor vector length for a config name — the D of the (K,D)
    arrays create_descriptor's functions return. Used to pre-build
    shape-exact dummy features (compile warming, empty_frame)."""
    key = descriptor_name.strip().upper()
    if key == "SURF":
        return 64
    if key in ("ORB", "BRIEF"):
        return 256
    return 128


def match_floor(descriptor_name: str) -> float:
    """Distance floor for the 3*min_dist good-match gate.

    SIFT-family floats keep the reference's no-floor behavior (their
    min distance is never ~0 in practice). Binary descriptors (L2 =
    sqrt Hamming) need one: a single exact match collapses the bound to
    zero — the same degeneracy the reference's exp1 variant floors at
    5.0 (src/exp1/exp1.cpp:315-321)."""
    key = descriptor_name.strip().upper()
    if key in ("ORB", "BRIEF"):
        return 5.0
    return 0.0


def detect_and_describe(detector_name: str, descriptor_name: str, max_kp: int = 512):
    det = create_detector(detector_name, max_kp)
    desc = create_descriptor(descriptor_name)

    def run(img, mask=None):
        kps = det(img, mask)
        d = desc(img, kps)
        return kps, d

    return run
