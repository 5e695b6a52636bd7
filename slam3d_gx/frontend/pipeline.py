"""Jit-compiled per-frame compute: feature extraction and multiPnP.

The functional core of the frontend (SURVEY.md §7): everything here is
fixed-shape and jitted once per configuration; the host state machine in
graphic_end.py only reads back scalars and 4x4 poses.

Parity anchors:
- plane-frame extraction mirrors extractPlanesAndGenerateImage + per-plane
  extractKeypoints(image, mask) / extractDescriptor(_currRGB, kp) /
  compute3dPosition (reference src/GraphicEnd.cpp:128-134, 353-457);
  detection runs on the equalized masked plane image, descriptors on the
  full grayscale frame, exactly like the reference;
- image-frame extraction mirrors GraphicEnd2::extractKPandDesp +
  its zero-depth-dropping compute3dPosition (src/GraphicEnd2.cpp:203-233);
- multipnp_planes follows GraphicEnd::multiPnP step-for-step
  (src/GraphicEnd.cpp:557-659): plane match -> per-pair pnp inliers pooled
  -> global RANSAC(8px) -> inlier gate -> re-RANSAC(3px, extrinsic guess)
  -> norm gate; failure returns Identity (the caller's lost sentinel);
- multipnp_image follows GraphicEnd2::multiPnP (src/GraphicEnd2.cpp:235-312):
  single match -> RANSAC(8px) -> inlier gate -> norm2 gate, no second solve.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import CameraIntrinsics
from ..ops import imageproc, lie, match, plane_ransac, pnp, pointcloud
from ..ops.features import registry
from .state import FrameFeatures, MultiPnPResult

# point budget the plane-RANSAC stage decimates the cloud to (see
# build_plane_extractor); exported so cloud producers (readimage's voxel
# path) can size their fixed output capacity compatibly
PLANE_POINTS = 8192


# ---------------------------------------------------------------------------
# 3D backprojection of keypoints
# ---------------------------------------------------------------------------


def _kp_depths(depth, uv):
    """Raw depth at rounded keypoint pixels (reference compute3dPosition
    reads depth.at<ushort>(round(v), round(u)), src/GraphicEnd.cpp:438)."""
    H, W = depth.shape
    u = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, H - 1)
    return depth[v, u].astype(jnp.float32)


def compute_kp3d_plane(depth, uv, coeff, intr: CameraIntrinsics):
    """Pinhole backprojection; zero-depth keypoints fall back to the
    plane-ray intersection (reference src/GraphicEnd.cpp:440-455)."""
    d = _kp_depths(depth, uv)
    k1 = (uv[..., 0] - intr.cx) / intr.fx
    k2 = (uv[..., 1] - intr.cy) / intr.fy
    z_meas = d / intr.factor
    a, b, c, e = coeff[0], coeff[1], coeff[2], coeff[3]
    denom = a * k1 + b * k2 + c
    z_plane = -e / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
    z = jnp.where(d > 0, z_meas, z_plane)
    return jnp.stack([k1 * z, k2 * z, z], axis=-1), jnp.ones(uv.shape[:-1], bool)


def compute_kp3d_drop(depth, uv, intr: CameraIntrinsics):
    """GraphicEnd2 variant: zero-depth keypoints are dropped
    (src/GraphicEnd2.cpp:221-225)."""
    d = _kp_depths(depth, uv)
    z = d / intr.factor
    k1 = (uv[..., 0] - intr.cx) / intr.fx
    k2 = (uv[..., 1] - intr.cy) / intr.fy
    return jnp.stack([k1 * z, k2 * z, z], axis=-1), d > 0


# ---------------------------------------------------------------------------
# frame extraction
# ---------------------------------------------------------------------------


def build_plane_extractor(
    detector_name: str,
    descriptor_name: str,
    intr: CameraIntrinsics,
    max_planes: int = 3,
    max_kp: int = 512,
    dist_thresh: float = 0.08,
    percent: float = 0.2,
    hypotheses: int = 256,
    plane_points: int = PLANE_POINTS,
    z_max: float = 7.0,
    plane_image_mode: str = "membership",
    detect_scope: str = "frame",
    frame_kp_budget: int = 0,
) -> Callable:
    """Returns jitted extract(gray, depth, cloud_xyz, cloud_mask, key)
    -> FrameFeatures with P=max_planes.

    The RANSAC plane fit sees a strided decimation of the cloud
    (`plane_points` budget) — the reference's VoxelGrid served the same
    purpose (cheap uniform subsample before segmentation,
    src/GraphicEnd.cpp:287-295) but an exact voxel grid needs a
    300k-point sort per frame (`voxel_downsample_clouds` turns it on).

    plane_image_mode selects how each plane's coverage image is built
    (config key `plane_image_mode`): "membership" (default) computes it
    analytically at full resolution from the plane equation;
    "splat" reproduces the reference's point splatting with
    depth-adaptive blocks (src/GraphicEnd.cpp:390-420) from the
    decimated cloud's inlier sets — splat-vs-membership changes which
    pixels each detector sees, hence the escape hatch.

    detect_scope (config key `detect_scope`) is the biggest per-frame
    cost knob: "frame" (the default) equalizes + detects +
    describes ONCE on the full frame and assigns keypoints to planes by
    coverage-mask membership — one scale-space pyramid instead of
    max_planes of them; "plane" reproduces the reference exactly
    (per-plane equalizeHist + detection restricted to the plane image,
    src/GraphicEnd.cpp:128-134 + GraphicEnd.h:97-111), tripling the
    detector/descriptor work. The two differ in which pixels the
    detector sees (per-plane equalization stretches each plane's local
    contrast), so "plane" is kept as the parity escape hatch; quality
    parity of "frame" is tracked by benchmarks/quality_e2e.py.

    frame_kp_budget: global detection budget for "frame" scope
    (config key `frame_kp_budget`; 0 = max_kp). The default shares one
    max_kp pool across planes — 1.5x faster than per-plane budgets and
    trajectory quality is equal-or-better on the tracked benchmarks —
    but wide-baseline frames with many planes can starve a plane of
    keypoints; set max_planes*max_kp (or detect_scope: plane) for
    reference budget parity.
    """
    if plane_image_mode not in ("membership", "splat"):
        raise ValueError(f"plane_image_mode: {plane_image_mode!r}")
    if detect_scope not in ("frame", "plane"):
        raise ValueError(f"detect_scope: {detect_scope!r}")
    if detect_scope == "frame":
        global_detect = registry.create_detector(
            detector_name, frame_kp_budget or max_kp)
    else:
        detect = registry.create_detector(detector_name, max_kp)
    describe = registry.create_descriptor(descriptor_name)

    @jax.jit
    def extract(gray, depth, cloud_xyz, cloud_mask, key):
        n = cloud_xyz.shape[0]
        stride = max(1, n // plane_points)
        dxyz = cloud_xyz[::stride][:plane_points]
        dmask = cloud_mask[::stride][:plane_points]
        with jax.named_scope("plane_ransac"):
            coeffs, plane_masks, valids, _ = plane_ransac.extract_planes(
                dxyz, dmask, key,
                max_planes=max_planes, dist_thresh=dist_thresh,
                percent=percent, hypotheses=hypotheses,
            )

        xyz_img, valid_img = pointcloud.backproject(
            depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
        z = xyz_img[..., 2]
        valid_img = valid_img & (z > 0) & (z <= z_max)
        if plane_image_mode == "splat":
            H, W = gray.shape

            def splat_one(pmask, pv):
                return imageproc.splat_plane_image(
                    dxyz, pmask & pv, gray, intr.fx, intr.fy,
                    intr.cx, intr.cy, height=H, width=W)

            images, masks = jax.vmap(splat_one)(plane_masks, valids)
        else:
            with jax.named_scope("coverage"):
                images, masks = imageproc.plane_membership_images(
                    xyz_img, valid_img, coeffs, valids, gray, dist_thresh)

        if detect_scope == "frame":
            # ONE pyramid + ONE descriptor pass for the whole frame at
            # the full P*max_kp global budget; keypoints are assigned to
            # planes by coverage membership and each plane keeps its own
            # top-max_kp by response — per-plane capacity matches the
            # reference path exactly, but the scale-space pyramid (the
            # dominant SIFT frame cost) is built once instead of P times.
            P = coeffs.shape[0]
            with jax.named_scope("equalize"):
                eq = imageproc.equalize_hist(gray.astype(jnp.float32))
            with jax.named_scope("detect"):
                kps = global_detect(eq.astype(jnp.float32))
            with jax.named_scope("describe"):
                desc1 = describe(gray, kps)
            H, W = gray.shape
            ui = jnp.clip(jnp.round(kps.uv[:, 0]).astype(jnp.int32), 0, W - 1)
            vi = jnp.clip(jnp.round(kps.uv[:, 1]).astype(jnp.int32), 0, H - 1)
            in_plane = jax.vmap(lambda m: m[vi, ui])(masks)  # (P,Kg)

            def pick_plane(member_p, coeff_p, valid_p):
                score = jnp.where(member_p & kps.valid & valid_p,
                                  kps.response, -jnp.inf)
                # a budget below max_kp can't fill a plane's capacity:
                # take what exists and pad the rest invalid (the
                # starvation regime the frame_kp_budget sweep measures)
                k_eff = min(max_kp, score.shape[0])
                vals, idx = jax.lax.top_k(score, k_eff)
                # exact row gathers: a one-hot matmul at default
                # precision runs in TF32 on the GPU and rounds the
                # descriptors
                uv_p = kps.uv[idx]
                desc_p = desc1[idx]
                if k_eff < max_kp:
                    pad = max_kp - k_eff
                    vals = jnp.pad(vals, (0, pad),
                                   constant_values=-jnp.inf)
                    uv_p = jnp.pad(uv_p, ((0, pad), (0, 0)))
                    desc_p = jnp.pad(desc_p, ((0, pad), (0, 0)))
                kp3d_p, v3 = compute_kp3d_plane(depth, uv_p, coeff_p, intr)
                return uv_p, kp3d_p, desc_p, (vals > -jnp.inf) & v3

            uv, kp3d, desc, kpv = jax.vmap(pick_plane)(
                in_plane, coeffs, valids)
            return FrameFeatures(
                coeffs=coeffs,
                plane_valid=valids,
                uv=uv,
                kp3d=kp3d,
                desc=desc,
                kp_valid=kpv,
            )

        # parity path: per-plane work vmapped over the P axis — one
        # kernel chain instead of max_planes sequential copies
        def per_plane(img_p, mask_img, coeff_p, valid_p):
            img_p = imageproc.equalize_hist(img_p)
            kps = detect(img_p, mask_img)
            kps = kps._replace(valid=kps.valid & valid_p)
            desc = describe(gray, kps)
            kp3d, v3 = compute_kp3d_plane(depth, kps.uv, coeff_p, intr)
            return kps.uv, kp3d, desc, kps.valid & v3

        uv, kp3d, desc, kpv = jax.vmap(per_plane)(images, masks, coeffs, valids)
        return FrameFeatures(
            coeffs=coeffs,
            plane_valid=valids,
            uv=uv,
            kp3d=kp3d,
            desc=desc,
            kp_valid=kpv,
        )

    return extract


def build_image_extractor(
    detector_name: str,
    descriptor_name: str,
    intr: CameraIntrinsics,
    max_kp: int = 512,
) -> Callable:
    """GraphicEnd2 path: whole image = one pseudo-plane
    (reference src/GraphicEnd2.cpp:133,156,203-212)."""
    detect = registry.create_detector(detector_name, max_kp)
    describe = registry.create_descriptor(descriptor_name)

    @jax.jit
    def extract(gray, depth):
        kps = detect(gray)
        kp3d, has_depth = compute_kp3d_drop(depth, kps.uv, intr)
        kps = kps._replace(valid=kps.valid & has_depth)
        desc = describe(gray, kps)
        return FrameFeatures(
            coeffs=jnp.zeros((1, 4), jnp.float32),
            plane_valid=jnp.ones((1,), bool),
            uv=kps.uv[None],
            kp3d=kp3d[None],
            desc=desc[None],
            kp_valid=kps.valid[None],
        )

    return extract


# ---------------------------------------------------------------------------
# multiPnP
# ---------------------------------------------------------------------------


_IDENTITY = jnp.eye(4, dtype=jnp.float32)


def _finish(rvec, tvec, norm, inliers, accept):
    R = lie.rodrigues(rvec)
    T = lie.make_T(R, tvec)
    T = jnp.where(accept, T, _IDENTITY)
    return MultiPnPResult(T=T, norm=norm, inliers=inliers, ok=accept)


def build_multipnp_planes(
    intr: CameraIntrinsics,
    error_threshold: float = 1.0,
    hypotheses: int = 256,
    match_floor: float = 0.0,
    pooled_reproj: float = 8.0,
    refine_mode: str = "tiered",
) -> Callable:
    """GraphicEnd::multiPnP (src/GraphicEnd.cpp:557-659).

    minimum_inliers is a traced argument (12 normally, loop_closure_inliers
    for loop closure — reference src/GraphicEnd.h:134). match_floor: see
    ops/features/registry.match_floor (binary descriptors need > 0).
    pooled_reproj: px threshold of the pooled global RANSAC — 8.0 in the
    frontend (GraphicEnd.cpp:595); exp1_2's MatchingPlanar reads it from
    `ransac_accuracy` (exp1_2.cpp:465-467).

    refine_mode (config key `pnp_refine_mode`): "tiered" (default) skips
    the Gauss-Newton polish in the per-plane solves (only their inlier
    masks are consumed) and shortens it in the pooled solve (its pose
    only seeds the 3px refine) — same inlier sets, a shorter chain of
    dependent steps; "full" restores the uniform 10-iteration
    polish everywhere (round-1 behavior, matching cv::solvePnPRansac's
    always-refine) for marginal scenes where the acceptance count sits
    at the minimum_inliers boundary.
    """
    if refine_mode not in ("tiered", "full"):
        raise ValueError(f"refine_mode: {refine_mode!r}")
    plane_iters = 0 if refine_mode == "tiered" else 10
    pooled_iters = 4 if refine_mode == "tiered" else 10

    @jax.jit
    def multipnp(fa: FrameFeatures, fb: FrameFeatures, key, minimum_inliers):
        P, K = fa.uv.shape[0], fa.uv.shape[1]
        keys = jax.random.split(key, P + 2)

        # plane match by (a,b,c,d) coefficients (src/GraphicEnd.cpp:561)
        pidx, _, pvalid = match.match_planes(
            fa.coeffs, fa.plane_valid, fb.coeffs, fb.plane_valid
        )

        # per-plane-pair matching + pnp, vmapped over the P axis (one
        # batched kernel chain instead of P sequential RANSAC solves).
        # Only the inlier masks are consumed downstream (pooled into the
        # global solve, src/GraphicEnd.cpp:572-595), so the Gauss-Newton
        # polish is skipped here: best-of-B P3P inliers are equivalent
        # at the 8px gate and each GN iteration is a sequential chain of
        # small dependent ops.
        def per_plane(desc_a, kpv_a, obj, uv_b, desc_b, kpv_b, pv, k):
            midx, mdist, mok = match.match_nn(desc_a, kpv_a, desc_b, kpv_b)
            good = match.good_match_filter(mdist, mok, floor=match_floor) & pv
            img = match.gather_rows_onehot(midx, uv_b)
            res_p = pnp.solve_pnp_ransac(
                obj, img, good, intr.fx, intr.fy, intr.cx, intr.cy,
                k, reproj_thresh=8.0, hypotheses=hypotheses,
                refine_iters=plane_iters,
            )
            return img, res_p.inliers & res_p.ok

        img_p, w_p = jax.vmap(per_plane)(
            fa.desc, fa.kp_valid, fa.kp3d,
            fb.uv[pidx], fb.desc[pidx], fb.kp_valid[pidx],
            pvalid, keys[:P],
        )

        obj = fa.kp3d.reshape(P * K, 3)
        img = img_p.reshape(P * K, 2)
        pooled = w_p.reshape(P * K)

        # global RANSAC at pooled_reproj px (src/GraphicEnd.cpp:595).
        # Its pose only seeds the 3px refine solve below, so a short
        # polish suffices.
        res1 = pnp.solve_pnp_ransac(
            obj, img, pooled, intr.fx, intr.fy, intr.cx, intr.cy,
            keys[P], reproj_thresh=pooled_reproj, hypotheses=hypotheses,
            refine_iters=pooled_iters,
        )
        n1 = res1.n_inliers
        have_any = pooled.sum() >= 3

        # refine on inliers at 3px with extrinsic guess (src/GraphicEnd.cpp:615)
        res2 = pnp.solve_pnp_ransac(
            obj, img, res1.inliers, intr.fx, intr.fy, intr.cx, intr.cy,
            keys[P + 1], reproj_thresh=3.0, hypotheses=hypotheses,
            guess_rvec=res1.rvec, guess_tvec=res1.tvec,
        )

        rn = jnp.linalg.norm(res2.rvec)
        tn = jnp.linalg.norm(res2.tvec)
        norm = jnp.abs(jnp.minimum(rn, 2 * jnp.pi - rn)) + 0.9 * jnp.abs(tn)

        enough = (n1 >= minimum_inliers) & res1.ok & have_any
        small = norm <= error_threshold
        accept = enough & small & res2.ok
        # reference reports norm/inliers even when gated (result.norm set
        # before the threshold check, src/GraphicEnd.cpp:620-624)
        norm_out = jnp.where(enough, norm, 0.0)
        return _finish(res2.rvec, res2.tvec, norm_out, n1, accept)

    return multipnp


def build_multipnp_image(
    intr: CameraIntrinsics,
    error_threshold: float = 1.0,
    hypotheses: int = 256,
    match_floor: float = 0.0,
) -> Callable:
    """GraphicEnd2::multiPnP (src/GraphicEnd2.cpp:235-312): single plane,
    one RANSAC at 8px, inlier gate, norm2 formula, no second solve."""

    @jax.jit
    def multipnp(fa: FrameFeatures, fb: FrameFeatures, key, minimum_inliers):
        midx, mdist, mok = match.match_nn(
            fa.desc[0], fa.kp_valid[0], fb.desc[0], fb.kp_valid[0]
        )
        good = match.good_match_filter(mdist, mok, floor=match_floor)
        obj = fa.kp3d[0]
        img = match.gather_rows_onehot(midx, fb.uv[0])
        res = pnp.solve_pnp_ransac(
            obj, img, good, intr.fx, intr.fy, intr.cx, intr.cy,
            key, reproj_thresh=8.0, hypotheses=hypotheses,
        )
        rn = jnp.linalg.norm(res.rvec)
        tn = jnp.linalg.norm(res.tvec)
        norm = jnp.abs(jnp.minimum(rn, 2 * jnp.pi - rn) + tn)
        enough = (res.n_inliers >= minimum_inliers) & res.ok & (good.sum() > 0)
        accept = enough & (norm <= error_threshold)
        norm_out = jnp.where(enough, norm, 0.0)
        return _finish(res.rvec, res.tvec, norm_out, res.n_inliers, accept)

    return multipnp
