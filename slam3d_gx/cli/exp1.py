"""exp1 frame1 frame2 detector descriptor p|n — pairwise registration
experiment with headless visual artifacts.

Parity target: reference src/exp1/exp1.cpp — the interactive sibling of
exp1_2 whose value-add is the visual output: drawMatches after the
pooled RANSAC (exp1.cpp:388), per-plane images (exp1.cpp:578-582), and
per-plane match/inlier match windows (exp1.cpp:674-682). This build
is headless-first (CLAUDE.md convention), so each imshow becomes a PNG
under data/exp1/:

  match_<f1>_<f2>.png        all good matches (full image, `n` mode)
  inliers_<f1>_<f2>.png      RANSAC inlier matches (`n` mode)
  plane_<f>_<p>.png          equalized masked plane image (`p` mode)
  plane_match_<f1>_<f2>_<p>.png    per-plane-pair good matches
  plane_inliers_<f1>_<f2>_<p>.png  per-plane-pair PnP inliers

The registration math and the error.log row are shared with exp1_2
(same accept gates; exp1's `n` mode uses the max(3*min_dist, 5.0)
floor, exp1.cpp:315-321).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ParameterReader
from ..geometry import se3
from ..io import images, tum
from ..ops import match as match_ops, pnp
from ..ops.features import registry
from ..frontend import pipeline
from ..utils import viz
from .exp1_2 import _load_cloud, error_angle


def _pairs_from(midx, sel):
    """(K,) NN targets + (K,) bool -> (M,2) index pairs."""
    src = np.nonzero(np.asarray(sel))[0]
    return np.stack([src, np.asarray(midx)[src]], axis=1) if len(src) else \
        np.zeros((0, 2), int)


def _plane_images_np(depth, gray, coeffs, valids, intr, dist_thresh, z_max):
    """Host-side recompute of the per-plane coverage images for dumping
    (the jitted extractor doesn't return them; this mirrors
    imageproc.plane_membership_images + equalize, off the hot path)."""
    h, w = depth.shape
    vv, uu = np.mgrid[0:h, 0:w]
    z = depth.astype(np.float32) / intr.factor
    x = (uu - intr.cx) * z / intr.fx
    y = (vv - intr.cy) * z / intr.fy
    valid = (z > 0) & (z <= z_max)
    claimed = np.zeros((h, w), bool)
    out = []
    for p in range(coeffs.shape[0]):
        if not valids[p]:
            out.append(None)
            continue
        a, b, c, d = coeffs[p]
        dist = np.abs(a * x + b * y + c * z + d)
        m = (dist < dist_thresh) & valid & ~claimed
        claimed |= m
        img = np.where(m, gray, 0).astype(np.uint8)
        out.append(img)
    return out


def main(argv=None) -> int:
    import jax

    from ..utils import compile_cache

    compile_cache.enable(jax)
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 5:
        print("usage: exp1 frame1 frame2 detector descriptor p/n")
        return -1
    f1_idx, f2_idx, detector, descriptor, mode = argv
    params = ParameterReader("./parameters.yaml")
    intr = params.intrinsics
    ds = params.GetPara("data_source")
    max_kp = params.get_int("max_keypoints")
    hypotheses = params.get_int("ransac_hypotheses")
    key = jax.random.PRNGKey(params.get_int("seed"))
    out_dir = "./data/exp1"
    os.makedirs(out_dir, exist_ok=True)

    gray1 = images.load_gray(os.path.join(ds, f"rgb_index/{f1_idx}.png"))
    gray2 = images.load_gray(os.path.join(ds, f"rgb_index/{f2_idx}.png"))
    dep1 = images.load_depth(os.path.join(ds, f"dep_index/{f1_idx}.png"))
    dep2 = images.load_depth(os.path.join(ds, f"dep_index/{f2_idx}.png"))

    rows = tum.read_associate(os.path.join(ds, "associate.txt"))
    T1 = se3.set_estimate_data(rows[int(f1_idx) - 1].pose)
    T2 = se3.set_estimate_data(rows[int(f2_idx) - 1].pose)
    Tr = se3.inverse(T1) @ T2

    if mode == "n":
        run = registry.detect_and_describe(detector, descriptor, max_kp)
        k1, d1 = run(jnp.asarray(gray1))
        k2, d2 = run(jnp.asarray(gray2))
        midx, mdist, mok = match_ops.match_nn(d1, k1.valid, d2, k2.valid)
        good = match_ops.good_match_filter(mdist, mok, floor=5.0)
        kp3d, has_depth = pipeline.compute_kp3d_drop(
            jnp.asarray(dep1), k1.uv, intr)
        good = good & has_depth
        res = pnp.solve_pnp_ransac(
            kp3d, k2.uv[midx], good, intr.fx, intr.fy, intr.cx, intr.cy,
            key, reproj_thresh=8.0, hypotheses=hypotheses)
        uv1, uv2 = np.asarray(k1.uv), np.asarray(k2.uv)
        images.save_gray(
            os.path.join(out_dir, f"match_{f1_idx}_{f2_idx}.png"),
            viz.draw_matches(gray1, uv1, gray2, uv2,
                             _pairs_from(midx, good)))
        images.save_gray(
            os.path.join(out_dir, f"inliers_{f1_idx}_{f2_idx}.png"),
            viz.draw_matches(gray1, uv1, gray2, uv2,
                             _pairs_from(midx, np.asarray(res.inliers))))
        from ..ops import lie
        T = np.asarray(lie.make_T(lie.rodrigues(res.rvec), res.tvec),
                       np.float64)
        T = se3.inverse(T)
        n_inl = int(res.n_inliers)
    elif mode == "p":
        z_max = params.get_float("optimize_step")  # reference config slip
        grid = params.get_float("grid_leaf")
        cap = params.get_int("cloud_capacity") or int(gray1.size)
        align = params.get_bool("align_cloud_scale")
        c1, m1 = _load_cloud(os.path.join(ds, f"pcd/{f1_idx}.pcd"),
                             z_max, grid, cap, dep1, intr, align)
        c2, m2 = _load_cloud(os.path.join(ds, f"pcd/{f2_idx}.pcd"),
                             z_max, grid, cap, dep2, intr, align)
        extract = pipeline.build_plane_extractor(
            detector, descriptor, intr,
            max_planes=params.get_int("max_planes"), max_kp=max_kp,
            dist_thresh=params.get_float("distance_threshold"),
            percent=params.get_float("plane_percent"),
            hypotheses=hypotheses)
        n_keys = params.get_int("max_planes") + 3
        keys = jax.random.split(key, n_keys)
        fa = extract(jnp.asarray(gray1, jnp.float32),
                     jnp.asarray(dep1, jnp.float32), c1, m1, keys[0])
        fb = extract(jnp.asarray(gray2, jnp.float32),
                     jnp.asarray(dep2, jnp.float32), c2, m2, keys[1])

        # plane images (exp1.cpp:578-582)
        dist_thresh = params.get_float("distance_threshold")
        for tag, gray, dep, f in (
            (f1_idx, gray1, dep1, fa), (f2_idx, gray2, dep2, fb)):
            planes = _plane_images_np(
                np.asarray(dep), np.asarray(gray),
                np.asarray(f.coeffs), np.asarray(f.plane_valid), intr,
                dist_thresh, z_max=7.0)
            for p, img in enumerate(planes):
                if img is not None:
                    images.save_gray(
                        os.path.join(out_dir, f"plane_{tag}_{p}.png"), img)

        # per-plane-pair matches + inliers (exp1.cpp:674-682)
        pidx, _, pvalid = match_ops.match_planes(
            fa.coeffs, fa.plane_valid, fb.coeffs, fb.plane_valid)
        for p in range(int(fa.coeffs.shape[0])):
            if not bool(np.asarray(pvalid)[p]):
                continue
            q = int(np.asarray(pidx)[p])
            midx, mdist, mok = match_ops.match_nn(
                fa.desc[p], fa.kp_valid[p], fb.desc[q], fb.kp_valid[q])
            good = match_ops.good_match_filter(mdist, mok)
            res_p = pnp.solve_pnp_ransac(
                fa.kp3d[p], fb.uv[q][midx], good,
                intr.fx, intr.fy, intr.cx, intr.cy, keys[2 + p],
                reproj_thresh=8.0, hypotheses=hypotheses)
            uva = np.asarray(fa.uv[p])
            uvb = np.asarray(fb.uv[q])
            images.save_gray(
                os.path.join(out_dir,
                             f"plane_match_{f1_idx}_{f2_idx}_{p}.png"),
                viz.draw_matches(gray1, uva, gray2, uvb,
                                 _pairs_from(midx, good)))
            images.save_gray(
                os.path.join(out_dir,
                             f"plane_inliers_{f1_idx}_{f2_idx}_{p}.png"),
                viz.draw_matches(gray1, uva, gray2, uvb,
                                 _pairs_from(midx, np.asarray(res_p.inliers))))

        mp = pipeline.build_multipnp_planes(
            intr, error_threshold=1e9, hypotheses=hypotheses,
            pooled_reproj=params.get_float("ransac_accuracy"))
        res = mp(fa, fb, keys[n_keys - 1], 0)
        T = se3.inverse(np.asarray(res.T, np.float64))
        n_inl = int(res.inliers)
    else:
        return -1

    Terr = se3.inverse(Tr) @ T
    err_trans = float(np.linalg.norm(Terr[:3, 3]))
    err_rot = error_angle(Terr)
    gt_trans = float(np.linalg.norm(Tr[:3, 3]))
    gt_rot = error_angle(Tr)
    print(f"error: {err_trans}, {err_rot}")
    with open(os.path.join(out_dir, "error.log"), "a") as f:
        f.write(f"{f1_idx} {f2_idx} {gt_trans:g} {gt_rot:g} "
                f"{err_trans:g} {err_rot:g} {n_inl}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
