#!/usr/bin/env python3
"""Reference-protocol pairwise registration sweep, batched on device.

Protocol parity: reference exp1_2.py:14-27 — 100 random anchors x
offsets 1..19, planar and normal modes, error rows in the
data/exp1/error.log schema. The reference spawns one process per pair
and re-extracts both frames every time; here every frame is extracted
ONCE and all registrations run as batched device programs
(parallel/registration.BatchedRegistrar), so the full 1900-pair x
2-mode protocol finishes in minutes instead of hours.

Usage: sweep_pairs.py [--frames N] [--anchors A] [--offsets K]
                      [--modes pn] [--detector D] [--out DIR]
Env: SWEEP_PLATFORM=cpu forces the CPU mesh (default: whatever JAX
picks — the GPU when available).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

if os.environ.get("SWEEP_PLATFORM"):
    import jax

    jax.config.update("jax_platforms", os.environ["SWEEP_PLATFORM"])

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def error_angle(T):
    return float(np.arccos(min(1.0, max(-1.0, (np.trace(T[:3, :3]) - 1) / 2))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--anchors", type=int, default=100)
    p.add_argument("--offsets", type=int, default=19)
    p.add_argument("--modes", default="pn")
    p.add_argument("--detector", default="GFTT")
    p.add_argument("--descriptor", default="SIFT")
    p.add_argument("--max-kp", type=int, default=256)
    p.add_argument("--hypotheses", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="./data/exp1")
    args = p.parse_args(argv)

    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.geometry import se3
    from slam3d_gx.frontend import pipeline
    from slam3d_gx.ops import pointcloud
    from slam3d_gx.parallel.registration import BatchedRegistrar
    from slam3d_gx.testing import synthetic

    h, w = 240, 320
    intr = CameraIntrinsics(fx=260.0, fy=260.0, cx=w / 2, cy=h / 2,
                            factor=5000.0)
    scene = synthetic.RoomScene(seed=3)
    traj = synthetic.orbit_trajectory(args.frames, radius=0.25, yaw_amp=0.12)
    key = jax.random.PRNGKey(args.seed)

    print(f"rendering {args.frames} frames ({w}x{h})...", flush=True)
    frames = [synthetic.render_frame(scene, T, intr, h, w) for T in traj]

    extractors = {}
    if "p" in args.modes:
        extractors["p"] = pipeline.build_plane_extractor(
            args.detector, args.descriptor, intr, max_kp=args.max_kp,
            hypotheses=args.hypotheses)
    if "n" in args.modes:
        extractors["n"] = pipeline.build_image_extractor(
            args.detector, args.descriptor, intr, max_kp=args.max_kp)

    feats = {m: [] for m in extractors}
    t0 = time.time()
    for gray, depth in frames:
        g = jnp.asarray(gray, jnp.float32)
        d = jnp.asarray(depth, jnp.float32)
        if "p" in extractors:
            xyz, valid = pointcloud.backproject(
                d, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
            xyz = xyz.reshape(-1, 3)
            valid = pointcloud.passthrough_z(
                xyz, valid.reshape(-1), 0.0, 7.0)
            key, sub = jax.random.split(key)
            feats["p"].append(extractors["p"](g, d, xyz, valid, sub))
        if "n" in extractors:
            feats["n"].append(extractors["n"](g, d))
    # force completion for honest timing
    for m in feats:
        np.asarray(feats[m][-1].desc)
    print(f"extracted {args.frames} frames x {len(feats)} modes "
          f"in {time.time() - t0:.1f}s", flush=True)

    rng = random.Random(args.seed)
    pairs = []
    for _ in range(args.anchors):
        a = rng.randrange(0, max(1, args.frames - args.offsets - 1))
        for off in range(1, args.offsets + 1):
            if a + off < args.frames:
                pairs.append((a, a + off))
    print(f"{len(pairs)} pairs per mode", flush=True)

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for m in extractors:
        reg = BatchedRegistrar(
            intr, image_only=(m == "n"), error_threshold=1e9,
            hypotheses=args.hypotheses,
            match_floor=5.0 if m == "n" else 0.0)
        t0 = time.time()
        key, sub = jax.random.split(key)
        results = reg([(feats[m][a], feats[m][b]) for a, b in pairs],
                      sub, min_inliers=0)
        dt = time.time() - t0
        # per-frame plane counts (one batched transfer): the
        # failure-mode classification below needs them (VERDICT r2 #9)
        pv = np.asarray(jnp.stack([f.plane_valid for f in feats[m]]))
        n_planes = pv.sum(axis=1).astype(int)
        rows = []
        for (a, b), (T, norm, inl, ok) in zip(pairs, results):
            Tr = se3.inverse(traj[a]) @ traj[b]
            Terr = se3.inverse(Tr) @ se3.inverse(T)
            rows.append((a + 1, b + 1, float(np.linalg.norm(Tr[:3, 3])),
                         error_angle(Tr), float(np.linalg.norm(Terr[:3, 3])),
                         error_angle(Terr), inl, b - a, int(bool(ok)),
                         int(n_planes[a]), int(n_planes[b])))
        # error.log schema (reference src/exp1/exp1_2.cpp:292-295) +
        # appended diagnostic columns: ok planes_a planes_b
        with open(os.path.join(args.out, f"error_sweep_{m}.log"), "w") as f:
            for r in rows:
                f.write(f"{r[0]} {r[1]} {r[2]:g} {r[3]:g} {r[4]:g} "
                        f"{r[5]:g} {r[6]} {r[8]} {r[9]} {r[10]}\n")
        print(f"mode {m}: {len(pairs)} registrations in {dt:.1f}s "
              f"({len(pairs) / dt:.0f} pairs/s)", flush=True)

        # offset table
        print(f"\n| offset | median err_t (m) | p90 err_t | fail>0.25m | "
              f"median inliers |  ({m} mode)")
        print("|---|---|---|---|---|")
        for off in range(1, args.offsets + 1):
            sel = [r for r in rows if r[7] == off]
            if not sel:
                continue
            errs = np.array([r[4] for r in sel])
            inls = np.array([r[6] for r in sel])
            print(f"| {off} | {np.median(errs):.4f} | "
                  f"{np.percentile(errs, 90):.4f} | "
                  f"{(errs > 0.25).mean() * 100:.1f}% | "
                  f"{np.median(inls):.0f} |", flush=True)
        errs = np.array([r[4] for r in rows])
        summary[m] = (float(np.median(errs)),
                      float((errs > 0.25).mean()), len(rows))

        # failure-mode breakdown (VERDICT r2 #9; the distinction the
        # reference's error.log + viewLC replay workflow existed to
        # make, src/exp1/exp1_2.cpp:292-295): a >0.25 m pair whose
        # pooled solve NEVER had enough support (not ok / inliers
        # below the frontend's 12 floor / a plane-starved frame) is a
        # no-overlap failure; one that passed the gates and still
        # missed is a genuine registration miss.
        fails = [r for r in rows if r[4] > 0.25]
        def _no_overlap(r):
            return (not r[8]) or r[6] < 12 or (
                m == "p" and min(r[9], r[10]) == 0)
        no_ov = [r for r in fails if _no_overlap(r)]
        missed = [r for r in fails if not _no_overlap(r)]
        if fails:
            line = (f"failures>0.25m ({m}): {len(fails)}/{len(rows)} "
                    f"({100 * len(fails) / len(rows):.1f}%) -> "
                    f"no-overlap {len(no_ov)}")
            if no_ov:
                line += (f" (median offset "
                         f"{np.median([r[7] for r in no_ov]):.0f}, "
                         f"median inliers "
                         f"{np.median([r[6] for r in no_ov]):.0f})")
            print(line, flush=True)
            if missed:
                print(f"  missed-registration {len(missed)} "
                      f"(median offset {np.median([r[7] for r in missed]):.0f}, "
                      f"median inliers {np.median([r[6] for r in missed]):.0f}, "
                      f"median err {np.median([r[4] for r in missed]):.3f} m)",
                      flush=True)
            else:
                print("  missed-registration 0", flush=True)
        print()
    for m, (med, fail, n) in summary.items():
        print(f"TOTAL {m}: {n} pairs, median err_t {med:.4f} m, "
              f"fail>0.25m {fail * 100:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
