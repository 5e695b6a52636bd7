#!/usr/bin/env python3
"""Device-true stage profile of the BATCHED multiPnP program.

Times truncated variants of the vmapped plane-mode multiPnP (the
sweep-throughput hot program) on identical (B, P, K) batch shapes:

  match      — per-plane NN match + good-match filter only
  plane_pnp  — + per-plane solve_pnp_ransac (8px)
  pooled     — + pooled global RANSAC (8px)
  full       — + 3px extrinsic-guess refine (the deployed program)

Successive differences localize the chunk cost. Input data is random
with realistic validity masks — every stage is fixed-shape, so runtime
is data-independent.

Usage: profile_multipnp.py
Env: PROF_BATCH (64), PROF_MAXKP (512), PROF_HYP (256), PROF_REPS (8),
     PROF_PLATFORM (cpu forces CPU).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

if os.environ.get("PROF_PLATFORM"):
    import jax

    jax.config.update("jax_platforms", os.environ["PROF_PLATFORM"])


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    B = int(os.environ.get("PROF_BATCH", "64"))
    K = int(os.environ.get("PROF_MAXKP", "512"))
    hyp = int(os.environ.get("PROF_HYP", "256"))
    reps = int(os.environ.get("PROF_REPS", "8"))
    P = 3

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)

    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.frontend.state import FrameFeatures
    from slam3d_gx.ops import match, pnp

    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)
    log(f"profile: B={B} P={P} K={K} hyp={hyp} "
        f"on {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)

    def mk_feat():
        kp3d = rng.uniform(-1, 1, (B, P, K, 3)).astype(np.float32)
        kp3d[..., 2] += 3.0
        uv = np.stack([
            kp3d[..., 0] / kp3d[..., 2] * intr.fx + intr.cx,
            kp3d[..., 1] / kp3d[..., 2] * intr.fy + intr.cy,
        ], axis=-1).astype(np.float32)
        return FrameFeatures(
            coeffs=jnp.asarray(
                rng.normal(size=(B, P, 4)).astype(np.float32)),
            plane_valid=jnp.ones((B, P), bool),
            uv=jnp.asarray(uv),
            kp3d=jnp.asarray(kp3d),
            desc=jnp.asarray(
                rng.normal(size=(B, P, K, 128)).astype(np.float32)),
            kp_valid=jnp.asarray(rng.uniform(size=(B, P, K)) < 0.9),
        )

    fa, fb = mk_feat(), mk_feat()

    def match_stage(a: FrameFeatures, b: FrameFeatures, key):
        def per_plane(desc_a, kpv_a, uv_b, desc_b, kpv_b):
            midx, mdist, mok = match.match_nn(desc_a, kpv_a, desc_b, kpv_b)
            good = match.good_match_filter(mdist, mok)
            return uv_b[midx], good

        return jax.vmap(per_plane)(
            a.desc, a.kp_valid, b.uv, b.desc, b.kp_valid)

    def plane_pnp_stage(a, b, key):
        img_p, good_p = match_stage(a, b, key)
        keys = jax.random.split(key, P)

        def solve(obj, img, good, k):
            r = pnp.solve_pnp_ransac(
                obj, img, good, intr.fx, intr.fy, intr.cx, intr.cy, k,
                reproj_thresh=8.0, hypotheses=hyp, refine_iters=0)
            return img, r.inliers & r.ok

        return jax.vmap(solve)(a.kp3d, img_p, good_p, keys)

    def pooled_stage(a, b, key):
        img_p, w_p = plane_pnp_stage(a, b, key)
        obj = a.kp3d.reshape(P * K, 3)
        img = img_p.reshape(P * K, 2)
        pooled = w_p.reshape(P * K)
        r = pnp.solve_pnp_ransac(
            obj, img, pooled, intr.fx, intr.fy, intr.cx, intr.cy,
            jax.random.fold_in(key, 7), reproj_thresh=8.0,
            hypotheses=hyp, refine_iters=4)
        return r.rvec, r.tvec, r.inliers

    def full_stage(a, b, key):
        img_p, w_p = plane_pnp_stage(a, b, key)
        obj = a.kp3d.reshape(P * K, 3)
        img = img_p.reshape(P * K, 2)
        pooled = w_p.reshape(P * K)
        r1 = pnp.solve_pnp_ransac(
            obj, img, pooled, intr.fx, intr.fy, intr.cx, intr.cy,
            jax.random.fold_in(key, 7), reproj_thresh=8.0,
            hypotheses=hyp, refine_iters=4)
        r2 = pnp.solve_pnp_ransac(
            obj, img, r1.inliers, intr.fx, intr.fy, intr.cx, intr.cy,
            jax.random.fold_in(key, 8), reproj_thresh=3.0,
            hypotheses=hyp, guess_rvec=r1.rvec, guess_tvec=r1.tvec)
        return r2.rvec, r2.tvec, r2.n_inliers

    stages = {}
    for name, fn in [("match", match_stage), ("plane_pnp", plane_pnp_stage),
                     ("pooled", pooled_stage), ("full", full_stage)]:
        stages[name] = jax.jit(jax.vmap(fn, in_axes=(0, 0, 0)))

    # warm all four concurrently (XLA compiles them in parallel threads)
    import concurrent.futures as cf

    def warm(item):
        name, fn = item
        t0 = time.time()
        keys = jax.random.split(jax.random.PRNGKey(0), B)
        out = fn(fa, fb, keys)
        np.asarray(jax.tree.leaves(out)[0])
        return name, time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        for name, dt in ex.map(warm, stages.items()):
            log(f"warm {name}: {dt:.1f}s")

    print(f"| stage | ms/chunk(B={B}) | ms/pair | delta ms/pair |")
    print("|---|---|---|---|")
    prev = 0.0
    for name, fn in stages.items():
        best = np.inf
        for r in range(3):
            keys = jax.random.split(jax.random.PRNGKey(r + 1), B)
            t0 = time.time()
            for i in range(reps):
                out = fn(fa, fb, jax.vmap(
                    lambda k: jax.random.fold_in(k, i))(keys))
            np.asarray(jax.tree.leaves(out)[0])
            best = min(best, (time.time() - t0) / reps)
        ms = best * 1e3
        print(f"| {name} | {ms:.1f} | {ms / B:.3f} | "
              f"{(ms - prev) / B:.3f} |", flush=True)
        prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
