#!/usr/bin/env python3
"""Micro-profile inside solve_pnp_ransac: sampling / P3P / score+topk.

Times truncated variants of the batched per-plane solve at the sweep
shapes (192 solves, N=512, hyp=256) to localize the fixed per-solve
cost the N-independence of the macro profile points at.

Env: PROF_SOLVES (192), PROF_N (512), PROF_HYP (256), PROF_REPS (16),
     PROF_PLATFORM.
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
    S = int(os.environ.get("PROF_SOLVES", "192"))
    N = int(os.environ.get("PROF_N", "512"))
    hyp = int(os.environ.get("PROF_HYP", "256"))
    reps = int(os.environ.get("PROF_REPS", "16"))

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)
    from slam3d_gx.ops import pnp

    fx = fy = 517.0
    cx, cy = 318.6, 255.3
    log(f"pnp-solve profile: S={S} N={N} hyp={hyp} on "
        f"{jax.devices()[0].platform}")
    rng = np.random.default_rng(0)
    obj = rng.uniform(-1, 1, (S, N, 3)).astype(np.float32)
    obj[..., 2] += 3.0
    img = np.stack([obj[..., 0] / obj[..., 2] * fx + cx,
                    obj[..., 1] / obj[..., 2] * fy + cy],
                   axis=-1).astype(np.float32)
    obj = jnp.asarray(obj)
    img = jnp.asarray(img)
    mask = jnp.asarray(rng.uniform(size=(S, N)) < 0.9)

    def bearings(im):
        x = (im[:, 0] - cx) / fx
        y = (im[:, 1] - cy) / fy
        f = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    def sample_stage(o, im, m, key):
        logits = jnp.where(m, 0.0, -1e30)
        idx = jax.random.categorical(key, logits, shape=(hyp, 3))
        return o[idx].sum() + bearings(im)[idx].sum()

    def p3p_stage(o, im, m, key):
        logits = jnp.where(m, 0.0, -1e30)
        idx = jax.random.categorical(key, logits, shape=(hyp, 3))
        f = bearings(im)
        R, t, valid = pnp.p3p_grunert(o[idx], f[idx])
        return R.sum() + t.sum() + valid.sum()

    def full_stage(o, im, m, key):
        r = pnp.solve_pnp_ransac(o, im, m, fx, fy, cx, cy, key,
                                 reproj_thresh=8.0, hypotheses=hyp,
                                 refine_iters=0)
        return r.rvec.sum() + r.tvec.sum() + r.n_inliers

    variants = {
        "sample": jax.jit(jax.vmap(sample_stage)),
        "sample+p3p": jax.jit(jax.vmap(p3p_stage)),
        "full_solve(refine0)": jax.jit(jax.vmap(full_stage)),
    }

    import concurrent.futures as cf

    keys = jax.random.split(jax.random.PRNGKey(0), S)

    def warm(item):
        name, fn = item
        t0 = time.time()
        np.asarray(fn(obj, img, mask, keys))
        return name, time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=len(variants)) as ex:
        for name, dt in ex.map(warm, variants.items()):
            log(f"warm {name}: {dt:.1f}s")

    print(f"| variant | ms ({S} solves) | us/solve |")
    print("|---|---|---|")
    for name, fn in variants.items():
        best = np.inf
        for r in range(3):
            kk = jax.random.split(jax.random.PRNGKey(r + 1), S)
            t0 = time.time()
            for _ in range(reps):
                out = fn(obj, img, mask, kk)
            np.asarray(out)
            best = min(best, (time.time() - t0) / reps)
        print(f"| {name} | {best * 1e3:.2f} | {best * 1e6 / S:.1f} |",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
