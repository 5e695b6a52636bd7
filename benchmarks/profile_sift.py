#!/usr/bin/env python3
"""Device-true stage profile of the SIFT detect+describe path.

VERDICT r4 #3: the reference-default config (SIFT, parameters.yaml:8-9)
steps at ~59% of the GFTT headline and the remaining ~4 ms had never
been localized. Times truncated variants of ops/features/dog.detect_sift
(640x480, max_kp=512) plus the descriptor:

  pyramid  — per-octave Gaussian stacks + DoG differences only
  extrema  — + 3x3x3 reduce-window extrema + contrast/edge masks
  topk     — + per-octave lax.top_k over the (L,h,w) stack
  detect   — full detect_sift (adds subpixel gather, merge, final topk)
  describe — + sift_descriptors at the detected keypoints (the deployed
             detect_and_describe composition)

Successive differences localize the cost. Shapes are fixed, runtime is
data-independent; reps are dispatched back-to-back and synced once
(the device runs enqueued programs back to back, hiding host gaps).

Usage: profile_sift.py
Env: PROF_MAXKP (512), PROF_REPS (16), PROF_PLATFORM (cpu forces CPU).
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
    max_kp = int(os.environ.get("PROF_MAXKP", "512"))
    reps = int(os.environ.get("PROF_REPS", "16"))
    n_octaves = 4

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)

    from slam3d_gx.ops.features import dog, sift_desc
    from slam3d_gx.testing import synthetic
    from slam3d_gx.config import CameraIntrinsics

    log(f"profile: 640x480 max_kp={max_kp} "
        f"on {jax.devices()[0].platform}")

    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)
    scene = synthetic.RoomScene(seed=3)
    T = synthetic.orbit_trajectory(4, radius=0.25)[1]
    gray, _ = synthetic.render_frame(scene, T, intr, 480, 640)
    rng = np.random.default_rng(0)
    gray = np.clip(gray.astype(np.float64)
                   + rng.normal(0, 2.0, gray.shape), 0, 255)
    img = jnp.asarray(gray.astype(np.float32))

    # --- truncated variants of detect_sift's internals -------------------
    def octave_stacks(x):
        """Replicates detect_sift's pyramid loop; yields per-octave DoG."""
        inc = max(dog.SIGMA0**2 - dog.INIT_BLUR**2, 0.01) ** 0.5
        base = dog.gaussian_blur(x / 255.0, inc)
        out = []
        for _ in range(n_octaves):
            gs = dog._octave_gaussians(base, dog.N_LAYERS + 3)
            d = jnp.stack([gs[i + 1] - gs[i]
                           for i in range(dog.N_LAYERS + 2)])
            out.append(d)
            base = dog._downsample2(gs[dog.N_LAYERS])
        return out

    def pyramid_stage(x):
        return [d.sum() for d in octave_stacks(x)]

    def resp_stacks(x):
        thr = 0.5 * dog.CONTRAST_THR / dog.N_LAYERS
        outs = []
        for d in octave_stacks(x):
            ext = dog._extrema_mask(d)
            h, w = d.shape[1], d.shape[2]
            rs = jnp.stack([
                jnp.where(
                    ext[i] & (jnp.abs(d[i]) > thr) & dog._edge_ok(d[i]),
                    jnp.abs(d[i]), -jnp.inf)
                for i in range(1, dog.N_LAYERS + 1)])
            row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
            inside = ((row >= 4) & (row < h - 4)
                      & (col >= 4) & (col < w - 4))
            outs.append(jnp.where(inside[None], rs, -jnp.inf))
        return outs

    def extrema_stage(x):
        return [r.max() for r in resp_stacks(x)]

    def topk_stage(x):
        outs = []
        for r in resp_stacks(x):
            vals, idx = jax.lax.top_k(r.reshape(-1), max_kp)
            outs.append((vals.sum(), idx.max()))
        return outs

    def detect_stage(x):
        k = dog.detect_sift(x, max_kp=max_kp, n_octaves=n_octaves)
        return k.uv.sum(), k.valid.sum()

    def describe_stage(x):
        k = dog.detect_sift(x, max_kp=max_kp, n_octaves=n_octaves)
        d = sift_desc.sift_descriptors(x, k)
        return d.sum(), k.valid.sum()

    stages = {
        "pyramid": jax.jit(pyramid_stage),
        "extrema": jax.jit(extrema_stage),
        "topk": jax.jit(topk_stage),
        "detect": jax.jit(detect_stage),
        "describe": jax.jit(describe_stage),
    }

    # warm all concurrently (XLA compiles them in parallel threads)
    import concurrent.futures as cf

    def warm(item):
        name, fn = item
        t0 = time.time()
        out = fn(img)
        np.asarray(jax.tree.leaves(out)[0])
        return name, time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=len(stages)) as ex:
        for name, dt in ex.map(warm, stages.items()):
            log(f"warm {name}: {dt:.1f}s")

    print(f"| stage | ms/frame | delta ms |")
    print("|---|---|---|")
    prev = 0.0
    for name, fn in stages.items():
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            for _ in range(reps):
                out = fn(img)
            np.asarray(jax.tree.leaves(out)[0])
            best = min(best, (time.time() - t0) / reps)
        ms = best * 1e3
        print(f"| {name} | {ms:.2f} | {ms - prev:.2f} |", flush=True)
        prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
