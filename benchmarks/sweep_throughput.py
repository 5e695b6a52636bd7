#!/usr/bin/env python3
"""Batched-registration throughput benchmark.

The reference's experiment program is a batch workload: exp1_2.py:19-27
registers 100 anchors x 19 offsets = 1900 independent pairs, one
process per pair. This phase runs the same exp1_2 protocol through the
DP layer (parallel/registration.BatchedRegistrar) as large fixed-shape
device batches:

- frames are extracted ONCE in one vmapped device program (batched
  frame extraction), then
- B pairs are registered as chunked vmapped multiPnP launches that are
  all dispatched before the single sync, with
- a larger hypothesis batch than the latency phase (512 vs 256).

Reports pairs/s (median over passes), batched-extraction FPS, and the
sweep's median translation error vs ground truth so throughput cannot
be bought with accuracy.

Usage: sweep_throughput.py [pairs]
Env: SWEEP_PAIRS (384), SWEEP_BATCH (chunk size, 128), SWEEP_MAXKP
     (512), SWEEP_HYP (512), SWEEP_FRAMES (16), SWEEP_DETECTOR (GFTT),
     SWEEP_DESCRIPTOR (SIFT), SWEEP_PASSES (3).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    n_pairs = int(argv[0]) if argv else int(
        os.environ.get("SWEEP_PAIRS", "384"))
    batch = int(os.environ.get("SWEEP_BATCH", "128"))
    max_kp = int(os.environ.get("SWEEP_MAXKP", "512"))
    hyp = int(os.environ.get("SWEEP_HYP", "512"))
    n_frames = int(os.environ.get("SWEEP_FRAMES", "16"))
    detector = os.environ.get("SWEEP_DETECTOR", "GFTT")
    descriptor = os.environ.get("SWEEP_DESCRIPTOR", "SIFT")
    n_passes = int(os.environ.get("SWEEP_PASSES", "3"))

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    log(f"compile cache: {compile_cache.enable(jax)}")

    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.frontend import pipeline
    from slam3d_gx.frontend.state import FrameFeatures
    from slam3d_gx.geometry import se3
    from slam3d_gx.ops import pointcloud
    from slam3d_gx.parallel import registration
    from slam3d_gx.testing import synthetic

    h, w = 480, 640
    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)
    n_planes = 3
    log(f"sweep: {n_pairs} pairs, chunk {batch}, {detector}/{descriptor} "
        f"max_kp={max_kp} hyp={hyp}, {n_frames} frames {w}x{h} "
        f"on {jax.devices()[0].platform}")

    # --- data ---------------------------------------------------------------
    scene = synthetic.RoomScene(seed=3)
    traj = synthetic.orbit_trajectory(n_frames, radius=0.25, yaw_amp=0.12)
    rng = np.random.default_rng(7)
    grays, depths = [], []
    for T in traj:
        g, d = synthetic.render_frame(scene, T, intr, h, w)
        g = np.clip(g.astype(np.float64) + rng.normal(0, 2.0, g.shape),
                    0, 255).astype(np.uint8)
        grays.append(g)
        depths.append(d.astype(np.uint16))
    grays_d = jnp.asarray(np.stack(grays))
    depths_d = jnp.asarray(np.stack(depths))

    # --- batched frame extraction (ONE vmapped program for all frames) ------
    extract = pipeline.build_plane_extractor(
        detector, descriptor, intr, max_planes=n_planes, max_kp=max_kp,
        hypotheses=hyp)

    def one(gray, depth, key):
        xyz, valid = pointcloud.backproject(
            depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
        xyz = xyz.reshape(-1, 3)
        valid = pointcloud.passthrough_z(xyz, valid.reshape(-1), 0.0, 7.0)
        return extract(gray.astype(jnp.float32), depth.astype(jnp.float32),
                       xyz, valid, key)

    batch_extract = jax.jit(jax.vmap(one))
    key = jax.random.PRNGKey(0)
    ekeys = jax.random.split(key, n_frames)

    # --- exp1_2-protocol pairs (anchors x offsets within the frame set) ----
    import random as _random
    prng = _random.Random(0)
    pairs = []
    while len(pairs) < n_pairs:
        a = prng.randrange(0, n_frames - 1)
        off = prng.randrange(1, min(8, n_frames - a))
        pairs.append((a, a + off))
    idx_a = jnp.asarray([p[0] for p in pairs], jnp.int32)
    idx_b = jnp.asarray([p[1] for p in pairs], jnp.int32)

    reg = registration.BatchedRegistrar(
        intr, image_only=False, error_threshold=1e9, hypotheses=hyp)

    gather = jax.jit(lambda f, i: jax.tree.map(lambda x: x[i], f))

    # --- warm both big programs concurrently (XLA compiles them in
    # parallel threads) --------------------------------------------------------
    import concurrent.futures as cf

    def warm_extract():
        t0 = time.time()
        f = batch_extract(grays_d, depths_d, ekeys)
        jax.block_until_ready(f.desc)
        return "batch-extract", time.time() - t0

    def warm_register():
        t0 = time.time()
        f0 = jax.tree.map(
            lambda s: jnp.zeros((batch,) + s.shape,
                                s.dtype) if hasattr(s, "shape") else s,
            FrameFeatures(
                coeffs=jnp.zeros((n_planes, 4), jnp.float32),
                plane_valid=jnp.zeros((n_planes,), bool),
                uv=jnp.zeros((n_planes, max_kp, 2), jnp.float32),
                kp3d=jnp.zeros((n_planes, max_kp, 3), jnp.float32),
                desc=jnp.zeros((n_planes, max_kp, 128), jnp.float32),
                kp_valid=jnp.zeros((n_planes, max_kp), bool)))
        keys = jax.random.split(jax.random.PRNGKey(1), batch)
        res = reg.fn(f0, f0, keys, jnp.int32(0))
        np.asarray(res.norm)
        return "batch-register", time.time() - t0

    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=2) as ex:
        for name, dt in ex.map(lambda f: f(), [warm_extract, warm_register]):
            log(f"warm {name}: {dt:.1f}s")
    first_step_s = time.time() - t0
    log(f"parallel warm total {first_step_s:.1f}s")

    # --- timed batched extraction -------------------------------------------
    t0 = time.time()
    feats = batch_extract(grays_d, depths_d, ekeys)
    np.asarray(feats.plane_valid)
    extract_dt = time.time() - t0
    extract_fps = n_frames / extract_dt
    log(f"batched extraction: {n_frames} frames in {extract_dt:.2f}s "
        f"-> {extract_fps:.1f} FPS")

    # --- timed registration passes (dispatch all chunks, sync once) --------
    from slam3d_gx.frontend.state import pack_result

    n_chunks = (n_pairs + batch - 1) // batch
    chunk_idx = []
    for c in range(n_chunks):
        sl = slice(c * batch, min((c + 1) * batch, n_pairs))
        ia = jnp.pad(idx_a[sl], (0, batch - (sl.stop - sl.start)))
        ib = jnp.pad(idx_b[sl], (0, batch - (sl.stop - sl.start)))
        chunk_idx.append((ia, ib, sl.stop - sl.start))

    # untimed pipeline warm: the chunk gather + pack programs compile on
    # their first use; one chunk through the full dispatch path keeps
    # that out of pass 0's rate
    _ia, _ib, _nv = chunk_idx[0]
    _keys = jax.random.split(jax.random.PRNGKey(9), batch)
    registration.resolve_async(
        [(pack_result(reg.fn(gather(feats, _ia), gather(feats, _ib),
                             _keys, jnp.int32(0))), _nv)])

    pass_rates, last_results = [], None
    for p_i in range(n_passes):
        kk = jax.random.split(jax.random.PRNGKey(10 + p_i), n_chunks)
        t0 = time.time()
        pending = []
        for c, (ia, ib, nv) in enumerate(chunk_idx):
            fa = gather(feats, ia)
            fb = gather(feats, ib)
            keys = jax.random.split(kk[c], batch)
            res = reg.fn(fa, fb, keys, jnp.int32(0))
            pending.append((pack_result(res), nv))
        results = registration.resolve_async(pending)  # syncs every chunk
        dt = time.time() - t0
        pass_rates.append(n_pairs / dt)
        last_results = results
        log(f"pass {p_i}: {n_pairs} pairs in {dt:.2f}s "
            f"-> {pass_rates[-1]:.0f} pairs/s")

    pairs_per_s = float(np.median(pass_rates))
    spread = (round((max(pass_rates) - min(pass_rates)) / pairs_per_s, 3)
              if len(pass_rates) > 1 else 0.0)

    # --- accuracy (throughput must not cost accuracy) ------------------------
    errs = []
    for (a, b), (T, norm, inl, ok) in zip(pairs, last_results):
        Tr = se3.inverse(traj[a]) @ traj[b]
        Terr = se3.inverse(Tr) @ se3.inverse(T)
        errs.append(float(np.linalg.norm(Terr[:3, 3])))
    errs = np.array(errs)
    med_err = float(np.median(errs))
    fail = float((errs > 0.25).mean())
    log(f"accuracy: median err_t {med_err:.4f} m, fail>0.25m {fail*100:.1f}%")

    print(json.dumps({
        "metric": "sweep_pairs_per_s",
        "value": round(pairs_per_s, 1),
        "unit": "pairs/sec",
        "pairs": n_pairs,
        "batch": batch,
        "hypotheses": hyp,
        "max_kp": max_kp,
        "detector": detector,
        "passes": [round(r, 1) for r in pass_rates],
        "pass_spread": spread,
        "extract_fps": round(extract_fps, 2),
        "median_err_t": round(med_err, 4),
        "fail_rate": round(fail, 4),
        "first_step_s": round(first_step_s, 1),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
