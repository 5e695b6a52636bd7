#!/usr/bin/env python3
"""Frontend kernels on the device, at 640x480: times, step shares, and
the precision choices of the matcher.

Prints one JSON line (the last line of stdout) with:
- the plain XLA time of each image kernel the frontend runs per frame
  (equalize_hist with its histogram and LUT, the Shi-Tomasi response),
  next to the alternative forms a hand-written kernel would replace;
- the per-frame planar GFTT step (bench.py's frame_step) time, and each
  kernel's share of the step's device time from a jax.profiler trace
  (kernels are attributed through the op_name metadata of the compiled
  step's fusions, scoped with jax.named_scope in frontend/pipeline.py);
- compile and run time of solve_pnp_ransac with the quartic solver's
  loop rolled against unrolled by 4;
- descriptor-distance error at Precision.HIGH and HIGHEST against a
  float64 oracle, and the error of a default-precision one-hot gather.

Usage: frontend_kernels.py [out_dir]   (traces and the step's HLO are
written under out_dir, default $TMPDIR/frontend_kernels)
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, *args, reps: int = 50):
    """Median wall seconds of fn(*args) to completion, after one warm
    call (compilation excluded)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device_us(fn, *args, trace_dir: str, reps: int = 20) -> float:
    """Mean device time of fn(*args) in microseconds: the kernel events
    of a profiler trace of `reps` calls, divided by reps (host dispatch
    excluded)."""
    import jax

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(reps):
            jax.block_until_ready(fn(*args))
    events, _ = device_events(trace_dir)
    return sum(d for name, d in events
               if not name.startswith("Memcpy")) / reps / 1e3


def device_events(trace_dir: str):
    """(name, duration_ns) of the kernel events on the GPU device planes,
    and {line name: event count} of those planes. Only the per-stream
    lines are read: the derived lines ("XLA Ops", "XLA Modules") repeat
    the same time."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    out, lines = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("Stream"):
                out.extend((ev.name, ev.duration_ns) for ev in evs)
    return out, lines


# jax.named_scope names of the frontend step (frontend/pipeline.py,
# ops/imageproc.py, ops/features/harris.py); they nest, so a kernel
# can count toward several
SCOPES = ("plane_ransac", "coverage", "equalize", "histogram", "lut",
          "detect", "response", "describe")


def _kernel_key(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def scopes_of_kernels(hlo_text: str) -> dict:
    """Kernel name -> the SCOPES in its HLO instruction's op_name
    metadata (GPU kernel names are the instruction names with '.' and
    '-' replaced by '_')."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         hlo_text):
        parts = m.group(2).split("/")
        hit = [s for s in SCOPES if s in parts]
        if hit:
            out[_kernel_key(m.group(1))] = hit
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = argv[0] if argv else os.path.join(
        tempfile.gettempdir(), "frontend_kernels")
    os.makedirs(out_dir, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)
    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.frontend import pipeline
    from slam3d_gx.frontend.state import empty_frame
    from slam3d_gx.ops import imageproc, pnp, pointcloud, polynomial
    from slam3d_gx.ops.features import harris
    from slam3d_gx.testing import oracles, synthetic

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    res = {"platform": dev.platform, "device_kind": dev.device_kind}

    h, w = 480, 640
    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)
    scene = synthetic.RoomScene(seed=0)
    traj = synthetic.orbit_trajectory(8, radius=0.15, yaw_amp=0.08)
    frames = [synthetic.render_frame(scene, T, intr, h, w) for T in traj]
    gray = jnp.asarray(frames[0][0])
    depth = jnp.asarray(frames[0][1])

    # --- image kernels, plain forms and the alternatives -------------------
    img = gray.astype(jnp.int32)
    lut = jnp.asarray(np.sort(np.random.default_rng(0).integers(
        0, 256, 256)).astype(np.float32))
    bins = jnp.arange(256, dtype=jnp.int32)

    @jax.jit
    def hist_compare_reduce(v):
        return jnp.sum((v.reshape(-1)[None, :] == bins[:, None])
                       .astype(jnp.int32), axis=1)

    @jax.jit
    def lut_telescoping(v, table):
        d = jnp.diff(table, prepend=0.0)
        return jnp.sum((v[..., None] >= bins).astype(jnp.float32) * d,
                       axis=-1)

    def dev(name, fn, *args):
        return device_us(fn, *args, trace_dir=os.path.join(
            out_dir, "kernels", name))

    kernel_us = {
        "equalize_hist": dev("equalize_hist", imageproc.equalize_hist, gray),
        "histogram_scatter_add": dev(
            "hist_scatter", jax.jit(imageproc.histogram256), img),
        "histogram_compare_reduce": dev(
            "hist_compare", hist_compare_reduce, img),
        "lut_gather": dev("lut_gather", jax.jit(lambda v, t: t[v]), img, lut),
        "lut_telescoping": dev("lut_telescoping", lut_telescoping, img, lut),
        "min_eig_response": dev("min_eig", jax.jit(harris.min_eig_response),
                                gray.astype(jnp.float32)),
    }
    for k, v in kernel_us.items():
        log(f"{k}: {v:.2f} us device")
    res["kernel_device_us"] = {k: round(v, 3) for k, v in kernel_us.items()}

    # --- the per-frame planar GFTT step and its trace ------------------------
    extract = pipeline.build_plane_extractor(
        "GFTT", "SIFT", intr, max_planes=3, max_kp=512, hypotheses=256)
    multipnp = pipeline.build_multipnp_planes(intr, hypotheses=256)

    @jax.jit
    def frame_step(prev_feat, gray, depth, key):
        xyz, valid = pointcloud.backproject(
            depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
        xyz = xyz.reshape(-1, 3)
        valid = pointcloud.passthrough_z(xyz, valid.reshape(-1), 0.0, 7.0)
        k1, k2 = jax.random.split(key)
        feat = extract(gray.astype(jnp.float32), depth.astype(jnp.float32),
                       xyz, valid, k1)
        r = multipnp(prev_feat, feat, k2, jnp.int32(12))
        return feat, r.T

    f0 = empty_frame(3, 512, 128)
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    compiled = frame_step.lower(f0, gray, depth, key).compile()
    res["gfft_step_compile_s"] = round(time.time() - t0, 2)
    feat, _ = compiled(f0, gray, depth, key)
    step_s = timeit(compiled, feat, jnp.asarray(frames[1][0]),
                    jnp.asarray(frames[1][1]), key, reps=30)
    res["gfft_step_ms"] = round(step_s * 1e3, 3)
    log(f"GFTT planar step: {step_s * 1e3:.2f} ms "
        f"(compile {res['gfft_step_compile_s']} s)")

    trace_dir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(trace_dir):
        for i in range(5):
            jax.block_until_ready(compiled(feat, jnp.asarray(frames[2][0]),
                                           jnp.asarray(frames[2][1]), key))
    kernel_scopes = scopes_of_kernels(compiled.as_text())
    with open(os.path.join(out_dir, "gfft_step.hlo.txt"), "w") as f:
        f.write(compiled.as_text())
    events, lines = device_events(trace_dir)
    res["trace_lines"] = lines
    total = sum(d for _, d in events)
    per_scope = {s: 0 for s in SCOPES}
    per_kernel = {}
    for name, d in events:
        per_kernel[name] = per_kernel.get(name, 0) + d
        for s in kernel_scopes.get(_kernel_key(name), ()):
            per_scope[s] += d
    res["step_device_us"] = round(total / 5 / 1e3, 2)
    res["step_scope_share"] = {s: round(v / max(total, 1), 4)
                               for s, v in per_scope.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    res["step_top_kernels_us"] = [
        (n, round(d / 5 / 1e3, 2), kernel_scopes.get(_kernel_key(n)))
        for n, d in top]
    log(f"step device time {res['step_device_us']} us per step; shares "
        f"{res['step_scope_share']}")

    # --- quartic solver: rolled loop vs unroll 4 ------------------------------
    rng = np.random.default_rng(1)
    pw = jnp.asarray(rng.uniform(-1.5, 1.5, (1536, 3)) + [0, 0, 3.0],
                     jnp.float32)
    uv = jnp.asarray(rng.uniform(0, [w, h], (1536, 2)), jnp.float32)
    mask = jnp.ones(1536, bool)
    res["pnp"] = {}
    for unroll in (1, 4):
        jax.clear_caches()
        polynomial.UNROLL = unroll
        fn = jax.jit(lambda o, i, m, k: pnp.solve_pnp_ransac(
            o, i, m, intr.fx, intr.fy, intr.cx, intr.cy, k,
            reproj_thresh=8.0, hypotheses=256))
        t0 = time.time()
        c = fn.lower(pw, uv, mask, key).compile()
        comp = time.time() - t0
        run = timeit(c, pw, uv, mask, key, reps=30)
        run_dev = device_us(c, pw, uv, mask, key, trace_dir=os.path.join(
            out_dir, "kernels", f"pnp_unroll{unroll}"))
        q = jnp.asarray(oracles.quartic_cases("distinct", 4096, rng))
        qfn = jax.jit(lambda x: polynomial.quartic_roots(x))
        t0 = time.time()
        qc = qfn.lower(q).compile()
        qcomp = time.time() - t0
        qrun = timeit(qc, q)
        res["pnp"][f"unroll{unroll}"] = dict(
            solve_compile_s=round(comp, 3), solve_run_us=round(run * 1e6, 2),
            solve_device_us=round(run_dev, 2),
            quartic4096_compile_s=round(qcomp, 3),
            quartic4096_run_us=round(qrun * 1e6, 2))
        log(f"unroll {unroll}: solve_pnp_ransac compile {comp:.2f}s run "
            f"{run * 1e6:.1f} us ({run_dev:.1f} us device); quartic x4096 compile {qcomp:.2f}s run "
            f"{qrun * 1e6:.1f} us")
    polynomial.UNROLL = 1
    jax.clear_caches()

    # --- matcher precision on real descriptors --------------------------------
    # SIFT descriptors are integers in 0..255 (exact in TF32); SURF's are
    # unit-norm floats
    res["match"] = {}
    idx = jnp.asarray(np.random.default_rng(2).integers(0, 512, 512))
    onehot = jax.nn.one_hot(idx, 512, dtype=jnp.float32)
    for desc_name in ("SIFT", "SURF"):
        ext = pipeline.build_image_extractor("GFTT", desc_name, intr,
                                             max_kp=512)
        fa = ext(gray, depth)
        fb = ext(jnp.asarray(frames[3][0]), jnp.asarray(frames[3][1]))
        da, db = fa.desc[0], fb.desc[0]
        ref = oracles.l2_distance_matrix(np.asarray(da), np.asarray(db)) ** 2
        va, vb = np.asarray(fa.kp_valid[0]), np.asarray(fb.kp_valid[0])
        norms = ((np.asarray(da, np.float64) ** 2).sum(1)[:, None]
                 + (np.asarray(db, np.float64) ** 2).sum(1)[None, :])
        ref_idx = np.argmin(np.where(vb[None], ref, np.inf), axis=1)
        for prec in ("DEFAULT", "HIGH", "HIGHEST"):
            p = getattr(jax.lax.Precision, prec)

            @jax.jit
            def dist(a, b, p=p):
                aa = jnp.sum(a * a, axis=1, keepdims=True)
                bb = jnp.sum(b * b, axis=1, keepdims=True)
                return aa + bb.T - 2.0 * jnp.matmul(a, b.T, precision=p)

            d2 = np.asarray(dist(da, db), np.float64)
            got_idx = np.argmin(np.where(vb[None], d2, np.inf), axis=1)
            err = float((np.abs(d2 - ref) / np.maximum(norms, 1)).max())
            n_diff = int((va & (got_idx != ref_idx)).sum())
            t = dev(f"dist_{desc_name}_{prec}", dist, da, db)
            res["match"][f"{desc_name}_{prec}"] = dict(
                max_rel_err_d2=err, argmin_differs=n_diff,
                valid_queries=int(va.sum()), device_us=round(t, 3))
            log(f"{desc_name} distance {prec}: max |d2-ref|/(|a|^2+|b|^2) "
                f"{err:.3g}, {n_diff}/{int(va.sum())} argmin differ, "
                f"{t:.2f} us device")
        gathered = np.asarray(jax.jit(jnp.matmul)(onehot, da))
        exact = np.asarray(da)[np.asarray(idx)]
        gerr = np.abs(gathered - exact)
        res["match"][f"{desc_name}_onehot_default_gather"] = dict(
            max_abs_err=float(gerr.max()),
            rows_changed=int((gerr.max(1) > 0).sum()))
        log(f"{desc_name} one-hot default-precision gather: max abs err "
            f"{gerr.max():.3g}, rows changed {(gerr.max(1) > 0).sum()}/512")

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
