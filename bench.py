"""Frontend throughput benchmark on one device.

Four phases, each in its own subprocess, run one after another (a JAX
process reserves most of the card's memory, so two at once would fail):

1. step/GFTT  — steady-state jitted per-frame frontend FPS (backproject
   -> z-filter -> plane RANSAC -> coverage images -> keypoints ->
   descriptors -> multiPnP) at 640x480, GFTT detector.
2. step/SIFT  — same protocol with the reference's default detector
   (reference parameters.yaml:8-9).
3. streaming  — the deployed `run_SLAM_streaming` wall rate at chunk=32
   on a disk dataset (benchmarks/streaming_wall.py protocol): host PNG
   decode + upload + chunked on-device tracking + loop closure + logs.
4. sweep      — the reference's exp1_2 batch-registration protocol as
   large fixed-shape device batches (benchmarks/sweep_throughput.py),
   in pairs/s.

Prints one JSON line. A phase that fails or times out is listed under
`failed_phases` with a null value, and the exit code is then 1.

Env overrides: BENCH_FRAMES (timed steps/phase), BENCH_MAXKP,
BENCH_HYPOTHESES, BENCH_PHASE_TIMEOUT_S / BENCH_STREAM_TIMEOUT_S /
BENCH_SWEEP_TIMEOUT_S, BENCH_STREAM_FRAMES, BENCH_CHUNK (streaming
chunk, default 32), BENCH_SKIP_PHASES (comma-list of
step_gfft,step_sift,streaming,sweep).
Single-phase worker mode: `bench.py --phase step` honors BENCH_DETECTOR
and BENCH_MODE=planes|imageonly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
BASELINE_FPS = 30.0  # the TUM/Kinect sensor rate


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# worker: one measured phase in this process (called in a subprocess)
# ---------------------------------------------------------------------------

def run_step_phase() -> int:
    """Steady-state jitted per-frame step FPS. Emits one JSON line."""
    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    log(f"compile cache: {compile_cache.enable(jax)}")

    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.frontend import pipeline
    from slam3d_gx.frontend.state import empty_frame
    from slam3d_gx.ops import pointcloud
    from slam3d_gx.testing import synthetic

    h, w = 480, 640
    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)

    n_timed = int(os.environ.get("BENCH_FRAMES", "192"))
    detector = os.environ.get("BENCH_DETECTOR", "GFTT")
    max_kp = int(os.environ.get("BENCH_MAXKP", "512"))
    hypotheses = int(os.environ.get("BENCH_HYPOTHESES", "256"))
    mode = os.environ.get("BENCH_MODE", "planes")

    log(f"bench: {mode} {detector}/SIFT max_kp={max_kp} hyp={hypotheses} "
        f"{w}x{h} on {jax.devices()[0].platform}")

    # --- data: a short synthetic orbit, rendered once on host ------------
    scene = synthetic.RoomScene(seed=0)
    n_src = 8
    traj = synthetic.orbit_trajectory(n_src, radius=0.15, yaw_amp=0.08)
    grays, depths = [], []
    rng = np.random.default_rng(7)
    for T in traj:
        g, d = synthetic.render_frame(scene, T, intr, h, w)
        g = np.clip(g.astype(np.float64) + rng.normal(0, 2.0, g.shape),
                    0, 255).astype(np.uint8)
        grays.append(jnp.asarray(g))
        depths.append(jnp.asarray(d.astype(np.uint16)))

    if mode == "imageonly":
        extract_img = pipeline.build_image_extractor(
            detector, "SIFT", intr, max_kp=max_kp)
        multipnp = pipeline.build_multipnp_image(intr, hypotheses=hypotheses)
        n_planes = 1

        @jax.jit
        def frame_step(prev_feat, gray, depth, key):
            feat = extract_img(gray, depth)
            res = multipnp(prev_feat, feat, key, jnp.int32(12))
            return feat, res.T, res.norm, res.inliers
    else:
        extract = pipeline.build_plane_extractor(
            detector, "SIFT", intr, max_planes=3, max_kp=max_kp,
            hypotheses=hypotheses)
        multipnp = pipeline.build_multipnp_planes(intr, hypotheses=hypotheses)
        n_planes = 3

        @jax.jit
        def frame_step(prev_feat, gray, depth, key):
            xyz, valid = pointcloud.backproject(
                depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
            xyz = xyz.reshape(-1, 3)
            valid = pointcloud.passthrough_z(xyz, valid.reshape(-1), 0.0, 7.0)
            k1, k2 = jax.random.split(key)
            feat = extract(gray.astype(jnp.float32),
                           depth.astype(jnp.float32), xyz, valid, k1)
            res = multipnp(prev_feat, feat, k2, jnp.int32(12))
            return feat, res.T, res.norm, res.inliers

    # --- warmup (compile + first iterations) ------------------------------
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, n_timed + 4)

    t0 = time.time()
    feat = frame_step(empty_frame(n_planes, max_kp, 128),
                      grays[0], depths[0], keys[1])[0]
    jax.block_until_ready(feat)
    first_step_s = time.time() - t0
    log(f"compile+first step: {first_step_s:.1f}s")
    for i in range(3):
        feat, *_ = frame_step(feat, grays[(i + 1) % n_src],
                              depths[(i + 1) % n_src], keys[2 + i])
    jax.block_until_ready(feat)

    # --- timed steady-state loop ------------------------------------------
    t0 = time.time()
    out = []
    for i in range(n_timed):
        j = i % n_src
        feat, T, norm, inl = frame_step(feat, grays[j], depths[j], keys[4 + i])
        out.append((T, norm, inl))
    jax.block_until_ready(out[-1])  # data-dependent on every frame
    dt = time.time() - t0
    fps = n_timed / dt

    inliers = [int(o[2]) for o in out[:8]]
    log(f"{n_timed} frames in {dt:.2f}s -> {fps:.2f} FPS; "
        f"sample inlier counts {inliers}")

    print(json.dumps({
        "metric": "frontend_fps_640x480",
        "value": round(fps, 3),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "detector": detector,
        "first_step_s": round(first_step_s, 1),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
    }))
    return 0


# ---------------------------------------------------------------------------
# orchestrator: one subprocess per phase, sequential, one JSON line
# ---------------------------------------------------------------------------

def _run_phase(cmd, timeout: float, extra_env=None):
    """Run one measurement subprocess; return its last-stdout-line JSON
    dict, or None on timeout/failure/unparseable output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    log(f"phase: {' '.join(cmd)} (timeout {timeout:.0f}s)")
    try:
        r = subprocess.run(cmd, env=env, timeout=timeout,
                           stdout=subprocess.PIPE, stderr=sys.stderr)
    except subprocess.TimeoutExpired:
        log("phase: KILLED on timeout")
        return None
    if r.returncode != 0:
        log(f"phase: rc={r.returncode}")
        return None
    for line in reversed(r.stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    log("phase: no JSON line in stdout")
    return None


def phases():
    """(name, command, timeout_s, extra_env) for every phase not listed
    in BENCH_SKIP_PHASES."""
    phase_timeout = float(os.environ.get("BENCH_PHASE_TIMEOUT_S", "420"))
    stream_timeout = float(os.environ.get("BENCH_STREAM_TIMEOUT_S", "720"))
    sweep_timeout = float(os.environ.get("BENCH_SWEEP_TIMEOUT_S", "600"))
    # 1 init + 64 warm + 3 steady windows x 64 frames
    stream_frames = os.environ.get("BENCH_STREAM_FRAMES", "257")
    chunk = os.environ.get("BENCH_CHUNK", "32")
    skip = set(filter(None, os.environ.get(
        "BENCH_SKIP_PHASES", "").split(",")))
    step = [sys.executable, os.path.abspath(__file__), "--phase", "step"]
    out = [
        ("step_gfft", step, phase_timeout, {"BENCH_DETECTOR": "GFTT"}),
        ("step_sift", step, phase_timeout, {"BENCH_DETECTOR": "SIFT"}),
        ("streaming",
         [sys.executable, os.path.join(_REPO, "benchmarks",
                                       "streaming_wall.py"),
          stream_frames, chunk, "planes"],
         stream_timeout, {"WALL_DETECTOR": "GFTT"}),
        ("sweep",
         [sys.executable, os.path.join(_REPO, "benchmarks",
                                       "sweep_throughput.py")],
         sweep_timeout, {}),
    ]
    return [p for p in out if p[0] not in skip]


def orchestrate() -> int:
    fresh: dict[str, dict] = {}
    failed = []
    for name, cmd, timeout, env in phases():
        res = _run_phase(cmd, timeout, env)
        if res is None:
            failed.append(name)
        else:
            fresh[name] = res

    def value(name):
        return fresh.get(name, {}).get("value")

    gfft = value("step_gfft")
    out = {
        "metric": "frontend_fps_640x480",
        "value": gfft,
        "unit": "frames/sec",
        "vs_baseline": (round(gfft / BASELINE_FPS, 3)
                        if gfft is not None else None),
        "sift_fps": value("step_sift"),
        "streaming_wall_fps": value("streaming"),
        "sweep_pairs_per_s": value("sweep"),
        "failed_phases": failed,
    }
    if "step_gfft" in fresh:
        for k in ("first_step_s", "platform", "device_kind"):
            if k in fresh["step_gfft"]:
                out[k] = fresh["step_gfft"][k]
    if "streaming" in fresh:
        for k in ("chunk", "keyframes", "loop_closures", "windows_fps",
                  "window_spread", "overall_fps"):
            if k in fresh["streaming"]:
                out[f"streaming_{k}"] = fresh["streaming"][k]
    if "sweep" in fresh:
        for k in ("extract_fps", "median_err_t", "pass_spread"):
            if k in fresh["sweep"]:
                out[f"sweep_{k}"] = fresh["sweep"][k]
    print(json.dumps(out))
    return 1 if failed else 0


def main() -> int:
    if "--phase" in sys.argv:
        kind = sys.argv[sys.argv.index("--phase") + 1]
        if kind == "step":
            return run_step_phase()
        raise SystemExit(f"unknown phase {kind}")
    return orchestrate()


if __name__ == "__main__":
    sys.exit(main())
