#!/usr/bin/env python3
"""Deployed streaming SLAM wall-clock benchmark (the VERDICT r2 #1
headline number): the FULL application loop — host PNG decode, frame
upload, chunked on-device tracking, keyframe bookkeeping, loop-closure
rounds, logs — timed end-to-end on a disk dataset, exactly what
bin/run_SLAM_streaming deploys.

Reports steady-state wall FPS with the compile-bearing first chunks
excluded (the persistent cache makes those one-time), plus total keyframes
and loop-closure rows so throughput can't be bought by dropping work.

The steady state is timed as several independent windows and the
reported `value` is the MEDIAN window FPS, with the per-window rates and
their spread carried in the JSON line.

Usage: streaming_wall.py [n_frames] [chunk] [planes|imageonly]
Env: WALL_DS (dataset root; generated at 640x480 if missing),
     WALL_DETECTOR/WALL_DESCRIPTOR (GFTT/SIFT), WALL_MAXKP (512),
     WALL_HYP (256), WALL_MPC (max_pos_change, 0.1), WALL_SCORED (0),
     WALL_WARM_FRAMES (frames excluded as warmup, 2*chunk),
     WALL_WINDOWS (steady-state windows, 3; 1 restores single-window),
     WALL_PREFETCH (streaming_prefetch_chunks; 0 = overlap-off baseline).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_frames = int(argv[0]) if argv else 96
    chunk = int(argv[1]) if len(argv) > 1 else 16
    kind = argv[2] if len(argv) > 2 else "planes"

    detector = os.environ.get("WALL_DETECTOR", "GFTT")
    descriptor = os.environ.get("WALL_DESCRIPTOR", "SIFT")
    max_kp = int(os.environ.get("WALL_MAXKP", "512"))
    hyp = int(os.environ.get("WALL_HYP", "256"))
    mpc = float(os.environ.get("WALL_MPC", "0.1"))
    scored = os.environ.get("WALL_SCORED", "0")
    prefetch = os.environ.get("WALL_PREFETCH", "2")  # 0 = overlap off
    warm = int(os.environ.get("WALL_WARM_FRAMES", str(2 * chunk)))

    import jax

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)

    from slam3d_gx.backend import SLAMEnd
    from slam3d_gx.config import CameraIntrinsics, ParameterReader
    from slam3d_gx.frontend.streaming import (
        StreamingGraphicEnd, StreamingGraphicEnd2)
    from slam3d_gx.testing import synthetic

    intr = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                            factor=5000.0)
    root = os.environ.get("WALL_DS", os.path.join(
        tempfile.gettempdir(), f"slam3d_wall_640x480_{n_frames}"))
    # the cache probe must match what THIS mode consumes: an imageonly
    # run caches a PCD-less dataset at the same root, which a later
    # planes run cannot reuse
    need_pcd = kind == "planes"
    have = os.path.exists(os.path.join(root, "associate.txt")) and (
        not need_pcd or os.path.exists(os.path.join(root, "pcd", "1.pcd")))
    if not have:
        log(f"generating {n_frames}-frame 640x480 dataset at {root}...")
        scene = synthetic.RoomScene(seed=3)
        traj = synthetic.orbit_trajectory(
            n_frames, radius=0.25, yaw_amp=0.15)
        synthetic.write_dataset(root, scene, traj, intr, height=480,
                                width=640, write_pcd=need_pcd)

    params = ParameterReader(None, overrides=dict(
        data_source=root, detector_name=detector,
        descriptor_name=descriptor,
        camera_fx=intr.fx, camera_fy=intr.fy, camera_cx=intr.cx,
        camera_cy=intr.cy, camera_factor=intr.factor,
        max_keypoints=max_kp, ransac_hypotheses=hyp,
        max_pos_change=mpc, loop_closure_scored=scored,
        streaming_prefetch_chunks=prefetch,
    ))
    datadir = os.path.join(tempfile.gettempdir(),
                           f"slam3d_wall_data_{os.getpid()}")
    cls = StreamingGraphicEnd if kind == "planes" else StreamingGraphicEnd2
    ge = cls(params, data_dir=datadir, chunk=chunk)
    slam = SLAMEnd()

    t0 = time.time()
    ge.init(slam)
    slam.init(ge)
    log(f"init (first extract) {time.time() - t0:.1f}s")

    # warmup: compile-bearing first chunks
    t0 = time.time()
    done = ge.run_streaming(warm)
    ge.drain_pending_loop_closures()
    log(f"warmup {done} frames {time.time() - t0:.1f}s "
        f"(tracker + LC round compiles)")

    # --- steady state: W independent windows, median wall FPS ------------
    steady = n_frames - 1 - done
    n_windows = max(1, int(os.environ.get("WALL_WINDOWS", "3")))
    base = steady // n_windows
    if base < chunk:  # too few frames to split: single window
        n_windows = 1
        base = steady
    sizes = [base] * (n_windows - 1) + [steady - base * (n_windows - 1)]

    window_fps, done2, total_dt = [], 0, 0.0
    for wi, sz in enumerate(sizes):
        t0 = time.time()
        applied = ge.run_streaming(sz)
        dt = time.time() - t0
        done2 += applied
        total_dt += dt
        if applied == 0:
            break
        window_fps.append(round(applied / dt, 3))
        log(f"window {wi}: {applied} frames in {dt:.2f}s "
            f"-> {window_fps[-1]:.2f} FPS")
    fps = float(np.median(window_fps)) if window_fps else 0.0
    spread = (round((max(window_fps) - min(window_fps)) / fps, 3)
              if fps and len(window_fps) > 1 else 0.0)
    kf = len(ge.keyframes)
    ge.drain_pending_loop_closures()
    lc_path = os.path.join(datadir, "lc.txt")
    n_lc = (sum(1 for r in open(lc_path) if r.strip())
            if os.path.exists(lc_path) else 0)
    log(f"steady state: {done2} frames in {total_dt:.2f}s over "
        f"{len(window_fps)} windows -> median {fps:.2f} FPS wall "
        f"(windows {window_fps}, {kf} keyframes, {n_lc} lc rows)")
    print(json.dumps({
        "metric": "streaming_wall_fps_640x480",
        "value": round(fps, 3),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 30.0, 3),
        "mode": kind,
        "chunk": chunk,
        "detector": detector,
        "keyframes": kf,
        "loop_closures": n_lc,
        "frames_timed": done2,
        "windows_fps": window_fps,
        "window_spread": spread,
        "overall_fps": round(done2 / total_dt, 3) if total_dt else 0.0,
        "scored": scored,
        "prefetch_chunks": int(prefetch),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
