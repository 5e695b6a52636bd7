#!/usr/bin/env python3
"""End-to-end quality benchmark: full plane-SLAM on a synthetic orbit,
ATE/RPE scored with the TUM tools (the BASELINE.md protocol).

Prints one JSON line: {"ate_rmse_m", "rpe_trans_rmse_m", "keyframes",
"loop_closures", "frames"}.

Usage: python benchmarks/quality_e2e.py [n_frames] [detector] [descriptor]
Env knobs (for the detector-zoo matrix and the frame-scope starvation
sweep, VERDICT r2 #3/#8): QUALITY_MAXKP (256), QUALITY_BUDGET
(frame_kp_budget, 0), QUALITY_SCOPE (frame|plane), QUALITY_HYP (128),
QUALITY_ARTIFACTS ("" | kinect — render through the Kinect-v1 sensor
artifact model, the attested robustness regime per VERDICT r4 #5).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_frames = int(argv[0]) if argv else 40
    detector = argv[1] if len(argv) > 1 else "GFTT"
    descriptor = argv[2] if len(argv) > 2 else "SIFT"
    max_kp = int(os.environ.get("QUALITY_MAXKP", "256"))
    budget = int(os.environ.get("QUALITY_BUDGET", "0"))
    scope = os.environ.get("QUALITY_SCOPE", "frame")
    hyp = int(os.environ.get("QUALITY_HYP", "128"))
    artifacts = os.environ.get("QUALITY_ARTIFACTS") or None

    import jax

    if os.environ.get("QUALITY_PLATFORM"):
        # ATE/RPE are platform-independent; CPU runs produce the same
        # quality table (FPS is measured elsewhere)
        jax.config.update("jax_platforms", os.environ["QUALITY_PLATFORM"])

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)

    from slam3d_gx.backend import SLAMEnd
    from slam3d_gx.cli import generate_trajectory
    from slam3d_gx.config import CameraIntrinsics, ParameterReader
    from slam3d_gx.frontend import GraphicEnd
    from slam3d_gx.geometry import se3
    from slam3d_gx.io import tum
    from slam3d_gx.testing import synthetic

    intr = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                            factor=5000.0)
    work = tempfile.mkdtemp(prefix="slam_quality_")
    root = os.path.join(work, "ds")
    datadir = os.path.join(work, "data")
    scene = synthetic.RoomScene(seed=3)
    traj = synthetic.orbit_trajectory(n_frames, radius=0.25, yaw_amp=0.15)
    synthetic.write_dataset(root, scene, traj, intr, write_pcd=True,
                            artifacts=artifacts)

    params = ParameterReader(None, overrides=dict(
        data_source=root, detector_name=detector,
        descriptor_name=descriptor,
        camera_fx=intr.fx, camera_fy=intr.fy, camera_cx=intr.cx,
        camera_cy=intr.cy, camera_factor=intr.factor,
        max_keypoints=max_kp, ransac_hypotheses=hyp,
        max_pos_change=0.05, grid_leaf=0.05,
        detect_scope=scope, frame_kp_budget=budget,
    ))
    ge = GraphicEnd(params, data_dir=datadir)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    import time
    t0 = time.time()
    for i in range(n_frames - 1):
        ge.run()
        if (i + 1) % 5 == 0:
            print(f"frame {i + 1}/{n_frames - 1} t={time.time() - t0:.0f}s",
                  file=sys.stderr, flush=True)
    print(f"frontend done t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    ge.save_final_result()
    print(f"optimize done t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)

    est_path = os.path.join(work, "trajectory.txt")
    generate_trajectory.generate(
        os.path.join(datadir, "keyframe.txt"),
        os.path.join(datadir, "final_after.g2o"),
        params=params, out_path=est_path)

    asso = tum.read_associate(os.path.join(root, "associate.txt"))
    gt_path = os.path.join(work, "groundtruth.txt")
    with open(gt_path, "w") as f:
        for row, T in zip(asso, traj):
            d = se3.get_estimate_data(T)
            f.write(f"{row.rgb_ts} " + " ".join(f"{v:.9g}" for v in d) + "\n")

    def run_tool(tool, *args):
        r = subprocess.run(
            [sys.executable, os.path.join(_REPO, "tools", tool),
             gt_path, est_path, *args],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        return r.stdout

    ate = float(run_tool("evaluate_ate.py").strip())
    # parse the verbose RMSE line: non-verbose stdout is the TUM
    # protocol's MEAN (matching the reference script), which must not
    # be published under an _rmse_ key
    rpe = float(next(
        l for l in run_tool("evaluate_rpe.py", "--fixed_delta",
                            "--delta", "0.1", "--verbose").splitlines()
        if l.startswith("translational_error.rmse")).split()[1])

    lc_path = os.path.join(datadir, "lc.txt")
    n_lc = 0
    if os.path.exists(lc_path):
        n_lc = sum(1 for line in open(lc_path) if line.strip())

    print(json.dumps({
        "ate_rmse_m": round(ate, 5),
        "rpe_trans_rmse_m": round(rpe, 5),
        "keyframes": len(ge.keyframes),
        "loop_closures": n_lc,
        "frames": n_frames,
        "detector": detector,
        "descriptor": descriptor,
        "max_kp": max_kp,
        "frame_kp_budget": budget,
        "detect_scope": scope,
        "artifacts": artifacts or "",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
