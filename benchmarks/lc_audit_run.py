#!/usr/bin/env python3
"""Drive scored-vs-uniform loop-closure runs and audit their edges.

Runs the streaming plane-SLAM frontend twice on the same loop-rich
synthetic sequence — loop_closure_scored=0 (the reference's uniform
random candidate draws, src/GraphicEnd.cpp:729-731) and =1 (the lcdb
descriptor-scored draws) — then scores every accepted edge against
ground truth with benchmarks/lc_audit.py. This turns the round-3
"row counts and wall FPS" comparison into recall/precision.

Usage: lc_audit_run.py [n_frames=300] [chunk=16] [height=240] [width=320]
Env: LCA_MPC (0.08), LCA_DETECTOR (GFTT), LCA_MAXKP (384),
     LCA_HYP (128), LCA_MODES ("0,1"); SLAM3D_PLATFORM=cpu|gpu forces
     the backend.
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import lc_audit  # noqa: E402  (sibling module)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_frames = int(argv[0]) if argv else 300
    chunk = int(argv[1]) if len(argv) > 1 else 16
    h = int(argv[2]) if len(argv) > 2 else 240
    w = int(argv[3]) if len(argv) > 3 else 320

    mpc = float(os.environ.get("LCA_MPC", "0.08"))
    detector = os.environ.get("LCA_DETECTOR", "GFTT")
    max_kp = int(os.environ.get("LCA_MAXKP", "384"))
    hyp = int(os.environ.get("LCA_HYP", "128"))
    modes = os.environ.get("LCA_MODES", "0,1").split(",")
    max_drift = os.environ.get("LCA_MAXDRIFT", "0")

    import slam3d_gx  # noqa: F401  (applies SLAM3D_PLATFORM)
    import jax

    from slam3d_gx.backend import SLAMEnd
    from slam3d_gx.config import CameraIntrinsics, ParameterReader
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd
    from slam3d_gx.testing import synthetic
    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)
    log(f"backend: {jax.default_backend()}")

    # intrinsics scale with the render size (fr1 * w/640)
    s = w / 640.0
    intr = CameraIntrinsics(fx=517.0 * s, fy=517.0 * s, cx=318.6 * s,
                            cy=255.3 * s, factor=5000.0)
    artifacts = os.environ.get("LCA_ARTIFACTS") or None  # e.g. "kinect"
    root = (f"/tmp/slam3d_lcaudit/ds{n_frames}_{h}x{w}"
            + (f"_{artifacts}" if artifacts else ""))
    traj = synthetic.multi_loop_trajectory(n_frames)
    if not os.path.exists(os.path.join(root, "associate.txt")):
        log(f"generating {n_frames}-frame {w}x{h} dataset at {root}"
            f" (artifacts={artifacts})...")
        synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj,
                                intr, height=h, width=w, write_pcd=True,
                                artifacts=artifacts)

    results = {}
    for scored in modes:
        datadir = (f"/tmp/slam3d_lcaudit/data{n_frames}_{h}x{w}_s{scored}"
                   f"_d{max_drift}")
        import shutil

        shutil.rmtree(datadir, ignore_errors=True)
        params = ParameterReader(None, overrides=dict(
            data_source=root, detector_name=detector,
            descriptor_name="SIFT",
            camera_fx=intr.fx, camera_fy=intr.fy, camera_cx=intr.cx,
            camera_cy=intr.cy, camera_factor=intr.factor,
            max_keypoints=max_kp, ransac_hypotheses=hyp,
            max_pos_change=mpc, loop_closure_scored=scored,
            loop_closure_max_drift=max_drift,
        ))
        ge = StreamingGraphicEnd(params, data_dir=datadir, chunk=chunk)
        slam = SLAMEnd()
        t0 = time.time()
        ge.init(slam)
        slam.init(ge)
        done = ge.run_streaming(n_frames - 1)
        ge.drain_pending_loop_closures()
        os.makedirs(datadir, exist_ok=True)
        slam.globalOptimizer.save(os.path.join(datadir, "final.g2o"))
        if os.environ.get("LCA_FINALIZE", "0") == "1":
            # adds findMoreLoops' walk edges + the optimized graph; the
            # audit itself reads final.g2o (the runtime-accepted edges,
            # exactly what loopClosure's gates admitted) and only needs
            # keyframe.txt, written directly below
            ge.save_final_result()
        else:
            from slam3d_gx.io import tum as _tum

            _tum.write_keyframes(
                os.path.join(datadir, "keyframe.txt"),
                [(kf.id, kf.frame_index) for kf in ge.keyframes])
        wall = time.time() - t0
        log(f"scored={scored}: {done} frames, {len(ge.keyframes)} "
            f"keyframes, {wall:.0f}s wall")
        want_after = os.environ.get("LCA_GRAPH") == "after"
        finalized = os.environ.get("LCA_FINALIZE", "0") == "1"
        if want_after and not finalized:
            log("LCA_GRAPH=after requires LCA_FINALIZE=1 "
                "(final_after.g2o is only written at finalize); "
                "auditing final.g2o instead")
        a = lc_audit.audit(
            datadir, traj,
            graph=("final_after.g2o" if want_after and finalized
                   else "final.g2o"))
        a["wall_s"] = round(wall, 1)
        a["frames"] = done
        results[f"scored_{scored}"] = a
        log(f"scored={scored}: loops={a['loop_edges']} "
            f"precision={a['precision_at_accepted']} "
            f"recall={a['recall_closable']} n_bad={a['n_bad']}")

    print(json.dumps({"metric": "lc_audit_run", "n_frames": n_frames,
                      "size": f"{w}x{h}", "detector": detector,
                      **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
