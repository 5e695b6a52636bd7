#!/usr/bin/env python3
"""Loop-closure edge quality audit against ground truth (VERDICT r3 #5).

Round 3's long run accepted 418 lc.txt rows vs the reference run's 22
at the same keyframe count; ATE implied the graph was clean but no
artifact scored the accepted edges themselves. This harness does:
given a finished run's data dir (final.g2o + keyframe.txt + lc.txt)
and the dataset's ground-truth trajectory, it

- scores EVERY graph edge's measurement against the ground-truth
  relative pose (translation + rotation error), split into sequential
  (odometry/visual chain) vs loop edges — the reference's accept gates
  are norm/inlier thresholds only (src/GraphicEnd.cpp:739-760), so
  this is the missing precision@accepted audit of the lc.txt workflow
  (:840-862);
- reports recall against the set of ground-truth-closable keyframe
  pairs (frame gap > 30, gt relative translation < `close_t` and
  rotation < `close_r` — pairs a perfect loop detector would close).

Can audit an existing run (pass datadir + n_frames) or drive fresh
runs itself; benchmarks/lc_audit_run.py compares scored vs uniform
candidate draws with it.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _edge_errors(Z, Tg1, Tg2):
    """Measurement Z vs ground-truth pair (both edge directions tried;
    the caller calibrates direction on sequential edges)."""
    from slam3d_gx.geometry import se3

    gt_rel = se3.inverse(Tg1) @ Tg2
    E = se3.inverse(Z) @ gt_rel
    t = float(np.linalg.norm(E[:3, 3]))
    r = float(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    return t, r


def audit(datadir: str, gt_poses, close_t: float = 0.3,
          close_r: float = 0.5, min_gap: int = 30,
          graph: str = "final.g2o") -> dict:
    """gt_poses: frame_index (1-based) -> 4x4 ground-truth pose list
    (index 0 = frame 1). Returns the audit dict.

    graph: "final.g2o" audits the runtime-accepted edges (loopClosure's
    gates); "final_after.g2o" additionally audits the findMoreLoops
    walk edges added at finalize (src/GraphicEnd.cpp:864-947) — edge
    measurements are untouched by the optimize that precedes saving, so
    the same scoring applies."""
    from slam3d_gx.geometry import se3
    from slam3d_gx.io import g2o_io, tum

    kf_rows = tum.read_keyframes(os.path.join(datadir, "keyframe.txt"))
    frame_of = {vid: fidx for vid, fidx in kf_rows}
    g = g2o_io.load_g2o(os.path.join(datadir, graph))

    def gt_of(vid):
        return gt_poses[frame_of[vid] - 1]

    # calibrate the edge direction on sequential edges: convention A
    # scores Z against inv(gt[id1])@gt[id2], B against the inverse
    seq = [e for e in g.edges if abs(e.id1 - e.id2) == 1]
    loops = [e for e in g.edges if abs(e.id1 - e.id2) > 1]
    errA = [_edge_errors(e.T, gt_of(e.id1), gt_of(e.id2))[0] for e in seq]
    errB = [_edge_errors(se3.inverse(e.T), gt_of(e.id1), gt_of(e.id2))[0]
            for e in seq]
    flip = float(np.median(errB)) < float(np.median(errA))

    def score(edges):
        te, re_ = [], []
        for e in edges:
            Z = se3.inverse(e.T) if flip else e.T
            t, r = _edge_errors(Z, gt_of(e.id1), gt_of(e.id2))
            te.append(t)
            re_.append(r)
        return np.array(te), np.array(re_)

    seq_t, seq_r = score(seq)
    loop_t, loop_r = score(loops)

    def stats(x):
        if len(x) == 0:
            return None
        return dict(mean=round(float(np.mean(x)), 5),
                    median=round(float(np.median(x)), 5),
                    p95=round(float(np.percentile(x, 95)), 5),
                    max=round(float(np.max(x)), 5))

    # precision@accepted: loop edges no worse than the sequential
    # chain's own error envelope (p99 of sequential trans error)
    gate_t = float(np.percentile(seq_t, 99)) if len(seq_t) else 0.05
    gate_r = float(np.percentile(seq_r, 99)) if len(seq_r) else 0.05
    bad = [(e.id1, e.id2, round(t, 4), round(r, 4))
           for e, t, r in zip(loops, loop_t, loop_r)
           if t > max(2 * gate_t, 0.02) or r > max(2 * gate_r, 0.02)]
    precision = 1.0 - len(bad) / max(1, len(loops))

    # recall vs ground-truth-closable keyframe pairs
    vids = sorted(frame_of)
    closed = {tuple(sorted((e.id1, e.id2))) for e in loops}
    closable, closed_hits = 0, 0
    for i, va in enumerate(vids):
        for vb in vids[i + 1:]:
            if abs(frame_of[vb] - frame_of[va]) <= min_gap:
                continue
            rel = np.linalg.inv(gt_of(va)) @ gt_of(vb)
            ang = float(np.arccos(np.clip(
                (np.trace(rel[:3, :3]) - 1) / 2, -1, 1)))
            if np.linalg.norm(rel[:3, 3]) < close_t and ang < close_r:
                closable += 1
                if tuple(sorted((va, vb))) in closed:
                    closed_hits += 1

    lc_path = os.path.join(datadir, "lc.txt")
    n_lc_rows = (sum(1 for r in open(lc_path) if r.strip())
                 if os.path.exists(lc_path) else 0)
    return dict(
        graph=graph,
        keyframes=len(kf_rows),
        seq_edges=len(seq), loop_edges=len(loops), lc_rows=n_lc_rows,
        seq_trans=stats(seq_t), seq_rot=stats(seq_r),
        loop_trans=stats(loop_t), loop_rot=stats(loop_r),
        precision_at_accepted=round(precision, 4),
        bad_edges=bad[:20], n_bad=len(bad),
        closable_pairs=closable, closed_closable=closed_hits,
        recall_closable=round(closed_hits / max(1, closable), 4),
        direction_flipped=bool(flip),
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("Usage: lc_audit.py <datadir> <n_frames> "
              "[trajectory=multi_loop|orbit] [graph=final.g2o]",
              file=sys.stderr)
        return 2
    datadir, n_frames = argv[0], int(argv[1])
    traj_name = argv[2] if len(argv) > 2 else "multi_loop"
    graph = argv[3] if len(argv) > 3 else "final.g2o"

    from slam3d_gx.testing import synthetic

    makers = {"multi_loop": synthetic.multi_loop_trajectory,
              "orbit": synthetic.orbit_trajectory}
    if traj_name not in makers:
        print(f"unknown trajectory {traj_name!r} "
              f"(options: {sorted(makers)})", file=sys.stderr)
        return 2
    gt = makers[traj_name](n_frames)
    out = audit(datadir, gt, graph=graph)
    print(json.dumps({"metric": "lc_audit", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
