"""Integration tests for the failure-handling branches (SURVEY.md §5.3):
lost counter, lostRecovery's unconstrained vertex + all-history scan,
the 9999 sentinel log, and odometry-mode edges."""

import os

import numpy as np
import pytest

from slam3d_gx.backend import SLAMEnd
from slam3d_gx.config import CameraIntrinsics, ParameterReader
from slam3d_gx.io import images
from slam3d_gx.testing import synthetic

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N = 14
BLANK = (5, 6, 7)  # 1-based frame indices rendered featureless


@pytest.fixture(scope="module")
def dataset_with_blackout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blackout"))
    scene = synthetic.RoomScene(seed=3)
    traj = synthetic.orbit_trajectory(N, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, scene, traj, INTR, write_pcd=False)
    # occlusion: constant gray frames have no keypoints -> multiPnP fails
    for i in BLANK:
        g = np.full((240, 320), 120, np.uint8)
        images.save_gray(os.path.join(root, f"rgb_index/{i}.png"), g)
    return root, traj


def _params(root, **kw):
    over = dict(
        data_source=root, detector_name="GFTT", descriptor_name="SIFT",
        camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx,
        camera_cy=INTR.cy, camera_factor=INTR.factor,
        max_keypoints=256, ransac_hypotheses=128,
        max_pos_change=0.05, grid_leaf=0.05,
        lost_frames=1,  # recover fast so the test exercises the branch
    )
    over.update(kw)
    return ParameterReader(None, overrides=over)


def test_blackout_triggers_lost_recovery(dataset_with_blackout, tmp_path_factory):
    from slam3d_gx.frontend import GraphicEnd2

    root, traj = dataset_with_blackout
    datadir = str(tmp_path_factory.mktemp("data_lost"))
    ge = GraphicEnd2(_params(root), data_dir=datadir)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    for _ in range(N - 1):
        ge.run()

    # 9999 sentinel rows for failed registrations (reference
    # src/GraphicEnd.cpp:176)
    log = open(os.path.join(datadir, "error_of_transform.log")).read().split()
    assert "9999" in log

    # lostRecovery fired: lost.txt rows + unconstrained vertex in graph
    lost_rows = open(os.path.join(datadir, "lost.txt")).read().strip().splitlines()
    assert len(lost_rows) >= 1
    g = ge.opt.graph
    lost_ids = {int(r.split()[0]) for r in lost_rows}
    constrained = set()
    for e in g.edges:
        constrained.add(e.id1)
        constrained.add(e.id2)
    # at least one recovery vertex from the blackout must be edge-free
    # (the blank keyframe can't re-localize, reference src/GraphicEnd.cpp:792)
    assert any(vid not in constrained for vid in lost_ids)

    # tracking resumed after the blackout: keyframes cover late frames
    assert ge.keyframes[-1].frame_index >= N - 2
    # and the late keyframes are mutually constrained again
    late = [kf.id for kf in ge.keyframes if kf.frame_index > max(BLANK)]
    assert sum(1 for v in late if v in constrained) >= len(late) - 1


def test_odometry_mode_adds_odometry_edges(dataset_with_blackout, tmp_path_factory):
    from slam3d_gx.frontend import GraphicEnd2

    root, traj = dataset_with_blackout
    datadir = str(tmp_path_factory.mktemp("data_odo"))
    ge = GraphicEnd2(_params(root, use_odometry="yes", error_odometry=0.03),
                     data_dir=datadir)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    assert len(ge.odometry) == N  # associate.txt rows parsed + remapped
    for _ in range(N - 1):
        ge.run()

    g = ge.opt.graph
    # odometry mode: keyframe pairs get a second edge with information
    # 1/sigma^2 (reference src/GraphicEnd.cpp:330-346)
    info_odo = 1.0 / (0.03**2)
    odo_edges = [e for e in g.edges
                 if abs(e.information[0, 0] - info_odo) < 1e-6]
    visual_edges = [e for e in g.edges if abs(e.information[0, 0] - 100.0) < 1e-6]
    assert len(odo_edges) >= 3
    assert len(visual_edges) >= 3
    # lost frames in odometry mode don't rescue via last-frame logic;
    # recovery adds an odometry edge instead of scanning history
    lost_rows = open(os.path.join(datadir, "lost.txt")).read().strip().splitlines()
    assert len(lost_rows) >= 1


def test_scored_loop_closure_mode(dataset_with_blackout, tmp_path_factory):
    """loop_closure_scored=1: candidates come from the keyframe database
    (parallel/lcdb.py) instead of random draws; loops still close."""
    from slam3d_gx.frontend import GraphicEnd2

    root, traj = dataset_with_blackout
    datadir = str(tmp_path_factory.mktemp("data_scored"))
    ge = GraphicEnd2(_params(root, loop_closure_scored="1", lost_frames=1),
                     data_dir=datadir)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    for _ in range(N - 1):
        ge.run()
    assert ge.lcdb is not None
    assert ge.lcdb.count == len(ge.keyframes)
    # fused rounds resolve lazily (lc_drain_threshold); nothing reads
    # loop edges before recovery/finalize, which drain unconditionally
    ge.drain_pending_loop_closures()
    lc = os.path.join(datadir, "lc.txt")
    assert os.path.exists(lc)
    rows = [r for r in open(lc).read().splitlines() if r.strip()]
    assert len(rows) >= 1  # scored retrieval found verifiable loops


def test_rescue_with_last_promotes_both(tmp_path_factory):
    """GraphicEnd's lost branch: when the stale keyframe no longer
    matches but the previous ordinary frame does, BOTH are promoted
    (reference src/GraphicEnd.cpp:183-227)."""
    from slam3d_gx.frontend import GraphicEnd

    root = str(tmp_path_factory.mktemp("rescue"))
    scene = synthetic.RoomScene(seed=7)
    # wide orbit: consecutive frames overlap, but frame 1 vs frame ~6+
    # share almost no view
    traj = synthetic.orbit_trajectory(10, radius=0.9, yaw_amp=0.9)
    synthetic.write_dataset(root, scene, traj, INTR, write_pcd=True)

    # max_pos_change huge -> no ordinary keyframe promotion: curr_kf
    # stays frame 1 until tracking against it fails. The scenario is
    # tuned to ride the norm~1.0 acceptance boundary, which is scope-
    # sensitive; pin the reference-exact per-plane detection since this
    # test exercises the state machine, not the detector scope.
    ge = GraphicEnd(_params(root, max_pos_change=999.0, lost_frames=5,
                            loop_closure_inliers=20, detect_scope="plane"),
                    data_dir=str(tmp_path_factory.mktemp("data_rescue")))
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    for _ in range(9):
        ge.run()

    # the rescue fired at least once: more than the initial keyframe and
    # consecutive ids promoted in one step (last + present)
    assert len(ge.keyframes) >= 3, [k.frame_index for k in ge.keyframes]
    # consecutive frame indices appearing as back-to-back keyframes is the
    # rescue signature (promote last=f-1 then present=f)
    pairs = list(zip(ge.keyframes, ge.keyframes[1:]))
    assert any(b.frame_index - a.frame_index == 1 for a, b in pairs), \
        [k.frame_index for k in ge.keyframes]
    # both promotions added constrained vertices (edge between them)
    g = ge.opt.graph
    edge_pairs = {(e.id1, e.id2) for e in g.edges}
    assert any((a.id, b.id) in edge_pairs for a, b in pairs)
