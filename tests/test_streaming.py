"""Streaming (chunked on-device) frontend vs the per-frame path."""

import os

import numpy as np
import pytest

from slam3d_gx.backend import SLAMEnd
from slam3d_gx.config import CameraIntrinsics, ParameterReader
from slam3d_gx.testing import synthetic

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N = 13  # 12 processed frames; chunk=5 leaves a 2-frame tail path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream"))
    traj = synthetic.orbit_trajectory(N, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR,
                            write_pcd=False)
    return root, traj


def _params(root, **kw):
    over = dict(
        data_source=root, detector_name="GFTT", descriptor_name="SIFT",
        camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx,
        camera_cy=INTR.cy, camera_factor=INTR.factor,
        max_keypoints=256, ransac_hypotheses=128,
        max_pos_change=0.05, end_index=100,
    )
    over.update(kw)
    return ParameterReader(None, overrides=over)


def test_streaming_matches_per_frame(dataset, tmp_path_factory):
    from slam3d_gx.frontend import GraphicEnd2
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd2

    root, traj = dataset

    d1 = str(tmp_path_factory.mktemp("per_frame"))
    ge = GraphicEnd2(_params(root), data_dir=d1)
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    for _ in range(N - 1):
        ge.run()
    ge.save_final_result()

    d2 = str(tmp_path_factory.mktemp("stream"))
    gs = StreamingGraphicEnd2(_params(root), data_dir=d2, chunk=5)
    slam2 = SLAMEnd()
    gs.init(slam2)
    slam2.init(gs)
    done = gs.run_streaming(N - 1)
    assert done == N - 1
    gs.save_final_result()

    # same decisions (RANSAC streams differ, so allow 1 keyframe slack)
    kf1 = [k.frame_index for k in ge.keyframes]
    kf2 = [k.frame_index for k in gs.keyframes]
    assert abs(len(kf1) - len(kf2)) <= 1, (kf1, kf2)

    # both trajectories hit the ground truth
    for g in (ge, gs):
        est = [g.opt.vertex_estimate(k.id) for k in g.keyframes]
        gt = [traj[k.frame_index - 1] for k in g.keyframes]
        ate = synthetic.ate_rmse(gt, est)
        assert ate < 0.05, ate

    # artifact contracts intact
    for d, g in ((d1, ge), (d2, gs)):
        rows = open(os.path.join(d, "error_of_transform.log")).read().split()
        assert len(rows) == N - 1
        assert os.path.exists(os.path.join(d, "keyframe.txt"))


def test_streaming_planes(tmp_path_factory):
    """StreamingGraphicEnd: the flagship plane pipeline tracked in
    chunks; decisions line up with the per-frame GraphicEnd."""
    from slam3d_gx.frontend import GraphicEnd
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd

    root = str(tmp_path_factory.mktemp("pstream"))
    traj = synthetic.orbit_trajectory(N, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR,
                            write_pcd=True)
    # full budgets: reduced ones put every pair at the 12-inlier noise
    # floor where key luck, not the streaming logic, decides tracking
    kw = dict(max_keypoints=256, ransac_hypotheses=128)

    ge = GraphicEnd(_params(root, **kw),
                    data_dir=str(tmp_path_factory.mktemp("pf")))
    slam = SLAMEnd()
    ge.init(slam)
    slam.init(ge)
    for _ in range(N - 1):
        ge.run()

    gs = StreamingGraphicEnd(_params(root, **kw), chunk=5,
                             data_dir=str(tmp_path_factory.mktemp("st")))
    slam2 = SLAMEnd()
    gs.init(slam2)
    slam2.init(gs)
    done = gs.run_streaming(N - 1)
    assert done == N - 1
    gs.save_final_result()

    kf1 = [k.frame_index for k in ge.keyframes]
    kf2 = [k.frame_index for k in gs.keyframes]
    assert abs(len(kf1) - len(kf2)) <= 1, (kf1, kf2)
    est = [gs.opt.vertex_estimate(k.id) for k in gs.keyframes]
    gt = [traj[k.frame_index - 1] for k in gs.keyframes]
    assert synthetic.ate_rmse(gt, est) < 0.06
    rows = open(os.path.join(gs.data_dir,
                             "error_of_transform.log")).read().split()
    assert len(rows) == N - 1


def test_streaming_odometry_edges(dataset, tmp_path_factory):
    """use_odometry in streaming mode: odo_this advances per applied
    frame, so keyframes get the odometry edge at 1/sigma^2 like the
    per-frame path (reference src/GraphicEnd.cpp:330-346)."""
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd2

    root, traj = dataset
    gs = StreamingGraphicEnd2(_params(root, use_odometry="yes"), chunk=5,
                              data_dir=str(tmp_path_factory.mktemp("odo")))
    slam = SLAMEnd()
    gs.init(slam)
    slam.init(gs)
    gs.run_streaming(N - 1)
    gs.drain_pending_loop_closures()
    info_odo = 1.0 / (0.03**2)
    odo_edges = [e for e in gs.opt.graph.edges
                 if abs(e.information[0, 0] - info_odo) < 1e-6]
    assert len(odo_edges) >= len(gs.keyframes) - 1
    # odometry edges must differ between keyframes (odo_this advanced;
    # before the fix every edge reused the stale chunk-entry pose)
    if len(odo_edges) >= 2:
        assert not np.allclose(odo_edges[0].T, odo_edges[1].T)


def test_streaming_handles_blackout(tmp_path_factory):
    """Frames the tracker cannot register (blackout) trigger the
    per-frame lost_recovery fallback mid-chunk."""
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd2
    from slam3d_gx.io import images as img_io

    root = str(tmp_path_factory.mktemp("blackout"))
    traj = synthetic.orbit_trajectory(12, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR,
                            write_pcd=False)
    # black out frames 5-7 (after init eats frame 1)
    for i in (5, 6, 7):
        p = os.path.join(root, "rgb_index", f"{i}.png")
        img_io.save_gray(p, np.zeros((240, 320), np.uint8))

    gs = StreamingGraphicEnd2(_params(root, lost_frames=1), chunk=4,
                              data_dir=str(tmp_path_factory.mktemp("d")))
    slam = SLAMEnd()
    gs.init(slam)
    slam.init(gs)
    done = gs.run_streaming(11)
    assert done == 11
    log = open(os.path.join(gs.data_dir,
                            "error_of_transform.log")).read().split()
    assert "9999" in log          # blackout frames went lost
    assert gs.lost <= 1           # recovered after the blackout
    lost_file = os.path.join(gs.data_dir, "lost.txt")
    assert os.path.exists(lost_file)  # lostRecovery actually fired


def test_streaming_chunk1_fused_per_frame(dataset, tmp_path_factory):
    """chunk=1 IS the fused per-frame mode (VERDICT r2 #5): one
    dispatch + one packed readback per frame, with the next frame's
    step speculatively dispatched while this one's records apply."""
    from slam3d_gx.frontend.streaming import StreamingGraphicEnd2

    root, traj = dataset
    d = str(tmp_path_factory.mktemp("stream1"))
    gs = StreamingGraphicEnd2(_params(root), data_dir=d, chunk=1)
    slam = SLAMEnd()
    gs.init(slam)
    slam.init(gs)
    done = gs.run_streaming(N - 1)
    assert done == N - 1
    gs.save_final_result()

    est = [gs.opt.vertex_estimate(k.id) for k in gs.keyframes]
    gt = [traj[k.frame_index - 1] for k in gs.keyframes]
    assert synthetic.ate_rmse(gt, est) < 0.05
    rows = open(os.path.join(d, "error_of_transform.log")).read().split()
    assert len(rows) == N - 1


def test_tracker_device_rescue_logic():
    """build_tracker(rescue=True) oracle: stubbed extract/multipnp
    script a chunk where one frame fails against the keyframe but
    rescues against the last frame (GraphicEnd.cpp:183-227 semantics),
    and two frames fail both ways (lost counting)."""
    import jax
    import jax.numpy as jnp

    from slam3d_gx.frontend.state import FrameFeatures, MultiPnPResult
    from slam3d_gx.frontend.streaming import REC_WIDTH, build_tracker

    def mkfeat(v):
        return FrameFeatures(
            coeffs=jnp.full((1, 4), v, jnp.float32),
            plane_valid=jnp.ones((1,), bool),
            uv=jnp.zeros((1, 4, 2), jnp.float32),
            kp3d=jnp.zeros((1, 4, 3), jnp.float32),
            desc=jnp.zeros((1, 4, 8), jnp.float32),
            kp_valid=jnp.ones((1, 4), bool),
        )

    def extract_fn(gray, depth, key):
        return mkfeat(gray[0, 0])

    def multipnp(a, b, key, min_inl):
        d = jnp.abs(b.coeffs[0, 0] - a.coeffs[0, 0])
        ok = d < 1.5
        T = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(d)
        return MultiPnPResult(
            T=T, norm=jnp.where(ok, 0.01 * d, jnp.float32(7.0)),
            inliers=jnp.where(ok, jnp.int32(50), jnp.int32(5)), ok=ok)

    # frame "values": keyframe starts at 0
    # f0 0.5 ok; f1 1.0 ok; f2 2.4 fails vs kf(0), rescues vs last(1.0);
    # f3 2.6 ok vs new kf 2.4; f4 9.0 fails both -> lost 1;
    # f5 9.2 fails vs kf and vs last (still 2.6) -> lost 2
    vals = [0.5, 1.0, 2.4, 2.6, 9.0, 9.2]
    chunk = len(vals)
    grays = jnp.stack([jnp.full((2, 2), v, jnp.uint8 if False else
                                jnp.float32) for v in vals])
    depths = jnp.zeros((chunk, 2, 2), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), chunk)

    tracker = build_tracker(extract_fn, multipnp, max_pos_change=0.05,
                            chunk=chunk, rescue=True,
                            rescue_inliers=30, rescue_error=1.5)
    carry, feats, recs = tracker(
        mkfeat(0.0), jnp.eye(4, dtype=jnp.float32),
        jnp.eye(4, dtype=jnp.float32), jnp.int32(0), mkfeat(0.0),
        grays, depths, keys)
    recs = np.asarray(recs)
    assert recs.shape == (chunk, REC_WIDTH)
    assert list(recs[:, 18]) == [1, 1, 0, 1, 0, 0]      # ok
    assert list(recs[:, 24]) == [0, 0, 1, 0, 0, 0]      # rescued
    assert list(recs[:, 20]) == [0, 0, 0, 0, 1, 2]      # lost-after
    # rescue records: r_T is last(1.0)->present(2.4), d=1.4
    assert abs(recs[2, 25:41].reshape(4, 4)[0, 3] - 1.4) < 1e-5
    # rr_T is keyframe(0)->last(1.0), d=1.0
    assert abs(recs[2, 43:59].reshape(4, 4)[0, 3] - 1.0) < 1e-5
    # carry: keyframe switched to the rescued frame's features (2.4)
    kf_feat_n = carry[0]
    assert abs(float(kf_feat_n.coeffs[0, 0]) - 2.4) < 1e-5
    # last survives failed frames (2.6, not 9.x)
    assert abs(float(carry[4].coeffs[0, 0]) - 2.6) < 1e-5


def test_streaming_rescue_host_mirror(dataset, tmp_path_factory):
    """_process_chunk applies a rescued record exactly like
    _rescue_with_last: promote last then present, edges inverse(rr_T) /
    inverse(r_T), robot untouched, lost reset."""
    import jax.numpy as jnp

    from slam3d_gx.frontend.streaming import (REC_WIDTH,
                                                  StreamingGraphicEnd2)
    from slam3d_gx.geometry import se3

    root, traj = dataset
    gs = StreamingGraphicEnd2(_params(root), chunk=3,
                              data_dir=str(tmp_path_factory.mktemp("rm")))
    slam = SLAMEnd()
    gs.init(slam)
    slam.init(gs)
    gs._ensure_tracker()

    st = gs._dispatch_chunk([2, 3, 4])
    recs = np.asarray(st["recs"]).copy()
    # craft: frame 3 (j=1) rescued; known r_T / rr_T
    r_T = np.eye(4); r_T[0, 3] = 0.25
    rr_T = np.eye(4); rr_T[1, 3] = -0.5
    recs[1, 18] = 0.0   # ok = False
    recs[1, 19] = 0.0
    recs[1, 24] = 1.0   # rescued
    recs[1, 25:41] = r_T.reshape(16)
    recs[1, 43:59] = rr_T.reshape(16)
    recs[1, 20] = 0.0
    st["recs"] = jnp.asarray(recs)

    kf_before = len(gs.keyframes)
    applied, clean = gs._process_chunk(st)
    assert applied == 3 and clean
    # two keyframes from the rescue (last at frame 2's slot, present at 3)
    resc_kfs = [k for k in gs.keyframes[kf_before:]
                if k.frame_index in (2, 3)]
    assert len(resc_kfs) >= 2
    k_last = next(k for k in resc_kfs if k.frame_index == 2)
    k_pres = next(k for k in resc_kfs if k.frame_index == 3)
    assert k_pres.id == k_last.id + 1
    edges = {(e.id1, e.id2): e.T for e in gs.opt.graph.edges}
    assert np.allclose(edges[(k_last.id - 1, k_last.id)],
                       se3.inverse(rr_T), atol=1e-6)
    assert np.allclose(edges[(k_last.id, k_pres.id)],
                       se3.inverse(r_T), atol=1e-6)
    assert gs.lost == 0
