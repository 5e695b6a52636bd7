"""Multi-chip layer tests on the virtual 8-device CPU mesh (conftest)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from slam3d_gx.config import CameraIntrinsics
from slam3d_gx.backend.pose_graph import PoseGraphOptimizer
from slam3d_gx.frontend import pipeline
from slam3d_gx.frontend.state import FrameFeatures
from slam3d_gx.geometry import se3
from slam3d_gx.parallel import lcdb, mesh as mesh_mod, optimize_sharded, registration

INTR = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3, factor=5000.0)


def _mesh2d():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return mesh_mod.make_mesh(8)


def test_make_mesh_shapes():
    m = _mesh2d()
    assert m.shape["dp"] * m.shape["sp"] == 8
    m1 = mesh_mod.make_mesh(1)
    assert m1.shape["dp"] == 1 and m1.shape["sp"] == 1
    md = mesh_mod.make_mesh(8, axis_names=("dp",))
    assert md.shape["dp"] == 8


def _synthetic_pair(rng, k=96, rot_deg=4.0, t=0.06):
    """Random 3D points seen from two poses; exact correspondences."""
    pts = np.stack([
        rng.uniform(-1.5, 1.5, k),
        rng.uniform(-1.0, 1.0, k),
        rng.uniform(1.5, 3.5, k),
    ], axis=1)
    ang = np.deg2rad(rot_deg)
    R = se3.rodrigues(np.array([0.0, ang, 0.0]))
    tv = np.array([t, 0.0, 0.01])
    pts_b = pts @ R.T + tv
    uv_a = np.stack([
        INTR.fx * pts[:, 0] / pts[:, 2] + INTR.cx,
        INTR.fy * pts[:, 1] / pts[:, 2] + INTR.cy,
    ], axis=1)
    uv_b = np.stack([
        INTR.fx * pts_b[:, 0] / pts_b[:, 2] + INTR.cx,
        INTR.fy * pts_b[:, 1] / pts_b[:, 2] + INTR.cy,
    ], axis=1)
    desc = rng.normal(size=(k, 32)).astype(np.float32) * 10
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = tv
    return pts, uv_a, uv_b, desc, T


def _features(pts, uv, desc):
    k = pts.shape[0]
    return FrameFeatures(
        coeffs=jnp.zeros((1, 4), jnp.float32),
        plane_valid=jnp.ones((1,), bool),
        uv=jnp.asarray(uv, jnp.float32)[None],
        kp3d=jnp.asarray(pts, jnp.float32)[None],
        desc=jnp.asarray(desc, jnp.float32)[None],
        kp_valid=jnp.ones((1, k), bool),
    )


def test_batched_registration_sharded():
    rng = np.random.default_rng(3)
    m = _mesh2d()
    reg = registration.BatchedRegistrar(
        INTR, image_only=True, hypotheses=128, mesh=m)
    pairs, gts = [], []
    for _ in range(5):  # 5 pairs -> padded to dp multiple
        pts, uv_a, uv_b, desc, T = _synthetic_pair(rng)
        fa = _features(pts, uv_a, desc)
        fb = _features(pts, uv_b, desc)
        pairs.append((fa, fb))
        gts.append(T)
    out = reg(pairs, jax.random.PRNGKey(0), min_inliers=12)
    assert len(out) == 5
    for (T_est, norm, inliers, ok), T_gt in zip(out, gts):
        assert ok, f"registration failed (inliers={inliers}, norm={norm})"
        # multiPnP solves world->cam of frame b: T maps kp3d(a) to cam b
        err = np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3])
        assert err < 0.02, err


def test_batched_matches_single():
    """Sharded batch result == single-pair pipeline result (same keys)."""
    rng = np.random.default_rng(7)
    m = _mesh2d()
    pts, uv_a, uv_b, desc, _ = _synthetic_pair(rng)
    fa, fb = _features(pts, uv_a, desc), _features(pts, uv_b, desc)

    single = pipeline.build_multipnp_image(INTR, hypotheses=64)
    key = jax.random.PRNGKey(1)
    r1 = single(fa, fb, key, jnp.int32(12))

    batched = registration.build_batched_multipnp(
        INTR, image_only=True, hypotheses=64, mesh=m)
    stack = registration.pad_batch(registration.stack_features([fa]), m.shape["dp"])
    fbs = registration.pad_batch(registration.stack_features([fb]), m.shape["dp"])
    keys = jnp.stack([key] * m.shape["dp"])
    rb = batched(stack, fbs, keys, jnp.int32(12))
    np.testing.assert_allclose(np.asarray(rb.T[0]), np.asarray(r1.T),
                               rtol=1e-4, atol=1e-4)


def test_lcdb_scores_and_top():
    rng = np.random.default_rng(11)
    m = _mesh2d()
    db = lcdb.KeyframeDatabase(n_desc=96, dim=32, capacity=8, mesh=m)
    frames = []
    for i in range(10):  # forces one capacity doubling (8 -> 16)
        pts, uv_a, _, desc, _ = _synthetic_pair(rng)
        f = _features(pts, uv_a, desc)
        frames.append(f)
        assert db.add(f) == i
    assert db.count == 10
    # query = noisy copy of frame 4's descriptors
    q = frames[4]
    noisy = FrameFeatures(*q)._replace(
        desc=q.desc + 0.01 * jnp.asarray(rng.normal(size=q.desc.shape),
                                         jnp.float32))
    s = db.scores(noisy)
    assert s.shape == (10,)
    assert int(np.argmax(s)) == 4
    top = db.top_candidates(noisy, 3)
    assert top[0] == 4
    assert all(t < 7 for t in top)  # newest 3 excluded


def test_lcdb_orb_floor_fixes_binary_degeneracy():
    """Scored retrieval with binary (ORB-style) descriptors: one exact
    duplicate descriptor collapses the 3*min_dist bound to zero, so the
    true-revisit frame scores ~1 without the floor. With the
    registry.match_floor threading (VERDICT r1 #9) it scores ~all kp."""
    from slam3d_gx.ops.features import registry

    rng = np.random.default_rng(17)
    k, d = 64, 32
    # ORB-style: small-integer L2 distances (sqrt-Hamming scale)
    q_desc = rng.integers(0, 2, (k, d)).astype(np.float32) * 8
    near = q_desc.copy()
    near[1:] += rng.normal(0, 0.4, (k - 1, d)).astype(np.float32)  # dist ~2-3
    far = rng.integers(0, 2, (k, d)).astype(np.float32) * 8

    def feats(desc):
        return FrameFeatures(
            coeffs=jnp.zeros((1, 4), jnp.float32),
            plane_valid=jnp.ones((1,), bool),
            uv=jnp.zeros((1, k, 2), jnp.float32),
            kp3d=jnp.zeros((1, k, 3), jnp.float32),
            desc=jnp.asarray(desc)[None],
            kp_valid=jnp.ones((1, k), bool),
        )

    floor = registry.match_floor("ORB")
    assert floor > 0.0
    db = lcdb.KeyframeDatabase(n_desc=k, dim=d, capacity=8,
                               match_floor=floor)
    db.add(feats(near))
    db.add(feats(far))
    s = db.scores(feats(q_desc))
    # the near-duplicate frame must score nearly all keypoints despite
    # the exact row-0 match; without the floor it degenerates to ~1
    assert s[0] > 0.8 * k, s
    assert s[0] > s[1]

    db_nofloor = lcdb.KeyframeDatabase(n_desc=k, dim=d, capacity=8)
    db_nofloor.add(feats(near))
    s0 = db_nofloor.scores(feats(q_desc))
    assert s0[0] < 3, s0  # demonstrates the degeneracy being fixed


def test_lcdb_unsharded_equivalence():
    rng = np.random.default_rng(13)
    m = _mesh2d()
    db_s = lcdb.KeyframeDatabase(n_desc=96, dim=32, capacity=8, mesh=m)
    db_u = lcdb.KeyframeDatabase(n_desc=96, dim=32, capacity=8, mesh=None)
    frames = []
    for _ in range(6):
        pts, uv_a, _, desc, _ = _synthetic_pair(rng)
        f = _features(pts, uv_a, desc)
        frames.append(f)
        db_s.add(f)
        db_u.add(f)
    q = frames[2]
    np.testing.assert_array_equal(db_s.scores(q), db_u.scores(q))


def _ring_graph(n=12, noise=0.01):
    rng = np.random.default_rng(5)
    opt = PoseGraphOptimizer()
    gt = [np.eye(4)]
    ang = 2 * np.pi / n
    step = se3.make_isometry(
        se3.rodrigues(np.array([0, ang, 0.0])), np.array([0.3, 0, 0.0]))
    for i in range(1, n):
        gt.append(gt[-1] @ step)
    opt.add_vertex(0, gt[0], fixed=True)
    for i in range(1, n):
        noisy = gt[i].copy()
        noisy[:3, 3] += rng.normal(0, noise, 3)
        opt.add_vertex(i, noisy)
    info = np.eye(6) * 100
    for i in range(1, n):
        Z = se3.inverse(gt[i - 1]) @ gt[i]
        Z[:3, 3] += rng.normal(0, noise, 3)
        opt.add_edge(i - 1, i, Z, info)
    opt.add_edge(n - 1, 0, se3.inverse(gt[n - 1]) @ gt[0], info, robust=True)
    return opt, gt


def test_posegraph_sharded_matches_dense():
    m = _mesh2d()
    opt_a, gt = _ring_graph()
    opt_b, _ = _ring_graph()
    chi_a = opt_a.optimize(n_iters=15)
    chi_b = optimize_sharded(opt_b, m, n_iters=15)
    assert chi_b <= chi_a * 1.5 + 1e-3
    for i in range(len(gt)):
        ta = opt_a.vertex_estimate(i)[:3, 3]
        tb = opt_b.vertex_estimate(i)[:3, 3]
        np.testing.assert_allclose(ta, tb, atol=5e-3)
        assert np.linalg.norm(tb - gt[i][:3, 3]) < 0.05


def test_posegraph_sharded_cg():
    """Edge-sharded linearization + the matrix-free CG solve — the
    multi-chip path for graphs past the dense bucket (backend
    pose_graph._optimize_cg under a dp mesh)."""
    m = _mesh2d()
    opt_a, gt = _ring_graph()
    opt_b, _ = _ring_graph()
    chi_a = opt_a.optimize(n_iters=15, solver="cg")
    chi_b = optimize_sharded(opt_b, m, n_iters=15, solver="cg")
    assert chi_b <= chi_a * 1.5 + 1e-3
    for i in range(len(gt)):
        tb = opt_b.vertex_estimate(i)[:3, 3]
        np.testing.assert_allclose(
            opt_a.vertex_estimate(i)[:3, 3], tb, atol=5e-3)
        assert np.linalg.norm(tb - gt[i][:3, 3]) < 0.05


def test_lcdb_grow_is_device_side_and_score_stable():
    """VERDICT r2 #6: _grow must not round-trip the database through
    host numpy (a full database round-trip per doubling), and
    scores must be bit-identical across a doubling."""
    rng = np.random.default_rng(23)
    db = lcdb.KeyframeDatabase(n_desc=96, dim=32, capacity=4)
    frames = []
    for _ in range(4):  # fill to capacity exactly
        pts, uv_a, _, desc, _ = _synthetic_pair(rng)
        f = _features(pts, uv_a, desc)
        frames.append(f)
        db.add(f)
    q = frames[2]
    before = db.scores(q).copy()

    # adding one more forces the doubling; no device->host transfer may
    # happen inside it (the old _grow np.asarray'd the whole database)
    pts, uv_a, _, desc, _ = _synthetic_pair(rng)
    f5 = _features(pts, uv_a, desc)
    with jax.transfer_guard_device_to_host("disallow"):
        db.add(f5)
    assert db.capacity == 8 and db.count == 5
    after = db.scores(q)
    np.testing.assert_array_equal(before, after[:4])


def test_lcdb_device_select_matches_host_topk():
    """The fused loop-closure round's on-device candidate selection
    (scores -> masked top-k + deterministic -3/-4 rows) must agree with
    the host top_candidates path it replaces."""
    rng = np.random.default_rng(31)
    db = lcdb.KeyframeDatabase(n_desc=96, dim=32, capacity=16)
    frames = []
    for _ in range(9):
        pts, uv_a, _, desc, _ = _synthetic_pair(rng)
        f = _features(pts, uv_a, desc)
        frames.append(f)
        db.add(f)
    q = frames[3]
    n = 4
    host = db.top_candidates(q, n)
    idx_dev, valid_dev = db.select_candidates_device(q, n)
    idx = np.asarray(idx_dev)
    valid = np.asarray(valid_dev)
    assert idx.shape == (2 + n,)
    # deterministic -3/-4 checks first (record=False rows)
    assert idx[0] == db.count - 3 and idx[1] == db.count - 4
    assert valid[0] and valid[1]
    # ranked draws match the host ranking
    assert [int(i) for i in idx[2:2 + len(host)]] == host
    assert valid[2:2 + len(host)].all()
    # over-asking pads with invalid rows
    idx2, valid2 = db.select_candidates_device(q, db.count + 5)
    v2 = np.asarray(valid2)
    assert v2[2:].sum() == db.count - 3  # only eligible prefix is real


def _plane_pair(rng, p=3, k=96, d_dim=32, rot_deg=3.0, t=0.05):
    """P planes of k keypoints each, seen from two poses with exact
    correspondences and consistently transformed plane coefficients."""
    ang = np.deg2rad(rot_deg)
    R = se3.rodrigues(np.array([0.0, ang, 0.0]))
    tv = np.array([t, 0.0, 0.01])
    normals = np.stack([
        [0.0, 0.0, -1.0],         # back wall
        [-0.95, 0.0, -0.31],      # left-ish wall
        [0.0, -0.95, -0.31],      # floor-ish
    ])[:p]
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ds = np.array([3.0, 2.5, 2.2])[:p]
    coeffs_a, coeffs_b = [], []
    uv_a, uv_b, pts_a = [], [], []
    for i in range(p):
        n, d0 = normals[i], ds[i]
        # sample points on the plane n.x + d0 = 0 inside the camera view
        e1 = np.cross(n, [0.0, 1.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        base = -d0 * n
        pts = base + rng.uniform(-0.8, 0.8, (k, 1)) * e1 \
            + rng.uniform(-0.8, 0.8, (k, 1)) * e2
        pts[:, 2] = np.clip(pts[:, 2], 1.2, 4.0)
        # re-project z-clipped points back onto the plane along z
        off = (pts @ n + d0) / n[2] if abs(n[2]) > 1e-6 else 0.0
        pts[:, 2] -= off
        pts_b = pts @ R.T + tv
        uv_a.append(np.stack([
            INTR.fx * pts[:, 0] / pts[:, 2] + INTR.cx,
            INTR.fy * pts[:, 1] / pts[:, 2] + INTR.cy], axis=1))
        uv_b.append(np.stack([
            INTR.fx * pts_b[:, 0] / pts_b[:, 2] + INTR.cx,
            INTR.fy * pts_b[:, 1] / pts_b[:, 2] + INTR.cy], axis=1))
        pts_a.append(pts)
        # plane transforms: n_b = R n, d_b = d - n_b . t (normalized d>=0)
        nb = R @ n
        db = d0 - nb @ tv
        ca = np.concatenate([n, [d0]])
        cb = np.concatenate([nb, [db]])
        if ca[3] < 0:
            ca = -ca
        if cb[3] < 0:
            cb = -cb
        coeffs_a.append(ca)
        coeffs_b.append(cb)
    desc = [rng.normal(size=(k, d_dim)).astype(np.float32) * 10
            for _ in range(p)]

    def feats(coeffs, uv, pts):
        return FrameFeatures(
            coeffs=jnp.asarray(np.stack(coeffs), jnp.float32),
            plane_valid=jnp.ones((p,), bool),
            uv=jnp.asarray(np.stack(uv), jnp.float32),
            kp3d=jnp.asarray(np.stack(pts), jnp.float32),
            desc=jnp.asarray(np.stack(desc), jnp.float32),
            kp_valid=jnp.ones((p, k), bool),
        )

    pts_b_all = [a @ R.T + tv for a in pts_a]
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = tv
    return feats(coeffs_a, uv_a, pts_a), feats(coeffs_b, uv_b, pts_b_all), T


def test_batched_plane_matches_single():
    """VERDICT r2 #4: sharded-vs-single equivalence for the PLANE
    multiPnP variant (the flagship registration path), not just the
    image-only one."""
    rng = np.random.default_rng(19)
    m = _mesh2d()
    fa, fb, T_gt = _plane_pair(rng)
    single = pipeline.build_multipnp_planes(INTR, hypotheses=64)
    key = jax.random.PRNGKey(2)
    r1 = single(fa, fb, key, jnp.int32(12))
    assert bool(r1.ok), "single plane multiPnP failed on exact data"
    np.testing.assert_allclose(
        np.asarray(r1.T)[:3, 3], T_gt[:3, 3], atol=0.02)

    batched = registration.build_batched_multipnp(
        INTR, image_only=False, hypotheses=64, mesh=m)
    stack = registration.pad_batch(
        registration.stack_features([fa]), m.shape["dp"])
    fbs = registration.pad_batch(
        registration.stack_features([fb]), m.shape["dp"])
    keys = jnp.stack([key] * m.shape["dp"])
    rb = batched(stack, fbs, keys, jnp.int32(12))
    np.testing.assert_allclose(np.asarray(rb.T[0]), np.asarray(r1.T),
                               rtol=1e-4, atol=1e-4)
