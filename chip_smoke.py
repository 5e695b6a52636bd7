#!/usr/bin/env python3
"""Smoke test of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py               # one GPU, every phase below
    python chip_smoke.py --devices 4   # four GPUs: the sharded path only

Phases, in order, in this one process (a JAX process reserves most of
a card's memory, so the CLIs run in-process through the same `run`
functions their console scripts call, never as a second process):

1. card     — jax devices and `nvidia-smi` name and power limit; fails
              unless the platform is "gpu".
2. dataset  — a synthetic TUM-layout 640x480 orbit (RoomScene from
              --seed, TUM fr1 intrinsics) that returns to its start, so
              loop closure and finalize have revisits to find.
3. kernels  — each frontend kernel at real width against its plain
              numpy reference (slam3d_gx.testing.oracles), tolerance
              printed beside the measured error.
4. planar streaming — run_SLAM_streaming <N> 32 planes (GFTT/SIFT,
              512 keypoints, 256 hypotheses: bench.py's protocol), then
              generateTrajectory; ATE against ground truth.
5. per-frame — run_SLAM (planar) and run_SLAM_imageonly with SIFT.

With --devices 4 only the multi-device path runs: phase 4 with
`mesh_devices: 4` against the same dataset at `mesh_devices: 0` (the
scored keyframe database on, so all three sharded components work),
requiring equal keyframes and loop edges.

The last stdout line is {"ok": true, "device": {...}}. Any failed check
raises, so the process then exits non-zero without that line; so does a
run with no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from slam3d_gx.config import CameraIntrinsics  # noqa: E402
from slam3d_gx.geometry import se3  # noqa: E402
from slam3d_gx.io import g2o_io, images, tum  # noqa: E402
from slam3d_gx.testing import oracles, synthetic  # noqa: E402

# TUM fr1 preset (config.py; bench.py uses the same)
FR1 = CameraIntrinsics(fx=517.0, fy=517.0, cx=318.6, cy=255.3,
                       factor=5000.0)
ATE_BOUND_M = 0.05  # the bound tests/test_e2e.py holds the CLIs to
STREAM_LOOPS = 160  # five chunks of 32 around the orbit
PERFRAME_LOOPS = 24
SEED = 3
# bench.py's protocol: GFTT detector, SIFT descriptor, 512 keypoints,
# 256 RANSAC hypotheses; keyframe every 0.1 of motion norm
BENCH_PARAMS = dict(detector_name="GFTT", descriptor_name="SIFT",
                    max_keypoints=512, ransac_hypotheses=256,
                    max_pos_change=0.1)


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card
# ---------------------------------------------------------------------------

def phase_card(require_gpu: bool = True) -> dict:
    """Print the devices and the card's name and power limit. Raises
    SmokeFailure unless JAX's platform is gpu (when require_gpu)."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[card] jax {jax.__version__} devices: {devs}")
    log(f"[card] platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if require_gpu:
        check(info["platform"] == "gpu",
              f"platform is {info['platform']!r}, not 'gpu'")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            log(f"[card] nvidia-smi: {line.strip()}")
    return info


# ---------------------------------------------------------------------------
# phase 2: dataset
# ---------------------------------------------------------------------------

def phase_dataset(root: str, n_frames: int, height: int = 480,
                  width: int = 640, seed: int = 3, radius: float = 0.25,
                  yaw_amp: float = 0.15):
    """Write an n_frames orbit with PCD clouds (the planar frontends
    read them at init and on lost recovery) under root. Returns the
    ground-truth camera-to-world poses."""
    t0 = time.time()
    scene = synthetic.RoomScene(seed=seed)
    traj = synthetic.orbit_trajectory(n_frames, radius=radius,
                                      yaw_amp=yaw_amp)
    synthetic.write_dataset(root, scene, traj, FR1, height=height,
                            width=width, write_pcd=True)
    log(f"[dataset] {n_frames} frames {width}x{height} seed={seed} in "
        f"{time.time() - t0:.1f}s; PNG decoder: {images.decoder()}")
    return traj


# ---------------------------------------------------------------------------
# phase 3: kernels against the numpy references
# ---------------------------------------------------------------------------

def _report(name: str, measured: float, tolerance: float, unit: str = ""):
    ok = measured <= tolerance
    log(f"[kernels] {name}: {measured:.3g}{unit} (tolerance "
        f"{tolerance:.3g}{unit}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: {measured} > {tolerance}")


def phase_kernels(dataset_root: str, n_quartics: int = 4096,
                  posegraph_vertices: int = 2048, seed: int = 0) -> None:
    """Each kernel of the frontend at the dataset's width against its
    plain numpy reference."""
    import jax
    import jax.numpy as jnp

    from slam3d_gx.frontend import pipeline
    from slam3d_gx.ops import imageproc, match, pnp, polynomial
    from slam3d_gx.ops.features import harris
    from slam3d_gx.testing.posegraph import graph_ate, make_loopy_graph

    rng = np.random.default_rng(seed)

    def frame(i):
        return (images.load_gray(os.path.join(
                    dataset_root, "rgb_index", f"{i}.png")),
                images.load_depth(os.path.join(
                    dataset_root, "dep_index", f"{i}.png")))

    gray, depth = frame(1)
    gray2, depth2 = frame(5)
    h, w = gray.shape

    # equalizeHist: exact (OpenCV's own float32 arithmetic)
    got = np.asarray(imageproc.equalize_hist(jnp.asarray(gray)))
    n_diff = int((got != oracles.equalize_hist(gray)).sum())
    _report(f"equalize_hist {w}x{h} differing pixels", n_diff, 0)

    # Shi-Tomasi response: rtol 1e-5 plus an absolute 1e-6 of the largest
    # response, for the float32 cancellation in tr/2 - sqrt(.) (an error
    # of order eps32 * trace where the response is near zero)
    eq = got.astype(np.float32)
    resp = np.asarray(harris.min_eig_response(jnp.asarray(eq)))
    ref = oracles.min_eig_response(eq)
    bound = 1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
    _report(f"min_eig_response {w}x{h} max |err| / (1e-5 |ref| + "
            "1e-6 max|ref|)", float(np.max(np.abs(resp - ref) / bound)), 1.0)

    # descriptors of two real frames (GFTT + SIFT, 512 keypoints)
    extract = pipeline.build_image_extractor("GFTT", "SIFT", FR1, max_kp=512)
    fa = extract(jnp.asarray(gray), jnp.asarray(depth))
    fb = extract(jnp.asarray(gray2), jnp.asarray(depth2))
    da, db = np.asarray(fa.desc[0]), np.asarray(fb.desc[0])
    va, vb = np.asarray(fa.kp_valid[0]), np.asarray(fb.kp_valid[0])
    d = np.asarray(match.l2_distance_matrix(jnp.asarray(da),
                                            jnp.asarray(db)))
    d_ref = oracles.l2_distance_matrix(da, db)
    # float32 dot products of 128 terms: |d^2 - d_ref^2| within
    # 16 eps32 (|a|^2 + |b|^2)
    norms = (da.astype(np.float64) ** 2).sum(1)[:, None] + \
        (db.astype(np.float64) ** 2).sum(1)[None, :]
    err2 = np.abs(d.astype(np.float64) ** 2 - d_ref**2) / np.maximum(norms, 1)
    eps32 = float(np.finfo(np.float32).eps)
    _report(f"l2_distance_matrix {da.shape[0]}x{db.shape[0]}x{da.shape[1]} "
            "max |d^2 - ref^2|/(|a|^2+|b|^2)", float(err2.max()),
            16 * eps32)
    idx, _, ok = map(np.asarray, match.match_nn(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb)))
    # a near-tie: the reference's squared distances to the chosen and to
    # its own best train differ by less than twice the tolerance above
    d2 = np.where(vb[None, :], d_ref**2, np.inf)
    ref_idx = np.argmin(d2, axis=1)
    rows = np.arange(len(idx))
    gap = d2[rows, idx] - d2[rows, ref_idx]
    differ = ok & (idx != ref_idx)
    near_tie = differ & (gap <= 2 * 16 * eps32 * norms[rows, idx])
    log(f"[kernels] match_nn: {int(ok.sum())} valid queries, "
        f"{int(differ.sum())} differ from numpy argmin, "
        f"{int(near_tie.sum())} of them near-ties")
    check(int((differ & ~near_tie).sum()) == 0,
          "match_nn differs from numpy beyond near-ties")

    # quartic roots against np.roots, every case kind
    per_kind = -(-n_quartics // len(oracles.QUARTIC_TOLERANCES))
    for kind, (med_tol, p99_tol) in sorted(
            oracles.QUARTIC_TOLERANCES.items()):
        c = oracles.quartic_cases(kind, per_kind, rng)
        roots = np.asarray(polynomial.quartic_roots(jnp.asarray(c)))
        check(bool(np.isfinite(roots).all()), f"quartic {kind}: non-finite")
        err = oracles.quartic_root_error(c, roots)
        _report(f"quartic_roots {kind} x{per_kind} median rel err",
                float(np.median(err)), med_tol)
        _report(f"quartic_roots {kind} x{per_kind} p99 rel err",
                float(np.quantile(err, 0.99)), p99_tol)

    # PnP RANSAC on a known pose: 300 points, 1 px noise, 25% outliers
    rvec = np.array([0.1, -0.2, 0.05])
    tvec = np.array([0.1, -0.05, 0.2])
    pw = rng.uniform(-1.5, 1.5, (300, 3)) + [0.0, 0.0, 3.0]
    pc = pw @ se3.rodrigues(rvec).T + tvec
    uv = np.column_stack([pc[:, 0] * FR1.fx / pc[:, 2] + FR1.cx,
                          pc[:, 1] * FR1.fy / pc[:, 2] + FR1.cy])
    uv += rng.normal(0, 1.0, uv.shape)
    bad = rng.random(len(uv)) < 0.25
    uv[bad] = rng.uniform(0, [w, h], (int(bad.sum()), 2))
    res = pnp.solve_pnp_ransac(
        jnp.asarray(pw, jnp.float32), jnp.asarray(uv, jnp.float32),
        jnp.ones(len(uv), bool), FR1.fx, FR1.fy, FR1.cx, FR1.cy,
        jax.random.PRNGKey(seed), reproj_thresh=8.0, hypotheses=256)
    check(bool(res.ok), "solve_pnp_ransac: not ok")
    _report("solve_pnp_ransac rotation error",
            float(np.abs(np.asarray(res.rvec) - rvec).max()), 1e-2, " rad")
    _report("solve_pnp_ransac translation error",
            float(np.abs(np.asarray(res.tvec) - tvec).max()), 1e-2, " m")

    # pose-graph LM on a synthetic loopy graph with known solution
    opt, gt, n_loops = make_loopy_graph(posegraph_vertices, seed=1)
    ate0 = graph_ate(opt, gt)
    t0 = time.time()
    chi = opt.optimize(n_iters=15, solver="cg")
    ate1 = graph_ate(opt, gt)
    log(f"[kernels] pose-graph LM {posegraph_vertices} vertices, {n_loops} "
        f"loops: ATE {ate0:.4f} -> {ate1:.4f} m, chi2 {chi:.1f}, "
        f"{time.time() - t0:.1f}s")
    check(bool(np.isfinite(chi)) and ate1 < ate0,
          "pose-graph LM did not reduce the error")
    # 0.049 m is the converged optimum at 2048 vertices
    # (tests/test_pose_graph_scale.py holds it to 0.06 m)
    _report("pose-graph ATE after LM", ate1, 0.06, " m")


# ---------------------------------------------------------------------------
# phases 4 and 5: the CLIs
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cwd(path: str):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _write_params(path: str, dataset: str, **overrides) -> None:
    values = dict(data_source=dataset, camera_fx=FR1.fx, camera_fy=FR1.fy,
                  camera_cx=FR1.cx, camera_cy=FR1.cy,
                  camera_factor=FR1.factor, **overrides)
    with open(path, "w") as f:
        for k, v in values.items():
            f.write(f"{k}: {v}\n")


def _summarize(label: str, dataset: str, traj, wall_s: float) -> dict:
    """Read the run's outputs in the current directory: keyframes, loop
    edges, and ATE of generateTrajectory's output against ground truth."""
    from slam3d_gx.cli import generate_trajectory

    generate_trajectory.generate("data/keyframe.txt", "data/final_after.g2o")
    frame_of_ts = {float(r.rgb_ts): i for i, r in enumerate(
        tum.read_associate(os.path.join(dataset, "associate.txt")))}
    rows = tum.read_trajectory("trajectory.txt")
    gt = [traj[frame_of_ts[ts]] for ts, _ in rows]
    est = [se3.set_estimate_data(p) for _, p in rows]
    ate = synthetic.ate_rmse(gt, est)
    graph = g2o_io.load_g2o("data/final_after.g2o")
    loops = sorted((min(e.id1, e.id2), max(e.id1, e.id2))
                   for e in graph.edges if abs(e.id1 - e.id2) > 1)
    out = dict(keyframes=[f for _, f in tum.read_keyframes(
        "data/keyframe.txt")], loop_edges=loops, ate_m=ate, wall_s=wall_s,
        poses=est)
    log(f"[{label}] keyframes {len(out['keyframes'])}, loop-closure edges "
        f"{len(loops)}, wall {wall_s:.1f}s (cold, compile included), "
        f"ATE {ate:.4f} m (bound {ATE_BOUND_M} m)")
    return out


def phase_streaming(workdir: str, dataset: str, traj, n_loops: int,
                    chunk: int = 32, mesh_devices: int = 0,
                    **params) -> dict:
    """run_SLAM_streaming <n_loops> <chunk> planes, then
    generateTrajectory; returns the run's summary and holds its ATE to
    the bound."""
    from slam3d_gx.cli import run_slam_streaming

    label = f"streaming mesh_devices={mesh_devices}"
    with _cwd(workdir):
        _write_params("parameters.yaml", dataset,
                      **{**BENCH_PARAMS, **params,
                         "mesh_devices": mesh_devices})
        t0 = time.time()
        ge = run_slam_streaming.run([str(n_loops), str(chunk), "planes"])
        summary = _summarize(label, dataset, traj, time.time() - t0)
    summary["frontend"] = ge
    check(summary["ate_m"] < ATE_BOUND_M, f"{label}: ATE {summary['ate_m']}")
    return summary


def phase_per_frame(workdir: str, dataset: str, traj, n_loops: int,
                    kind: str, **params) -> dict:
    """run_SLAM (kind "planes") or run_SLAM_imageonly for n_loops frames
    with the reference's default SIFT detector, then generateTrajectory;
    holds the ATE to the bound."""
    from slam3d_gx.cli import run_slam
    from slam3d_gx.frontend import GraphicEnd, GraphicEnd2

    cls = GraphicEnd if kind == "planes" else GraphicEnd2
    label = "run_SLAM" if kind == "planes" else "run_SLAM_imageonly"
    with _cwd(workdir):
        _write_params("parameters.yaml", dataset,
                      **{**BENCH_PARAMS, "detector_name": "SIFT", **params})
        t0 = time.time()
        run_slam.run(cls, [str(n_loops)])
        summary = _summarize(label, dataset, traj, time.time() - t0)
    check(summary["ate_m"] < ATE_BOUND_M, f"{label}: ATE {summary['ate_m']}")
    return summary


def compare_mesh_runs(single: dict, sharded: dict,
                      pose_tol_m: float = 0.01) -> None:
    """Same keyframes and loop edges, trajectories within pose_tol_m
    (float reduction order differs across devices)."""
    check(single["keyframes"] == sharded["keyframes"],
          "keyframe sets differ between mesh_devices 0 and 4")
    check(single["loop_edges"] == sharded["loop_edges"],
          "loop edges differ between mesh_devices 0 and 4")
    diff = max(float(np.abs(a[:3, 3] - b[:3, 3]).max())
               for a, b in zip(single["poses"], sharded["poses"]))
    log(f"[mesh] keyframes and loop edges equal; max trajectory position "
        f"difference {diff:.3g} m (tolerance {pose_tol_m} m)")
    check(diff <= pose_tol_m, f"trajectories differ by {diff} m")


def report_sharded_arrays(min_devices: int) -> int:
    """Print every live array spread over more than one device; returns
    how many span min_devices or more."""
    import jax

    n = 0
    for a in jax.live_arrays():
        k = len(a.sharding.device_set)
        if k > 1:
            log(f"[mesh] array {a.shape} {a.dtype}: {a.sharding}, "
                f"device_set size {k}")
            n += k >= min_devices
    return n


def run_phases(devices: int, info: dict, root: str) -> None:
    """Phases 2-5 (or, with devices=4, the sharded path) under root."""
    if devices == 4:
        check(info["count"] >= 4, f"--devices 4 needs 4 GPUs, found "
              f"{info['count']}")
        traj = phase_dataset(os.path.join(root, "ds"), STREAM_LOOPS + 1,
                             seed=SEED)
        runs = {}
        for mesh in (4, 0):
            runs[mesh] = phase_streaming(
                os.path.join(root, f"mesh{mesh}"), os.path.join(root, "ds"),
                traj, STREAM_LOOPS, mesh_devices=mesh, loop_closure_scored=1)
            if mesh == 4:
                check(report_sharded_arrays(4) > 0,
                      "no array spans four devices")
                check(runs[4]["frontend"].mesh.devices.size == 4,
                      "frontend mesh is not four devices")
            runs[mesh].pop("frontend")
        compare_mesh_runs(runs[0], runs[4])
    else:
        traj = phase_dataset(os.path.join(root, "ds"), STREAM_LOOPS + 1,
                             seed=SEED)
        phase_kernels(os.path.join(root, "ds"))
        phase_streaming(os.path.join(root, "stream"),
                        os.path.join(root, "ds"), traj, STREAM_LOOPS)
        for kind in ("planes", "imageonly"):
            phase_per_frame(os.path.join(root, kind),
                            os.path.join(root, "ds"), traj,
                            PERFRAME_LOOPS, kind)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: jax platform is {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 1
    from slam3d_gx.utils import compile_cache

    log(f"[card] compile cache: {compile_cache.enable(jax)}")
    info = phase_card()
    t_start = time.time()
    if args.workdir:
        run_phases(args.devices, info, args.workdir)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            run_phases(args.devices, info, root)

    log(f"[done] all phases passed in {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
