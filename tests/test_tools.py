"""Tests for the dataset-prep and evaluation tools (SURVEY.md §2.1 rows 29-31)."""

import os
import subprocess
import sys

import numpy as np
import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)


def run_tool(name, *args, cwd=None):
    return subprocess.run(
        [sys.executable, os.path.join(TOOLS, name), *args],
        capture_output=True, text=True, cwd=cwd,
    )


# --- associate -------------------------------------------------------------

def test_associate_nearest(tmp_path):
    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_text("# comment\n1.00 rgb/1.png\n2.00 rgb/2.png\n3.00 rgb/3.png\n")
    b.write_text("1.005 d/1.png\n2.30 d/2.png\n2.995 d/3.png\n")
    r = run_tool("associate.py", str(a), str(b))
    assert r.returncode == 0
    lines = r.stdout.strip().splitlines()
    # 2.00 has no partner within 0.02
    assert len(lines) == 2
    assert lines[0].split()[1] == "rgb/1.png" and lines[0].split()[3] == "d/1.png"
    assert lines[1].split()[1] == "rgb/3.png" and lines[1].split()[3] == "d/3.png"


def test_associate_greedy_unique(tmp_path):
    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_text("1.000 x\n1.010 y\n")
    b.write_text("1.004 p\n")
    r = run_tool("associate.py", str(a), str(b))
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1  # each row used once, best pair wins
    assert lines[0].split()[1] == "x"


# --- generateTxt / change2index / prepare ----------------------------------

def test_generate_and_index(tmp_path):
    from PIL import Image

    rgb = tmp_path / "rgb"
    dep = tmp_path / "depth"
    rgb.mkdir()
    dep.mkdir()
    for i, ts in enumerate([1.0, 1.05, 1.1], start=1):
        Image.fromarray(np.full((4, 4), i * 10, np.uint8)).save(rgb / f"{ts:.6f}.png")
        Image.fromarray(np.full((4, 4), i * 100, np.uint16)).save(dep / f"{ts:.6f}.png")

    assert run_tool("generateTxt.py", str(rgb), str(tmp_path / "rgb.txt")).returncode == 0
    assert run_tool("generateTxt.py", str(dep), str(tmp_path / "depth.txt")).returncode == 0
    rows = (tmp_path / "rgb.txt").read_text().strip().splitlines()
    assert len(rows) == 3 and rows[0].split()[1].startswith("rgb/")

    r = run_tool("associate.py", str(tmp_path / "rgb.txt"), str(tmp_path / "depth.txt"))
    (tmp_path / "associate.txt").write_text(r.stdout)
    assert run_tool("change2index.py", str(tmp_path)).returncode == 0
    for i in (1, 2, 3):
        assert (tmp_path / "rgb_index" / f"{i}.png").exists()
        assert (tmp_path / "dep_index" / f"{i}.png").exists()

    r = run_tool("img2pcd.py", str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "pcd" / "1.pcd").exists()
    from slam3d_gx.io import pcd as pcd_io
    xyz, rgba = pcd_io.read_pcd(str(tmp_path / "pcd" / "1.pcd"))
    assert xyz.shape[0] == 16  # all depths nonzero


# --- evaluate_rpe / evaluate_ate --------------------------------------------

def _write_traj(path, poses, t0=100.0):
    from slam3d_gx.geometry import se3
    rows = []
    for i, T in enumerate(poses):
        d = se3.get_estimate_data(T)
        rows.append(f"{t0 + 0.1 * i:.6f} " + " ".join(f"{v:.9g}" for v in d))
    path.write_text("\n".join(rows) + "\n")


def _orbit(n, drift=0.0):
    from slam3d_gx.geometry import se3
    rng = np.random.default_rng(1)
    out = []
    T = np.eye(4)
    for i in range(n):
        step = se3.make_isometry(
            se3.rodrigues(np.array([0, 0.05, 0.0])), np.array([0.1, 0, 0.0]))
        T = T @ step
        Td = T.copy()
        Td[:3, 3] += drift * rng.normal(0, 1, 3)
        out.append(Td)
    return out


def test_evaluate_rpe_perfect(tmp_path):
    poses = _orbit(20)
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    _write_traj(gt, poses)
    _write_traj(est, poses)
    r = run_tool("evaluate_rpe.py", str(gt), str(est),
                 "--fixed_delta", "--delta", "0.1", "--verbose")
    assert r.returncode == 0, r.stderr
    rmse = float([l for l in r.stdout.splitlines()
                  if "translational_error.rmse" in l][0].split()[1])
    assert rmse < 1e-6


def test_evaluate_rpe_drift(tmp_path):
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    _write_traj(gt, _orbit(20))
    _write_traj(est, _orbit(20, drift=0.05))
    r = run_tool("evaluate_rpe.py", str(gt), str(est),
                 "--fixed_delta", "--delta", "0.1")
    assert r.returncode == 0, r.stderr
    assert 0.005 < float(r.stdout.strip()) < 1.0


def test_evaluate_ate(tmp_path):
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    poses = _orbit(20)
    # est = gt in a different gauge (rotated + shifted frame)
    from slam3d_gx.geometry import se3
    G = se3.make_isometry(se3.rodrigues(np.array([0.1, 0.7, -0.2])),
                          np.array([3.0, -1.0, 2.0]))
    _write_traj(gt, poses)
    _write_traj(est, [G @ T for T in poses])
    r = run_tool("evaluate_ate.py", str(gt), str(est), "--verbose")
    assert r.returncode == 0, r.stderr
    rmse = float([l for l in r.stdout.splitlines()
                  if ".rmse" in l][0].split()[1])
    assert rmse < 1e-6  # alignment removes the gauge


def test_testrpe_smoke():
    r = run_tool("testrpe.py")
    assert r.returncode == 0, r.stderr
    assert "ok" in r.stdout


def test_draw_trajectory(tmp_path):
    traj = tmp_path / "trajectory.txt"
    _write_traj(traj, _orbit(10))
    out = tmp_path / "traj.pdf"
    r = run_tool("drawTrajectory.py", str(traj), str(tmp_path / "none.txt"), str(out))
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 100


def test_record_gated():
    r = run_tool("record.py", "/tmp")
    assert r.returncode == 1
    assert "ROS" in r.stderr
