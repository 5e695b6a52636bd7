"""CPU rehearsal of chip_smoke.py's phases at a tiny size (320x240,
8 frames), and the script's refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

N_FRAMES = 8
SMALL = dict(height=240, width=320, radius=0.12, yaw_amp=0.06)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke_ds"))
    traj = chip_smoke.phase_dataset(root, N_FRAMES, **SMALL)
    return root, traj


def test_phase_card_reports_cpu():
    info = chip_smoke.phase_card(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_card(require_gpu=True)


def test_phase_kernels_tiny(dataset):
    root, _ = dataset
    chip_smoke.phase_kernels(root, n_quartics=500, posegraph_vertices=512)


def test_phase_streaming_tiny(dataset, tmp_path):
    root, traj = dataset
    out = chip_smoke.phase_streaming(
        str(tmp_path), root, traj, N_FRAMES - 1, chunk=4,
        max_keypoints=256, ransac_hypotheses=128, max_pos_change=0.05)
    assert len(out["keyframes"]) >= 3
    assert out["ate_m"] < chip_smoke.ATE_BOUND_M


@pytest.mark.parametrize("kind", ["planes", "imageonly"])
def test_phase_per_frame_tiny(dataset, tmp_path, kind):
    root, traj = dataset
    out = chip_smoke.phase_per_frame(
        str(tmp_path), root, traj, N_FRAMES - 1, kind,
        detector_name="GFTT", max_keypoints=256, ransac_hypotheses=128,
        max_pos_change=0.05)
    assert len(out["keyframes"]) >= 3


@pytest.mark.gpu
def test_phase_kernels_on_gpu(gpu, tmp_path):
    """The kernel phase at full width on the card."""
    root = str(tmp_path / "ds")
    chip_smoke.phase_dataset(root, 6)
    chip_smoke.phase_kernels(root)


def test_compare_mesh_runs():
    a = dict(keyframes=[1, 4], loop_edges=[(0, 3)],
             poses=[np.eye(4), np.eye(4)])
    chip_smoke.compare_mesh_runs(a, dict(a))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_mesh_runs(a, dict(a, loop_edges=[]))


def test_main_refuses_without_gpu():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, SLAM3D_PLATFORM="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
