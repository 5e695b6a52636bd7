"""L0 dataset-prep chain end-to-end ON REAL PIXELS (VERDICT r3 #7).

Starts from the reference's raw real Kinect recordings (the exp1 frame
pair, reference data/exp1/) laid out as a raw recording (timestamped
rgb/ + dep/ files), then runs the DOCUMENTED prepare workflow
(reference tools/prepare.sh:1-9 / README:43-67) entirely through the
shipped CLIs — generateTxt -> associate -> change2index -> convert2PCD
— and finally `run_SLAM 1` on the produced dataset directory, asserting
keyframe promotion. No test shims anywhere: a user can go from raw
recordings to SLAM output with this repo alone.

The exp1 fixtures predate the fr1 preset: convert2PCD's hardcoded
525/319.5/235.5 factor-1000 intrinsics (src/convert2PCD.cpp:19-23) are
the correct ones for these images (see tests/test_real_kinect.py).
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
BIN = os.path.join(REPO, "bin")


def run_cli(args, cwd, stdout=None):
    env = dict(os.environ)
    env["SLAM3D_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        args, cwd=cwd, env=env,
        stdout=subprocess.PIPE if stdout is None else stdout,
        stderr=subprocess.PIPE, text=(stdout is None))
    assert r.returncode == 0, (args, r.stderr[-2000:])
    return r


@pytest.fixture(scope="module")
def raw_recording(reference_dir, tmp_path_factory):
    """The real exp1 pair laid out as a raw Kinect recording."""
    base = os.path.join(reference_dir, "data", "exp1")
    root = str(tmp_path_factory.mktemp("raw"))
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "dep"))
    # timestamps ~0.3 s apart; depth stamps offset by ~12 ms like a
    # real unsynchronized recording (associate must still pair them)
    frames = [("1759.png", "1.png", 100.000000, 100.012345),
              ("1768.png", "2.png", 100.300000, 100.312345)]
    for rgb_name, dep_name, ts_rgb, ts_dep in frames:
        shutil.copy(os.path.join(base, "rgb", rgb_name),
                    os.path.join(root, "rgb", f"{ts_rgb:.6f}.png"))
        shutil.copy(os.path.join(base, "dep", dep_name),
                    os.path.join(root, "dep", f"{ts_dep:.6f}.png"))
    return root


@pytest.fixture(scope="module")
def prepared_dataset(raw_recording):
    """prepare.sh workflow via the shipped CLIs."""
    root = raw_recording
    py = sys.executable
    run_cli([py, os.path.join(TOOLS, "generateTxt.py"), "rgb", "rgb.txt"],
            cwd=root)
    run_cli([py, os.path.join(TOOLS, "generateTxt.py"), "dep", "dep.txt"],
            cwd=root)
    with open(os.path.join(root, "associate.txt"), "w") as f:
        run_cli([py, os.path.join(TOOLS, "associate.py"),
                 "rgb.txt", "dep.txt", "--max_difference", "0.05"],
                cwd=root, stdout=f)
    run_cli([py, os.path.join(TOOLS, "change2index.py"), "."], cwd=root)
    run_cli([os.path.join(BIN, "convert2PCD"), "1", "3"], cwd=root)
    return root


def test_prepare_chain_outputs(prepared_dataset):
    root = prepared_dataset
    rows = [r.split() for r in open(os.path.join(root, "associate.txt"))
            if r.strip()]
    assert len(rows) == 2
    # rgb matched to the ~12 ms-offset depth stamp
    assert abs(float(rows[0][0]) - 100.0) < 1e-6
    assert abs(float(rows[0][2]) - 100.012345) < 1e-6
    for i in (1, 2):
        assert os.path.exists(os.path.join(root, "rgb_index", f"{i}.png"))
        assert os.path.exists(os.path.join(root, "dep_index", f"{i}.png"))
        assert os.path.exists(os.path.join(root, "pcd", f"{i}.pcd"))
    # the PCDs parse and hold a real cloud
    from slam3d_gx.io import pcd as pcd_io

    xyz, rgba = pcd_io.read_pcd(os.path.join(root, "pcd", "1.pcd"))
    assert xyz.shape[0] > 50_000
    assert (xyz[:, 2] > 0).all()


def test_run_slam_on_prepared_real_dataset(prepared_dataset):
    """run_SLAM 1 on the chain's output: frame 2 must register against
    the init keyframe and be promoted (real-pixel end-to-end)."""
    root = prepared_dataset
    with open(os.path.join(root, "parameters.yaml"), "w") as f:
        f.write("""\
data_source: .
detector_name: GFTT
descriptor_name: SIFT
camera_fx: 525.0
camera_fy: 525.0
camera_cx: 319.5
camera_cy: 235.5
camera_factor: 1000
max_keypoints: 256
ransac_hypotheses: 128
max_pos_change: 0.01
loop_closure_detection: no
""")
    r = run_cli([os.path.join(BIN, "run_SLAM"), "1"], cwd=root)
    assert "keyframes: 2" in r.stdout, r.stdout[-2000:]
    kf = [row.split() for row in
          open(os.path.join(root, "data", "keyframe.txt")) if row.strip()]
    assert len(kf) == 2 and kf[1] == ["1", "2"]
    for name in ("final.g2o", "final_after.g2o", "error_of_transform.log"):
        assert os.path.exists(os.path.join(root, "data", name))
    # the per-frame motion norm logged a real (non-lost) registration
    norm = float(open(os.path.join(
        root, "data", "error_of_transform.log")).read().split()[0])
    assert norm != 9999 and 0.0 < norm < 1.0
