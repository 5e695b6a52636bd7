"""Unit coverage for the two headless utility CLIs (VERDICT r4 #8).

- planarFeatures (reference src/planarFeatures.cpp:26-136): FAST
  keypoints classified planar via micro plane-RANSAC on the 7x7 depth
  patch — driven on the reference's real Kinect frame (data/exp1).
- viewLC (reference src/viewLC.cpp:20-65): replays a 4-column lc.txt,
  tolerating 3-column rows, malformed rows, and closures whose frames
  are missing on disk.
"""

import os

import numpy as np
import pytest

from slam3d_gx.config import CameraIntrinsics, ParameterReader
from slam3d_gx.io import images

# the exp1 fixtures predate the fr1 preset: factor-1000 depth with
# convert2PCD intrinsics (src/convert2PCD.cpp:19-23)
INTR = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=235.5,
                        factor=1000.0)


@pytest.fixture(scope="module")
def real_frame(reference_dir):
    base = os.path.join(reference_dir, "data", "exp1")
    gray = images.load_gray(os.path.join(base, "rgb", "1759.png"))
    depth = images.load_depth(os.path.join(base, "dep", "1.png"))
    return gray, depth


def test_planar_features_real_fixture(real_frame):
    """classify_planar on real Kinect pixels: both classes must be
    populated — an office scene has walls/desk (planar) and clutter
    edges (non-planar) — and planar must imply a valid keypoint."""
    from slam3d_gx.cli.planar_features import classify_planar

    gray, depth = real_frame
    kps, planar = classify_planar(gray, depth, INTR, max_kp=256)
    valid = np.asarray(kps.valid)
    pl = np.asarray(planar)
    assert valid.sum() > 20, "FAST found almost nothing on a real frame"
    assert not np.any(pl & ~valid), "planar verdict on an invalid keypoint"
    assert 0 < pl.sum() < valid.sum(), (
        f"degenerate classification: {pl.sum()} planar of {valid.sum()}")


def test_planar_features_cli_main(reference_dir, tmp_path, monkeypatch,
                                  capsys):
    """The CLI entry point runs headless end-to-end and writes the
    visualization PNG (the reference shows an imshow window instead —
    documented delta)."""
    from slam3d_gx.cli import planar_features

    base = os.path.join(reference_dir, "data", "exp1")
    monkeypatch.chdir(tmp_path)
    rc = planar_features.main([os.path.join(base, "rgb", "1759.png"),
                               os.path.join(base, "dep", "1.png")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "keypoints:" in out and "planar:" in out
    vis = tmp_path / "planar_features.png"
    assert vis.exists() and vis.stat().st_size > 0


def test_view_lc_tolerates_missing_frames_and_short_rows(tmp_path, capsys):
    """viewLC must replay every parseable closure, skip closures whose
    frames are missing on disk without dying, and accept both the
    canonical 4-column rows (src/GraphicEnd.cpp:861) and older
    3-column files."""
    from slam3d_gx.cli.view_lc import view

    root = tmp_path / "ds"
    rgb = root / "rgb_index"
    rgb.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in (1, 2):
        images.save_gray(str(rgb / f"{i}.png"),
                         rng.integers(0, 255, (48, 64)).astype(np.uint8))

    lc = tmp_path / "lc.txt"
    lc.write_text(
        "1 2 0.5123 41\n"      # canonical 4-column, frames exist
        "7 9 0.3000 25\n"      # frames missing on disk -> skipped
        "2 1 0.4\n"            # legacy 3-column, frames exist
        "5\n"                  # malformed short row -> ignored
        "\n")

    out_dir = tmp_path / "lc_view"
    params = ParameterReader(None, overrides={"data_source": str(root)})
    rc = view(str(lc), params=params, out_dir=str(out_dir))
    assert rc == 0
    out = capsys.readouterr().out
    assert "1 <-> 2" in out and "7 <-> 9" in out and "2 <-> 1" in out
    assert (out_dir / "lc_1_2.png").exists()
    assert (out_dir / "lc_2_1.png").exists()
    assert not (out_dir / "lc_7_9.png").exists()
    assert "2 loop closures rendered" in out
