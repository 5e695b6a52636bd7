import numpy as np

from slam3d_gx.geometry import se3
from slam3d_gx.io import tum


def write_associate(path, n=5, with_odo=True):
    with open(path, "w") as f:
        for i in range(n):
            ts = 1000.0 + i * 0.03
            row = f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png"
            if with_odo:
                row += f" {ts:.6f} {0.1*i} {0.2*i} {0.3*i} 0 0 0 1"
            f.write(row + "\n")


def test_read_associate(tmp_path):
    p = str(tmp_path / "associate.txt")
    write_associate(p)
    rows = tum.read_associate(p)
    assert len(rows) == 5
    assert rows[2].rgb_path.startswith("rgb/")
    np.testing.assert_allclose(rows[3].pose[:3], [0.3, 0.6, 0.9])


def test_read_odometry_applies_remap(tmp_path):
    p = str(tmp_path / "associate.txt")
    write_associate(p)
    odo = tum.read_odometry(p)
    assert len(odo) == 5
    # translation remap (-ty, -tz, tx)
    np.testing.assert_allclose(odo[1][:3, 3], [-0.2, -0.3, 0.1], atol=1e-12)
    np.testing.assert_allclose(odo[1][:3, :3], np.eye(3), atol=1e-12)


def test_trajectory_roundtrip(tmp_path):
    p = str(tmp_path / "trajectory.txt")
    rows = [("1000.5", se3.get_estimate_data(np.eye(4)))]
    tum.write_trajectory(p, rows)
    back = tum.read_trajectory(p)
    assert len(back) == 1
    assert back[0][0] == 1000.5
    np.testing.assert_allclose(back[0][1], [0, 0, 0, 0, 0, 0, 1], atol=1e-12)


def test_keyframes_roundtrip(tmp_path):
    p = str(tmp_path / "keyframe.txt")
    tum.write_keyframes(p, [(0, 50), (1, 66)])
    assert tum.read_keyframes(p) == [(0, 50), (1, 66)]


def test_reference_keyframe_fixture(reference_dir):
    kf = tum.read_keyframes(reference_dir + "/data/keyframe.txt")
    assert len(kf) == 117
    assert kf[0] == (0, 50)


def test_reference_trajectory_fixture(reference_dir):
    rows = tum.read_trajectory(reference_dir + "/trajectory.txt")
    assert len(rows) == 73
    np.testing.assert_allclose(rows[0][1], [0, 0, 0, 0, 0, 0, 1])


def test_associate_algorithm():
    first = {1.00: ["a"], 1.05: ["b"], 2.0: ["c"]}
    second = {1.01: ["x"], 1.06: ["y"], 5.0: ["z"]}
    m = tum.associate_timestamps(first, second, 0.0, 0.02)
    assert m == [(1.00, 1.01), (1.05, 1.06)]
