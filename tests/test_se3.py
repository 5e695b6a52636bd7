import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from slam3d_gx.geometry import se3


def random_rotations(n, rng):
    return Rotation.random(n, random_state=np.random.RandomState(int(rng.integers(1 << 30)))).as_matrix()


def test_quat_roundtrip(rng):
    for R in random_rotations(50, rng):
        q = se3.rot_to_quat(R)
        np.testing.assert_allclose(se3.quat_to_rot(q), R, atol=1e-12)
        assert q[3] >= 0
        # matches scipy up to sign
        q_sp = Rotation.from_matrix(R).as_quat()
        assert np.allclose(q, q_sp, atol=1e-10) or np.allclose(q, -q_sp, atol=1e-10)


def test_rodrigues_roundtrip(rng):
    for _ in range(50):
        rvec = rng.normal(size=3)
        R = se3.rodrigues(rvec)
        np.testing.assert_allclose(R, Rotation.from_rotvec(rvec).as_matrix(), atol=1e-12)
        theta = np.linalg.norm(rvec)
        if theta < np.pi:  # inverse is canonical in [0, pi)
            np.testing.assert_allclose(se3.inv_rodrigues(R), rvec, atol=1e-8)


def test_inv_rodrigues_near_pi(rng):
    for _ in range(20):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        rvec = axis * (np.pi - 1e-9)
        R = se3.rodrigues(rvec)
        r2 = se3.inv_rodrigues(R)
        np.testing.assert_allclose(se3.rodrigues(r2), R, atol=1e-6)


def test_isometry_inverse(rng):
    for R in random_rotations(10, rng):
        T = se3.make_isometry(R, rng.normal(size=3))
        np.testing.assert_allclose(se3.inverse(T) @ T, np.eye(4), atol=1e-12)


def test_estimate_data_roundtrip(rng):
    for R in random_rotations(10, rng):
        T = se3.make_isometry(R, rng.normal(size=3))
        d = se3.get_estimate_data(T)
        np.testing.assert_allclose(se3.set_estimate_data(d), T, atol=1e-12)


def test_euler_zxz_reconstruction(rng):
    """eulerAngles(2,0,2): R == Rz(a0) * Rx(a1) * Rz(a2)."""
    ez = np.array([0.0, 0.0, 1.0])
    ex = np.array([1.0, 0.0, 0.0])
    for R in random_rotations(100, rng):
        a = se3.euler_angles(R, 2, 0, 2)
        R2 = (
            se3.axis_angle_matrix(a[0], ez)
            @ se3.axis_angle_matrix(a[1], ex)
            @ se3.axis_angle_matrix(a[2], ez)
        )
        np.testing.assert_allclose(R2, R, atol=1e-9)
        # Eigen range convention: first angle in [0, pi]
        assert 0.0 - 1e-12 <= a[0] <= np.pi + 1e-12


def test_euler_tait_bryan_reconstruction(rng):
    axes = [np.eye(3)[i] for i in range(3)]
    for R in random_rotations(50, rng):
        a = se3.euler_angles(R, 0, 1, 2)
        R2 = (
            se3.axis_angle_matrix(a[0], axes[0])
            @ se3.axis_angle_matrix(a[1], axes[1])
            @ se3.axis_angle_matrix(a[2], axes[2])
        )
        np.testing.assert_allclose(R2, R, atol=1e-9)


def test_odometry_remap_identity():
    # identity pose -> identity-rotation with zero translation
    T = se3.odometry_remap([0, 0, 0, 0, 0, 0, 1])
    np.testing.assert_allclose(T, np.eye(4), atol=1e-12)


def test_odometry_remap_translation_axes():
    # pure translation (tx,ty,tz) -> (-ty,-tz,tx) (src/GraphicEnd.h:166-168)
    T = se3.odometry_remap([1.0, 2.0, 3.0, 0, 0, 0, 1])
    np.testing.assert_allclose(T[:3, 3], [-2.0, -3.0, 1.0], atol=1e-12)
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=1e-12)


def test_odometry_remap_yaw():
    # pure z-rotation psi: eulerAngles(2,0,2) of Rz(psi) gives rpy[2]
    psi = 0.7
    q = Rotation.from_euler("z", psi).as_quat()
    T = se3.odometry_remap([0, 0, 0, *q])
    # yaw rotation about -Y by rpy[2]
    R_full = Rotation.from_quat(q).as_matrix()
    rpy = se3.euler_angles(R_full, 2, 0, 2)
    expected = se3.axis_angle_matrix(rpy[2], np.array([0.0, -1.0, 0.0]))
    np.testing.assert_allclose(T[:3, :3], expected, atol=1e-12)


def test_motion_norms():
    rvec = np.array([0.1, 0.0, 0.0])
    tvec = np.array([0.0, 0.2, 0.0])
    assert se3.motion_norm(rvec, tvec) == pytest.approx(0.1 + 0.9 * 0.2)
    assert se3.motion_norm2(rvec, tvec) == pytest.approx(0.1 + 0.2)
    big = np.array([2 * np.pi - 0.1, 0, 0])
    assert se3.motion_norm(big, tvec) == pytest.approx(0.1 + 0.9 * 0.2)
