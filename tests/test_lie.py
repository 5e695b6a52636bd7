import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

from slam3d_gx.geometry import se3
from slam3d_gx.ops import lie


def test_rodrigues_matches_host(rng):
    rvecs = rng.normal(size=(64, 3)).astype(np.float32)
    R = np.asarray(lie.rodrigues(jnp.asarray(rvecs)))
    for i in range(len(rvecs)):
        np.testing.assert_allclose(R[i], se3.rodrigues(rvecs[i]), atol=1e-5)


def test_rodrigues_small_angle():
    R = np.asarray(lie.rodrigues(jnp.zeros((1, 3))))
    np.testing.assert_allclose(R[0], np.eye(3), atol=1e-6)


def test_inv_rodrigues_roundtrip(rng):
    rvecs = rng.normal(size=(64, 3)).astype(np.float32)
    rvecs = rvecs / np.linalg.norm(rvecs, axis=1, keepdims=True)
    rvecs *= rng.uniform(0.01, 3.1, size=(64, 1)).astype(np.float32)
    R = lie.rodrigues(jnp.asarray(rvecs))
    back = np.asarray(lie.inv_rodrigues(R))
    np.testing.assert_allclose(back, rvecs, atol=2e-3)


def test_inv_rodrigues_near_pi(rng):
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rvecs = (axes * (np.pi - 1e-6)).astype(np.float32)
    R = lie.rodrigues(jnp.asarray(rvecs))
    back = np.asarray(lie.inv_rodrigues(R))
    R2 = np.asarray(lie.rodrigues(jnp.asarray(back)))
    np.testing.assert_allclose(R2, np.asarray(R), atol=1e-3)


def test_se3_exp_log_roundtrip(rng):
    xi = rng.normal(size=(32, 6)).astype(np.float32) * 0.5
    T = lie.se3_exp(jnp.asarray(xi))
    back = np.asarray(lie.se3_log(T))
    np.testing.assert_allclose(back, xi, atol=1e-4)


def test_se3_exp_is_valid_isometry(rng):
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    T = np.asarray(lie.se3_exp(jnp.asarray(xi)))
    for t in T:
        np.testing.assert_allclose(t[:3, :3] @ t[:3, :3].T, np.eye(3), atol=1e-5)
        np.testing.assert_allclose(t[3], [0, 0, 0, 1], atol=0)


def test_inv_T(rng):
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    T = lie.se3_exp(jnp.asarray(xi))
    I = np.asarray(T @ lie.inv_T(T))
    np.testing.assert_allclose(I, np.broadcast_to(np.eye(4), I.shape), atol=1e-5)


def test_quat_conversions(rng):
    Rs = Rotation.random(32, random_state=np.random.RandomState(7)).as_matrix().astype(np.float32)
    q = np.asarray(lie.rot_to_quat(jnp.asarray(Rs)))
    for i in range(32):
        q_ref = se3.rot_to_quat(Rs[i])
        np.testing.assert_allclose(q[i], q_ref, atol=1e-5)
    R2 = np.asarray(lie.quat_to_rot(jnp.asarray(q)))
    np.testing.assert_allclose(R2, Rs, atol=1e-5)


def test_vmap_and_jit_compose():
    f = jax.jit(jax.vmap(lie.se3_exp))
    xi = jnp.ones((4, 2, 6)) * 0.1
    out = f(xi)
    assert out.shape == (4, 2, 4, 4)
