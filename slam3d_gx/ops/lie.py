"""Device-side Lie-group math (jnp, batch-friendly, jit-safe).

The float64 host twin for bookkeeping/codecs is geometry/se3.py; these
versions are branch-free (Taylor-guarded) so they vmap/jit cleanly and run
in float32 on the device.

Conventions match OpenCV Rodrigues / g2o SE3: rotation vectors are
axis*angle; se3 tangent is (rho, phi) with translation first, matching
g2o's EdgeSE3 error ordering (used by the pose-graph optimizer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# 3x3 geometry matmuls must run at full f32 precision — the default
# precision may round f32 matmul inputs (TF32 on the GPU), which is far
# too coarse for rotation algebra.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def hat(v):
    """(…,3) -> (…,3,3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], -1),
            jnp.stack([z, zero, -x], -1),
            jnp.stack([-y, x, zero], -1),
        ],
        -2,
    )


def rodrigues(rvec):
    """(…,3) axis-angle -> (…,3,3) rotation matrix, small-angle safe."""
    theta2 = jnp.sum(rvec * rvec, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with Taylor guards
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    K = hat(rvec)
    KK = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def inv_rodrigues(R):
    """(…,3,3) rotation -> (…,3) axis-angle with theta in [0, pi].

    Routed through the branch-free quaternion extraction, which is
    numerically stable across the whole rotation range (the direct
    trace/arccos route loses ~3 digits near theta=pi in float32).
    """
    q = rot_to_quat(R)
    vec, w = q[..., :3], q[..., 3]
    s = jnp.linalg.norm(vec, axis=-1)
    theta = 2.0 * jnp.arctan2(s, w)
    scale = jnp.where(s > 1e-12, theta / jnp.where(s > 1e-12, s, 1.0), 2.0)
    return vec * scale[..., None]


def make_T(R, t):
    """(…,3,3),(…,3) -> (…,4,4)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def inv_T(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -(_mm(Rt, t[..., None]))[..., 0])


def _so3_left_jacobian(phi):
    """V such that exp_se3 translation = V @ rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    KK = _mm(K, K)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(
        theta2 > _EPS,
        (theta - jnp.sin(theta)) / (theta2 * theta),
        1.0 / 6.0 - theta2 / 120.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * KK


def se3_exp(xi):
    """(…,6) tangent (rho, phi) -> (…,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = rodrigues(phi)
    V = _so3_left_jacobian(phi)
    t = (_mm(V, rho[..., None]))[..., 0]
    return make_T(R, t)


def se3_log(T):
    """(…,4,4) -> (…,6) tangent (rho, phi)."""
    phi = inv_rodrigues(T[..., :3, :3])
    V = _so3_left_jacobian(phi)
    rho = jnp.linalg.solve(V, T[..., :3, 3][..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def rot_to_quat(R):
    """(…,3,3) -> (…,4) quaternion (qx,qy,qz,qw), qw>=0; branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically best
    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, 1e-12, None)) * 0.5
    c0 = jnp.stack([(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw0 * qw0], -1) / (
        4.0 * qw0[..., None]
    )
    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    c1 = jnp.stack([4.0 * qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], -1) / (
        4.0 * qx1[..., None]
    )
    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    c2 = jnp.stack([(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21), (m02 - m20)], -1) / (
        4.0 * qy2[..., None]
    )
    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    c3 = jnp.stack([(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3, (m10 - m01)], -1) / (
        4.0 * qz3[..., None]
    )
    cand = jnp.stack([c0, c1, c2, c3], -2)  # (…,4,4)
    scores = jnp.stack([tr, m00, m11, m22], -1)
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cand, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_rot(q):
    """(…,4) (qx,qy,qz,qw) -> (…,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.where(n > 0, n, 1.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    r0 = jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1)
    r1 = jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1)
    r2 = jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1)
    return jnp.stack([r0, r1, r2], -2)
