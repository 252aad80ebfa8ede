"""SO(3)/SE(3) primitives for the registration engine.

Functional equivalents of the reference's Sophus-derived helpers
(``include/nano_gicp/gicp/so3.hpp:50-124``) plus the small amount of
quaternion plumbing OdomNode does by hand (``src/odometry/odom.cc:921-955``).
All functions are pure, f32-by-default, batched via leading dims where
noted, and safe under ``jit``/``vmap`` (Taylor fallbacks near theta=0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix (..., 3) -> (..., 3, 3). so3.hpp:50-74."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp_quat(omega: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> unit quaternion [w, x, y, z].

    Matches the reference's Sophus-derived ``so3_exp`` (so3.hpp:101-124):
    q = [cos(theta/2), sin(theta/2)/theta * omega], with the standard
    Taylor expansion of sin(theta/2)/theta for small theta.
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS))
    half = 0.5 * theta
    small = theta_sq < 1e-10
    # sin(theta/2)/theta, guarded for theta -> 0
    imag_big = jnp.sin(half) / jnp.where(small, 1.0, theta)
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq
    imag = jnp.where(small, imag_small, imag_big)
    real = jnp.where(small, 1.0 - (1.0 / 8.0) * theta_sq, jnp.cos(half))
    return jnp.concatenate([real[..., None], imag[..., None] * omega], axis=-1)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [w,x,y,z] (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> unit quaternion [w,x,y,z].

    Branch-free Shepperd's method: compute all four candidate forms and
    select the numerically best by the largest diagonal combination.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # candidate 0: trace
    s0 = _safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack(
        [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1
    )
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack(
        [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1
    )
    s2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack(
        [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1
    )
    s3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack(
        [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1
    )

    cands = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4, 4)
    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of [w,x,y,z] quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_angle_deg(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle in degrees of a unit quaternion.

    Same formula as the keyframe rotation test (odom.cc:1107-1110):
    theta = 2 atan2(||xyz||, w)."""
    xyz = jnp.linalg.norm(q[..., 1:], axis=-1)
    return 2.0 * jnp.arctan2(xyz, q[..., 0]) * (180.0 / jnp.pi)


def se3_exp(d: jnp.ndarray) -> jnp.ndarray:
    """Twist [omega(3), t(3)] -> 4x4 transform with R=exp(omega), trans=t.

    NOTE: this matches the reference optimizer's update convention
    (lsq_registration_impl.hpp:165-168): the translation part is used
    directly, NOT passed through the SE(3) V-matrix.
    """
    R = quat_to_matrix(so3_exp_quat(d[..., :3]))
    T = jnp.zeros(d.shape[:-1] + (4, 4), dtype=d.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(d[..., 3:])
    T = T.at[..., 3, 3].set(1.0)
    return T


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 transform (..., 4, 4) to points (..., N, 3).

    Computed as explicit elementwise muls/adds rather than a matmul: an
    unpinned f32 matmul may run in a reduced-precision pass (TF32 on the
    GPU keeps ~10 mantissa bits), which turns a 25 m coordinate into
    centimeters of noise — fatal for registration (the reference carries
    full f32/f64 throughout, odom.cc/nano_gicp)."""
    R = T[..., :3, :3]
    out = (
        pts[..., 0:1] * R[..., None, :, 0]
        + pts[..., 1:2] * R[..., None, :, 1]
        + pts[..., 2:3] * R[..., None, :, 2]
    )
    return out + T[..., None, :3, 3]


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """4x4 pose composition at full f32 (a TF32 pass would put ~1e-3
    relative noise on translations — millimeters per step, compounding)."""
    return jnp.matmul(A, B, precision=jax.lax.Precision.HIGHEST)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    T = jnp.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T
