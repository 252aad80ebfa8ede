import numpy as np
import pytest

import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from dynamic_direct_lidar_odometry.core import se3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_so3_exp_matches_scipy(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    q = np.asarray(se3.so3_exp_quat(jnp.asarray(w)))
    R = np.asarray(se3.quat_to_matrix(jnp.asarray(q)))
    R_ref = Rotation.from_rotvec(w).as_matrix()
    np.testing.assert_allclose(R, R_ref, atol=1e-5)


def test_so3_exp_small_angle():
    w = jnp.array([[1e-8, -1e-9, 2e-8], [0.0, 0.0, 0.0]])
    q = se3.so3_exp_quat(w)
    np.testing.assert_allclose(np.asarray(q[:, 0]), 1.0, atol=1e-6)
    R = se3.quat_to_matrix(q)
    np.testing.assert_allclose(np.asarray(R), np.eye(3)[None].repeat(2, 0), atol=1e-6)


def test_matrix_quat_roundtrip():
    rng = np.random.default_rng(3)
    R_ref = Rotation.random(32, random_state=rng).as_matrix().astype(np.float32)
    q = se3.matrix_to_quat(jnp.asarray(R_ref))
    R = np.asarray(se3.quat_to_matrix(q))
    np.testing.assert_allclose(R, R_ref, atol=1e-5)


def test_quat_mul_matches_scipy():
    rng = np.random.default_rng(4)
    a = Rotation.random(8, random_state=rng)
    b = Rotation.random(8, random_state=rng)
    qa = np.roll(a.as_quat(), 1, axis=-1)  # scipy xyzw -> wxyz
    qb = np.roll(b.as_quat(), 1, axis=-1)
    q = np.asarray(se3.quat_mul(jnp.asarray(qa), jnp.asarray(qb)))
    q_ref = np.roll((a * b).as_quat(), 1, axis=-1)
    # sign ambiguity
    sign = np.sign(np.sum(q * q_ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(q * sign, q_ref, atol=1e-6)


def test_transform_points():
    rng = np.random.default_rng(5)
    R = Rotation.random(random_state=rng).as_matrix().astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    T = se3.from_rt(jnp.asarray(R), jnp.asarray(t))
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    out = np.asarray(se3.transform_points(T, jnp.asarray(pts)))
    np.testing.assert_allclose(out, pts @ R.T + t, atol=1e-5)


def test_quat_angle_deg():
    w = np.array([0.3, -0.2, 0.1], dtype=np.float32)
    q = se3.so3_exp_quat(jnp.asarray(w))
    angle = float(se3.quat_angle_deg(q))
    np.testing.assert_allclose(angle, np.linalg.norm(w) * 180 / np.pi, rtol=1e-4)
