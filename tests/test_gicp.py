import numpy as np
import pytest

import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from dynamic_direct_lidar_odometry.core import cloud as cloud_lib
from dynamic_direct_lidar_odometry.ops import covariance, gicp


def make_structured_scene(rng, n=3000):
    """Synthetic structured environment: ground plane + two walls + boxes."""
    pts = []
    m = n // 4
    # ground
    g = np.column_stack(
        [rng.uniform(-10, 10, m), rng.uniform(-10, 10, m), 0.02 * rng.normal(size=m)]
    )
    pts.append(g)
    # wall x=8
    w1 = np.column_stack(
        [8 + 0.02 * rng.normal(size=m), rng.uniform(-10, 10, m), rng.uniform(0, 4, m)]
    )
    pts.append(w1)
    # wall y=-6
    w2 = np.column_stack(
        [rng.uniform(-10, 10, m), -6 + 0.02 * rng.normal(size=m), rng.uniform(0, 4, m)]
    )
    pts.append(w2)
    # a box
    b = np.column_stack(
        [
            2 + 0.02 * rng.normal(size=m),
            rng.uniform(1, 3, m),
            rng.uniform(0, 2, m),
        ]
    )
    pts.append(b)
    return np.concatenate(pts).astype(np.float32)


def _prep(pts, k=20):
    c = cloud_lib.from_array(jnp.asarray(pts)).sanitized()
    covs = covariance.plane_covariances(c.points, c.mask, k=k)
    return c, covs


@pytest.mark.parametrize("seed", [0, 1])
def test_align_recovers_known_transform(seed):
    rng = np.random.default_rng(seed)
    tgt = make_structured_scene(rng)
    # ground-truth motion: ~0.3 m translation, ~5 deg rotation
    rotvec = rng.normal(size=3)
    rotvec *= np.deg2rad(5.0) / np.linalg.norm(rotvec)
    R = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
    t = (0.3 * rng.normal(size=3)).astype(np.float32)
    # source cloud = target moved by T_gt^-1 (so aligning src->tgt finds T_gt)
    src = (tgt - t) @ R  # == R^-1 (tgt - t) since (tgt @ R) rows: careful
    src = ((tgt - t) @ R).astype(np.float32)  # R^T^T... verify below

    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    # check: T_gt @ src == tgt
    np.testing.assert_allclose(src @ R.T + t, tgt, atol=1e-4)

    (src_c, src_covs) = _prep(src)
    (tgt_c, tgt_covs) = _prep(tgt)

    res = gicp.align(
        src_c.points,
        src_c.mask,
        src_covs,
        tgt_c.points,
        tgt_c.mask,
        tgt_covs,
        jnp.eye(4),
        gicp.GICPSettings(
            max_correspondence_distance=1.0,
            max_iterations=64,
            transformation_epsilon=5e-4,
        ),
    )
    T = np.asarray(res.T)
    terr = np.linalg.norm(T[:3, 3] - t)
    rerr = Rotation.from_matrix(T[:3, :3] @ R.T).magnitude()
    assert bool(res.converged)
    assert terr < 0.02, f"translation error {terr}"
    assert np.degrees(rerr) < 0.5, f"rotation error {np.degrees(rerr)} deg"


def test_align_identity_pair_converges_fast():
    rng = np.random.default_rng(2)
    pts = make_structured_scene(rng, n=1000)
    c, covs = _prep(pts, k=10)
    res = gicp.align(
        c.points, c.mask, covs, c.points, c.mask, covs, jnp.eye(4),
        gicp.GICPSettings(max_correspondence_distance=1.0),
    )
    assert bool(res.converged)
    assert int(res.iterations) <= 3
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=1e-4)
    # residuals at aligned pose are ~0
    r = np.asarray(res.residuals)
    assert r[np.asarray(c.mask)].max() < 1e-2


def test_align_respects_masks():
    rng = np.random.default_rng(3)
    pts = make_structured_scene(rng, n=800)
    # pad source with garbage rows that are masked out
    garbage = rng.uniform(-100, 100, size=(200, 3)).astype(np.float32)
    src = np.concatenate([pts, garbage])
    mask = np.concatenate([np.ones(len(pts), bool), np.zeros(200, bool)])
    src_c = cloud_lib.Cloud(jnp.asarray(src), jnp.asarray(mask)).sanitized()
    src_covs = covariance.plane_covariances(src_c.points, src_c.mask, k=10)
    tgt_c, tgt_covs = _prep(pts, k=10)
    res = gicp.align(
        src_c.points, src_c.mask, src_covs,
        tgt_c.points, tgt_c.mask, tgt_covs, jnp.eye(4),
        gicp.GICPSettings(max_correspondence_distance=1.0),
    )
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=1e-3)
    assert int(res.num_inliers) == len(pts)
    # masked rows report zero residual and -1 correspondence
    assert np.all(np.asarray(res.residuals)[len(pts):] == 0)
    assert np.all(np.asarray(res.correspondences)[len(pts):] == -1)


def test_align_vmap_batch():
    """A batch of independent registrations via vmap — the scale-out path."""
    rng = np.random.default_rng(4)
    tgt = make_structured_scene(rng, n=600)
    tgt_c, tgt_covs = _prep(tgt, k=10)

    offsets = np.array([[0.2, 0.0, 0.0], [0.0, -0.3, 0.1]], np.float32)
    srcs, masks, covss = [], [], []
    for off in offsets:
        src = (tgt - off).astype(np.float32)
        c, covs = _prep(src, k=10)
        srcs.append(c.points), masks.append(c.mask), covss.append(covs)
    srcs = jnp.stack(srcs)
    masks = jnp.stack(masks)
    covss = jnp.stack(covss)

    batched = jax.vmap(
        lambda p, m, c: gicp.align(
            p, m, c, tgt_c.points, tgt_c.mask, tgt_covs, jnp.eye(4),
            gicp.GICPSettings(max_correspondence_distance=1.0),
        )
    )
    res = batched(srcs, masks, covss)
    T = np.asarray(res.T)
    np.testing.assert_allclose(T[:, :3, 3], offsets, atol=0.02)
    assert bool(res.converged.all())


def test_inv3x3():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(32, 3, 3)).astype(np.float32)
    m = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(3)
    inv = np.asarray(gicp.inv3x3(jnp.asarray(m)))
    np.testing.assert_allclose(inv @ m, np.eye(3)[None].repeat(32, 0), atol=1e-3)


def test_align_degenerate_no_correspondences_stays_finite():
    """Zero inliers (far-off guess / empty source) must not NaN the pose."""
    rng = np.random.default_rng(6)
    pts = make_structured_scene(rng, n=400)
    c, covs = _prep(pts, k=10)
    far = jnp.eye(4).at[:3, 3].set(jnp.asarray([50.0, 50.0, 50.0]))
    res = gicp.align(
        c.points, c.mask, covs, c.points, c.mask, covs, far,
        gicp.GICPSettings(max_correspondence_distance=1.0),
    )
    assert bool(jnp.isfinite(res.T).all())
    assert not bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(far), atol=1e-6)
