import numpy as np

import jax.numpy as jnp
from scipy.spatial import cKDTree

from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.ops import knn as knn_ops


def _clouds(seed, q=777, t=1531):
    rng = np.random.default_rng(seed)
    query = rng.normal(size=(q, 3)).astype(np.float32) * 5
    target = rng.normal(size=(t, 3)).astype(np.float32) * 5
    return query, target


def test_nn1_matches_kdtree():
    query, target = _clouds(0)
    idx, sqd = knn_ops.nn1(jnp.asarray(query), jnp.asarray(target))
    tree = cKDTree(target)
    d_ref, i_ref = tree.query(query, k=1)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    np.testing.assert_allclose(np.asarray(sqd), d_ref**2, rtol=1e-3, atol=1e-4)


def test_nn1_sentinel_rows_lose():
    query, target = _clouds(1, q=64, t=256)
    target[10:20] = SENTINEL  # invalidated target rows
    idx, _ = knn_ops.nn1(jnp.asarray(query), jnp.asarray(target))
    assert not np.any(np.isin(np.asarray(idx), np.arange(10, 20)))


def test_knn_matches_kdtree():
    query, target = _clouds(2, q=301, t=900)
    k = 10
    idx, sqd = knn_ops.knn(jnp.asarray(query), jnp.asarray(target), k)
    tree = cKDTree(target)
    d_ref, i_ref = tree.query(query, k=k)
    # distances must match exactly (as sets the indices might permute ties)
    np.testing.assert_allclose(
        np.sort(np.asarray(sqd), axis=1), np.sort(d_ref**2, axis=1), rtol=1e-3, atol=1e-4
    )
    assert (np.sort(np.asarray(idx), 1) == np.sort(i_ref, 1)).mean() > 0.999


def test_knn_self_includes_self():
    pts, _ = _clouds(3, q=128, t=1)
    idx, sqd = knn_ops.knn(jnp.asarray(pts), jnp.asarray(pts), 5)
    np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(128))
    np.testing.assert_allclose(np.asarray(sqd)[:, 0], 0.0, atol=1e-4)
