import numpy as np

import jax.numpy as jnp

from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.ops import filters


def test_rowcol_downsample_mask():
    m = np.asarray(filters.rowcol_downsample_mask(4, 6, 2, 3)).reshape(4, 6)
    assert m[0, 0] and m[0, 3] and m[2, 0]
    assert not m[1, 0] and not m[0, 1] and not m[3, 5]
    assert m.sum() == 2 * 2


def test_crop_box_negative():
    pts = jnp.asarray(
        np.array([[0.5, 0.5, 0.5], [2.0, 0.0, 0.0], [-0.9, 0.9, 0.0]], np.float32)
    )
    keep = np.asarray(filters.crop_box_mask(pts, 1.0))
    np.testing.assert_array_equal(keep, [False, True, False])
    # translated box
    keep_t = np.asarray(filters.crop_box_mask(pts, 1.0, jnp.asarray([2.0, 0.0, 0.0])))
    np.testing.assert_array_equal(keep_t, [True, False, True])


def test_voxel_downsample_centroids():
    # two clusters in distinct voxels + one masked point
    pts = np.array(
        [
            [0.01, 0.01, 0.01],
            [0.02, 0.03, 0.04],
            [5.0, 5.0, 5.0],
            [99.0, 99.0, 99.0],  # masked out
        ],
        np.float32,
    )
    mask = np.array([True, True, True, False])
    out, out_mask = filters.voxel_downsample(
        jnp.asarray(pts), jnp.asarray(mask), 0.5, capacity=8
    )
    out, out_mask = np.asarray(out), np.asarray(out_mask)
    assert out_mask.sum() == 2
    got = out[out_mask]
    expect = np.stack([pts[:2].mean(0), pts[2]])
    # lexicographic voxel order: (0,0,0) before (10,10,10)
    np.testing.assert_allclose(got, expect, atol=1e-6)
    assert np.all(out[~out_mask] == SENTINEL)


def test_voxel_downsample_matches_grid_count():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, size=(5000, 3)).astype(np.float32)
    mask = np.ones(5000, bool)
    res = 1.0
    out, out_mask = filters.voxel_downsample(
        jnp.asarray(pts), jnp.asarray(mask), res, capacity=8192
    )
    n_ref = len(np.unique(np.floor(pts / res).astype(np.int64), axis=0))
    assert int(np.asarray(out_mask).sum()) == n_ref


def test_compact():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    mask = np.array([True, False] * 5)
    out, om = filters.compact(jnp.asarray(pts), jnp.asarray(mask), 8)
    out, om = np.asarray(out), np.asarray(om)
    assert om[:5].all() and not om[5:].any()
    np.testing.assert_allclose(out[:5], pts[mask])
    assert np.all(out[5:] == SENTINEL)
