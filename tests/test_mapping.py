"""Map accumulator tests (reference: src/odometry/map.cc)."""

import numpy as np
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.mapping import mapper


def _cloud(rng, n, lo=-10, hi=10):
    pts = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    return jnp.asarray(pts), jnp.ones((n,), bool)


def test_add_keyframe_accumulates():
    rng = np.random.default_rng(0)
    m = mapper.empty_map(4096)
    pts1, msk1 = _cloud(rng, 512)
    m = mapper.add_keyframe(m, pts1, msk1, leaf_size=0.01)
    n1 = int(mapper.num_points(m))
    assert 0 < n1 <= 512
    pts2, msk2 = _cloud(rng, 512, lo=20, hi=30)
    m = mapper.add_keyframe(m, pts2, msk2, leaf_size=0.01)
    assert int(mapper.num_points(m)) > n1
    assert int(m.total_added) == int(mapper.num_points(m))


def test_add_keyframe_respects_mask_and_voxel():
    rng = np.random.default_rng(1)
    m = mapper.empty_map(1024)
    pts, _ = _cloud(rng, 256)
    msk = jnp.asarray(rng.uniform(size=256) < 0.5)
    m = mapper.add_keyframe(m, pts, msk, leaf_size=0.05)
    assert int(mapper.num_points(m)) == int(jnp.sum(msk))
    # coarse voxel collapses everything into few cells
    m2 = mapper.empty_map(1024)
    m2 = mapper.add_keyframe(m2, pts, jnp.ones((256,), bool), leaf_size=50.0)
    assert int(mapper.num_points(m2)) <= 8


def test_ring_eviction_overwrites_oldest():
    rng = np.random.default_rng(2)
    m = mapper.empty_map(256)
    for i in range(4):
        pts, msk = _cloud(rng, 128, lo=i * 100, hi=i * 100 + 10)
        m = mapper.add_keyframe(m, pts, msk, leaf_size=0.01)
    assert int(mapper.num_points(m)) == 256  # full, bounded
    # oldest batch (around 0..10) got evicted; newest (300..310) present
    pts = np.asarray(m.points)[np.asarray(m.mask)]
    assert pts.min() >= 90.0
    assert (pts > 290.0).any()


def test_remove_boxes_crops_dynamic_points():
    m = mapper.empty_map(1024)
    grid = np.stack(
        np.meshgrid(np.linspace(-5, 5, 11), np.linspace(-5, 5, 11), [1.0]),
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    m = mapper.add_keyframe(
        m, jnp.asarray(grid), jnp.ones((len(grid),), bool), 0.01,
        use_voxel_filter=False,
    )
    n0 = int(mapper.num_points(m))
    # axis-aligned box at origin, 2x2x4
    box = jnp.asarray([[0.0, 0.0, 1.0, 0.0, 2.0, 2.0, 4.0]])
    m2 = mapper.remove_boxes(m, box, jnp.asarray([True]))
    pts = np.asarray(m2.points)[np.asarray(m2.mask)]
    assert int(mapper.num_points(m2)) < n0
    inside = (np.abs(pts[:, 0]) <= 1.0) & (np.abs(pts[:, 1]) <= 1.0)
    assert not inside.any()
    # invalid box removes nothing
    m3 = mapper.remove_boxes(m, box, jnp.asarray([False]))
    assert int(mapper.num_points(m3)) == n0


def test_remove_boxes_yaw_rotation():
    # 45-degree box: the corner point (1.3, 0) is inside the rotated
    # 4x0.5 box but outside its axis-aligned version
    pts = jnp.asarray([[1.3, 1.3, 0.0], [1.3, -1.3, 0.0]], jnp.float32)
    m = mapper.empty_map(16)
    m = mapper.add_keyframe(m, pts, jnp.ones((2,), bool), 0.01,
                            use_voxel_filter=False)
    yaw = np.pi / 4
    box = jnp.asarray(
        [[0.0, 0.0, 0.0, np.sin(yaw / 2), 6.0, 0.5, 2.0]], jnp.float32
    )
    m2 = mapper.remove_boxes(m, box, jnp.asarray([True]))
    kept = np.asarray(m2.points)[np.asarray(m2.mask)]
    # the box's long axis points along +45deg: (1.3,1.3) removed,
    # (1.3,-1.3) kept
    assert len(kept) == 1 and kept[0, 1] < 0


def test_snapshot_voxelizes():
    rng = np.random.default_rng(3)
    m = mapper.empty_map(2048)
    pts, msk = _cloud(rng, 1024, lo=0, hi=1)
    m = mapper.add_keyframe(m, pts, msk, leaf_size=0.001)
    snap_pts, snap_mask = mapper.snapshot(m, leaf_size=0.5, capacity=64)
    assert 1 <= int(jnp.sum(snap_mask)) <= 27
