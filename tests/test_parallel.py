"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Validates the two scale axes of parallel/sharding.py: dp-sharded stream
batches and (dp, pt)-sharded registrations with psum'd normal equations
match their single-device references exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.io import synthetic
from dynamic_direct_lidar_odometry.ops import covariance, gicp
from dynamic_direct_lidar_odometry.parallel import sharding


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _registration_batch(B=8, N=256, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    shift = rng.uniform(-0.1, 0.1, (B, 1, 3)).astype(np.float32)
    tgt = (src + shift).astype(np.float32)
    m = jnp.ones((B, N), bool)
    covs = jax.vmap(lambda p: covariance.plane_covariances(p, m[0], k=8))(
        jnp.asarray(src)
    )
    tcovs = jax.vmap(lambda p: covariance.plane_covariances(p, m[0], k=8))(
        jnp.asarray(tgt)
    )
    guess = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    return jnp.asarray(src), m, covs, jnp.asarray(tgt), m, tcovs, guess, shift


def test_point_sharded_align_matches_single_device():
    args = _registration_batch()
    src, m, covs, tgt, tm, tcovs, guess, shift = args
    settings = gicp.GICPSettings(max_iterations=16)

    ref = jax.vmap(
        lambda a, b, c, d, e, f, g: gicp.align(a, b, c, d, e, f, g, settings)
    )(src, m, covs, tgt, tm, tcovs, guess)

    mesh = sharding.make_mesh(8, pt=2)
    aligner = sharding.batched_align(mesh, settings, point_sharded=True)
    res = aligner(src, m, covs, tgt, tm, tcovs, guess)

    np.testing.assert_allclose(
        np.asarray(res.T), np.asarray(ref.T), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(res.num_inliers), np.asarray(ref.num_inliers)
    )
    # recovered the planted translation
    np.testing.assert_allclose(
        np.asarray(res.T[:, :3, 3]), shift[:, 0, :], atol=2e-2
    )


def test_dp_only_align_matches():
    src, m, covs, tgt, tm, tcovs, guess, _ = _registration_batch(seed=1)
    settings = gicp.GICPSettings(max_iterations=8)
    mesh = sharding.make_mesh(8, pt=1)
    aligner = sharding.batched_align(mesh, settings, point_sharded=False)
    res = aligner(src, m, covs, tgt, tm, tcovs, guess)
    ref = jax.vmap(
        lambda a, b, c, d, e, f, g: gicp.align(a, b, c, d, e, f, g, settings)
    )(src, m, covs, tgt, tm, tcovs, guess)
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(ref.T), atol=1e-6)


def _tiny_cfg():
    cfg = cfg_lib.doals_config()
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection, rows=8, columns=64, ground_rows=2
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=512,
            max_submap_points=2048,
            max_keyframes=8,
            max_keyframe_points=512,
            max_objects=4,
            max_tracks=4,
            nn_chunk=128,
        ),
    )


def test_batched_pipeline_step_runs_sharded():
    cfg = _tiny_cfg()
    world = synthetic.World.town(seed=0, n_static=4)
    pts, mask = synthetic.render_scan(
        world, np.eye(4), H=cfg.detection.rows, W=cfg.detection.columns
    )
    B = 8
    pts_b = jnp.broadcast_to(jnp.asarray(pts), (B,) + pts.shape)
    mask_b = jnp.broadcast_to(jnp.asarray(mask), (B,) + mask.shape)
    ts0 = jnp.zeros((B,), jnp.float32)

    states = sharding.batched_init_state(cfg, pts_b, mask_b, ts0)
    mesh = sharding.make_mesh(8, pt=1)
    states = sharding.shard_batch(mesh, states)
    step = sharding.batched_pipeline_step(cfg, mesh)
    new_states, outputs = step(
        sharding.shard_batch(mesh, states),
        sharding.shard_batch(mesh, pts_b),
        sharding.shard_batch(mesh, mask_b),
        sharding.shard_batch(mesh, jnp.full((B,), 0.1, jnp.float32)),
    )
    poses = np.asarray(outputs.odom.pose)
    assert poses.shape == (B, 3)
    assert np.all(np.isfinite(poses))
    # identical inputs -> identical outputs across the sharded batch
    np.testing.assert_allclose(poses, np.broadcast_to(poses[0], (B, 3)))
    # matches the unsharded single-stream step
    s1 = pipeline.init_state(cfg, jnp.asarray(pts), jnp.asarray(mask), 0.0)
    _, out1 = pipeline.step(
        cfg, s1, jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.1)
    )
    np.testing.assert_allclose(poses[0], np.asarray(out1.odom.pose), atol=1e-5)


def test_point_parallel_pipeline_matches_single_device():
    """The FULL pipeline step with its GICP point loops sharded over pt
    (psum'd normal equations, all-gathered covariances/residuals) must
    reproduce the unsharded transition."""
    cfg = _tiny_cfg()
    world = synthetic.World.town(seed=0, n_static=4)
    pts, mask = synthetic.render_scan(
        world, np.eye(4), H=cfg.detection.rows, W=cfg.detection.columns
    )
    B = 2
    pts_b = jnp.broadcast_to(jnp.asarray(pts), (B,) + pts.shape)
    mask_b = jnp.broadcast_to(jnp.asarray(mask), (B,) + mask.shape)
    ts0 = jnp.zeros((B,), jnp.float32)
    states = sharding.batched_init_state(cfg, pts_b, mask_b, ts0)

    mesh = sharding.make_mesh(8, pt=4)  # dp=2, pt=4
    step = sharding.point_parallel_pipeline_step(cfg, mesh)
    new_states, outputs = step(
        sharding.shard_batch(mesh, states),
        sharding.shard_batch(mesh, pts_b),
        sharding.shard_batch(mesh, mask_b),
        sharding.shard_batch(mesh, jnp.full((B,), 0.1, jnp.float32)),
    )
    poses = np.asarray(outputs.odom.pose)
    assert poses.shape == (B, 3) and np.all(np.isfinite(poses))

    s1 = pipeline.init_state(cfg, jnp.asarray(pts), jnp.asarray(mask), 0.0)
    _, out1 = pipeline.step(
        cfg, s1, jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.1)
    )
    np.testing.assert_allclose(poses[0], np.asarray(out1.odom.pose), atol=1e-4)
    # residuals were all-gathered back to full scan length and agree
    np.testing.assert_allclose(
        np.asarray(outputs.odom.residuals[0]),
        np.asarray(out1.odom.residuals),
        atol=1e-4,
    )


def test_replay_batch_matches_single_stream():
    """Batched multi-stream replay (parallel/replay.py) on the 8-device
    CPU mesh reproduces the single-stream transition per stream."""
    import dataclasses

    import numpy as np
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry import config as cfg_lib, pipeline
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry.parallel import replay, sharding

    cfg = cfg_lib.doals_config()
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection, rows=16, columns=128, ground_rows=4
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=512, max_submap_points=2048, max_keyframes=8,
            max_keyframe_points=512, max_objects=4, max_tracks=4,
            nn_chunk=128,
        ),
    )
    B, S = 4, 3
    seqs = [
        dataset.synthetic_sequence(n_scans=S, H=16, W=128, n_dynamic=0, seed=i)
        for i in range(B)
    ]
    points = np.stack([s.points for s in seqs])
    masks = np.stack([s.mask for s in seqs])
    stamps = np.stack([s.stamps for s in seqs])

    mesh = sharding.make_mesh(4, pt=1)
    res = replay.replay_batch(cfg, points, masks, stamps, mesh=mesh)
    assert res.poses.shape == (B, S - 1, 3)
    assert np.all(np.isfinite(res.poses))

    # stream 0 must match a plain single-stream run
    st = pipeline.init_state(
        cfg, jnp.asarray(points[0, 0]), jnp.asarray(masks[0, 0]),
        float(stamps[0, 0]),
    )
    for s in range(1, S):
        st, out = pipeline.step(
            cfg, st, jnp.asarray(points[0, s]), jnp.asarray(masks[0, s]),
            jnp.float32(stamps[0, s]),
        )
        np.testing.assert_allclose(
            res.poses[0, s - 1], np.asarray(out.odom.pose), atol=2e-4
        )
