"""Gravity alignment (OdomNode::gravityAlign, odom.cc:534-597)."""

import numpy as np

from dynamic_direct_lidar_odometry.odometry import odometry


def test_level_sensor_is_identity():
    accels = np.tile([0.0, 0.0, 9.81], (1000, 1))
    T0 = odometry.gravity_align(accels)
    np.testing.assert_allclose(T0, np.eye(4), atol=1e-6)


def test_tilted_sensor_levels_gravity():
    # sensor pitched 20 deg: accel measured in sensor frame
    th = np.deg2rad(20.0)
    R_tilt = np.array(
        [
            [np.cos(th), 0, np.sin(th)],
            [0, 1, 0],
            [-np.sin(th), 0, np.cos(th)],
        ]
    )
    g_world = np.array([0.0, 0.0, 9.81])
    a_sensor = R_tilt.T @ g_world
    accels = np.tile(a_sensor, (1000, 1)) + np.random.default_rng(0).normal(
        0, 0.01, (1000, 3)
    )
    T0 = odometry.gravity_align(accels)
    # the aligned rotation must map the measured accel back to +z
    up = T0[:3, :3] @ (a_sensor / np.linalg.norm(a_sensor))
    np.testing.assert_allclose(up, [0, 0, 1], atol=1e-3)


def test_imu_lidar_extrinsic_applied():
    # the fork's hardcoded -90 deg z rotation (odom.cc:575-580)
    q_ext = (0.7071067811865474, 0.0, 0.0, -0.7071067811865474)
    accels = np.tile([0.0, 0.0, 9.81], (100, 1))
    T0 = odometry.gravity_align(accels, imu_lidar_quat=q_ext)
    # pure z rotation: +x maps to -y
    np.testing.assert_allclose(T0[:3, :3] @ [1, 0, 0], [0, -1, 0], atol=1e-6)


def test_runner_seeds_gravity_aligned_pose():
    import dataclasses

    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry import runner

    cfg = cfg_lib.doals_config()
    cfg = dataclasses.replace(
        cfg,
        gravity_align=True,
        dynamic_detection=False,
        detection=dataclasses.replace(
            cfg.detection, rows=16, columns=128, ground_rows=4
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
    seq = dataset.synthetic_sequence(n_scans=3, H=16, W=128, n_dynamic=0)
    seq.imu_accel = np.tile([0.0, 0.0, 9.81], (50, 1))
    res = runner.replay(cfg, seq)
    assert len(res.poses) == 2  # runs through with a T0 seed
