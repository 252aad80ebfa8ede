"""Shared golden-scene builders for the regression tests and
tools/regen_golden.py — one definition of each locked scene, so the test
and the regeneration tool can never drift apart.

Scenes:
  organized : 32x512 organized town replay (the round-1 golden)
  spherical : same town/trajectory with detection.organized=False —
              range/residual images come from the upstream LeGO-LOAM
              spherical projection (detection.cpp:344-356) instead of
              the organized row-major layout (detection.cpp:300-329)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.io import synthetic


def golden_cfg(organized: bool = True):
    cfg = cfg_lib.doals_config()
    det = dataclasses.replace(
        cfg.detection, rows=32, columns=512, ground_rows=10
    )
    if not organized:
        # ang_bottom sized to the renderer's +-16.6 deg FOV so the
        # spherical grid actually fills (ang_res_y = 2*17/31 ~ 1.1 deg)
        det = dataclasses.replace(det, organized=False, ang_bottom=17.0)
    return dataclasses.replace(
        cfg,
        detection=det,
        capacity=cfg_lib.CapacityConfig(
            max_points=2048, max_submap_points=8192, max_keyframes=16,
            max_keyframe_points=2048, max_objects=8, max_tracks=8,
            nn_chunk=256,
        ),
    )


def golden_trajectory(organized: bool = True) -> np.ndarray:
    """Replay the locked 10-scan scene; returns the (9, 3) pose track."""
    cfg = golden_cfg(organized)
    world = synthetic.World.town(seed=7, n_static=10)
    mov = [
        synthetic.Box(
            np.array([4.0, -2.0, 0.9]),
            np.array([0.8, 0.8, 1.8]),
            np.array([1.0, 0.3, 0.0]),
        )
    ]
    rng = np.random.default_rng(0)
    T = np.eye(4)
    pts, mask = synthetic.render_scan(
        world, T, H=32, W=512, t=0.0, extra_boxes=mov, rng=rng
    )
    st = pipeline.init_state(cfg, jnp.asarray(pts), jnp.asarray(mask), 0.0)
    poses = []
    for i in range(1, 10):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.03 * i, 0.0]
        T[0, 0] = T[1, 1] = np.cos(th)
        T[0, 1] = -np.sin(th)
        T[1, 0] = np.sin(th)
        pts, mask = synthetic.render_scan(
            world, T, H=32, W=512, t=0.1 * i, extra_boxes=mov, rng=rng
        )
        st, out = pipeline.step(
            cfg, st, jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.1 * i)
        )
        poses.append(np.asarray(out.odom.pose))
    return np.array(poses)
