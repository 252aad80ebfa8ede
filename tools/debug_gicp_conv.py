"""Debug GICP convergence behavior: iterations / error / NaNs on
identical and slightly-moved scan pairs at bench scale."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np


def main():
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry.io import synthetic
    from dynamic_direct_lidar_odometry.odometry import preprocess as prep
    from dynamic_direct_lidar_odometry.ops import covariance, gicp

    cfg = cfg_lib.doals_config()
    H, W = cfg.detection.rows, cfg.detection.columns
    world = synthetic.World.town(seed=3, n_static=10)

    def scan(T, t):
        pts, mask = synthetic.render_scan(
            world, T, H=H, W=W, t=t, rng=np.random.default_rng(0)
        )
        return jnp.asarray(pts), jnp.asarray(mask)

    T0 = np.eye(4)
    T1 = np.eye(4)
    T1[:3, 3] = [0.12, 0.03, 0.0]  # ~10 Hz at ~1.2 m/s

    p0r, m0r = scan(T0, 0.0)
    p1r, m1r = scan(T1, 0.1)

    pre0 = prep.preprocess(cfg, p0r, m0r)
    pre1 = prep.preprocess(cfg, p1r, m1r)

    k = cfg.gicp.s2s.k_correspondences
    c0 = covariance.plane_covariances(pre0.points, pre0.mask, k=k)
    c1 = covariance.plane_covariances(pre1.points, pre1.mask, k=k)

    settings = gicp.GICPSettings(
        max_correspondence_distance=cfg.gicp.s2s.max_correspondence_distance,
        max_iterations=cfg.gicp.s2s.max_iterations,
        lm_max_iterations=cfg.gicp.s2s.lm_max_iterations,
    )

    print("== identical pair ==")
    r = gicp.align(pre0.points, pre0.mask, c0, pre0.points, pre0.mask, c0,
                   jnp.eye(4), settings)
    print("iters", int(r.iterations), "conv", bool(r.converged),
          "err", float(r.final_error), "inliers", int(r.num_inliers))
    print("T", np.asarray(r.T))

    print("== moved pair (true dt = [0.12, 0.03, 0]) ==")
    r = gicp.align(pre1.points, pre1.mask, c1, pre0.points, pre0.mask, c0,
                   jnp.eye(4), settings)
    print("iters", int(r.iterations), "conv", bool(r.converged),
          "err", float(r.final_error), "inliers", int(r.num_inliers))
    print("T", np.asarray(r.T))

    # GN for comparison
    gn = settings._replace(optimizer="gn")
    r = gicp.align(pre1.points, pre1.mask, c1, pre0.points, pre0.mask, c0,
                   jnp.eye(4), gn)
    print("GN iters", int(r.iterations), "conv", bool(r.converged),
          "err", float(r.final_error))
    print("T", np.asarray(r.T))


if __name__ == "__main__":
    main()
