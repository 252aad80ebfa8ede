"""Micro-profile of detection sub-stages at bench scale (64x2048)."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


from dynamic_direct_lidar_odometry.utils import devtime


def timeit(name, fn, *args, n=10, **kw):
    _, out = devtime.timeit(fn, *args, n=n, label=name, **kw)
    return out


def main():
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry.io import synthetic
    from dynamic_direct_lidar_odometry.ops import bbox as bbox_ops
    from dynamic_direct_lidar_odometry.ops import projection, segmentation

    # bench operating point: 64 object slots (the VERDICT-r3 numbers were
    # taken at doals_config's 32 slots, which understated segment costs)
    devtime.enable_compile_cache()
    cfg = cfg_lib.bench_config()
    det = cfg.detection
    H, W = det.rows, det.columns

    world = synthetic.World.town(seed=3, n_static=10)
    pts, mask = synthetic.render_scan(
        world, np.eye(4), H=H, W=W, t=0.0, rng=np.random.default_rng(0)
    )
    pts = jnp.asarray(pts)
    mask = jnp.asarray(mask)
    T = jnp.eye(4)

    ri = timeit(
        "project_organized", projection.project_organized,
        pts, mask, T[:3, 3], H, W, det.minimum_range,
    )
    res = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (16384,))) * 0.1
    rpts = pts[: 16384]
    rmask = mask[: 16384]
    timeit(
        "project_residuals", projection.project_residuals,
        rpts, res, rmask, H, W, ang_bottom=det.ang_bottom, grid="lidar",
    )

    g = timeit(
        "ground_removal", segmentation.ground_removal,
        ri.points, ri.valid, ri.ranges, det.ground_rows,
        det.sensor_mount_angle, det.ground_angle_threshold,
    )

    ang_res_x = 360.0 / W
    ang_res_y = 2.0 * det.ang_bottom / (H - 1)
    seg = timeit(
        "label_components", segmentation.label_components,
        ri.ranges, g.eligible, det.theta, ang_res_x, ang_res_y, n=5,
    )

    res_img = jnp.zeros((H, W))
    stats = timeit(
        "segment_stats (exact, off hot path)", segmentation.segment_stats,
        seg.labels, ri.ranges, ri.points, res_img, T[2, 3],
        det.min_line_num, det.valid_point_num, det.valid_line_num,
        det.max_distance, det.min_delta_z, det.max_delta_z,
        det.max_elevation, n=5,
    )

    timeit(
        "compact_segments (exact, off hot path)",
        segmentation.compact_segments,
        seg.labels, stats, cfg.capacity.max_objects,
    )

    # the pipeline's actual path: fused gates + compaction over
    # candidate roots (one scatter total)
    roots, slot_valid, pixel_slot, avg = timeit(
        "segment_objects (fused)", segmentation.segment_objects,
        seg.labels, ri.ranges, ri.points, res_img, T[2, 3],
        det.min_line_num, det.valid_point_num, det.valid_line_num,
        det.max_distance, det.min_delta_z, det.max_delta_z,
        det.max_elevation, cfg.capacity.max_objects,
        cfg.capacity.segment_candidates, n=5,
    )
    timeit(
        "pca_bboxes", bbox_ops.pca_bboxes,
        ri.points, pixel_slot, slot_valid, avg,
        cfg.capacity.max_objects, det.max_dim_ratio, n=5,
    )


if __name__ == "__main__":
    main()
