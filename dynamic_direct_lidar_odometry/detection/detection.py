"""Dynamic-perception stage: projection -> ground -> segmentation -> objects.

The functional equivalent of ``DetectionModule::projectScan`` +
``projectResiduals`` + ``applySegmentation`` (src/detection/detection.cpp:
179-382,448-818), producing the per-frame detection list plus the pixel
masks the odometry loop needs to drop non-static points.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.ops import bbox as bbox_ops
from dynamic_direct_lidar_odometry.ops import projection, segmentation
from dynamic_direct_lidar_odometry.ops.bbox import Objects


class DetectionResult(NamedTuple):
    objects: Objects  # fixed-slot detections
    pixel_slot: jnp.ndarray  # (H, W) slot per pixel, -1 = background
    ground: jnp.ndarray  # (H, W) int8 ground mat
    range_image: jnp.ndarray  # (H, W)
    residual_image: jnp.ndarray  # (H, W)
    labels: jnp.ndarray  # (H, W) raw component roots (visualization)
    # source-point index per pixel: identity for organized clouds, the
    # scatter winner for spherical projection (-1 = no point)
    point_index: jnp.ndarray  # (H, W) int32


def _window_mask(cfg: DDLOConfig) -> jnp.ndarray | None:
    det = cfg.detection
    if det.window_row_min is None:
        return None
    H, W = det.rows, det.columns
    r = jnp.arange(H)[:, None]
    c = jnp.arange(W)[None, :]
    return (
        (r >= det.window_row_min)
        & (r <= det.window_row_max)
        & (c >= det.window_col_min)
        & (c <= det.window_col_max)
    )


@partial(jax.jit, static_argnames=("cfg",))
def detect(
    cfg: DDLOConfig,
    seg_points_world: jnp.ndarray,  # (H*W, 3) organized, world frame
    seg_mask: jnp.ndarray,  # (H*W,)
    reg_points_sensor: jnp.ndarray,  # (N, 3) registration cloud, sensor frame
    reg_mask: jnp.ndarray,  # (N,)
    residuals: jnp.ndarray,  # (N,) S2M NN residuals
    T: jnp.ndarray,  # (4, 4) current pose
    seg_points_sensor: jnp.ndarray | None = None,  # for spherical mode
) -> DetectionResult:
    det = cfg.detection
    H, W = det.rows, det.columns

    if det.organized:
        # fork path: pixel (r, c) <-> point r*W + c (detection.cpp:300-329)
        ri = projection.project_organized(
            seg_points_world, seg_mask, T[:3, 3], H, W, det.minimum_range
        )
    else:
        # upstream LiDAR path: rows from elevation, cols from azimuth
        # (detection.cpp:330-367); needs the sensor-frame cloud for angles
        if seg_points_sensor is None:
            raise ValueError("spherical mode needs seg_points_sensor")
        ri = projection.project_spherical(
            seg_points_world, seg_mask, seg_points_sensor, T[:3, 3],
            H, W, det.ang_bottom, det.minimum_range,
        )
    res_img = projection.project_residuals(
        reg_points_sensor,
        residuals,
        reg_mask,
        H,
        W,
        ang_bottom=det.ang_bottom,
        grid=det.residual_grid,
    )

    g = segmentation.ground_removal(
        ri.points,
        ri.valid,
        ri.ranges,
        det.ground_rows,
        det.sensor_mount_angle,
        det.ground_angle_threshold,
    )

    ang_res_x = 360.0 / W
    ang_res_y = 2.0 * det.ang_bottom / (H - 1)
    seg_res = segmentation.label_components(
        ri.ranges,
        g.eligible,
        det.theta,
        ang_res_x,
        ang_res_y,
        window=_window_mask(cfg),
    )

    # fused gates + compaction over candidate roots: one scatter total
    # (vs segment_stats' three + the presence scatter); equivalence with
    # the exact segment_stats/compact_segments path is tested in
    # tests/test_detection_ops.py
    roots, slot_valid, pixel_slot, avg_res = segmentation.segment_objects(
        seg_res.labels,
        ri.ranges,
        ri.points,
        res_img,
        T[2, 3],
        det.min_line_num,
        det.valid_point_num,
        det.valid_line_num,
        det.max_distance,
        det.min_delta_z,
        det.max_delta_z,
        det.max_elevation,
        cfg.capacity.max_objects,
        candidates=cfg.capacity.segment_candidates,
    )

    objects = bbox_ops.pca_bboxes(
        ri.points,
        pixel_slot,
        slot_valid,
        avg_res,
        cfg.capacity.max_objects,
        det.max_dim_ratio,
    )
    # objects rejected by the dim-ratio gate keep their pixels unlabeled
    pixel_slot = jnp.where(
        objects.valid[jnp.clip(pixel_slot, 0, cfg.capacity.max_objects - 1)]
        & (pixel_slot >= 0),
        pixel_slot,
        -1,
    )

    return DetectionResult(
        objects=objects,
        pixel_slot=pixel_slot,
        ground=g.ground,
        range_image=ri.ranges,
        residual_image=res_img,
        labels=seg_res.labels,
        point_index=ri.point_index,
    )


