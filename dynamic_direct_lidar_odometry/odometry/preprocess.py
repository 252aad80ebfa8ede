"""Scan preprocessing: row/col decimation -> crop box -> voxel grid.

Mirror of ``OdomNode::preprocessPoints`` (odom.cc:442-478) with the filter
setup of odom.cc:114-131, as one fused masked pipeline with a fixed-capacity
output. Also computes the spaciousness metric (``computeSpaciousness``,
odom.cc:970-991) used for adaptive keyframing.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.ops import filters


class PreprocessedScan(NamedTuple):
    points: jnp.ndarray  # (max_points, 3), sensor frame, SENTINEL-padded
    mask: jnp.ndarray  # (max_points,)
    spaciousness_median: jnp.ndarray  # () median range of kept points


@partial(jax.jit, static_argnames=("cfg",))
def preprocess(
    cfg: DDLOConfig,
    raw_points: jnp.ndarray,
    raw_mask: jnp.ndarray,
) -> PreprocessedScan:
    """Run the registration-scan preprocessing chain.

    Args:
      raw_points: (H*W, 3) organized scan, row-major, invalid rows anything.
      raw_mask: (H*W,) validity (finite, non-empty pixel).
    """
    pre = cfg.preprocessing
    H, W = cfg.detection.rows, cfg.detection.columns
    pts = raw_points
    mask = raw_mask

    if pre.downsampling.use:
        pts, mask = filters.decimate(
            pts, mask, H, W, pre.downsampling.row, pre.downsampling.col
        )
    if pre.crop_box.use:
        mask = mask & filters.crop_box_mask(pts, pre.crop_box.size)

    if pre.voxel_scan.use:
        pts, mask = filters.voxel_downsample(
            pts, mask, pre.voxel_scan.res, cfg.capacity.max_points
        )
    else:
        pts, mask = filters.compact(pts, mask, cfg.capacity.max_points)

    med = masked_median_range(pts, mask)
    return PreprocessedScan(pts, mask, med)


def masked_median_range(points: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median point range (computeSpaciousness, odom.cc:970-991).

    The reference takes the n/2-th order statistic of all ranges; here the
    same over valid points only.
    """
    d = jnp.linalg.norm(points, axis=1)
    d = jnp.where(mask, d, jnp.inf)
    cnt = jnp.sum(mask)
    srt = jnp.sort(d)
    idx = jnp.clip(cnt // 2, 0, d.shape[0] - 1)
    med = srt[idx]
    return jnp.where(cnt > 0, med, 0.0)


def adaptive_keyframe_thresh(spaciousness: jnp.ndarray) -> jnp.ndarray:
    """Spaciousness -> keyframe distance threshold (odom.cc:1156-1178)."""
    s = spaciousness
    return jnp.where(
        s > 20.0,
        10.0,
        jnp.where(s > 10.0, 5.0, jnp.where(s > 5.0, 1.0, 0.5)),
    ).astype(jnp.float32)
