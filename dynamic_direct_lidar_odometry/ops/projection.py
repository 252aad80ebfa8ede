"""Range-image projection ops.

Equivalents of ``DetectionModule::projectScan`` (detection.cpp:254-382) and
``projectResiduals`` (:203-252), supporting both cloud layouts the
reference knows:

- *organized*: pixel (r, c) <-> point index r*W + c (the fork's Azure
  Kinect path, detection.cpp:300-329),
- *spherical*: rows from elevation, cols from azimuth (the upstream LiDAR
  path kept in comments at detection.cpp:330-367), used here both for
  unorganized clouds and for scattering the voxelized registration scan's
  ICP residuals onto the image grid (odom.cc:804-827 does the same with a
  camera-angle grid).

Projection is just elementwise math + one scatter; no loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class RangeImage(NamedTuple):
    ranges: jnp.ndarray  # (H, W) f32, 0 = no return
    points: jnp.ndarray  # (H, W, 3) world-frame points (garbage if invalid)
    valid: jnp.ndarray  # (H, W) bool
    point_index: jnp.ndarray  # (H, W) int32 index into the source cloud


@partial(jax.jit, static_argnames=("H", "W"))
def project_organized(
    points_world: jnp.ndarray,
    mask: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    H: int,
    W: int,
    minimum_range: float,
) -> RangeImage:
    """Organized projection: range = ||p - origin|| per pixel.

    detection.cpp:300-329 (the fork computes ``pt + (-T[0:3,3])``, i.e.
    the world point minus the current sensor position)."""
    pts = points_world.reshape(H, W, 3)
    m = mask.reshape(H, W)
    d = pts - sensor_origin
    rng = jnp.linalg.norm(d, axis=-1)
    valid = m & (rng >= minimum_range)
    rng = jnp.where(valid, rng, 0.0)
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    return RangeImage(rng, pts, valid, idx)


def lidar_grid_rowcol(
    points_sensor: jnp.ndarray, H: int, W: int, ang_bottom: float
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Row/col on the LeGO-LOAM-style spherical grid.

    detection.cpp:344-356 (commented upstream path), with
    ang_res_x = 360/W, ang_res_y = 2*ang_bottom/(H-1) (detection.cpp:82-83).

    Returns (row, col, in_fov) int32/int32/bool.
    """
    x, y, z = points_sensor[:, 0], points_sensor[:, 1], points_sensor[:, 2]
    ang_res_x = 360.0 / W
    ang_res_y = 2.0 * ang_bottom / (H - 1)
    v_angle = jnp.degrees(jnp.arctan2(z, jnp.sqrt(x * x + y * y)))
    row = (H - (v_angle + ang_bottom) / ang_res_y).astype(jnp.int32)
    in_fov = (row >= 0) & (row < H)
    h_angle = jnp.degrees(jnp.arctan2(x, y))
    col = jnp.round(h_angle / ang_res_x).astype(jnp.int32)
    col = jnp.where(col >= W, col - W, jnp.where(col < 0, col + W, col))
    col = jnp.clip(col, 0, W - 1)
    row = jnp.clip(row, 0, H - 1)
    return row, col, in_fov


def camera_grid_rowcol(
    points_sensor: jnp.ndarray, H: int, W: int, half_fov_deg: float = 60.0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Row/col on the fork's depth-camera grid (odom.cc:804-827):
    theta = atan2(x, z), phi = atan2(y, sqrt(x^2+z^2)), both mapped from
    [-half_fov, half_fov] onto [0, W) / [0, H)."""
    x, y, z = points_sensor[:, 0], points_sensor[:, 1], points_sensor[:, 2]
    lim = jnp.deg2rad(half_fov_deg)
    theta = jnp.arctan2(x, z)
    phi = jnp.arctan2(y, jnp.sqrt(x * x + z * z))
    u = ((theta + lim) / (2 * lim) * W).astype(jnp.int32)
    v = ((phi + lim) / (2 * lim) * H).astype(jnp.int32)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return jnp.clip(v, 0, H - 1), jnp.clip(u, 0, W - 1), ok


@partial(jax.jit, static_argnames=("H", "W"))
def project_spherical(
    points_world: jnp.ndarray,
    mask: jnp.ndarray,
    points_sensor: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    H: int,
    W: int,
    ang_bottom: float,
    minimum_range: float,
) -> RangeImage:
    """Spherical projection of an unorganized cloud (upstream LiDAR mode)."""
    row, col, in_fov = lidar_grid_rowcol(points_sensor, H, W, ang_bottom)
    rng = jnp.linalg.norm(points_world - sensor_origin, axis=-1)
    ok = mask & in_fov & (rng >= minimum_range)
    flat = row * W + col
    flat = jnp.where(ok, flat, H * W)  # drop slot
    ranges = jnp.zeros((H * W + 1,), points_world.dtype).at[flat].set(
        jnp.where(ok, rng, 0.0)
    )[: H * W]
    pts = jnp.zeros((H * W + 1, 3), points_world.dtype).at[flat].set(
        points_world
    )[: H * W]
    idx = jnp.full((H * W + 1,), -1, jnp.int32).at[flat].set(
        jnp.arange(points_world.shape[0], dtype=jnp.int32)
    )[: H * W]
    valid = ranges > 0
    return RangeImage(
        ranges.reshape(H, W), pts.reshape(H, W, 3), valid.reshape(H, W),
        idx.reshape(H, W),
    )


@partial(jax.jit, static_argnames=("H", "W", "grid"))
def project_residuals(
    points_sensor: jnp.ndarray,
    residuals: jnp.ndarray,
    mask: jnp.ndarray,
    H: int,
    W: int,
    ang_bottom: float = 45.0,
    grid: str = "lidar",
) -> jnp.ndarray:
    """Scatter the registration scan's per-point ICP residuals onto the
    detection image grid -> (H, W) residual image.

    Reference counterparts: odom.cc:804-827 (fork camera grid) and
    detection.cpp:215-238 (upstream LiDAR grid, commented).
    """
    if grid == "camera":
        row, col, ok = camera_grid_rowcol(points_sensor, H, W)
    else:
        row, col, ok = lidar_grid_rowcol(points_sensor, H, W, ang_bottom)
    ok = ok & mask
    flat = jnp.where(ok, row * W + col, H * W)
    img = jnp.zeros((H * W + 1,), residuals.dtype).at[flat].max(
        jnp.where(ok, residuals, 0.0)
    )
    return img[: H * W].reshape(H, W)
