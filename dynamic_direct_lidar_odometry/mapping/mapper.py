"""Global map accumulation + dynamic-object hygiene.

Functional re-design of the reference's ``ddlo_map_node``
(``src/odometry/map.cc``, ``include/odometry/map.h``):

- ``keyframeCB`` (map.cc:101-131): voxel-filter the incoming keyframe
  cloud, append it to the global map            -> :func:`add_keyframe`
- ``dynamicObjectsCB`` (map.cc:133-156): delete map points inside each
  received static-bbox history entry (CropBox negative with yaw, +margin)
                                                -> :func:`remove_boxes`
- ``publishTimerCB`` (map.cc:83-99) full-map publish
                                                -> :func:`snapshot`
- ``savePcd`` service (map.cc:158-189)          -> io.pcd.save_pcd

The ROS process boundary becomes a pure state transition on a
fixed-capacity ring buffer: the map node subscribed to the odometry
node's ``keyframe`` topic and the tracker's ``clear_map`` topic
(map.cc:36-39); here both arrive as function arguments, so a replay
driver calls ``add_keyframe`` whenever the pipeline reports
``keyframe_added`` and ``remove_boxes`` with the tracker's
``clear_map_boxes`` output.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.ops import filters


class MapState(NamedTuple):
    points: jnp.ndarray  # (C, 3) world frame; invalid rows at SENTINEL
    mask: jnp.ndarray  # (C,) bool
    write_ptr: jnp.ndarray  # () int32 ring cursor
    total_added: jnp.ndarray  # () int64-ish count of points ever inserted


def empty_map(capacity: int) -> MapState:
    return MapState(
        points=jnp.full((capacity, 3), SENTINEL, jnp.float32),
        mask=jnp.zeros((capacity,), bool),
        write_ptr=jnp.int32(0),
        total_added=jnp.int32(0),
    )


@partial(jax.jit, static_argnames=("leaf_capacity", "use_voxel_filter"))
def add_keyframe(
    state: MapState,
    kf_points: jnp.ndarray,
    kf_mask: jnp.ndarray,
    leaf_size: float,
    use_voxel_filter: bool = True,
    leaf_capacity: int | None = None,
) -> MapState:
    """Voxelize + append one keyframe cloud (map.cc:101-131).

    The reference's map grows unboundedly (``*ddlo_map_ += *keyframe``);
    the fixed-capacity design appends into a ring, overwriting the
    oldest points once full — the long-sweep behavior SURVEY.md §5 calls
    for (bounded state with eviction).
    """
    P = kf_points.shape[0]
    if leaf_capacity is None:
        leaf_capacity = P
    if use_voxel_filter:
        pts, msk = filters.voxel_downsample(
            kf_points, kf_mask, leaf_size, leaf_capacity
        )
    else:
        pts, msk = filters.compact(kf_points, kf_mask, leaf_capacity)

    C = state.points.shape[0]
    # pack valid rows to positions ptr, ptr+1, ... (mod C); invalid rows
    # scatter into the dropped overflow slot
    pos = jnp.cumsum(msk.astype(jnp.int32)) - 1
    idx = (state.write_ptr + pos) % C
    idx = jnp.where(msk, idx, C)  # C = out-of-bounds -> dropped

    new_points = state.points.at[idx].set(pts, mode="drop")
    new_mask = state.mask.at[idx].set(True, mode="drop")
    n = jnp.sum(msk.astype(jnp.int32))
    return MapState(
        points=new_points,
        mask=new_mask,
        write_ptr=(state.write_ptr + n) % C,
        total_added=state.total_added + n,
    )


@jax.jit
def remove_boxes(
    state: MapState,
    boxes: jnp.ndarray,
    boxes_valid: jnp.ndarray,
    margin: float | jnp.ndarray = 0.0,
) -> MapState:
    """Delete map points inside dynamic-object bbox histories
    (dynamicObjectsCB, map.cc:133-156).

    ``boxes``: (..., 7) rows [cx, cy, cz, sin(yaw/2), l, w, h] — the
    tracker's state layout (bounding_box_filter.h:24-26); the reference
    derives yaw from the pose quaternion's z component the same way.
    ``boxes_valid``: (...,) bool. Any leading batch dims are flattened.
    """
    b = boxes.reshape(-1, 7)
    bv = boxes_valid.reshape(-1)

    yaw = 2.0 * jnp.arcsin(jnp.clip(b[:, 3], -1.0, 1.0))
    c, s = jnp.cos(-yaw), jnp.sin(-yaw)  # rotate points INTO box frame
    d = state.points[None, :, :] - b[:, None, :3]  # (B, C, 3)
    lx = c[:, None] * d[..., 0] - s[:, None] * d[..., 1]
    ly = s[:, None] * d[..., 0] + c[:, None] * d[..., 1]
    lz = d[..., 2]
    half = b[:, 4:7] * 0.5 + margin  # (B, 3)
    inside = (
        (jnp.abs(lx) <= half[:, None, 0])
        & (jnp.abs(ly) <= half[:, None, 1])
        & (jnp.abs(lz) <= half[:, None, 2])
        & bv[:, None]
    )
    hit = jnp.any(inside, axis=0)
    new_mask = state.mask & ~hit
    return state._replace(
        mask=new_mask,
        points=jnp.where(new_mask[:, None], state.points, SENTINEL),
    )


@partial(jax.jit, static_argnames=("capacity",))
def snapshot(
    state: MapState, leaf_size: float, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Voxel-filtered copy of the map for publishing / saving
    (publishTimerCB map.cc:83-99; savePcd's optional filter map.cc:165-176).
    """
    return filters.voxel_downsample(state.points, state.mask, leaf_size, capacity)


def num_points(state: MapState) -> jnp.ndarray:
    """Current map size — the ``map_info`` feedback the odometry node
    consumes (map.cc:93-98 -> odom.cc:740-743)."""
    return jnp.sum(state.mask.astype(jnp.int32))
