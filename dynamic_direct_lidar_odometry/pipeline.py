"""Full DDLO pipeline: odometry + dynamic perception + tracking.

The functional equivalent of the reference's ``ddlo_odom_node`` process —
``OdomNode::icpCB`` with ``dynamicDetection=true`` (odom.cc:614-729) —
as a single pure transition:

    state', outputs = step(cfg, state, scan, timestamp)

Stage order matches the reference exactly:
  preprocess -> S2S -> submap -> S2M -> residuals   (odometry.step)
  -> project + segment + detect objects             (detection.detect)
  -> track, classify static/dynamic                 (tracker.update)
  -> drop UNDEFINED/DYNAMIC points                  (odom.cc:867-892)
  -> re-filter the static cloud                     (odom.cc:901-918)
  -> keyframe update on the dynamic-free cloud      (odom.cc:696-699)

The whole transition is jit-compiled; batched replay is ``vmap(step)`` and
multi-host sweeps shard the batch axis (see parallel/sharding.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.core import se3
from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.detection import detection
from dynamic_direct_lidar_odometry.odometry import odometry
from dynamic_direct_lidar_odometry.ops import filters
from dynamic_direct_lidar_odometry.tracking import tracker
from dynamic_direct_lidar_odometry.tracking.tracker import DYNAMIC, UNDEFINED


class DDLOState(NamedTuple):
    odom: odometry.OdomState
    tracks: tracker.TrackerState
    prev_stamp: jnp.ndarray  # () f32 seconds


class DDLOOutputs(NamedTuple):
    odom: odometry.OdomOutputs
    detections: detection.DetectionResult
    tracks: tracker.TrackerOutputs
    # world-frame clouds (fixed capacity + masks)
    static_points: jnp.ndarray  # (H*W, 3) static-only segmentation cloud
    static_mask: jnp.ndarray
    dynamic_mask: jnp.ndarray  # (H*W,) pixels of DYNAMIC objects
    non_static_mask: jnp.ndarray  # (H*W,) UNDEFINED + DYNAMIC pixels
    ground_mask: jnp.ndarray  # (H*W,)
    keyframe_added: jnp.ndarray  # () bool
    # candidate keyframe cloud (world frame): in dynamic mode the RAW
    # re-filter-masked static cloud (H*W, 3) — the scan-res voxel pass
    # runs inside update_keyframes' add branch only (consumers of this
    # output voxelize again at their own leaf size, map.cc:101-131)
    new_keyframe_points: jnp.ndarray
    new_keyframe_mask: jnp.ndarray


def init_state(
    cfg: DDLOConfig,
    raw_points: jnp.ndarray,
    raw_mask: jnp.ndarray,
    timestamp: float | jnp.ndarray = 0.0,
    T0: jnp.ndarray | None = None,
) -> DDLOState:
    return DDLOState(
        odom=odometry.init_state(cfg, raw_points, raw_mask, T0),
        tracks=tracker.empty_state(cfg.capacity.max_tracks),
        prev_stamp=jnp.float32(timestamp),
    )


@partial(jax.jit, static_argnames=("cfg", "axis_name", "pt_size"))
def step(
    cfg: DDLOConfig,
    state: DDLOState,
    raw_points: jnp.ndarray,
    raw_mask: jnp.ndarray,
    timestamp: jnp.ndarray,
    hull_masks: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
    axis_name: str | None = None,
    pt_size: int = 1,
) -> Tuple[DDLOState, DDLOOutputs]:
    """One full DDLO transition. ``hull_masks``: optional exact (convex,
    concave) keyframe hull memberships from the host (see
    keyframes.exact_hull_masks); the replay driver supplies them,
    device-only callers fall back to the on-device approximations.

    ``axis_name``/``pt_size``: point-parallel single-stream mode — the
    GICP/covariance point loops shard over a ``pt`` mesh axis (see
    odometry.step); detection/tracking run replicated (their cost is
    image-shaped, not point-sweep-shaped)."""
    H, W = cfg.detection.rows, cfg.detection.columns

    # ---- odometry (odom.cc:653-683) ----
    odo_state, odo = odometry.step(
        cfg, state.odom, raw_points, raw_mask, hull_masks,
        axis_name=axis_name, pt_size=pt_size,
    )

    # segmentation scan: the RAW organized cloud transformed to world
    # (transformScans, odom.cc:957-963)
    seg_world = se3.transform_points(odo.T, raw_points)
    seg_world = jnp.where(raw_mask[:, None], seg_world, SENTINEL)

    if not cfg.dynamic_detection:
        static_pts, static_mask = seg_world, raw_mask
        det = _empty_detection(cfg)
        trk_out = tracker.TrackerOutputs(
            clear_map_boxes=state.tracks.bbox_hist,
            clear_map_valid=jnp.zeros_like(state.tracks.bbox_hist[..., 0], bool),
            matched=jnp.full((cfg.capacity.max_objects,), -1, jnp.int32),
            spawned=jnp.zeros((cfg.capacity.max_objects,), bool),
        )
        trk_state = state.tracks
        non_static = jnp.zeros((H * W,), bool)
        dynamic = jnp.zeros((H * W,), bool)
        ground = jnp.zeros((H * W,), bool)
        kf_pts, kf_mask = odo.reg_points_world, odo.reg_mask
    else:
        # ---- dynamic perception (applySegmentation, odom.cc:853-919) ----
        # prev_points here is THIS scan's preprocessed cloud (sensor frame):
        # odometry.step stored it for the next S2S — exactly the cloud whose
        # residuals came out of S2M.
        det = detection.detect(
            cfg,
            seg_world,
            raw_mask,
            odo_state.prev_points,
            odo_state.prev_mask,
            odo.residuals,
            odo.T,
            seg_points_sensor=raw_points,
        )

        dt = jnp.maximum(timestamp - state.prev_stamp, 1e-3)
        trk_state, trk_out = tracker.update(
            cfg.tracking, state.tracks, det.objects, dt
        )

        # ---- remove UNDEFINED + DYNAMIC points (odom.cc:867-892) ----
        non_static_slots = tracker.status_detection_mask(
            trk_state, (UNDEFINED, DYNAMIC), cfg.capacity.max_objects
        )
        dynamic_slots = tracker.status_detection_mask(
            trk_state, (DYNAMIC,), cfg.capacity.max_objects
        )
        # map per-pixel slots back to source points: identity for the
        # organized layout (point_index IS arange — skip the two 131k
        # scatters), through the projection's
        # point_index otherwise
        ps_img = det.pixel_slot.reshape(-1)
        g_img = (det.ground == 1).reshape(-1)
        n_pts = raw_mask.shape[0]
        if cfg.detection.organized and n_pts == H * W:
            ps = ps_img
            ground = g_img
        else:
            pidx = det.point_index.reshape(-1)
            ps = jnp.full((n_pts,), -1, jnp.int32)
            ps = ps.at[jnp.where(pidx >= 0, pidx, n_pts)].set(
                ps_img, mode="drop"
            )
            ground = jnp.zeros((n_pts,), bool)
            ground = ground.at[jnp.where(pidx >= 0, pidx, n_pts)].set(
                g_img, mode="drop"
            )
        in_obj = ps >= 0
        psc = jnp.clip(ps, 0, cfg.capacity.max_objects - 1)
        non_static = in_obj & non_static_slots[psc]
        dynamic = in_obj & dynamic_slots[psc]

        static_mask = raw_mask & ~non_static
        static_pts = jnp.where(static_mask[:, None], seg_world, SENTINEL)

        # ---- re-filter static cloud (odom.cc:901-918) ----
        # cheap masks here; the voxel pass itself is deferred into
        # update_keyframes' add branch (refilter=True below): its output
        # is only consumed on keyframe-add scans
        pre = cfg.preprocessing
        sp, m = static_pts, static_mask
        if pre.downsampling.use:
            # static strided slice (filters.decimate): the add branch's
            # voxel argsort shrinks r*c-fold instead of sorting 131k
            # mostly-dead rows
            sp, m = filters.decimate(
                sp, m, H, W, pre.downsampling.row, pre.downsampling.col
            )
        if pre.crop_box.use:
            m = m & filters.crop_box_mask(sp, pre.crop_box.size, odo.pose)
        kf_pts, kf_mask = sp, m

    # ---- keyframe update on the (dynamic-free) world cloud ----
    odo_state, added = odometry.update_keyframes(
        cfg, odo_state, kf_pts, kf_mask,
        refilter=bool(cfg.dynamic_detection),
    )

    new_state = DDLOState(
        odom=odo_state, tracks=trk_state, prev_stamp=jnp.float32(timestamp)
    )
    outputs = DDLOOutputs(
        odom=odo._replace(new_keyframe=added),
        detections=det,
        tracks=trk_out,
        static_points=static_pts,
        static_mask=static_mask,
        dynamic_mask=dynamic,
        non_static_mask=non_static,
        ground_mask=ground,
        keyframe_added=added,
        new_keyframe_points=kf_pts,
        new_keyframe_mask=kf_mask,
    )
    return new_state, outputs


@partial(jax.jit, static_argnames=("cfg",))
def step_chunk(
    cfg: DDLOConfig,
    state: DDLOState,
    pts_stack: jnp.ndarray,  # (K, H*W, 3)
    mask_stack: jnp.ndarray,  # (K, H*W)
    ts_stack: jnp.ndarray,  # (K,)
    hull_masks: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[DDLOState, DDLOOutputs]:
    """K sequential full-pipeline steps in ONE dispatch (``lax.scan``).

    The scan loop is still strictly sequential — scan i+1's S2S target
    and keyframe store come from scan i — this only batches DISPATCH.
    Each dispatch carries a fixed host cost; at K=8 it amortizes 8x
    (whether that still pays on a local GPU is not measured yet).

    ``hull_masks`` are held fixed for the whole chunk: hull membership
    only changes on keyframe insertion, and a just-inserted keyframe is
    always selected by the knn-nearest rule anyway (same staleness
    argument as runner.py's one-scan-late refresh, just K scans wide).

    Returns (final state, outputs stacked over the K scans).
    """

    def body(st, xs):
        pts, mask, ts = xs
        st2, out = step(cfg, st, pts, mask, ts, hull_masks)
        return st2, out

    return jax.lax.scan(body, state, (pts_stack, mask_stack, ts_stack))


def _empty_detection(cfg: DDLOConfig) -> detection.DetectionResult:
    H, W = cfg.detection.rows, cfg.detection.columns
    S = cfg.capacity.max_objects
    from dynamic_direct_lidar_odometry.ops.bbox import Objects

    return detection.DetectionResult(
        objects=Objects(
            state=jnp.zeros((S, 7)),
            num_points=jnp.zeros((S,)),
            density=jnp.zeros((S,)),
            avg_residuum=jnp.zeros((S,)),
            valid=jnp.zeros((S,), bool),
        ),
        pixel_slot=jnp.full((H, W), -1, jnp.int32),
        ground=jnp.zeros((H, W), jnp.int8),
        range_image=jnp.zeros((H, W)),
        residual_image=jnp.zeros((H, W)),
        labels=jnp.full((H, W), -1, jnp.int32),
        point_index=jnp.arange(H * W, dtype=jnp.int32).reshape(H, W),
    )
