"""Multi-object tracker: fixed-slot KF bank + optimal assignment.

Functional redesign of ``TrackingModule`` (src/tracking/tracking.cpp) and
``BoundingBoxFilter`` (src/tracking/bounding_box_filter.cpp):

- the std::vector of filters becomes a fixed bank of T slots with an
  ``active`` mask; spawn = claim a free slot, erase = clear the mask,
- per-filter KF predict/update run batched (:mod:`..ops.kalman`),
- association cost 0.8*(1 - OBB IoU) + 0.1*(1 - point-count ratio)
  (tracking.cpp:172-190) over all pairs at once, solved by the JV
  assignment (:mod:`..ops.hungarian`), then the velocity gate
  ``displacement > maxObjVelocity * dt`` un-matches (tracking.cpp:137-148),
- the UNDEFINED -> STATIC/DYNAMIC status machine, rolling 5-deep static
  bbox history, and turned-dynamic "clear map" emission reproduce
  bounding_box_filter.cpp:169-243.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import TrackingConfig
from dynamic_direct_lidar_odometry.ops import bbox as bbox_ops
from dynamic_direct_lidar_odometry.ops import hungarian, kalman
from dynamic_direct_lidar_odometry.ops.bbox import Objects

# Object status (include/tracking/object.h:9-26)
UNDEFINED, STATIC, DYNAMIC = 0, 1, 2

_HIST = 5  # rolling static-bbox window (bounding_box_filter.cpp:238-241)


class TrackerState(NamedTuple):
    active: jnp.ndarray  # (T,) bool
    x: jnp.ndarray  # (T, 10) KF state
    P: jnp.ndarray  # (T, 10, 10) KF covariance
    obj_state: jnp.ndarray  # (T, 7) last copied detection state
    status: jnp.ndarray  # (T,) int32
    hits: jnp.ndarray  # (T,)
    sslu: jnp.ndarray  # (T,) steps since last update
    filter_id: jnp.ndarray  # (T,)
    next_id: jnp.ndarray  # ()
    first_xy: jnp.ndarray  # (T, 2) spawn position (travel-distance origin)
    num_points: jnp.ndarray  # (T,)
    avg_residuum: jnp.ndarray  # (T,)
    det_slot: jnp.ndarray  # (T,) detection slot matched this frame, -1
    bbox_hist: jnp.ndarray  # (T, 5, 7)
    bbox_hist_len: jnp.ndarray  # (T,)

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


class TrackerOutputs(NamedTuple):
    # static-bbox histories of filters that just turned dynamic -> the map
    # node's clear_map input (tracking.cpp:257-282)
    clear_map_boxes: jnp.ndarray  # (T, 5, 7)
    clear_map_valid: jnp.ndarray  # (T, 5) bool
    matched: jnp.ndarray  # (D,) track slot per detection, -1
    spawned: jnp.ndarray  # (D,) bool new filter created


def empty_state(max_tracks: int) -> TrackerState:
    T = max_tracks
    return TrackerState(
        active=jnp.zeros((T,), bool),
        x=jnp.zeros((T, 10), jnp.float32),
        P=jnp.tile(kalman.initial_covariance(), (T, 1, 1)),
        obj_state=jnp.zeros((T, 7), jnp.float32),
        status=jnp.zeros((T,), jnp.int32),
        hits=jnp.zeros((T,), jnp.int32),
        sslu=jnp.zeros((T,), jnp.int32),
        filter_id=jnp.full((T,), -1, jnp.int32),
        next_id=jnp.int32(0),
        first_xy=jnp.zeros((T, 2), jnp.float32),
        num_points=jnp.zeros((T,), jnp.float32),
        avg_residuum=jnp.zeros((T,), jnp.float32),
        det_slot=jnp.full((T,), -1, jnp.int32),
        bbox_hist=jnp.zeros((T, _HIST, 7), jnp.float32),
        bbox_hist_len=jnp.zeros((T,), jnp.int32),
    )


def _cost_matrices(
    dets: Objects, trk_state: jnp.ndarray, trk_np, d_valid, t_valid,
    iou_pair_budget: int = 256,
):
    """Full cost + displacement matrices (tracking.cpp:96-114).

    The IoU term only pays the polygon clip for pairs that can overlap
    (validity + z-extent + circumradius gates, see
    :func:`..ops.bbox.obb_iou_matrix_gated`); every other pair is exactly
    IoU = 0, which is what the dense matrix computes for them too."""
    iou = bbox_ops.obb_iou_matrix_gated(
        dets.state, trk_state, d_valid, t_valid, budget=iou_pair_budget
    )  # (D, T)
    np_d = dets.num_points[:, None]
    np_t = trk_np[None, :]
    ratio = jnp.minimum(np_d, np_t) / jnp.maximum(jnp.maximum(np_d, np_t), 1.0)
    cost = 0.8 * (1.0 - iou) + 0.1 * (1.0 - ratio)
    disp = jnp.linalg.norm(
        dets.state[:, None, :3] - trk_state[None, :, :3], axis=-1
    )
    return cost, disp


@partial(jax.jit, static_argnames=("cfg",))
def update(
    cfg: TrackingConfig,
    state: TrackerState,
    dets: Objects,
    dt: jnp.ndarray,
) -> Tuple[TrackerState, TrackerOutputs]:
    """One tracker tick (TrackingModule::update, tracking.cpp:27-78)."""
    T = state.capacity
    D = dets.valid.shape[0]

    # ---- predict (tracking.cpp:36-41) ----
    x_pred, P_pred = kalman.predict(state.x, state.P, dt)
    x_pred = jnp.where(state.active[:, None], x_pred, state.x)
    P_pred = jnp.where(state.active[:, None, None], P_pred, state.P)
    sslu = state.sslu + state.active.astype(jnp.int32)

    # tracked objects for association use the predicted KF state head
    trk_state7 = x_pred[:, :7]

    # ---- associate (tracking.cpp:80-150) ----
    cost, disp = _cost_matrices(
        dets, trk_state7, state.num_points, dets.valid, state.active,
        iou_pair_budget=cfg.iou_pair_budget,
    )
    col = hungarian.assign(cost, dets.valid, state.active)  # (D,) track per det
    # velocity gate
    gate = cfg.max_obj_velocity * dt
    col_ok = jnp.where(
        (col >= 0)
        & (disp[jnp.arange(D), jnp.clip(col, 0, T - 1)] <= gate),
        col,
        -1,
    )

    # per-track: which detection matched it (-1 none)
    det_of_track = jnp.full((T,), -1, jnp.int32)
    det_of_track = det_of_track.at[jnp.where(col_ok >= 0, col_ok, T)].set(
        jnp.arange(D, dtype=jnp.int32), mode="drop"
    )
    is_matched = det_of_track >= 0
    di = jnp.clip(det_of_track, 0, D - 1)

    # ---- matched updates (bounding_box_filter.cpp:64-85) ----
    hits = jnp.where(is_matched, state.hits + 1, state.hits)
    sslu = jnp.where(is_matched, 0, sslu)
    obj_state = jnp.where(is_matched[:, None], dets.state[di], state.obj_state)
    num_points = jnp.where(is_matched, dets.num_points[di], state.num_points)
    avg_res = jnp.where(is_matched, dets.avg_residuum[di], state.avg_residuum)

    # status machine (bounding_box_filter.cpp:169-217), evaluated only for
    # matched tracks (update() is the only caller of updateDynamicStatus)
    cur_xy = obj_state[:, :2]
    d2 = jnp.sum((cur_xy - state.first_xy) ** 2, axis=-1)
    min_res = obj_state[:, 6] * cfg.residuum_height_ratio
    dyn_check = (avg_res >= min_res) & (
        d2 >= cfg.min_dist_from_origin * cfg.min_dist_from_origin
    )

    st = state.status
    # UNDEFINED branch
    undef = st == UNDEFINED
    to_static = undef & (hits > cfg.max_undefined_hits)
    # fallthrough to dynamic check if hits >= min_dynamic_hits
    undef_dyn_eligible = undef & ~to_static & (hits >= cfg.min_dynamic_hits)
    static_branch = (st == STATIC) | undef_dyn_eligible
    to_dynamic = static_branch & dyn_check
    new_status = jnp.where(
        to_dynamic, DYNAMIC, jnp.where(to_static, STATIC, st)
    )
    new_status = jnp.where(is_matched, new_status, st)
    turned_dynamic = (
        is_matched & to_dynamic & (st != DYNAMIC) & (state.bbox_hist_len > 0)
    )

    # ---- bbox history (bounding_box_filter.cpp:219-243) ----
    # push the *detection* state while STATIC (after status update)
    push = is_matched & (new_status == STATIC)
    hist_len = state.bbox_hist_len
    shift_out = push & (hist_len >= _HIST)
    hist = jnp.where(
        shift_out[:, None, None],
        jnp.concatenate([state.bbox_hist[:, 1:], state.bbox_hist[:, :1]], axis=1),
        state.bbox_hist,
    )
    write_pos = jnp.where(shift_out, _HIST - 1, jnp.minimum(hist_len, _HIST - 1))
    pushed = hist.at[jnp.arange(T), write_pos].set(
        jnp.where(push[:, None], obj_state, hist[jnp.arange(T), write_pos])
    )
    hist_len = jnp.where(push, jnp.minimum(hist_len + 1, _HIST), hist_len)

    # ---- KF measurement update for matched tracks ----
    x_upd, P_upd = kalman.update(x_pred, P_pred, dets.state[di])
    x_new = jnp.where(is_matched[:, None], x_upd, x_pred)
    P_new = jnp.where(is_matched[:, None, None], P_upd, P_pred)

    # ---- clear_map emission: turned-dynamic histories, then reset ----
    clear_valid = turned_dynamic[:, None] & (
        jnp.arange(_HIST)[None, :] < hist_len[:, None]
    )
    clear_boxes = pushed
    hist_len = jnp.where(turned_dynamic, 0, hist_len)

    # ---- erase stale (tracking.cpp:67-73) ----
    alive = state.active & (sslu < cfg.max_no_hits)

    # ---- spawn new filters for unmatched detections (tracking.cpp:52-63) --
    det_matched = col_ok >= 0
    unmatched = dets.valid & ~det_matched
    free = ~alive
    # rank free slots and unmatched detections
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # per slot
    want_rank = jnp.cumsum(unmatched.astype(jnp.int32)) - 1  # per det
    n_free = jnp.sum(free.astype(jnp.int32))
    spawn_det = unmatched & (want_rank < n_free)
    # build mapping: for each slot, which det spawns here
    slot_order = jnp.argsort(jnp.where(free, 0, 1), stable=True)  # free first
    det_order = jnp.argsort(jnp.where(spawn_det, 0, 1), stable=True)
    n_spawn = jnp.sum(spawn_det.astype(jnp.int32))
    spawn_src = jnp.full((T,), -1, jnp.int32)
    take = jnp.arange(T) < n_spawn
    spawn_src = spawn_src.at[slot_order].set(
        jnp.where(take, det_order[jnp.clip(jnp.arange(T), 0, D - 1)], -1)
    )
    spawning = spawn_src >= 0
    si = jnp.clip(spawn_src, 0, D - 1)

    x0 = jnp.concatenate([dets.state[si], jnp.zeros((T, 3))], axis=-1)
    ids = jnp.where(
        spawning, state.next_id + jnp.cumsum(spawning.astype(jnp.int32)) - 1, -1
    )

    def spawn_where(new, old):
        nd = new.ndim - old.ndim  # broadcast helper
        m = spawning.reshape((T,) + (1,) * (old.ndim - 1))
        return jnp.where(m, new, old)

    active = alive | spawning
    x_new = spawn_where(x0, jnp.where(alive[:, None], x_new, state.x * 0))
    P_new = spawn_where(
        jnp.tile(kalman.initial_covariance(), (T, 1, 1)), P_new
    )
    obj_state = spawn_where(dets.state[si], obj_state)
    new_status = jnp.where(spawning, UNDEFINED, jnp.where(alive, new_status, 0))
    hits = jnp.where(spawning, 1, jnp.where(alive, hits, 0))
    sslu = jnp.where(spawning, 0, sslu)
    filter_id = jnp.where(spawning, ids, jnp.where(alive, state.filter_id, -1))
    first_xy = spawn_where(dets.state[si, :2], state.first_xy)
    num_points = spawn_where(dets.num_points[si], num_points)
    avg_res = spawn_where(dets.avg_residuum[si], avg_res)
    det_track = jnp.where(
        spawning, spawn_src, jnp.where(alive, det_of_track, -1)
    )
    hist_len = jnp.where(spawning, 0, jnp.where(alive, hist_len, 0))

    new_state = TrackerState(
        active=active,
        x=x_new,
        P=P_new,
        obj_state=obj_state,
        status=new_status,
        hits=hits,
        sslu=sslu,
        filter_id=filter_id,
        next_id=state.next_id + n_spawn,
        first_xy=first_xy,
        num_points=num_points,
        avg_residuum=avg_res,
        det_slot=det_track,
        bbox_hist=clear_boxes,
        bbox_hist_len=hist_len,
    )
    outputs = TrackerOutputs(
        clear_map_boxes=clear_boxes,
        clear_map_valid=clear_valid,
        matched=col_ok,
        spawned=spawn_det,
    )
    return new_state, outputs


def status_detection_mask(
    state: TrackerState, statuses: Tuple[int, ...], num_det_slots: int
) -> jnp.ndarray:
    """Which detection slots belong to tracks of the given statuses
    (TrackingModule::getIndices, tracking.cpp:192-222): the reference
    collects the point indices of each filter's *latest matched detection*.

    Returns (num_det_slots,) bool — combine with the detection pixel-slot
    image to get a pixel mask."""
    sel = jnp.zeros((state.capacity,), bool)
    for s in statuses:
        sel = sel | (state.status == s)
    sel = sel & state.active & (state.det_slot >= 0)
    out = jnp.zeros((num_det_slots,), bool)
    out = out.at[jnp.where(sel, state.det_slot, num_det_slots)].set(
        True, mode="drop"
    )
    return out
