"""Ground removal + range-image segmentation as vectorized image ops.

Accelerator redesign of the LeGO-LOAM-style stages in
``src/detection/detection.cpp``:

- ``groundRemoval`` (:448-508): the inter-ring slope test becomes a
  shifted-row stencil over the organized cloud — no loops.
- ``labelComponents`` BFS (:544-724): connected components under the
  angle predicate ``atan2(d2 sin a, d1 - d2 cos a) > theta`` become
  *iterated segmented min-scans*: each sweep saturates min-label
  propagation along every maximal connected row run (wrap-aware) and
  column run via ``lax.associative_scan`` — log-depth shifts with zero
  gathers (built where H*W-index gathers were slow; a pointer-jumping
  variant, the usual GPU CCL, is not measured on the H100 yet).
  Convergence needs one
  sweep per "turn" of a component's shape, 2-4 for real scans.
- per-segment feasibility gates (:659-699): ``segment_*`` reductions keyed
  by component root.

BFS seed order does not matter: the predicate is symmetric, so the
partition into connected components is identical to the reference's.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(2**30)


class GroundResult(NamedTuple):
    ground: jnp.ndarray  # (H, W) int8: -1 no-info, 0 not ground, 1 ground
    eligible: jnp.ndarray  # (H, W) bool: segmentation candidates (label 0)


@partial(jax.jit, static_argnames=("ground_rows",))
def ground_removal(
    points: jnp.ndarray,  # (H, W, 3) world frame (organized image)
    valid: jnp.ndarray,  # (H, W)
    ranges: jnp.ndarray,  # (H, W)
    ground_rows: int,
    sensor_mount_angle: float,
    ground_angle_threshold: float,
) -> GroundResult:
    """Mark ground pixels in the bottom ``ground_rows`` rows.

    detection.cpp:448-508: for each column, compare row r with row r-1
    (the ring above): angle = atan2(dz, sqrt(dx^2+dy^2)); ground if
    |angle - mount| <= threshold, marking BOTH rows. The reference's
    "invalid" test is x==0 (its nan_point_ stays NaN, so the test really
    fires for unfilled pixels, where full_cloud_ was reset); here the
    validity mask plays that role.
    """
    H, W = ranges.shape
    upper = jnp.roll(points, 1, axis=0)  # row r-1 at position r
    upper_valid = jnp.roll(valid, 1, axis=0)
    diff = upper - points
    angle = jnp.degrees(
        jnp.arctan2(diff[..., 2], jnp.linalg.norm(diff[..., :2], axis=-1))
    )
    pair_ok = valid & upper_valid
    is_ground_pair = pair_ok & (
        jnp.abs(angle - sensor_mount_angle) <= ground_angle_threshold
    )
    rows = jnp.arange(H)[:, None]
    in_band = (rows >= H - ground_rows) & (rows >= 1)
    is_ground_pair = is_ground_pair & in_band
    no_info = ~pair_ok & in_band

    ground = is_ground_pair | jnp.roll(is_ground_pair, -1, axis=0)  # mark r-1 too
    g = jnp.where(ground, 1, jnp.where(no_info, -1, 0)).astype(jnp.int8)
    # label_mat = -1 for ground or no-return pixels (detection.cpp:494-504)
    eligible = (~ground) & (ranges > 0)
    return GroundResult(g, eligible)


class SegmentationResult(NamedTuple):
    labels: jnp.ndarray  # (H, W) int32 component root id; -1 = not segmented
    edge_up: jnp.ndarray  # (H, W) connectivity to row above (debug/tests)
    edge_left: jnp.ndarray  # (H, W) connectivity to col left (wrapped)


@partial(jax.jit, static_argnames=("max_iters",))
def label_components(
    ranges: jnp.ndarray,
    eligible: jnp.ndarray,
    theta: float,
    ang_res_x_deg: float,
    ang_res_y_deg: float,
    window: jnp.ndarray | None = None,
    max_iters: int = 64,
) -> SegmentationResult:
    """Angle-predicate connected components (labelComponents,
    detection.cpp:544-724) via min-label propagation + pointer jumping.

    Args:
      window: optional (H, W) bool restricting segmentation (the fork's
        hardcoded 156..356 box, detection.cpp:514-516,569-571).
    """
    H, W = ranges.shape
    if window is not None:
        eligible = eligible & window

    def edge(shift_axis, shift, sin_a, cos_a):
        rn = jnp.roll(ranges, shift, axis=shift_axis)
        en = jnp.roll(eligible, shift, axis=shift_axis)
        d1 = jnp.maximum(ranges, rn)
        d2 = jnp.minimum(ranges, rn)
        ang = jnp.arctan2(d2 * sin_a, d1 - d2 * cos_a)
        ok = eligible & en & (ang > theta)
        if shift_axis == 0:  # vertical edges don't wrap (detection.cpp:591)
            rows = jnp.arange(H)[:, None]
            ok = ok & ((rows - shift >= 0) & (rows - shift < H))
        return ok

    sx, cx = jnp.sin(jnp.deg2rad(ang_res_x_deg)), jnp.cos(jnp.deg2rad(ang_res_x_deg))
    sy, cy = jnp.sin(jnp.deg2rad(ang_res_y_deg)), jnp.cos(jnp.deg2rad(ang_res_y_deg))

    e_up = edge(0, 1, sy, cy)  # connect (r, c) <-> (r-1, c)
    e_down = edge(0, -1, sy, cy)
    e_left = edge(1, 1, sx, cx)  # connect (r, c) <-> (r, c-1), wrapping
    e_right = edge(1, -1, sx, cx)

    del e_down, e_right  # scans use the canonical (up/left) edges only

    init = jnp.where(
        eligible, jnp.arange(H * W, dtype=jnp.int32).reshape(H, W), _BIG
    )

    def seg_scan(v, m, axis):
        """Segmented min-scan: m[i] connects element i to element i-1."""

        def combine(a, b):
            va, ma = a
            vb, mb = b
            return jnp.where(mb, jnp.minimum(va, vb), vb), ma & mb

        out, _ = jax.lax.associative_scan(combine, (v, m), axis=axis)
        return out

    # PACKED segmented min-scan: when label bits + run-key bits fit in
    # an int32, a segmented min-scan collapses to ONE plain cummax. With
    # key = run id (cumsum of break flags, non-decreasing along the
    # scan), the prefix max of  (key << VB) | (MAXV - L)  always carries
    # the current element's key (its own entry dominates every earlier
    # run's), so its low bits hold MAXV - min(L over the current run's
    # prefix). Halves the scanned payload vs the (value, mask) tuple
    # combine and uses the native cumulative op. Keys depend only on the
    # edge masks, so they hoist out of the while_loop.
    VB = max(1, (H * W - 1).bit_length())
    MAXV = jnp.int32((1 << VB) - 1)
    packed_ok = (VB + max((W + 1).bit_length(), (H + 1).bit_length())) <= 31
    # the doubled-scan form needs one extra key bit (bwd keys offset by
    # n+1 -> max 2n+1); shapes that fit the packed budget but not this
    # one (e.g. 64x4096) keep the two-scan packed form instead of
    # losing packing altogether
    doubled_ok = (
        VB
        + max((2 * W + 1).bit_length(), (2 * H + 1).bit_length())
    ) <= 31

    def seg_scan_packed(L, key, axis):
        enc = (key << VB) | (MAXV - jnp.minimum(L, MAXV))
        cm = jax.lax.associative_scan(jnp.maximum, enc, axis=axis)
        return MAXV - (cm & MAXV)

    def run_keys(m, axis):
        """(fwd key, bwd mask's key in flipped space) for one scan axis."""
        kf = jnp.cumsum(~m, axis=axis, dtype=jnp.int32)
        mr = jnp.flip(jnp.roll(m, -1, axis=axis), axis=axis)
        if axis == 0:
            mr = mr.at[0, :].set(False)
        else:
            mr = mr.at[:, 0].set(False)
        kb = jnp.cumsum(~mr, axis=axis, dtype=jnp.int32)
        return kf, kb

    def bidir_scan(L, m, axis, keys=None):
        """min over each element's maximal connected run, both directions."""
        if keys is not None and doubled_ok:
            # ONE doubled cummax instead of fwd + flipped-bwd scans: the
            # reversed copy rides behind the forward half with its keys
            # offset past the forward range, so the prefix max never
            # carries across the seam (every second-half enc dominates
            # every first-half one). 12 log-passes over 2n instead of
            # 2x11 over n — measured 0.355 -> 0.210 ms per row bidir at
            # 64x2048 (per-pass overhead halves; bandwidth is the same).
            kf, kb = keys
            n = L.shape[axis]
            Ld = jnp.concatenate([L, jnp.flip(L, axis=axis)], axis=axis)
            keys2 = jnp.concatenate(
                [kf, kb + jnp.int32(n + 1)], axis=axis
            )
            out = seg_scan_packed(Ld, keys2, axis)
            fwd = jax.lax.slice_in_dim(out, 0, n, axis=axis)
            bwd = jnp.flip(
                jax.lax.slice_in_dim(out, n, 2 * n, axis=axis), axis=axis
            )
            return jnp.minimum(fwd, bwd)
        if keys is not None:
            kf, kb = keys
            fwd = seg_scan_packed(L, kf, axis)
            bwd = jnp.flip(
                seg_scan_packed(jnp.flip(L, axis=axis), kb, axis), axis=axis
            )
            return jnp.minimum(fwd, bwd)
        fwd = seg_scan(L, m, axis)
        mr = jnp.flip(jnp.roll(m, -1, axis=axis), axis=axis)
        if axis == 0:
            mr = mr.at[0, :].set(False)
        else:
            mr = mr.at[:, 0].set(False)
        bwd = jnp.flip(seg_scan(jnp.flip(L, axis=axis), mr, axis), axis=axis)
        return jnp.minimum(fwd, bwd)

    # seam handling: e_left[:, 0] connects col 0 to col W-1 (the ring
    # wrap). Instead of scanning a doubled [L | L] row (2x the min-scan
    # work), scan single-width and merge the two seam-adjacent runs with
    # two cheap boolean cum-ANDs: in_prefix marks col 0's maximal run,
    # in_suffix marks col W-1's; where the seam edge holds, both runs
    # take the min of their two run-minima — exactly what the doubled
    # scan saturates to (a fully-connected ring makes both runs the
    # whole row, which also matches).
    m_row = e_left.at[:, 0].set(False)
    in_prefix = jax.lax.associative_scan(
        jnp.logical_and, m_row.at[:, 0].set(True), axis=1
    )
    ms = jnp.roll(m_row, -1, axis=1).at[:, -1].set(True)
    in_suffix = jnp.flip(
        jax.lax.associative_scan(jnp.logical_and, jnp.flip(ms, axis=1), axis=1),
        axis=1,
    )
    seam_fix = e_left[:, :1] & (in_prefix | in_suffix)

    m_col = e_up.at[0, :].set(False)
    row_keys = run_keys(m_row, 1) if packed_ok else None
    col_keys = run_keys(m_col, 0) if packed_ok else None

    # A Pallas kernel for these sweeps was built for the accelerator
    # this was first tuned for and deleted: it reproduced the packed
    # math exactly and ran no faster than XLA's associative_scan.
    def row_sweep(L):
        Lr = bidir_scan(L, m_row, 1, keys=row_keys)
        s = jnp.minimum(Lr[:, :1], Lr[:, -1:])
        return jnp.where(seam_fix, jnp.minimum(Lr, s), Lr)

    def col_sweep(L):
        return bidir_scan(L, m_col, 0, keys=col_keys)

    def cond(state):
        L, prev, it = state
        return (it < max_iters) & jnp.any(L != prev)

    def body(state):
        L, _, it = state
        Ln = col_sweep(row_sweep(L))
        return Ln, L, it + 1

    L, _, _ = jax.lax.while_loop(cond, body, (init, init + 1, jnp.int32(0)))
    labels = jnp.where(eligible, L, -1)
    return SegmentationResult(labels, e_up, e_left)


class SegmentStats(NamedTuple):
    """Per-root statistics + feasibility (flat arrays indexed by root id)."""

    size: jnp.ndarray  # (H*W,)
    line_count: jnp.ndarray
    min_z: jnp.ndarray
    max_z: jnp.ndarray
    max_dist: jnp.ndarray
    avg_residuum: jnp.ndarray
    feasible: jnp.ndarray  # (H*W,) bool


@jax.jit
def segment_stats(
    labels: jnp.ndarray,  # (H, W) from label_components
    ranges: jnp.ndarray,
    points: jnp.ndarray,  # (H, W, 3) world frame
    residual_img: jnp.ndarray,  # (H, W)
    sensor_height: jnp.ndarray,  # () T_(2,3)
    min_line_num: int,
    valid_point_num: int,
    valid_line_num: int,
    max_distance: float,
    min_delta_z: float,
    max_delta_z: float,
    max_elevation: float,
) -> SegmentStats:
    """Feasibility gates of labelComponents (detection.cpp:659-699).

    The reference tracks min/max z and distance incrementally over BFS
    expansion edges (and its min_z update has an ``else if`` quirk,
    detection.cpp:629-635); here the equivalent reductions run over all
    member pixels. NOTE: the reference's size gate uses a hardcoded 50,
    not minPointNum (detection.cpp:669).
    """
    H, W = labels.shape
    n = H * W
    lab = labels.reshape(-1)
    member = lab >= 0
    seg = jnp.where(member, lab, n)

    ones = member.astype(jnp.float32)

    # distinct-rows count per root: one presence scatter into (root, row)
    # buckets + a reduction — H x cheaper than a per-row scan
    rows_of = jnp.repeat(jnp.arange(H), W)
    bucket = seg * H + rows_of  # (n,) in [0, (n+1)*H)
    present = jnp.zeros(((n + 1) * H,), jnp.bool_).at[bucket].set(True)
    line_count = jnp.sum(
        present.reshape(n + 1, H).astype(jnp.float32), axis=1
    )[:n]

    # all sum- and min-style per-root stats ride TWO multi-column scatters
    # (segment ops reduce 2D data column-wise) instead of five scalar ones
    z = points[..., 2].reshape(-1)
    r = ranges.reshape(-1)
    res = residual_img.reshape(-1)
    res_pos = member & (res > 0)
    big = jnp.float32(1e9)

    sum_data = jnp.stack(
        [ones, jnp.where(res_pos, res, 0.0), res_pos.astype(jnp.float32)],
        axis=-1,
    )
    sums = jax.ops.segment_sum(sum_data, seg, num_segments=n + 1)[:n]
    size, res_sum, res_cnt = sums[:, 0], sums[:, 1], sums[:, 2]

    min_data = jnp.stack([z, -z, -r], axis=-1)
    min_data = jnp.where(member[:, None], min_data, big)
    mins = jax.ops.segment_min(min_data, seg, num_segments=n + 1)[:n]
    min_z, max_z, max_dist = mins[:, 0], -mins[:, 1], -mins[:, 2]

    avg_res = jnp.where(res_cnt > 0, res_sum / jnp.maximum(res_cnt, 1.0), 0.0)

    feasible = (size >= 50) & (line_count >= min_line_num)
    feasible = feasible | (
        (size >= valid_point_num) & (line_count >= valid_line_num)
    )
    feasible = feasible & (max_dist <= max_distance)
    dz = max_z - min_z
    feasible = feasible & (min_delta_z <= dz) & (dz <= max_delta_z)
    feasible = feasible & ((min_z - sensor_height) <= max_elevation)
    feasible = feasible & (size > 0)

    return SegmentStats(size, line_count, min_z, max_z, max_dist, avg_res, feasible)


@partial(jax.jit, static_argnames=("max_objects", "candidates"))
def segment_objects(
    labels: jnp.ndarray,  # (H, W) from label_components
    ranges: jnp.ndarray,
    points: jnp.ndarray,  # (H, W, 3) world frame
    residual_img: jnp.ndarray,  # (H, W)
    sensor_height: jnp.ndarray,  # () T_(2,3)
    min_line_num: int,
    valid_point_num: int,
    valid_line_num: int,
    max_distance: float,
    min_delta_z: float,
    max_delta_z: float,
    max_elevation: float,
    max_objects: int,
    candidates: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused feasibility gates + slot compaction over CANDIDATE roots.

    :func:`segment_stats` + :func:`compact_segments` compute every
    per-root statistic with segment_sum/min scatters over H*W segments
    (plus a (H*W)*H presence scatter for the distinct-row count), which
    made it the detection hot spot where scatters serialize per row.
    The only thing that genuinely needs a full
    per-root reduction is the RANKING signal (pixel count); everything
    else is only consulted for roots that could become object slots.

    So: ONE scalar segment-sum for sizes -> top-``candidates`` roots
    that pass the minimum-size gate -> every remaining stat (distinct
    rows, z extents, max range, residual means) as dense (K, n) masked
    reductions/matmuls over just those candidates — the same
    dense pattern as :func:`..bbox.pca_bboxes`. Gates match
    segment_stats exactly (including the hardcoded size-50 of
    detection.cpp:669).

    Equivalence to the exact path: bit-identical (same top_k
    tie-breaking by root id) whenever the final ``max_objects`` feasible
    roots rank inside the top-``candidates`` roots by size. With the
    default 256-candidate budget a feasible object is only ever lost if
    256 LARGER components pass the minimum-size gate first — a scene
    with more sizeable components than tracker slots by 4x, where the
    smallest objects are already being dropped by the slot cap.

    Returns:
      slot_roots: (max_objects,) root id per slot (or -1)
      slot_valid: (max_objects,) bool
      pixel_slot: (H, W) int32 slot per pixel (-1 if none / infeasible)
      slot_avg_residuum: (max_objects,) mean positive residual per slot
    """
    H, W = labels.shape
    n = H * W
    lab = labels.reshape(-1)
    member = lab >= 0
    seg = jnp.where(member, lab, n)

    # per-root pixel counts WITHOUT a scatter-add: sort the root ids, find run
    # boundaries, and read each run's length at its last element. Each
    # distinct root owns exactly one run, runs are ordered by root id,
    # so top_k tie-breaking (smaller root wins) matches the scatter
    # path's root-indexed top_k exactly.
    srt = jnp.sort(seg)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), srt[1:] != srt[:-1]]
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, idx, -1)
    )
    is_last = jnp.concatenate([srt[:-1] != srt[1:], jnp.ones((1,), bool)])
    run_len = (idx - run_start + 1).astype(jnp.float32)

    K = min(candidates, n)
    min_size = jnp.minimum(jnp.float32(50.0), jnp.float32(valid_point_num))
    cand_score = jnp.where(
        is_last & (srt < n) & (run_len >= jnp.maximum(min_size, 1.0)),
        run_len,
        -1.0,
    )
    cand_sz, cand_pos = jax.lax.top_k(cand_score, K)
    cand_roots = srt[cand_pos]
    cand_ok = cand_sz > 0
    size = jnp.maximum(cand_sz, 0.0)

    # dense (K, n) candidate membership; all stats fuse over it
    onehot = lab[None, :] == cand_roots[:, None]
    onehot = onehot & cand_ok[:, None]

    rows_any = jnp.any(onehot.reshape(K, H, W), axis=2)
    line_count = jnp.sum(rows_any.astype(jnp.float32), axis=1)

    z = points[..., 2].reshape(-1)
    r = ranges.reshape(-1)
    res = residual_img.reshape(-1)
    big = jnp.float32(1e9)
    min_z = jnp.min(jnp.where(onehot, z[None, :], big), axis=1)
    max_z = jnp.max(jnp.where(onehot, z[None, :], -big), axis=1)
    max_dist = jnp.max(jnp.where(onehot, r[None, :], -big), axis=1)
    res_pos = onehot & (res > 0)[None, :]
    res_sum = jnp.sum(jnp.where(res_pos, res[None, :], 0.0), axis=1)
    res_cnt = jnp.sum(res_pos.astype(jnp.float32), axis=1)
    avg_res = jnp.where(res_cnt > 0, res_sum / jnp.maximum(res_cnt, 1.0), 0.0)

    feasible = (size >= 50) & (line_count >= min_line_num)
    feasible = feasible | (
        (size >= valid_point_num) & (line_count >= valid_line_num)
    )
    feasible = feasible & (max_dist <= max_distance)
    dz = max_z - min_z
    feasible = feasible & (min_delta_z <= dz) & (dz <= max_delta_z)
    feasible = feasible & ((min_z - sensor_height) <= max_elevation)
    feasible = feasible & cand_ok & (size > 0)

    final_score = jnp.where(feasible, size, -1.0)
    top_sz, top_idx = jax.lax.top_k(final_score, max_objects)
    slot_valid = top_sz > 0
    slot_roots = jnp.where(slot_valid, cand_roots[top_idx], -1).astype(jnp.int32)
    slot_avg_res = jnp.where(slot_valid, avg_res[top_idx], 0.0)

    # pixel -> slot WITHOUT the (n+1)-buffer scatter + 131k-row gather:
    # each pixel belongs to at most one candidate row, so
    # one (slot+1)-weighted pass over the candidate onehot recovers the
    # slot id (0 -> no slot -> -1).
    sel = (top_idx[:, None] == jnp.arange(K)[None, :]) & slot_valid[:, None]
    w_slot = jnp.where(
        slot_valid, jnp.arange(max_objects, dtype=jnp.float32) + 1.0, 0.0
    )
    wk = w_slot @ sel.astype(jnp.float32)  # (K,) slot+1 per candidate row
    pixel_slot = (
        jnp.einsum("k,kn->n", wk, onehot.astype(jnp.float32)) - 1.0
    ).astype(jnp.int32)
    return slot_roots, slot_valid, pixel_slot.reshape(H, W), slot_avg_res


@partial(jax.jit, static_argnames=("max_objects",))
def compact_segments(
    labels: jnp.ndarray, stats: SegmentStats, max_objects: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack feasible roots into object slots.

    Returns:
      slot_roots: (max_objects,) root id per slot (or -1)
      slot_valid: (max_objects,) bool
      pixel_slot: (H, W) int32 slot per pixel (-1 if none / infeasible) —
        the analogue of the reference's per-object index lists
        (label_indices_i_, detection.cpp:524-538).
    """
    H, W = labels.shape
    n = H * W
    # top-max_objects feasible roots by size (reference keeps all; a
    # capacity cap must prefer big objects)
    score = jnp.where(stats.feasible, stats.size, -1.0)
    top_sz, top_roots = jax.lax.top_k(score, max_objects)
    slot_valid = top_sz > 0
    slot_roots = jnp.where(slot_valid, top_roots, -1)

    root_to_slot = jnp.full((n + 1,), -1, jnp.int32)
    root_to_slot = root_to_slot.at[jnp.where(slot_valid, top_roots, n)].set(
        jnp.arange(max_objects, dtype=jnp.int32), mode="drop"
    )
    lab = labels.reshape(-1)
    pixel_slot = jnp.where(lab >= 0, root_to_slot[jnp.where(lab >= 0, lab, 0)], -1)
    return slot_roots.astype(jnp.int32), slot_valid, pixel_slot.reshape(H, W)
