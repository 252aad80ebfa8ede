"""The DLO odometry core: a pure state-transition per scan.

Functional redesign of ``OdomNode::icpCB`` (odom.cc:614-729) and
``scanMatching`` (odom.cc:745-851): preprocessing -> scan-to-scan GICP ->
submap selection -> scan-to-submap GICP -> keyframe update, as one
``jit``-compiled ``step(state, scan) -> (state', outputs)``.

Mapping from the reference's mutable node state:

  target_cloud_/gicp_s2s swap semantics (odom.cc:696,768) -> ``prev_*``
      fields: the current scan + covariances become the next step's S2S
      target, with zero copies (pure-functional swap).
  covariance reuse s2s->s2m (odom.cc:765)                 -> the same
      ``src_covs`` array is passed to both aligns.
  keyframes_/keyframe_normals_                            -> KeyframeStore.
  submap cache + hasChanged (odom.cc:1290-1314)           -> the submap
      buffer is re-gathered each step; with no kd-tree there is no build
      cost to amortize, a gather is cheaper than the branch.

Dynamic-object removal (the "D" in DDLO) plugs in between scan matching
and the keyframe update exactly as in the reference (odom.cc:687-693);
see pipeline.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.core import se3
from dynamic_direct_lidar_odometry.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry.odometry import keyframes as kf
from dynamic_direct_lidar_odometry.odometry import preprocess as prep
from dynamic_direct_lidar_odometry.ops import covariance, filters, gicp


class OdomState(NamedTuple):
    # Poses (world frame)
    T: jnp.ndarray  # (4,4) current pose (T_, odom.h)
    T_s2s: jnp.ndarray  # (4,4) S2S-propagated pose
    T_s2s_prev: jnp.ndarray  # (4,4) base for next S2S propagation
    pose: jnp.ndarray  # (3,)
    rotq: jnp.ndarray  # (4,) [w,x,y,z]
    # Previous scan (sensor frame) = next S2S target
    prev_points: jnp.ndarray  # (N, 3)
    prev_mask: jnp.ndarray  # (N,)
    prev_covs: jnp.ndarray  # (N, 3, 3)
    # Keyframe map
    store: kf.KeyframeStore
    # Metrics / adaptive params
    spaciousness: jnp.ndarray  # () LPF'd median range
    keyframe_thresh_dist: jnp.ndarray  # () adaptive threshD
    # Last S2S increment (constant-velocity S2S seed when
    # cfg.initial_guess_motion; identity otherwise / at start)
    prev_rel: jnp.ndarray  # (4, 4)
    # Bookkeeping
    scan_count: jnp.ndarray  # () int32
    # Device-hull cache: the exact on-device hull masks depend only on
    # (store.positions, store.valid, alpha), the store changes only on
    # keyframe insertion, and alpha (adaptive_keyframe_thresh) is
    # piecewise CONSTANT — so recomputing the O(K^3) sweeps only when
    # ``hull_dirty | (alpha != hull_alpha)`` is EXACT, not an
    # approximation. The reference recomputes pcl hulls every scan
    # (odom.cc:993-1065) over inputs that equally only change on insert.
    hull_cv: jnp.ndarray  # (K,) bool cached convex membership
    hull_cc: jnp.ndarray  # (K,) bool cached concave membership
    hull_alpha: jnp.ndarray  # () f32 alpha the cache was built with
    hull_dirty: jnp.ndarray  # () bool store changed since last build


class OdomOutputs(NamedTuple):
    pose: jnp.ndarray
    rotq: jnp.ndarray
    T: jnp.ndarray
    T_s2s_rel: jnp.ndarray  # the local S2S increment (T_s2s_orig_)
    # registration scan in world frame + per-point S2M NN residuals
    reg_points_world: jnp.ndarray  # (N, 3)
    reg_mask: jnp.ndarray  # (N,)
    residuals: jnp.ndarray  # (N,)
    new_keyframe: jnp.ndarray  # () bool
    s2s_converged: jnp.ndarray
    s2m_converged: jnp.ndarray
    s2s_iterations: jnp.ndarray
    s2m_iterations: jnp.ndarray
    num_keyframes: jnp.ndarray
    submap_size: jnp.ndarray


def _nn_impl_from_env() -> str:
    """Correspondence-backend selection (DDLO_NN_IMPL=sparse|exact, read
    at trace time, so it is not part of the jit cache key: compare the
    two in separate processes, as tools/accuracy.py does). Default
    "sparse": exact within the correspondence gate; the block-sparse
    Pallas kernel on the GPU and the exact sweep elsewhere
    (knn.nn1_within), so CPU tests and goldens are unaffected."""
    import os

    impl = os.environ.get("DDLO_NN_IMPL", "sparse")
    if impl not in ("sparse", "exact"):
        raise ValueError(f"DDLO_NN_IMPL must be sparse or exact, got {impl!r}")
    return impl


def _settings(stage, compute_residuals: bool = True) -> gicp.GICPSettings:
    return gicp.GICPSettings(
        max_correspondence_distance=stage.max_correspondence_distance,
        max_iterations=stage.max_iterations,
        rotation_epsilon=stage.rotation_epsilon,
        transformation_epsilon=stage.transformation_epsilon,
        lm_max_iterations=stage.lm_max_iterations,
        lm_init_lambda_factor=stage.lm_init_lambda_factor,
        compute_residuals=compute_residuals,
        nn_impl=_nn_impl_from_env(),
    )


@partial(jax.jit, static_argnames=("cfg",))
def init_state(
    cfg: DDLOConfig,
    raw_points: jnp.ndarray,
    raw_mask: jnp.ndarray,
    T0: jnp.ndarray | None = None,
) -> OdomState:
    """Initialize from the first scan (initializeInputTarget, odom.cc:480-516):
    the first scan becomes the S2S target and the first keyframe.

    ``T0`` seeds the pose (identity, or a gravity-aligned rotation)."""
    if T0 is None:
        T0 = jnp.eye(4)
    T0 = T0.astype(jnp.float32)

    p = prep.preprocess(cfg, raw_points, raw_mask)
    covs = covariance.plane_covariances(
        p.points, p.mask, k=cfg.gicp.s2s.k_correspondences,
        morton_ordered=cfg.preprocessing.voxel_scan.use,
    )

    # first keyframe: transformed by T0, voxelized at submap res
    kf_pts_w = se3.transform_points(T0, p.points)
    kf_pts_w = jnp.where(p.mask[:, None], kf_pts_w, SENTINEL)
    if cfg.preprocessing.voxel_submap.use:
        kf_pts, kf_mask = filters.voxel_downsample(
            kf_pts_w, p.mask, cfg.preprocessing.voxel_submap.res,
            cfg.capacity.max_keyframe_points,
        )
    else:
        kf_pts, kf_mask = filters.compact(
            kf_pts_w, p.mask, cfg.capacity.max_keyframe_points
        )
    kf_covs = covariance.plane_covariances(
        kf_pts, kf_mask, k=cfg.gicp.s2s.k_correspondences,
        morton_ordered=cfg.preprocessing.voxel_submap.use,
    )

    store = kf.empty_store(
        cfg.capacity.max_keyframes, cfg.capacity.max_keyframe_points
    )
    store = kf.add_keyframe(
        store,
        jnp.bool_(True),
        T0[:3, 3],
        se3.matrix_to_quat(T0[:3, :3]),
        kf_pts,
        kf_mask,
        kf_covs,
    )

    return OdomState(
        T=T0,
        T_s2s=T0,
        T_s2s_prev=T0,
        pose=T0[:3, 3],
        rotq=se3.matrix_to_quat(T0[:3, :3]),
        prev_points=p.points,
        prev_mask=p.mask,
        prev_covs=covs,
        store=store,
        spaciousness=p.spaciousness_median,
        keyframe_thresh_dist=jnp.float32(cfg.keyframe.thresh_dist),
        prev_rel=jnp.eye(4),
        scan_count=jnp.int32(1),
        hull_cv=jnp.zeros((cfg.capacity.max_keyframes,), bool),
        hull_cc=jnp.zeros((cfg.capacity.max_keyframes,), bool),
        hull_alpha=jnp.float32(-1.0),
        hull_dirty=jnp.bool_(True),
    )


@partial(jax.jit, static_argnames=("cfg", "axis_name", "pt_size"))
def step(
    cfg: DDLOConfig,
    state: OdomState,
    raw_points: jnp.ndarray,
    raw_mask: jnp.ndarray,
    hull_masks: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
    axis_name: str | None = None,
    pt_size: int = 1,
) -> Tuple[OdomState, OdomOutputs]:
    """One odometry step (plain DLO: dynamicDetection=false path of icpCB).

    The DDLO pipeline (pipeline.py) re-uses all of this and inserts
    segmentation between scan matching and the keyframe update.

    ``hull_masks``: optional (convex, concave) EXACT hull membership masks
    over keyframe slots from :func:`keyframes.exact_hull_masks` (host);
    without them the device approximations select the submap.

    ``axis_name``/``pt_size``: POINT-PARALLEL single-stream mode (under
    ``shard_map`` over a ``pt`` mesh axis with the scan replicated): each
    shard runs the GICP linearizations for a 1/pt_size slice of the
    preprocessed scan; the 6x6/6x1 normal equations and errors are
    psum'd inside every LM iteration (the collective analogue of the
    reference's per-thread OpenMP H/b partials,
    nano_gicp_impl.hpp:284-339), and the S2M residuals are all-gathered
    back to full length. The hot N_src x N_tgt NN sweeps drop
    pt_size-fold per device. The source covariances are the
    single-device ones, computed replicated on every shard (the Morton
    window needs whole blocks of the scan), so pt mode and one device
    differ only by the reduction order of the collectives.
    """
    # ---- preprocess + metrics (odom.cc:653-660) ----
    p = prep.preprocess(cfg, raw_points, raw_mask)
    spacious = 0.95 * state.spaciousness + 0.05 * p.spaciousness_median
    kf_thresh_d = prep.adaptive_keyframe_thresh(spacious)

    # ---- source covariances, shared by S2S and S2M (odom.cc:765) ----
    src_covs = covariance.plane_covariances(
        p.points, p.mask, k=cfg.gicp.s2s.k_correspondences,
        morton_ordered=cfg.preprocessing.voxel_scan.use,
    )
    src = (p.points, p.mask, src_covs)
    N = p.points.shape[0]
    if axis_name is not None:
        if N % pt_size != 0:
            raise ValueError(
                f"max_points={N} must be divisible by pt_size={pt_size}"
            )
        chunk = N // pt_size
        i0 = jax.lax.axis_index(axis_name) * chunk
        src = tuple(jax.lax.dynamic_slice_in_dim(x, i0, chunk) for x in src)

    # ---- scan-to-scan (odom.cc:754-762) ----
    # guess: identity like the reference, or the previous increment
    # (constant-velocity model) when cfg.initial_guess_motion
    s2s_guess = state.prev_rel if cfg.initial_guess_motion else jnp.eye(4)
    s2s = gicp.align(
        *src,
        state.prev_points,
        state.prev_mask,
        state.prev_covs,
        s2s_guess,
        # the reference never exports S2S residuals (only gicp_s2m feeds
        # the residual image, odom.cc:792-793) — skip the extra NN sweep
        _settings(cfg.gicp.s2s, compute_residuals=False),
        axis_name=axis_name,
    )
    T_s2s = se3.compose(state.T_s2s_prev, s2s.T)  # propagateS2S (odom.cc:921-939)

    # ---- submap selection + gather (odom.cc:775-784) ----
    alpha = state.keyframe_thresh_dist  # concave-hull alpha (odom.cc:1177)
    if hull_masks is not None:
        cv_mask, cc_mask = hull_masks
        hull_cache = (state.hull_cv, state.hull_cc, state.hull_alpha,
                      state.hull_dirty)
    else:
        # exact on-device hulls, recomputed only when their inputs
        # changed (see OdomState.hull_* — exact, not an approximation:
        # the store changes only on keyframe insertion and alpha is
        # piecewise constant). lax.cond makes unchanged-store scans skip
        # the O(K^3) sweeps entirely IN THE SINGLE-STREAM step; under
        # vmapped dp-mode (parallel/replay.py) JAX batching lowers cond
        # to select and BOTH branches run every scan (~0.6 ms x batch)
        # — acceptable there because batched pipeline streams are
        # throughput-bound anyway (SCALING_r05: pipeline batching is
        # ~0.9x; dp-mode's win is registration-style work).
        need = state.hull_dirty | (alpha != state.hull_alpha)

        def build(_):
            return (
                kf.convex_hull_mask(state.store.positions, state.store.valid),
                kf.concave_hull_mask(
                    state.store.positions, state.store.valid, alpha
                ),
            )

        cv_mask, cc_mask = jax.lax.cond(
            need, build, lambda _: (state.hull_cv, state.hull_cc), None
        )
        hull_cache = (cv_mask, cc_mask, alpha, jnp.bool_(False))
    sel = kf.select_submap(
        state.store,
        T_s2s[:3, 3],
        alpha,
        cfg.submap.knn,
        cfg.submap.kcv,
        cfg.submap.kcc,
        cv_mask=cv_mask,
        cc_mask=cc_mask,
    )
    max_slots = min(
        cfg.submap.knn + cfg.submap.kcv + cfg.submap.kcc,
        cfg.capacity.max_keyframes,
    )
    sub_pts, sub_mask, sub_covs = kf.gather_submap(
        state.store, sel, max_slots, capacity=cfg.capacity.max_submap_points
    )

    # ---- scan-to-submap with S2S as guess (odom.cc:787-793) ----
    s2m = gicp.align(
        *src,
        sub_pts,
        sub_mask,
        sub_covs,
        T_s2s,
        _settings(cfg.gicp.s2m),
        axis_name=axis_name,
    )
    T_new = s2m.T
    residuals = s2m.residuals
    if axis_name is not None:
        # shard-local residual slices -> full scan (feeds the residual
        # image projection downstream)
        residuals = jax.lax.all_gather(residuals, axis_name, tiled=True)
    pose = T_new[:3, 3]
    rotq = se3.matrix_to_quat(T_new[:3, :3])

    reg_world = se3.transform_points(T_new, p.points)
    reg_world = jnp.where(p.mask[:, None], reg_world, SENTINEL)

    new_state = OdomState(
        T=T_new,
        T_s2s=T_s2s,
        T_s2s_prev=T_new,  # odom.cc:845
        pose=pose,
        rotq=rotq,
        prev_points=p.points,  # swap: current becomes next S2S target
        prev_mask=p.mask,
        prev_covs=src_covs,
        store=state.store,
        spaciousness=spacious,
        keyframe_thresh_dist=kf_thresh_d,
        prev_rel=s2s.T,
        scan_count=state.scan_count + 1,
        hull_cv=hull_cache[0],
        hull_cc=hull_cache[1],
        hull_alpha=hull_cache[2],
        hull_dirty=hull_cache[3],
    )

    outputs = OdomOutputs(
        pose=pose,
        rotq=rotq,
        T=T_new,
        T_s2s_rel=s2s.T,
        reg_points_world=reg_world,
        reg_mask=p.mask,
        residuals=residuals,
        new_keyframe=jnp.bool_(False),  # filled by update_keyframes
        s2s_converged=s2s.converged,
        s2m_converged=s2m.converged,
        s2s_iterations=s2s.iterations,
        s2m_iterations=s2m.iterations,
        num_keyframes=state.store.count,
        submap_size=jnp.sum(sub_mask.astype(jnp.int32)),
    )
    return new_state, outputs


def gravity_align(
    accel_samples: "np.ndarray",
    imu_lidar_quat: Tuple[float, float, float, float] | None = None,
) -> "np.ndarray":
    """Initial gravity-aligned pose from buffered IMU accelerations
    (OdomNode::gravityAlign, odom.cc:534-597).

    The reference blocks until 1000 IMU messages, averages the linear
    accelerations, normalizes, and seeds the pose rotation with
    ``FromTwoVectors(mean_accel, +z) * imu_lidar_tf``. Host-side NumPy:
    this runs once at startup, outside the jitted scan loop.

    Args:
      accel_samples: (N, 3) linear accelerations (sensor at rest).
      imu_lidar_quat: optional [w, x, y, z] IMU->LiDAR extrinsic rotation
        (the fork hardcodes a -90 deg z rotation, odom.cc:575-580;
        default identity).

    Returns:
      (4, 4) float32 T0 with the gravity-aligned rotation, zero trans.
    """
    import numpy as np

    a = np.asarray(accel_samples, dtype=np.float64).mean(axis=0)
    n = np.linalg.norm(a)
    if n < 1e-9:
        return np.eye(4, dtype=np.float32)
    a = a / n
    g = np.array([0.0, 0.0, 1.0])
    # Eigen::Quaternion::FromTwoVectors(a, g)
    w = 1.0 + float(a @ g)
    if w < 1e-9:  # antiparallel: rotate pi about any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        q = np.concatenate([[0.0], axis / np.linalg.norm(axis)])
    else:
        xyz = np.cross(a, g)
        q = np.concatenate([[w], xyz])
        q = q / np.linalg.norm(q)
    if imu_lidar_quat is not None:
        qe = np.asarray(imu_lidar_quat, dtype=np.float64)
        q = np.asarray(
            se3.quat_mul(jnp.asarray(q), jnp.asarray(qe)), dtype=np.float64
        )
        q = q / np.linalg.norm(q)
    R = np.asarray(se3.quat_to_matrix(jnp.asarray(q)))
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    return T0


def keyframe_decision(
    cfg: DDLOConfig, state: OdomState, pose: jnp.ndarray, rotq: jnp.ndarray
) -> jnp.ndarray:
    """updateKeyframes decision logic (odom.cc:1067-1127)."""
    store = state.store
    d = jnp.linalg.norm(store.positions - pose, axis=1)
    d = jnp.where(store.valid, d, jnp.inf)
    thresh = state.keyframe_thresh_dist
    num_nearby = jnp.sum((d <= thresh * 1.5) & store.valid)
    closest = jnp.argmin(d)
    dd = d[closest]
    closest_q = store.quats[closest]
    dq = se3.quat_mul(rotq, se3.quat_conj(closest_q))
    theta_deg = se3.quat_angle_deg(dq)

    new_kf = (jnp.abs(dd) > thresh) | (jnp.abs(theta_deg) > cfg.keyframe.thresh_rot)
    new_kf = jnp.where(jnp.abs(dd) <= thresh, False, new_kf)
    new_kf = jnp.where(
        (jnp.abs(dd) <= thresh)
        & (jnp.abs(theta_deg) > cfg.keyframe.thresh_rot)
        & (num_nearby <= 1),
        True,
        new_kf,
    )
    return new_kf


@partial(jax.jit, static_argnames=("cfg", "refilter"))
def update_keyframes(
    cfg: DDLOConfig,
    state: OdomState,
    world_points: jnp.ndarray,
    world_mask: jnp.ndarray,
    refilter: bool = False,
) -> Tuple[OdomState, jnp.ndarray]:
    """Conditionally add the current (world-frame, dynamic-free) scan as a
    keyframe (odom.cc:1067-1154). Returns (state', added?).

    ``refilter``: the input is the RAW (H*W) dynamic-free segmentation
    cloud and the scan-resolution re-filter voxel pass (odom.cc:901-918)
    still needs to run. Doing it here — inside the keyframe ``lax.cond``
    — instead of unconditionally in pipeline.step saves the ~4 ms
    131k-point voxel pass on every scan that does NOT add a keyframe
    (its output has no other consumer; the map node voxelizes incoming
    keyframes at its own leaf size again anyway, map.cc:101-131)."""
    new_kf = keyframe_decision(cfg, state, state.pose, state.rotq)

    def add(store):
        pts_in, mask_in = world_points, world_mask
        if refilter and not (
            cfg.preprocessing.voxel_scan.use
            and cfg.preprocessing.voxel_submap.use
        ):
            # re-filter at scan resolution (odom.cc:901-918), conditionally
            if cfg.preprocessing.voxel_scan.use:
                pts_in, mask_in = filters.voxel_downsample(
                    pts_in, mask_in,
                    cfg.preprocessing.voxel_scan.res,
                    cfg.capacity.max_points,
                )
            else:
                pts_in, mask_in = filters.compact(
                    pts_in, mask_in, cfg.capacity.max_points
                )
        # When BOTH voxel passes are enabled, the scan-res re-filter
        # output feeds ONLY this submap-res voxel (round 4 moved the
        # re-filter here because it has no other consumer), so the two
        # sequential 131k voxel passes collapse into ONE direct pass at
        # submap res. Deviation from the reference's double filter
        # (odom.cc:901-918 then 1129-1154): per-0.5m-voxel centroids
        # are computed from raw points instead of scan-res centroids —
        # a sub-voxel weighting difference inside each submap cell,
        # certified trajectory-neutral end-to-end by ACCURACY_r05.json.
        # Saves a full 131k Morton sort + segment reduction per
        # keyframe insert (~2-4 ms on every add scan).
        if cfg.preprocessing.voxel_submap.use:
            pts, mask = filters.voxel_downsample(
                pts_in,
                mask_in,
                cfg.preprocessing.voxel_submap.res,
                cfg.capacity.max_keyframe_points,
            )
        else:
            pts, mask = filters.compact(
                pts_in, mask_in, cfg.capacity.max_keyframe_points
            )
        covs = covariance.plane_covariances(
            pts, mask, k=cfg.gicp.s2s.k_correspondences,
            morton_ordered=cfg.preprocessing.voxel_submap.use,
        )
        return kf.add_keyframe(
            store, jnp.bool_(True), state.pose, state.rotq, pts, mask, covs
        )

    store = jax.lax.cond(new_kf, add, lambda s: s, state.store)
    return (
        state._replace(store=store, hull_dirty=state.hull_dirty | new_kf),
        new_kf,
    )
