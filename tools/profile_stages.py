"""Per-stage device timing of the DDLO pipeline at bench scale.

Times each jitted stage in isolation (same shapes as bench.py) so perf
work targets the true hot spots. Mirrors the reference's AccumulatorData
stage taxonomy (SURVEY.md §5). Run on the GPU:

    python tools/profile_stages.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.utils import devtime


def timeit(name, fn, *args, n=10, **kw):
    try:
        _, out = devtime.timeit(fn, *args, n=n, label=name, **kw)
    except Exception as e:  # a stage OOM/compile failure shouldn't
        # kill the rest of the profile — report and move on
        msg = str(e).splitlines()
        print(f"{name:<44} FAILED: {msg[-1] if msg else e!r}"[:200])
        return None
    return out


def main():
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import pipeline
    from dynamic_direct_lidar_odometry.detection import detection
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry.odometry import (
        keyframes as kfmod,
        odometry,
        preprocess as prep,
    )
    from dynamic_direct_lidar_odometry.ops import covariance, filters, gicp
    from dynamic_direct_lidar_odometry.tracking import tracker

    devtime.enable_compile_cache()
    cfg = cfg_lib.bench_config()
    H, W = cfg.detection.rows, cfg.detection.columns
    print(f"devices: {jax.devices()}  scan {H}x{W}")

    # the shared bench/accuracy sequence, replayed to a POPULATED store
    # (>= 20 keyframes) so the S2M stage sees the steady-state submap the
    # headline bench sees, not a 1-keyframe toy
    seq = dataset.steady_state_sequence(n_scans=48)
    scans = [
        (jnp.asarray(seq.points[i]), jnp.asarray(seq.mask[i]))
        for i in range(len(seq))
    ]
    pts, mask = scans[-1]

    state = pipeline.init_state(cfg, scans[0][0], scans[0][1], 0.0)
    for i in range(1, len(scans) - 1):
        state, _ = pipeline.step(
            cfg, state, scans[i][0], scans[i][1], jnp.float32(0.1 * i)
        )
    n_kf = int(jnp.sum(state.odom.store.valid))
    print(f"advanced {len(scans) - 2} scans; active keyframes: {n_kf}")

    # full pipeline step
    st2, out = timeit(
        "pipeline.step (full)", pipeline.step, cfg, state, pts, mask,
        jnp.float32(0.1 * len(scans)), n=5,
    )

    # odometry step alone
    timeit("odometry.step", odometry.step, cfg, state.odom, pts, mask, n=5)

    # stages inside odometry.step
    p = prep.preprocess(cfg, pts, mask)
    jax.block_until_ready(p)
    timeit("preprocess", prep.preprocess, cfg, pts, mask)

    k = cfg.gicp.s2s.k_correspondences
    covs = timeit(
        "plane_covariances (scan, k=%d)" % k,
        covariance.plane_covariances, p.points, p.mask, k=k, n=5,
        morton_ordered=cfg.preprocessing.voxel_scan.use,
    )

    nn_impl = odometry._nn_impl_from_env()
    print(f"nn_impl: {nn_impl}")

    def s2s_settings():
        return gicp.GICPSettings(
            max_correspondence_distance=cfg.gicp.s2s.max_correspondence_distance,
            max_iterations=cfg.gicp.s2s.max_iterations,
            lm_max_iterations=cfg.gicp.s2s.lm_max_iterations,
            nn_impl=nn_impl,
        )

    s2s = timeit(
        "gicp.align S2S (16k vs 16k)",
        gicp.align, p.points, p.mask, covs,
        state.odom.prev_points, state.odom.prev_mask, state.odom.prev_covs,
        jnp.eye(4), s2s_settings(), n=5,
    )
    print(f"  s2s iterations: {int(s2s.iterations)}")

    sel = kfmod.select_submap(
        state.odom.store, state.odom.T[:3, 3],
        state.odom.keyframe_thresh_dist,
        cfg.submap.knn, cfg.submap.kcv, cfg.submap.kcc,
    )
    max_slots = min(
        cfg.submap.knn + cfg.submap.kcv + cfg.submap.kcc,
        cfg.capacity.max_keyframes,
    )
    timeit(
        "select_submap", kfmod.select_submap,
        state.odom.store, state.odom.T[:3, 3],
        state.odom.keyframe_thresh_dist,
        cfg.submap.knn, cfg.submap.kcv, cfg.submap.kcc,
    )
    # capacity= matches odometry.step:268 — the compacted 64k submap the
    # real S2M sweep sees, not the padded slots*kf_points buffer
    sub_pts, sub_mask, sub_covs = kfmod.gather_submap(
        state.odom.store, sel, max_slots,
        capacity=cfg.capacity.max_submap_points,
    )
    jax.block_until_ready(sub_pts)

    def s2m_settings():
        return gicp.GICPSettings(
            max_correspondence_distance=cfg.gicp.s2m.max_correspondence_distance,
            max_iterations=cfg.gicp.s2m.max_iterations,
            lm_max_iterations=cfg.gicp.s2m.lm_max_iterations,
            nn_impl=nn_impl,
        )

    s2m = timeit(
        "gicp.align S2M (16k vs 64k-cap)",
        gicp.align, p.points, p.mask, covs, sub_pts, sub_mask, sub_covs,
        jnp.eye(4), s2m_settings(), n=5,
    )
    print(f"  s2m iterations: {int(s2m.iterations)}")

    # single linearization cost (1 NN sweep + H/b)
    from dynamic_direct_lidar_odometry.ops import knn as knn_ops

    timeit("nn1 16k x 16k", knn_ops.nn1, p.points, state.odom.prev_points, n=10)
    timeit("nn1 16k x 64k", knn_ops.nn1, p.points, sub_pts, n=10)
    timeit(
        "knn k=%d 16k x 16k" % k, knn_ops.knn, p.points, p.points, k, n=5
    )

    # the Triton block-sparse 1-NN (the "sparse" backend on the GPU),
    # chunk-list building included, and the Morton-window covariances
    from dynamic_direct_lidar_odometry.ops import nn_pallas

    for name, tgt, r in [
        ("16k x 16k", state.odom.prev_points, cfg.gicp.s2s.max_correspondence_distance),
        ("16k x 64k", sub_pts, cfg.gicp.s2m.max_correspondence_distance),
    ]:
        timeit(
            "nn1_sparse_pallas %s (r=%.0f)" % (name, r),
            nn_pallas.nn1_sparse_pallas, p.points, tgt, radius=r, n=10,
        )
    timeit(
        "window covariances k=%d 16k" % k,
        jax.jit(covariance._window_self_covariances, static_argnums=1),
        p.points, k, n=10,
    )

    # detection + tracking
    seg_world = jnp.where(mask[:, None], pts, 1.0e6)
    det = timeit(
        "detection.detect", detection.detect, cfg, seg_world, mask,
        p.points, p.mask, s2m.residuals, state.odom.T, n=5,
    )
    timeit(
        "tracker.update", tracker.update, cfg.tracking, state.tracks,
        det.objects, jnp.float32(0.1), n=10,
    )

    # keyframe update (incl covariance under cond)
    timeit(
        "update_keyframes", odometry.update_keyframes, cfg, st2.odom,
        out.new_keyframe_points, out.new_keyframe_mask, n=5,
    )

    timeit(
        "voxel_downsample 128k->16k", filters.voxel_downsample,
        seg_world, mask, cfg.preprocessing.voxel_scan.res,
        cfg.capacity.max_points, n=5,
    )


if __name__ == "__main__":
    main()
