"""Offline replay driver: the launch-file + node-graph equivalent.

What ``launch/ddlo.launch`` wires out of three ROS processes
(``ddlo_odom_node``, ``ddlo_map_node``, ``trajectories_server`` —
SURVEY.md §1) becomes one host loop around the jitted pipeline
transition:

  per scan:  state', out = pipeline.step(cfg, state, scan)     [device]
             map    += keyframe        (if out.keyframe_added) [device]
             map    -= clear_map boxes (tracker feedback)      [device]
             pose row -> PoseRecorder, bboxes -> ObjectTrajectories [host]

Host bookkeeping is applied ONE SCAN LATE: scan ``i``'s step is
dispatched (asynchronously) first, then scan ``i-1``'s host-side reads
block while scan ``i`` computes on device. This is the device equivalent of
the reference's detached publish/metrics threads (odom.cc:718-726) — the
device never idles waiting for host bookkeeping, and the host never
blocks the next dispatch.

Aux subsystems the reference exposes are all here: per-stage profiling
(odom.cc:189-192), reference-format evaluation dumps (timestamped dir +
cfg.yaml + %04d.txt indices + poses.txt, detection.cpp:910-954),
checkpoint/resume (new), and end-of-run map save via the save_pcd
equivalent (map.cc:158-189).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.io import pcd as pcd_io
from dynamic_direct_lidar_odometry.io.dataset import ScanSequence
from dynamic_direct_lidar_odometry.mapping import mapper
from dynamic_direct_lidar_odometry.odometry import keyframes
from dynamic_direct_lidar_odometry.tracking.tracker import DYNAMIC
from dynamic_direct_lidar_odometry.utils import checkpoint as ckpt
from dynamic_direct_lidar_odometry.utils import evaldump
from dynamic_direct_lidar_odometry.utils import profiling, trajectory


@dataclasses.dataclass
class ReplayResult:
    poses: np.ndarray  # (S, 3)
    quats: np.ndarray  # (S, 4) wxyz
    stamps: np.ndarray  # (S,)
    num_keyframes: int
    map_points: int
    dropped_scans: int
    profiler: profiling.Profiler
    pose_recorder: trajectory.PoseRecorder
    object_trajectories: trajectory.ObjectTrajectories
    dynamic_counts: np.ndarray  # (S,) dynamic pixels per scan
    final_state: pipeline.DDLOState
    map_state: mapper.MapState
    keyframe_overflow: int = 0  # keyframes accepted past store capacity


def replay(
    cfg: DDLOConfig,
    seq: ScanSequence,
    out_dir: Optional[str] = None,
    map_capacity: int = 500_000,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    evaluate: bool = False,
    progress: bool = False,
    dashboard_every: int = 0,
    viz_every: int = 0,
    save_every: int = 0,
    export_clouds_every: int = 0,
    hulls: str = "exact",
) -> ReplayResult:
    """Run the full DDLO node graph over a scan sequence.

    Mid-run artifact surface (the reference's services + rviz topics,
    which fire at ANY time during a run — map.cc:44,
    trajectories_server.cpp:24-25, odom.cc:43-52):

    - ``save_every=N``: every N scans, snapshot the map + trajectories
      into ``out_dir`` tagged with the scan index (periodic ``save_pcd``
      / ``save_trajectories``).
    - ``SIGUSR1``: requests the same snapshot on demand at the next scan
      (``kill -USR1 <pid>`` replaces the ROS service call).
    - ``export_clouds_every=N``: every N scans, export the per-stage
      intermediate clouds (S2M residual cloud with residual intensity,
      dynamic-free static cloud, keyframe positions) as PCDs under
      ``out_dir/clouds/`` — the offline analogue of the reference's
      per-stage rviz topics (odom.cc:43-52, gated on subscribers there,
      on the export period here).
    - ``out_dir/tracks.jsonl``: one JSON line per ACTIVE track per scan
      (scan idx, stamp, id, status, 7-d state, velocity, hits, matched)
      — the offline analogue of ``publishBBoxes``'s per-frame
      status-namespaced bbox + label topics (tracking.cpp:257-398), so
      status transitions / ghost tracks / identity churn are
      inspectable without a debugger.
    """
    # config-driven evaluation dumps (odomNode/evaluation/*, the YAML way
    # of enabling what the `evaluate` kwarg enables)
    if cfg.evaluate:
        evaluate = True
        if not out_dir and cfg.evaluation_dir:
            out_dir = cfg.evaluation_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    eval_dump = None
    if evaluate and out_dir:
        # reference-format dump session: timestamped dir + cfg.yaml copy
        # (detection.cpp:911-934)
        eval_dump = evaldump.EvalDump(
            out_dir, cfg.evaluation_cfg_path or None
        )

    prof = profiling.Profiler()
    pose_rec = trajectory.PoseRecorder()
    obj_trajs = trajectory.ObjectTrajectories()
    track_log = (
        open(os.path.join(out_dir, "tracks.jsonl"), "w")
        if out_dir and cfg.dynamic_detection
        else None
    )

    pts0 = jnp.asarray(seq.points[0])
    msk0 = jnp.asarray(seq.mask[0])
    # gravity alignment (initializeDDLO -> gravityAlign, odom.cc:599-612):
    # seed the pose rotation from buffered IMU accelerations when enabled
    T0 = None
    if cfg.gravity_align and seq.imu_accel is not None:
        from dynamic_direct_lidar_odometry.odometry import odometry

        T0 = jnp.asarray(odometry.gravity_align(seq.imu_accel))
    state = pipeline.init_state(cfg, pts0, msk0, float(seq.stamps[0]), T0=T0)
    map_state = mapper.empty_map(map_capacity)
    # the first keyframe (created by init, odom.cc:480-516) reaches the
    # map node like every other keyframe (map.cc:101-131)
    map_state = mapper.add_keyframe(
        map_state,
        state.odom.store.points[0],
        state.odom.store.masks[0],
        cfg.map.leaf_size,
        use_voxel_filter=cfg.map.use_voxel_filter,
    )
    start = 1

    if resume_from:
        (state, map_state), meta = ckpt.restore(
            resume_from, (state, map_state)
        )
        start = int(meta.get("next_scan", 1))

    poses, quats, dyn_counts, stamps_kept = [], [], [], []
    dropped = 0
    n_scans = len(seq)

    # EXACT keyframe hull memberships, computed host-side (qhull + alpha
    # shape over <= max_keyframes positions — the reference recomputes
    # pcl hulls every scan, odom.cc:993-1065). Recomputed in finalize()
    # so the ~0.1 ms of host geometry overlaps device compute; the masks
    # feeding scan i are from scan i-2's keyframe store (hull sets only
    # change on keyframe insertion, and a just-inserted keyframe is
    # always in the knn-nearest set anyway).
    # ``hulls="device"`` skips the host round trip entirely and lets
    # odometry.step compute the exact triple-sweep hulls on device
    # (keyframes.convex_hull_mask / concave_hull_mask) — the fully
    # device-resident mode and the bench default, with no host pack+fetch
    # in the loop.
    def host_hulls(st) -> tuple | None:
        if hulls == "device":
            return None
        cv, cc = keyframes.exact_hull_masks_packed(
            keyframes.packed_hull_inputs(
                st.odom.store, st.odom.keyframe_thresh_dist
            )
        )
        return (jnp.asarray(cv), jnp.asarray(cc))

    hull_masks = host_hulls(state)

    # on-demand snapshot flag, set by SIGUSR1 (the save_pcd /
    # save_trajectories service surface) and consumed at the next finalize
    save_requested = {"flag": False}
    prev_usr1 = None
    if out_dir:
        import signal

        def _on_usr1(signum, frame):
            save_requested["flag"] = True

        try:
            prev_usr1 = signal.signal(signal.SIGUSR1, _on_usr1)
        except ValueError:  # not on the main thread: signals unavailable
            prev_usr1 = None

    def save_snapshot(tag: str) -> None:
        """Map + trajectory snapshot (save_pcd service, map.cc:158-189;
        save_trajectories, trajectories_server.cpp:83-124)."""
        snap_pts, snap_mask = mapper.snapshot(
            map_state, cfg.map.leaf_size, map_capacity
        )
        pcd_io.save_pcd(
            os.path.join(out_dir, f"map_{tag}.pcd"),
            np.asarray(snap_pts), np.asarray(snap_mask),
        )
        pose_rec.save(os.path.join(out_dir, f"trajectory_tum_{tag}.txt"))
        obj_trajs.save(os.path.join(out_dir, f"object_traj_{tag}"))

    def finalize(p) -> bool:
        """Host + map bookkeeping for an already-dispatched scan. The
        blocking device reads here overlap with the NEXT scan's compute.
        Returns False if the scan's pose went non-finite (caller rolls
        back)."""
        nonlocal map_state, dropped, hull_masks
        i, out, st = p["i"], p["out"], p["state"]

        # NaN watchdog (new vs the reference, which has no failure
        # detection, SURVEY.md §5): a non-finite pose would poison every
        # later scan — roll back to the last good state
        T_np = np.asarray(out.odom.T)
        if not np.all(np.isfinite(T_np)):
            return False

        # refresh exact hull masks (blocks on st, which finished when this
        # scan's step did — overlapped with the in-flight next scan)
        hull_masks = host_hulls(st)

        # ---- map node feedback loop (map.cc:101-156) ----
        if bool(np.asarray(out.keyframe_added)):
            map_state = mapper.add_keyframe(
                map_state,
                out.new_keyframe_points,
                out.new_keyframe_mask,
                cfg.map.leaf_size,
                use_voxel_filter=cfg.map.use_voxel_filter,
            )
        if cfg.map.filter_bbox_history:
            cm_valid = np.asarray(out.tracks.clear_map_valid)
            if cm_valid.any():
                map_state = mapper.remove_boxes(
                    map_state,
                    out.tracks.clear_map_boxes,
                    out.tracks.clear_map_valid,
                    margin=cfg.map.filter_margin,
                )

        # ---- host-side recording ----
        pose = np.asarray(out.odom.pose)
        quat = np.asarray(out.odom.rotq)
        poses.append(pose)
        quats.append(quat)
        stamps_kept.append(p["stamp"])
        pose_rec.append(p["stamp"], pose, quat)
        trk = st.tracks
        obj_trajs.update(
            trk.filter_id,
            trk.obj_state,
            np.asarray(trk.active) & (np.asarray(trk.status) == DYNAMIC),
            p["stamp"],
        )
        if track_log is not None:
            # per-frame all-status track export (publishBBoxes,
            # tracking.cpp:257-398: UNDEFINED/STATIC/DYNAMIC namespaces
            # with id + velocity labels)
            import json

            active = np.asarray(trk.active)
            if active.any():
                ids = np.asarray(trk.filter_id)
                status = np.asarray(trk.status)
                x = np.asarray(trk.x)
                hits = np.asarray(trk.hits)
                det_slot = np.asarray(trk.det_slot)
                names = ("UNDEFINED", "STATIC", "DYNAMIC")
                for s in np.nonzero(active)[0]:
                    track_log.write(json.dumps({
                        "scan": i,
                        "stamp": p["stamp"],
                        "id": int(ids[s]),
                        "status": names[int(status[s])],
                        "state": [round(float(v), 4) for v in x[s, :7]],
                        "velocity": [
                            round(float(v), 4) for v in x[s, 7:10]
                        ],
                        "hits": int(hits[s]),
                        "matched": bool(det_slot[s] >= 0),
                    }) + "\n")
        dyn_np = np.asarray(out.dynamic_mask)
        n_dyn = int(dyn_np.sum())
        dyn_counts.append(n_dyn)

        if viz_every and out_dir and i % viz_every == 0:
            # DetectionModule::visualize (detection.cpp:834-909) as PNGs
            from dynamic_direct_lidar_odometry.utils import viz

            viz.save_debug_images(
                os.path.join(out_dir, "images"),
                i,
                np.asarray(out.detections.range_image),
                np.asarray(out.detections.residual_image),
                np.asarray(out.detections.labels),
                dilate_kernel_size=cfg.detection.dilate_kernel_size,
            )

        if eval_dump is not None:
            # reference evaluation dump (detection.cpp:936-952):
            # %04d.txt dynamic indices + poses.txt nsec/4x4 append
            eval_dump.frame(i, np.nonzero(dyn_np)[0], p["stamp"], T_np)

        if out_dir and export_clouds_every and i % export_clouds_every == 0:
            # per-stage intermediate clouds (rviz-topic analogue,
            # odom.cc:43-52): S2M residual cloud, static cloud, keyframes
            cdir = os.path.join(out_dir, "clouds")
            os.makedirs(cdir, exist_ok=True)
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_residuals.pcd"),
                np.asarray(out.odom.reg_points_world),
                np.asarray(out.odom.reg_mask),
                intensity=np.asarray(out.odom.residuals),
            )
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_static.pcd"),
                np.asarray(out.static_points),
                np.asarray(out.static_mask),
            )
            pcd_io.save_pcd(
                os.path.join(cdir, f"{i:05d}_keyframes.pcd"),
                np.asarray(st.odom.store.positions),
                np.asarray(st.odom.store.valid),
            )

        if out_dir and (
            save_requested["flag"] or (save_every and i % save_every == 0)
        ):
            save_requested["flag"] = False
            save_snapshot(f"{i:05d}")

        if checkpoint_every and out_dir and i % checkpoint_every == 0:
            ckpt.save(
                os.path.join(out_dir, f"ckpt_{i:06d}.npz"),
                (st, map_state),
                meta={"next_scan": i + 1},
            )

        if progress:
            print(
                f"scan {i}/{n_scans - 1} pose=({pose[0]:+.2f}, "
                f"{pose[1]:+.2f}, {pose[2]:+.2f}) dyn_px={n_dyn}"
            )
        if dashboard_every and i % dashboard_every == 0:
            print(
                debug_dashboard(
                    prof, i, n_scans, pose, quat,
                    int(np.asarray(st.odom.store.valid).sum()),
                    int(mapper.num_points(map_state)),
                    int(np.asarray(st.tracks.active).sum()),
                    n_dyn,
                )
            )
        return True

    pending = None  # scan whose bookkeeping is deferred one iteration
    last_t = None
    staged = None  # (idx, pts, msk): next scan's device arrays, uploaded
    # one scan ahead so the host->device copy overlaps the in-flight
    # step's compute (the prefetching input pipeline bench.py models by
    # staging its timed window up-front; 1.7 MB/scan)
    for i in range(start, n_scans):
        # low-return scan drop (odom.cc:635-639: "Low number of points!")
        if int(seq.mask[i].sum()) < cfg.gicp.min_num_points:
            dropped += 1
            continue
        if staged is not None and staged[0] == i:
            pts, msk = staged[1], staged[2]
        else:
            pts = jnp.asarray(seq.points[i])
            msk = jnp.asarray(seq.mask[i])
        staged = None
        ts = jnp.float32(seq.stamps[i])

        # per-scan wall time, dispatch-to-dispatch: in the pipelined loop
        # this covers device compute + overlapped host bookkeeping — the
        # honest per-scan cost (reference's "total" accumulator,
        # odom.cc:617-618,715)
        now = time.perf_counter()
        if last_t is not None:
            prof["total"].add((now - last_t) * 1e3)
        last_t = now

        prev_state = state
        with profiling.jax_annotation("total"):
            state, out = pipeline.step(
                cfg, state, pts, msk, ts, hull_masks
            )

        if pending is not None and not finalize(pending):
            # pending scan's pose was non-finite: restore the state from
            # before it, discard the in-flight step built on the bad
            # state, and RE-dispatch this scan against the restored state
            # (its raw data is fine — only the poisoned scan is dropped)
            state = pending["prev_state"]
            dropped += 1
            pending = None
            last_t = None
            prev_state = state
            with profiling.jax_annotation("total"):
                state, out = pipeline.step(
                    cfg, state, pts, msk, ts, hull_masks
                )
        # stage the next scan's upload behind the just-dispatched step
        if i + 1 < n_scans and int(seq.mask[i + 1].sum()) >= cfg.gicp.min_num_points:
            staged = (
                i + 1,
                jnp.asarray(seq.points[i + 1]),
                jnp.asarray(seq.mask[i + 1]),
            )
        pending = {
            "i": i, "out": out, "state": state,
            "prev_state": prev_state, "stamp": float(seq.stamps[i]),
        }
    if pending is not None:
        if not finalize(pending):
            state = pending["prev_state"]
            dropped += 1
        if last_t is not None:
            prof["total"].add((time.perf_counter() - last_t) * 1e3)

    if prev_usr1 is not None:
        import signal

        signal.signal(signal.SIGUSR1, prev_usr1)
    if track_log is not None:
        track_log.close()

    # keyframe-store saturation telemetry (at capacity the store evicts
    # the farthest non-hull keyframe per insert — keyframes.add_keyframe)
    kf_overflow = int(np.asarray(keyframes.overflow_count(state.odom.store)))
    if kf_overflow > 0:
        print(
            f"[ddlo] WARNING: keyframe store saturated — {kf_overflow} "
            "inserts evicted the farthest non-hull keyframe; raise "
            "capacity.max_keyframes if full-sweep coverage is needed",
            file=sys.stderr,
        )

    if out_dir:
        pose_rec.save(os.path.join(out_dir, "trajectory_tum.txt"))
        obj_trajs.save(os.path.join(out_dir, "object_traj"))
        snap_pts, snap_mask = mapper.snapshot(
            map_state, cfg.map.leaf_size, map_capacity
        )
        pcd_io.save_pcd(
            os.path.join(out_dir, "map.pcd"),
            np.asarray(snap_pts), np.asarray(snap_mask),
        )

    return ReplayResult(
        poses=np.stack(poses) if poses else np.zeros((0, 3)),
        quats=np.stack(quats) if quats else np.zeros((0, 4)),
        stamps=np.asarray(stamps_kept),
        num_keyframes=int(jnp.sum(state.odom.store.valid)),
        map_points=int(mapper.num_points(map_state)),
        dropped_scans=dropped,
        profiler=prof,
        pose_recorder=pose_rec,
        object_trajectories=obj_trajs,
        dynamic_counts=np.asarray(dyn_counts),
        final_state=state,
        map_state=map_state,
        keyframe_overflow=kf_overflow,
    )


def _cpu_stats() -> tuple:
    """Process CPU utilization since the previous call, plus core
    count/model — the reference dashboard's CPU block (odom.cc:1430-1458,
    via times()/cpuid there)."""
    t = os.times()
    cpu = t.user + t.system
    now = time.monotonic()
    prev = getattr(_cpu_stats, "_prev", None)
    _cpu_stats._prev = (cpu, now)
    pct = 0.0
    if prev is not None and now > prev[1]:
        pct = 100.0 * (cpu - prev[0]) / (now - prev[1])
    model = getattr(_cpu_stats, "_model", None)
    if model is None:
        model = "unknown cpu"
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("model name"):
                        model = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        _cpu_stats._model = model
    return pct, os.cpu_count() or 1, model


def debug_dashboard(
    prof: profiling.Profiler,
    scan_idx: int,
    n_scans: int,
    pose: np.ndarray,
    quat: np.ndarray,
    num_keyframes: int,
    map_points: int,
    active_tracks: int,
    dynamic_pixels: int,
) -> str:
    """Console dashboard (OdomNode::debug, odom.cc:1317-1461): pose,
    store sizes, host memory, and the per-stage timing table."""
    rss_mb = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_mb = float(line.split()[1]) / 1024.0
                    break
    except OSError:
        pass
    kind = jax.devices()[0].device_kind
    lines = [
        "+" + "-" * 62 + "+",
        "| DDLO (%.14s)  scan %6d / %-6d   RSS %8.1f MB"
        % (kind, scan_idx, n_scans - 1, rss_mb),
        "| pose  xyz (%+8.3f, %+8.3f, %+8.3f) m                |"
        % (pose[0], pose[1], pose[2]),
        "| quat wxyz (%+.3f, %+.3f, %+.3f, %+.3f)                   |"
        % (quat[0], quat[1], quat[2], quat[3]),
        "| keyframes %5d   map %9d pts   tracks %3d   dyn px %5d"
        % (num_keyframes, map_points, active_tracks, dynamic_pixels),
        "| host cpu %5.1f %% of %d cores (%.28s)"
        % _cpu_stats(),
        "+" + "-" * 62 + "+",
        prof.dashboard(),
    ]
    return "\n".join(lines)


def ate_rmse(
    est_positions: np.ndarray,
    gt_poses: np.ndarray,
    est_stamps: Optional[np.ndarray] = None,
    gt_stamps: Optional[np.ndarray] = None,
) -> float:
    """Absolute trajectory error (RMSE) — the evo-style metric the
    reference's TUM dumps feed (odom.cc:704-709).

    The estimated trajectory lives in the frame of the first scan (the
    replay seeds ``T0 = I``); ground truth is world-frame. Without
    stamps, ``est[i]`` corresponds to ``gt_poses[i + off]`` with
    ``off = len(gt) - len(est)``; with both stamp arrays (robust when the
    replay dropped scans mid-sequence), estimates pair with the
    nearest-stamp ground-truth pose. The reference frame is the init
    scan's ground-truth pose.
    """
    est = np.asarray(est_positions)
    if est_stamps is not None and gt_stamps is not None:
        gt_stamps = np.asarray(gt_stamps)
        idx = np.abs(
            gt_stamps[None, :] - np.asarray(est_stamps)[:, None]
        ).argmin(axis=1)
        T0 = gt_poses[max(int(idx.min()) - 1, 0)]
        gt = gt_poses[idx, :3, 3]
    else:
        off = len(gt_poses) - len(est)
        T0 = gt_poses[max(off - 1, 0)]
        gt = gt_poses[off:, :3, 3]
    est_w = est @ T0[:3, :3].T + T0[:3, 3]
    err = est_w - gt
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))
