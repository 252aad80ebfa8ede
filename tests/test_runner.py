"""End-to-end replay driver + CLI tests: the node-graph equivalent
(odometry + map + trajectories over a synthetic sequence)."""

import dataclasses
import os

import numpy as np

from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry import runner
from dynamic_direct_lidar_odometry.io import dataset, pcd


def _small_cfg(H, W):
    cfg = cfg_lib.doals_config()
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection, rows=H, columns=W, ground_rows=4
        ),
        # the DOALS preset downsamples every 10th column of a 2048-wide
        # scan; at test resolution keep all columns and coarsen voxels
        preprocessing=dataclasses.replace(
            cfg.preprocessing,
            downsampling=dataclasses.replace(
                cfg.preprocessing.downsampling, row=1, col=1
            ),
            voxel_scan=dataclasses.replace(
                cfg.preprocessing.voxel_scan, res=0.4
            ),
            voxel_submap=dataclasses.replace(
                cfg.preprocessing.voxel_submap, res=0.5
            ),
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=2048,
            max_submap_points=8192,
            max_keyframes=16,
            max_keyframe_points=2048,
            max_objects=8,
            max_tracks=8,
            nn_chunk=512,
        ),
    )


def _seq(n=6, H=16, W=128, n_dynamic=1, seed=0):
    return dataset.synthetic_sequence(
        n_scans=n, H=H, W=W, n_dynamic=n_dynamic, seed=seed,
        angle_span=0.3,
    )


def test_replay_end_to_end(tmp_path):
    seq = _seq()
    cfg = _small_cfg(seq.H, seq.W)
    out = os.path.join(tmp_path, "run")
    res = runner.replay(cfg, seq, out_dir=out, map_capacity=50_000,
                        evaluate=True)
    assert len(res.poses) == len(seq) - 1
    assert np.all(np.isfinite(res.poses))
    # tracked the slow circular motion: monotone-ish progress, low drift
    ate = runner.ate_rmse(res.poses, seq.gt_poses)
    assert ate < 0.5, f"ATE {ate}"
    assert res.num_keyframes >= 1
    assert res.map_points > 0
    # artifacts written
    assert os.path.exists(os.path.join(out, "trajectory_tum.txt"))
    assert os.path.exists(os.path.join(out, "map.pcd"))
    pts, _ = pcd.load_pcd(os.path.join(out, "map.pcd"))
    assert len(pts) == res.map_points or len(pts) > 0
    arr = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
    assert arr.shape == (len(seq) - 1, 8)
    # evaluation dumps (reference detection.cpp:910-954 format):
    # timestamped session dir containing %04d.txt + poses.txt
    sessions = [
        d for d in os.listdir(out)
        if os.path.isdir(os.path.join(out, d)) and d[:2] == "20"
    ]
    assert len(sessions) == 1
    sess = os.path.join(out, sessions[0])
    assert os.path.exists(os.path.join(sess, "0001.txt"))
    with open(os.path.join(sess, "poses.txt")) as f:
        poses_txt = f.read()
    # one block per scan: nsec line + 4 matrix rows ending in ";"
    assert poses_txt.count(";") == len(seq) - 1
    assert res.profiler["total"].n == len(seq) - 1


def test_replay_device_hulls_matches_exact(tmp_path):
    """The bench.py headline mode — ``hulls="device"`` (exact on-device
    triple-sweep hulls, no host round trip) — end-to-end: it must track
    ground truth AND stay within noise of the ``hulls="exact"`` host
    path. The only legitimate divergence is hull-refresh staleness (the
    host masks are one scan late; the device sweeps are fresh)."""
    seq = _seq(n=8)
    cfg = _small_cfg(seq.H, seq.W)
    res_dev = runner.replay(cfg, seq, map_capacity=20_000, hulls="device")
    res_ex = runner.replay(cfg, seq, map_capacity=20_000, hulls="exact")
    assert len(res_dev.poses) == len(seq) - 1
    assert np.all(np.isfinite(res_dev.poses))
    ate_dev = runner.ate_rmse(res_dev.poses, seq.gt_poses)
    assert ate_dev < 0.5, f"device-hulls ATE {ate_dev}"
    d = res_dev.poses - res_ex.poses
    rmse = float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
    assert rmse < 5e-3, f"device vs exact hull trajectory RMSE {rmse}"


def test_replay_checkpoint_resume(tmp_path):
    seq = _seq(n=6)
    cfg = _small_cfg(seq.H, seq.W)
    out = os.path.join(tmp_path, "a")
    full = runner.replay(cfg, seq, out_dir=out, checkpoint_every=3,
                         map_capacity=20_000)
    ck = os.path.join(out, "ckpt_000003.npz")
    assert os.path.exists(ck)
    resumed = runner.replay(cfg, seq, out_dir=None, resume_from=ck,
                            map_capacity=20_000)
    # resumed run reproduces the tail poses of the full run
    np.testing.assert_allclose(
        resumed.poses, full.poses[-len(resumed.poses):], atol=1e-5
    )


def test_track_log_status_transitions(tmp_path):
    """tracks.jsonl (the offline publishBBoxes analogue,
    tracking.cpp:257-398) records every active track each frame, and a
    mover's UNDEFINED -> STATIC -> DYNAMIC transition appears in it."""
    import json

    seq = _seq(n=14)
    cfg = _small_cfg(seq.H, seq.W)
    # force a STATIC phase before DYNAMIC: promote UNDEFINED->STATIC
    # after 2 hits, and require ~5 scans of travel before the dynamic
    # gate (1.5 m/s mover, dt=0.1)
    cfg = dataclasses.replace(
        cfg,
        tracking=dataclasses.replace(
            cfg.tracking,
            max_undefined_hits=2,
            min_dynamic_hits=4,
            min_dist_from_origin=0.7,
            residuum_height_ratio=0.0,
        ),
    )
    out = os.path.join(tmp_path, "run")
    runner.replay(cfg, seq, out_dir=out, map_capacity=20_000)

    path = os.path.join(out, "tracks.jsonl")
    assert os.path.exists(path)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert recs, "no track records at all"
    for r in recs:
        assert {"scan", "stamp", "id", "status", "state", "velocity",
                "hits", "matched"} <= set(r)
        assert len(r["state"]) == 7 and len(r["velocity"]) == 3

    # per-id status history, in scan order
    hist = {}
    for r in recs:
        hist.setdefault(r["id"], []).append(r["status"])
    ranks = {"UNDEFINED": 0, "STATIC": 1, "DYNAMIC": 2}
    dyn_ids = [i for i, h in hist.items() if "DYNAMIC" in h]
    assert dyn_ids, f"no track turned DYNAMIC; histories: {hist}"
    full = [
        i for i in dyn_ids
        if {"UNDEFINED", "STATIC", "DYNAMIC"} <= set(hist[i])
    ]
    assert full, f"no UNDEFINED->STATIC->DYNAMIC track; histories: {hist}"
    for i in full:
        r = [ranks[s] for s in hist[i]]
        assert r == sorted(r), f"non-monotone status for id {i}: {hist[i]}"
        assert r[0] == 0, hist[i]


def test_nan_watchdog_rolls_back_pipelined_loop(monkeypatch):
    """A scan whose step produces a non-finite pose must be dropped along
    with the in-flight step built on it, and replay must continue from
    the last good state (failure-detection path of the pipelined loop)."""
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry import pipeline

    seq = _seq(n=8)
    cfg = _small_cfg(seq.H, seq.W)

    real_step = pipeline.step
    calls = {"n": 0}

    def poisoned_step(cfg_, state, pts, mask, ts, hull_masks=None, **kw):
        calls["n"] += 1
        state2, out = real_step(cfg_, state, pts, mask, ts, hull_masks, **kw)
        if calls["n"] == 3:  # poison the third processed scan
            bad_T = out.odom.T.at[0, 3].set(jnp.nan)
            out = out._replace(odom=out.odom._replace(T=bad_T))
        return state2, out

    monkeypatch.setattr(runner.pipeline, "step", poisoned_step)
    res = runner.replay(cfg, seq, out_dir=None, map_capacity=20_000)
    # only the poisoned scan is dropped; its in-flight successor was
    # re-dispatched against the restored state and kept
    assert res.dropped_scans == 1
    assert len(res.poses) == len(seq) - 1 - 1
    assert np.all(np.isfinite(res.poses))


def test_sequence_roundtrip(tmp_path):
    seq = _seq(n=3)
    path = os.path.join(tmp_path, "s.npz")
    seq.save(path)
    loaded = dataset.ScanSequence.load(path)
    assert len(loaded) == 3 and loaded.H == seq.H
    np.testing.assert_array_equal(loaded.mask, seq.mask)
    assert loaded.gt_poses is not None


def test_cli_synth_and_run(tmp_path):
    from dynamic_direct_lidar_odometry import cli

    path = os.path.join(tmp_path, "seq.npz")
    assert cli.main([
        "synth", "--scans", "4", "--rows", "16", "--cols", "128",
        "--dynamic", "1", "--out", path,
    ]) == 0
    out = os.path.join(tmp_path, "results")
    assert cli.main([
        "run", "--dataset", path, "--out", out, "--quiet", "--no-dynamic",
    ]) == 0
    assert os.path.exists(os.path.join(out, "trajectory_tum.txt"))


def test_ate_rmse_stamp_alignment_with_drops():
    rng = np.random.default_rng(0)
    S = 10
    gt = np.tile(np.eye(4), (S, 1, 1))
    gt[:, :3, 3] = rng.uniform(-5, 5, (S, 3))
    stamps = np.arange(S) * 0.1
    # estimates in the frame of gt[0] for scans 1..9 minus a dropped scan 4
    kept = [i for i in range(1, S) if i != 4]
    T0 = gt[0]
    est = np.array([
        (np.linalg.inv(T0) @ gt[i])[:3, 3] for i in kept
    ])
    ate = runner.ate_rmse(est, gt, est_stamps=stamps[kept], gt_stamps=stamps)
    assert ate < 1e-5, ate
