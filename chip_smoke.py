#!/usr/bin/env python3
"""Smoke test of the DDLO pipeline on an NVIDIA GPU.

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: the two multi-card paths

One process; the phases run in order and the first failure ends the run
with a non-zero exit code. With one card:

  device    require a CUDA device; print the card's name and power limit
  compile   lower + compile pipeline.step_chunk at bench width (64x2048
            scans, 16k registration points, 64k submap), print its
            memory analysis, and require the block-sparse 1-NN kernel's
            Triton call in the compiled program
  kernel    the compiled kernel vs the exact sweep knn.nn1 on
            Morton-ordered voxel clouds at 16k x 16k (S2S) and 16k x 64k
            (S2M): equal indices inside the gate, sqdist to 1e-5 m^2;
            median times of both, and of the two covariance
            neighbourhood paths
  pipeline  runner.replay over 24 bench-width scans: ATE vs ground
            truth < 5 cm; a scans/s smoke figure (not a benchmark)
  cli       ``cli synth`` + ``cli run`` at 64x2048; trajectory and map
            files written

With ``--four``: replay_batch on a dp=4 mesh (4 streams x 8 scans) and
point_parallel_pipeline_step at pt=4, each against the same streams on
one card, to 1e-3 m.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dynamic_direct_lidar_odometry import cli, pipeline, runner  # noqa: E402
from dynamic_direct_lidar_odometry import config as cfg_lib  # noqa: E402
from dynamic_direct_lidar_odometry.core import se3  # noqa: E402
from dynamic_direct_lidar_odometry.core.cloud import SENTINEL  # noqa: E402
from dynamic_direct_lidar_odometry.io import dataset  # noqa: E402
from dynamic_direct_lidar_odometry.odometry import preprocess  # noqa: E402
from dynamic_direct_lidar_odometry.ops import covariance, filters, knn, nn_pallas  # noqa: E402
from dynamic_direct_lidar_odometry.parallel import replay, sharding  # noqa: E402
from dynamic_direct_lidar_odometry.utils import devtime  # noqa: E402

KERNEL_NAME = "ddlo_nn1_sparse"
ATE_BAR_M = 0.05
MULTI_CARD_TOL_M = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def check_device(n_required: int) -> str:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < n_required:
        raise SystemExit(f"need {n_required} GPUs, found {len(devs)}")
    card = card_line()
    log(f"[device] {devs[0].device_kind} x{len(devs)}; nvidia-smi: {card}")
    return card


def median_ms(fn, *args, n: int = 25) -> float:
    devtime.sync(fn(*args))  # compile + warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        devtime.sync(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# ---------------------------------------------------------------- compile


def check_compile(cfg, seq, K: int = 8) -> None:
    state = pipeline.init_state(
        cfg, jnp.asarray(seq.points[0]), jnp.asarray(seq.mask[0]), 0.0
    )
    args = (
        jnp.asarray(seq.points[1 : 1 + K]),
        jnp.asarray(seq.mask[1 : 1 + K]),
        jnp.asarray(seq.stamps[1 : 1 + K], dtype=jnp.float32),
        None,
    )
    t0 = time.perf_counter()
    compiled = pipeline.step_chunk.trace(cfg, state, *args).lower().compile()
    log(f"[compile] step_chunk K={K} compiled in {time.perf_counter() - t0:.1f} s")
    log(f"[compile] memory_analysis: {compiled.memory_analysis()}")
    n_calls = compiled.as_text().count(KERNEL_NAME)
    log(f"[compile] {KERNEL_NAME} occurrences in the compiled step: {n_calls}")
    if n_calls == 0:
        raise RuntimeError("compiled step has no Triton 1-NN call (XLA fallback)")


# ----------------------------------------------------------------- kernel


def morton_clouds(cfg, seq):
    """S2S and S2M inputs as the pipeline makes them: the voxelized
    (Morton-ordered) middle scan i, moved by ground truth onto scan i-1 (S2S) and
    into the world (S2M), and a 64k world submap voxelized from every
    scan of the sequence."""
    pre = jax.jit(partial(preprocess.preprocess, cfg))
    scans = [pre(jnp.asarray(p), jnp.asarray(m)) for p, m, _ in seq]
    gt = jnp.asarray(seq.gt_poses, jnp.float32)
    i = len(scans) // 2

    def moved(T, s):
        return jnp.where(s.mask[:, None], se3.transform_points(T, s.points), SENTINEL)

    rel = jnp.linalg.inv(gt[i - 1]) @ gt[i]
    s2s = (moved(rel, scans[i]), scans[i - 1].points)
    world = jnp.concatenate([moved(gt[j], s) for j, s in enumerate(scans)])
    wmask = jnp.concatenate([s.mask for s in scans])
    sub, _ = filters.voxel_downsample(
        world, wmask, cfg.preprocessing.voxel_submap.res,
        cfg.capacity.max_submap_points,
    )
    s2m = (moved(gt[i], scans[i]), sub)
    return s2s, s2m, scans[i]


def compare_nn(name: str, q, t, r: float, card: str) -> None:
    kern = jax.jit(partial(nn_pallas.nn1_sparse_pallas, radius=r))
    i1, d1 = (np.asarray(x) for x in kern(q, t))
    i0, d0 = (np.asarray(x) for x in knn.nn1(q, t))
    real = np.asarray(q[:, 0]) < 0.5 * SENTINEL
    gate = real & (d0 < r * r)
    differ = gate & (i0 != i1)
    err = float(np.max(np.abs(d1 - d0)[gate])) if gate.any() else 0.0
    log(
        f"[kernel] {name} {q.shape[0]}x{t.shape[0]} r={r}: {gate.sum()} gated-in "
        f"queries, {differ.sum()} index ties, max |dsq| {err:.3g} m^2, "
        f"min gated-out dsq {float(np.min(d1[real & ~gate], initial=np.inf)):.3g}"
    )
    if err > 1e-5:
        raise RuntimeError(f"{name}: sqdist differs by {err} m^2 inside the gate")
    if not np.all(d1[real & ~gate] >= r * r):
        raise RuntimeError(f"{name}: a gated-out query reports a distance < r^2")
    if gate.sum() < 0.5 * real.sum():
        raise RuntimeError(f"{name}: only {gate.sum()} of {real.sum()} queries in gate")
    t_k = median_ms(kern, q, t)
    t_x = median_ms(knn.nn1, q, t)
    log(
        f"[kernel] {name} median of 25: triton sparse {t_k:.3f} ms (chunk lists "
        f"included), knn.nn1 {t_x:.3f} ms  [{card}]"
    )


def check_kernel(cfg, seq, card: str) -> None:
    s2s, s2m, scan = morton_clouds(cfg, seq)
    r_s2s = cfg.gicp.s2s.max_correspondence_distance
    r_s2m = cfg.gicp.s2m.max_correspondence_distance
    compare_nn("S2S", *s2s, r_s2s, card)
    compare_nn("S2M", *s2m, r_s2m, card)
    k = cfg.gicp.s2m.k_correspondences
    window = jax.jit(lambda p: covariance._window_self_covariances(p, k))
    exact = jax.jit(lambda p: knn.knn(p, p, k))
    log(
        f"[kernel] covariance neighbourhoods k={k} at {scan.points.shape[0]}: "
        f"Morton window {median_ms(window, scan.points):.3f} ms, exact knn.knn "
        f"{median_ms(exact, scan.points):.3f} ms  [{card}]"
    )


# --------------------------------------------------------------- pipeline


def check_pipeline(cfg, seq, card: str) -> None:
    t0 = time.perf_counter()
    res = runner.replay(cfg, seq, hulls="device")
    t_first = time.perf_counter() - t0
    ate = runner.ate_rmse(
        res.poses, seq.gt_poses, est_stamps=res.stamps, gt_stamps=seq.stamps
    )
    log(
        f"[pipeline] replay of {len(res.poses)} scans ({t_first:.1f} s incl. "
        f"compile): ATE {ate * 100:.3f} cm vs ground truth, "
        f"{res.num_keyframes} keyframes"
    )
    if not ate < ATE_BAR_M:
        raise RuntimeError(f"ATE {ate} m is not below {ATE_BAR_M} m")
    t0 = time.perf_counter()
    res = runner.replay(cfg, seq, hulls="device")
    rate = len(res.poses) / (time.perf_counter() - t0)
    log(
        f"[pipeline] smoke figure, not a benchmark: {rate:.2f} scans/s "
        f"(second replay, host loop included)  [{card}]"
    )


# -------------------------------------------------------------------- cli


def check_cli(rows: int = 64, cols: int = 2048) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "seq.npz")
        out = os.path.join(tmp, "out")
        rc = cli.main([
            "synth", "--rows", str(rows), "--cols", str(cols), "--scans", "6",
            "--out", npz,
        ])
        if rc != 0:
            raise RuntimeError(f"cli synth returned {rc}")
        rc = cli.main(["run", "--dataset", npz, "--out", out, "--quiet"])
        if rc != 0:
            raise RuntimeError(f"cli run returned {rc}")
        written = sorted(os.listdir(out))
        log(f"[cli] run wrote {written}")
        for name in ("trajectory_tum.txt", "map.pcd"):
            path = os.path.join(out, name)
            if not os.path.getsize(path) > 0:
                raise RuntimeError(f"cli run wrote an empty {name}")
        with open(os.path.join(out, "trajectory_tum.txt")) as f:
            n = sum(1 for line in f if line.strip() and not line.startswith("#"))
        log(f"[cli] trajectory_tum.txt holds {n} poses")
        if n < 5:
            raise RuntimeError(f"trajectory has {n} poses for 6 scans")


# ------------------------------------------------------------- four cards


def check_four(cfg, seq, n_streams: int = 4, n_scans: int = 8) -> None:
    """dp fleet replay and pt point-parallel step on a 4-card mesh, each
    against the same streams on one card."""
    devs = jax.devices()[:4]
    S = n_scans
    pts = np.stack([seq.points[b * S : (b + 1) * S] for b in range(n_streams)])
    msk = np.stack([seq.mask[b * S : (b + 1) * S] for b in range(n_streams)])
    ts = np.stack([seq.stamps[b * S : (b + 1) * S] for b in range(n_streams)])

    t0 = time.perf_counter()
    dp = replay.replay_batch(cfg, pts, msk, ts, mesh=sharding.make_mesh(4, pt=1, devices=devs))
    t_dp = time.perf_counter() - t0
    with jax.default_device(devs[0]):
        one = replay.replay_batch(cfg, pts, msk, ts, mesh=None)
    err = float(np.max(np.linalg.norm(dp.poses - one.poses, axis=-1)))
    log(
        f"[four] dp=4 replay_batch, {n_streams} streams x {S} scans "
        f"({t_dp:.1f} s incl. compile): max pose diff vs one card {err:.3g} m"
    )
    if not err < MULTI_CARD_TOL_M:
        raise RuntimeError(f"dp=4 poses differ from one card by {err} m")

    mesh = sharding.make_mesh(4, pt=4, devices=devs)
    pt_step = sharding.point_parallel_pipeline_step(cfg, mesh)
    state = sharding.shard_batch(
        mesh,
        sharding.batched_init_state(
            cfg, jnp.asarray(pts[:1, 0]), jnp.asarray(msk[:1, 0]),
            jnp.asarray(ts[:1, 0], jnp.float32),
        ),
    )
    with jax.default_device(devs[0]):
        ref = pipeline.init_state(
            cfg, jnp.asarray(pts[0, 0]), jnp.asarray(msk[0, 0]), float(ts[0, 0])
        )
    err = 0.0
    for s in range(1, S):
        state, out = pt_step(
            state, *sharding.shard_batch(mesh, (
                jnp.asarray(pts[:1, s]), jnp.asarray(msk[:1, s]),
                jnp.asarray(ts[:1, s], jnp.float32),
            )),
        )
        with jax.default_device(devs[0]):
            ref, out_ref = pipeline.step(
                cfg, ref, jnp.asarray(pts[0, s]), jnp.asarray(msk[0, s]),
                jnp.float32(ts[0, s]),
            )
        err = max(err, float(np.linalg.norm(
            np.asarray(out.odom.pose[0]) - np.asarray(out_ref.odom.pose)
        )))
    log(f"[four] pt=4 point-parallel step, {S - 1} scans: max pose diff vs one card {err:.3g} m")
    if not err < MULTI_CARD_TOL_M:
        raise RuntimeError(f"pt=4 poses differ from one card by {err} m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card dp and pt paths")
    args = ap.parse_args(argv)
    devtime.enable_compile_cache()

    n_cards = 4 if args.four else 1
    card = check_device(n_cards)
    cfg = cfg_lib.bench_config()
    if args.four:
        seq = dataset.steady_state_sequence(n_scans=32)
        check_four(cfg, seq)
    else:
        seq = dataset.steady_state_sequence(n_scans=24)
        check_compile(cfg, seq)
        check_kernel(cfg, seq, card)
        check_pipeline(cfg, seq, card)
        check_cli()
    d = jax.devices()
    print(json.dumps({
        "ok": True,
        "device": {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
