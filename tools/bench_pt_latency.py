"""Point-parallel (pt) per-step LATENCY curve on the virtual CPU mesh.

The pt mesh axis exists to cut single-stream latency: the GICP point
loops shard over pt with psum'd 6x6/6x1 normal equations — the
cross-device analogue of the reference's OpenMP threads over points
(nano_gicp_impl.hpp:249,292). The multichip dryrun proves it compiles
and matches the unsharded step; THIS tool records what round 3 lacked,
a measured per-step latency at pt = 1 / 2 / 4:

  * full pipeline step (point_parallel_pipeline_step, dp=1), and
  * a registration-only align where the N_src x N_tgt NN sweep dominates
    (batched_align, B=1), the term pt actually divides.

Relative numbers are the point (on a CPU host the wall-clock gains
saturate at the physical core count; per-device sweep FLOPs still drop
pt-fold — on real GPUs the same program's collectives ride NVLink).

    env JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_pt_latency.py [--json out.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

import jax
import jax.numpy as jnp
import numpy as np


def _cfg():
    from dynamic_direct_lidar_odometry import config as cfg_lib

    cfg = cfg_lib.doals_config()
    # CPU-tractable scale: small image (detection is replicated across pt
    # and must not drown the point-sweep term), GICP sweep still the
    # dominant cost (4096 x 8192 pair distances per iteration)
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection, rows=16, columns=256, ground_rows=4
        ),
        gicp=dataclasses.replace(
            cfg.gicp,
            s2s=dataclasses.replace(cfg.gicp.s2s, max_iterations=8),
            s2m=dataclasses.replace(cfg.gicp.s2m, max_iterations=8),
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=4096,
            max_submap_points=8192,
            max_keyframes=16,
            max_keyframe_points=4096,
            max_objects=16,
            max_tracks=16,
            nn_chunk=512,
        ),
    )


def bench_pipeline_step(cfg, pt: int, n_steps: int = 6):
    """ms/step of the FULL pipeline at dp=1, given pt devices."""
    from dynamic_direct_lidar_odometry.io import synthetic
    from dynamic_direct_lidar_odometry.parallel import sharding

    world = synthetic.World.town(seed=0, n_static=6)
    H, W = cfg.detection.rows, cfg.detection.columns
    rng = np.random.default_rng(0)
    scans = []
    for i in range(n_steps + 2):
        T = np.eye(4)
        T[0, 3] = 0.12 * i
        pts, mask = synthetic.render_scan(world, T, H=H, W=W, rng=rng)
        scans.append((pts, mask))

    mesh = sharding.make_mesh(pt, pt=pt)
    step = sharding.point_parallel_pipeline_step(cfg, mesh)

    B = 1
    pts0 = jnp.asarray(scans[0][0])[None]
    msk0 = jnp.asarray(scans[0][1])[None]
    states = sharding.batched_init_state(
        cfg, pts0, msk0, jnp.zeros((B,), jnp.float32)
    )
    states = sharding.shard_batch(mesh, states)

    def run(states, lo, n):
        for i in range(lo, lo + n):
            states, out = step(
                states,
                sharding.shard_batch(mesh, jnp.asarray(scans[i][0])[None]),
                sharding.shard_batch(mesh, jnp.asarray(scans[i][1])[None]),
                sharding.shard_batch(
                    mesh, jnp.full((B,), 0.1 * i, jnp.float32)
                ),
            )
        jax.block_until_ready(out)
        return states

    states = run(states, 1, 1)  # compile + warm keyframe branches
    t0 = time.perf_counter()
    states = run(states, 2, n_steps)
    dt = time.perf_counter() - t0
    return 1e3 * dt / n_steps


def bench_align(pt: int, n_src: int = 4096, n_tgt: int = 8192, reps: int = 5):
    """ms/align of a point-sharded registration (B=1)."""
    from dynamic_direct_lidar_odometry.ops import covariance, gicp
    from dynamic_direct_lidar_odometry.parallel import sharding

    rng = np.random.default_rng(1)
    src = rng.uniform(-8, 8, (1, n_src, 3)).astype(np.float32)
    tgt = np.concatenate(
        [src + rng.uniform(-0.05, 0.05, (1, n_src, 3)).astype(np.float32)]
        + [rng.uniform(-8, 8, (1, n_tgt - n_src, 3)).astype(np.float32)],
        axis=1,
    )
    sm = jnp.ones((1, n_src), bool)
    tm = jnp.ones((1, n_tgt), bool)
    scov = jax.vmap(lambda p: covariance.plane_covariances(p, sm[0], k=10))(
        jnp.asarray(src)
    )
    tcov = jax.vmap(lambda p: covariance.plane_covariances(p, tm[0], k=10))(
        jnp.asarray(tgt)
    )
    guess = jnp.broadcast_to(jnp.eye(4), (1, 4, 4))

    mesh = sharding.make_mesh(pt, pt=pt)
    settings = gicp.GICPSettings(max_iterations=8, compute_residuals=False)
    aligner = sharding.batched_align(mesh, settings, point_sharded=True)

    args = (jnp.asarray(src), sm, scov, jnp.asarray(tgt), tm, tcov, guess)
    jax.block_until_ready(aligner(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        res = aligner(*args)
    jax.block_until_ready(res)
    return 1e3 * (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    if jax.default_backend() != "cpu" or len(jax.devices()) < 4:
        raise RuntimeError(
            "run with JAX_PLATFORMS=cpu and "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8 "
            f"(got {jax.default_backend()}, {len(jax.devices())} devices)"
        )

    cfg = _cfg()
    out = {
        "note": (
            "per-step latency vs pt (point-parallel group size), dp=1, "
            "virtual CPU devices on a 2-core host: wall-clock saturates "
            "at ~2x by physical cores; per-device sweep work drops "
            "pt-fold. align = registration only (4096x8192 sweep, 8 "
            "iters); pipeline = full DDLO step (16x256 image)."
        ),
        "pipeline_ms_per_step": {},
        "align_ms": {},
    }
    for pt in (1, 2, 4):
        ms = bench_align(pt)
        out["align_ms"][f"pt={pt}"] = round(ms, 1)
        print(f"align    pt={pt}: {ms:8.1f} ms", file=sys.stderr, flush=True)
    for pt in (1, 2, 4):
        ms = bench_pipeline_step(cfg, pt)
        out["pipeline_ms_per_step"][f"pt={pt}"] = round(ms, 1)
        print(f"pipeline pt={pt}: {ms:8.1f} ms", file=sys.stderr, flush=True)

    a1 = out["align_ms"]["pt=1"]
    out["align_speedup"] = {
        k: round(a1 / v, 2) for k, v in out["align_ms"].items()
    }
    p1 = out["pipeline_ms_per_step"]["pt=1"]
    out["pipeline_speedup"] = {
        k: round(p1 / v, 2) for k, v in out["pipeline_ms_per_step"].items()
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
