"""Device-saturation curves: how much of one GPU the single stream uses.

The headline bench is a SINGLE sequential stream (the reference's
process model, one sensor per node), whose small kernels of one
16k-point scan may leave the device idle between them. This tool
quantifies the headroom, the BASELINE.json north-star unit
("registrations/s/chip"), by sweeping batch size on the real chip:

  * batched INDEPENDENT GICP registrations (the north-star kernel,
    sharding.batched_align semantics via vmap on one device) —
    registrations/s vs batch 1..256;
  * batched INDEPENDENT full-pipeline streams (parallel/replay.py's
    transition: vmapped pipeline.step at the full 64x2048 bench config)
    — aggregate scans/s vs batch 1..32.

The ratio saturated-rate / single-rate is the honest motivation for
dp-mode (fleet replay / config sweeps): it is throughput the chip
already has that one stream cannot express. Writes the curves as JSON
(results/saturation.json).

Run on the GPU:  python -u tools/bench_saturation.py
(DDLO_SAT_SMALL=1 shrinks every size for a CPU rehearsal.)
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np


def bench_registrations(batches, n_points=4096, iters_budget=512):
    """Independent scan-pair registrations, vmapped on one chip.

    Same shapes/settings as tools/bench_registrations.py (n=4096,
    max_iterations=16) so the numbers line up with its anchor.
    """
    from dynamic_direct_lidar_odometry.ops import covariance, gicp
    from dynamic_direct_lidar_odometry.utils import devtime

    settings = gicp.GICPSettings(
        max_iterations=16, compute_residuals=False, nn_impl="sparse"
    )
    valign = jax.jit(jax.vmap(
        lambda sp, sm, sc, tp, tm, tc, g: gicp.align(
            sp, sm, sc, tp, tm, tc, g, settings
        )
    ))
    vcov = jax.jit(jax.vmap(
        lambda p, m: covariance.plane_covariances(p, m, k=10)
    ))

    rng = np.random.default_rng(0)
    out_rows = []
    for B in batches:
        src = rng.uniform(-20, 20, (B, n_points, 3)).astype(np.float32)
        dT = rng.uniform(-0.1, 0.1, (B, 1, 3)).astype(np.float32)
        tgt = src + dT
        mask = jnp.ones((B, n_points), bool)
        sp, tp = jnp.asarray(src), jnp.asarray(tgt)
        sc = vcov(sp, mask)
        tc = vcov(tp, mask)
        guess = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
        out = devtime.sync(valign(sp, mask, sc, tp, mask, tc, guess))
        iters = max(3, iters_budget // max(B, 1))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = valign(sp, mask, sc, tp, mask, tc, guess)
        devtime.sync(out)
        dt = (time.perf_counter() - t0) / iters
        rps = B / dt
        conv = int(jnp.sum(out.converged))
        row = {
            "batch": B, "registrations_per_s": round(rps, 1),
            "ms_per_batch": round(dt * 1e3, 2), "converged": conv,
            "iters_timed": iters,
        }
        print(f"[reg] B={B:<4d} {rps:10.1f} reg/s  "
              f"({dt * 1e3:7.2f} ms/batch, conv {conv}/{B})", flush=True)
        out_rows.append(row)
    return out_rows


def bench_pipeline_streams(batches, n_scans=16, small=False):
    """Independent full-pipeline streams (parallel/replay.py transition)
    at the full bench config, vmapped on one chip.

    Every stream replays the same steady-state scans (identical data,
    real per-stream work); rate = B * timed_scans / wall."""
    import dataclasses

    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import pipeline
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry.utils import devtime

    cfg = cfg_lib.bench_config()
    if small:  # CPU smoke: structure only, tiny shapes
        cfg = dataclasses.replace(
            cfg,
            detection=dataclasses.replace(
                cfg.detection, rows=16, columns=128, ground_rows=4
            ),
            capacity=cfg_lib.CapacityConfig(
                max_points=1024, max_submap_points=4096, max_keyframes=8,
                max_keyframe_points=1024, max_objects=8, max_tracks=8,
                nn_chunk=256,
            ),
        )
        seq = dataset.synthetic_sequence(
            n_scans=n_scans, H=16, W=128, n_dynamic=1, seed=0,
            angle_span=0.3,
        )
    else:
        seq = dataset.steady_state_sequence(n_scans=n_scans)

    rows = []
    for B in batches:
        vinit = jax.jit(jax.vmap(
            lambda p, m, t: pipeline.init_state(cfg, p, m, t)
        ))
        vstep = jax.jit(jax.vmap(
            lambda st, p, m, t: pipeline.step(cfg, st, p, m, t)
        ))
        rep = lambda a: jnp.broadcast_to(
            jnp.asarray(a)[None], (B,) + np.asarray(a).shape
        )
        state = vinit(
            rep(seq.points[0]), rep(seq.mask[0]),
            jnp.full((B,), seq.stamps[0], jnp.float32),
        )
        scans = [
            (rep(seq.points[i]), rep(seq.mask[i]),
             jnp.full((B,), seq.stamps[i], jnp.float32))
            for i in range(1, len(seq))
        ]
        # warmup: compile + populate store branches
        state, _ = vstep(state, *scans[0])
        for s in scans[:3]:
            state, _ = vstep(state, *s)
        devtime.sync(state)
        timed = scans[3:]
        t0 = time.perf_counter()
        for s in timed:
            state, _ = vstep(state, *s)
        devtime.sync(state)
        dt = time.perf_counter() - t0
        rate = B * len(timed) / dt
        row = {
            "batch_streams": B,
            "aggregate_scans_per_s": round(rate, 2),
            "ms_per_scan_per_stream": round(dt * 1e3 / len(timed), 2),
            "timed_scans": len(timed),
        }
        print(f"[pipe] B={B:<3d} {rate:9.2f} scans/s aggregate  "
              f"({dt * 1e3 / len(timed):7.2f} ms/step)", flush=True)
        rows.append(row)
    return rows


def main():
    from dynamic_direct_lidar_odometry.utils import devtime

    small = os.environ.get("DDLO_SAT_SMALL") == "1"  # CPU rehearsal
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not small:
        raise SystemExit(f"saturation bench needs a GPU, JAX found {dev.platform}")
    devtime.enable_compile_cache()
    reg_batches = [1, 8, 32] if small else [1, 8, 32, 128, 256]
    pipe_batches = [1, 2] if small else [1, 8, 32]
    n_points = 512 if small else 4096

    print(f"device: {dev.platform} {dev.device_kind}", flush=True)
    reg = bench_registrations(reg_batches, n_points=n_points)
    pipe = bench_pipeline_streams(
        pipe_batches, n_scans=8 if small else 16, small=small
    )

    sat = {
        "unit": "one device, vmapped independent work",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "registrations_vs_batch": reg,
        "pipeline_streams_vs_batch": pipe,
        "reg_saturation_x": round(
            reg[-1]["registrations_per_s"] / reg[0]["registrations_per_s"], 2
        ),
        "pipe_saturation_x": round(
            pipe[-1]["aggregate_scans_per_s"]
            / pipe[0]["aggregate_scans_per_s"], 2
        ),
    }
    out_path = os.path.join(REPO, "results", "saturation.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(sat, f, indent=1)
    print(json.dumps(sat, indent=1))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
