"""Headline bench: single-stream full-DDLO pipeline rate (Hz) on one GPU.

The reference's implicit real-time budget is ~10 Hz scan rate on CPU
(rosbag replay at rate 1.0, launch/play_DOALS_data.launch:5-6,
README.md:17); BASELINE.json's target is >= 10 Hz single stream. This
bench runs the complete jitted transition (preprocess -> S2S GICP ->
submap -> S2M GICP -> residuals -> range-image segmentation -> tracking
-> keyframe update) on DOALS-scale 64x2048 organized scans and reports
steps/second, vs_baseline = value / 10.

One process; it requires a CUDA device and fails without one. Prints
exactly one JSON line on stdout (progress goes to stderr), naming the
platform, device kind, device count and the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_timed():
    import numpy as np
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import pipeline
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry.odometry import keyframes
    from dynamic_direct_lidar_odometry.utils import devtime

    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(f"bench requires a GPU, JAX found {dev[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    devtime.enable_compile_cache()

    cfg = cfg_lib.bench_config()

    # THE shared steady-state sequence (also used by chip_smoke.py,
    # tools/accuracy.py and tools/profile_stages.py, so the Hz and the ATE
    # pin the same config): dense-town spiral, keyframe inserts fire
    # throughout, >= 20 active keyframes inside the timed window.
    # K scans per dispatch (pipeline.step_chunk).
    K = int(os.environ.get("DDLO_BENCH_CHUNK", "8"))
    seq = dataset.steady_state_sequence(n_scans=64)

    def chunk_args(lo):  # scans [lo, lo+K) as stacked device arrays
        return (
            jnp.asarray(seq.points[lo : lo + K]),
            jnp.asarray(seq.mask[lo : lo + K]),
            jnp.asarray(seq.stamps[lo : lo + K], dtype=jnp.float32),
        )

    # Keyframe hull memberships. Default "device": odometry.step computes
    # the exact triple-sweep hulls on device (keyframes.convex_hull_mask /
    # concave_hull_mask, cached until a keyframe insert), so the timed
    # loop has no per-chunk host round trip. DDLO_BENCH_HULLS=exact
    # restores the host-hull loop (scipy qhull, one chunk stale).
    hulls_mode = os.environ.get("DDLO_BENCH_HULLS", "device")

    def host_hulls(st):
        if hulls_mode == "device":
            return None
        cv, cc = keyframes.exact_hull_masks_packed(
            keyframes.packed_hull_inputs(
                st.odom.store, st.odom.keyframe_thresh_dist
            )
        )
        return (jnp.asarray(cv), jnp.asarray(cc))

    n_chunks = (len(seq) - 1 - K) // K
    if n_chunks < 1:
        raise ValueError(
            f"DDLO_BENCH_CHUNK={K} leaves no timed chunks in the "
            f"{len(seq)}-scan sequence (need K <= {(len(seq) - 1) // 2})"
        )
    n_timed = n_chunks * K

    # the timed window's scan stacks are staged on the device once,
    # outside the timed loop
    staged_chunks = None

    def one_pass():
        """Init + warmup chunk, then the timed 56-scan steady-state replay.
        With host hulls, the masks for chunk c+1 come from the state
        entering chunk c (one chunk stale), inside the timed loop."""
        nonlocal staged_chunks
        state = pipeline.init_state(
            cfg, jnp.asarray(seq.points[0]), jnp.asarray(seq.mask[0]), 0.0
        )
        hulls = host_hulls(state)
        # warm up: compile the chunked transition + populate store branches
        state, _ = pipeline.step_chunk(cfg, state, *chunk_args(1), hulls)
        hulls = host_hulls(state)
        if staged_chunks is None:
            staged_chunks = devtime.sync(
                [chunk_args(1 + K + c * K) for c in range(n_chunks)]
            )
        devtime.sync(state)

        t0 = time.perf_counter()
        for c in range(n_chunks):
            entering = state
            state, out = pipeline.step_chunk(
                cfg, state, *staged_chunks[c], hulls
            )
            hulls = host_hulls(entering)
            del out
        devtime.sync(state)
        dt = time.perf_counter() - t0
        return n_timed / dt, int(np.asarray(state.odom.store.valid).sum())

    n_passes = int(os.environ.get("DDLO_BENCH_PASSES", "3"))
    passes = []
    n_kf = 0
    for _ in range(max(n_passes, 1)):
        hz_i, n_kf = one_pass()
        passes.append(round(hz_i, 3))
        _log(f"[bench] pass {len(passes)}/{n_passes}: {hz_i:.2f} Hz")
    hz = float(np.median(passes))
    print(json.dumps({
        "metric": "ddlo_pipeline_rate",
        "value": round(hz, 3),
        "unit": "Hz (64x2048 scans/s, full dynamic pipeline, 1 GPU, "
                "steady-state %d-keyframe replay, %d-scan dispatch "
                "chunks, device-staged input, %s hulls; median of %d "
                "passes)" % (n_kf, K, hulls_mode, len(passes)),
        "vs_baseline": round(hz / 10.0, 3),
        "passes_hz": passes,
        "min_hz": min(passes),
        "max_hz": max(passes),
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
        "card": card,
        "nn_impl": os.environ.get("DDLO_NN_IMPL", "sparse"),
        "knn_impl": os.environ.get("DDLO_KNN_IMPL", "window"),
    }))


if __name__ == "__main__":
    run_timed()
