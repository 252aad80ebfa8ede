"""Trajectory-level accuracy of the default NN backends on the GPU.

The headline bench (bench.py) runs the defaults — block-sparse Pallas
1-NN correspondences (exact within the gate) and Morton-window
covariance neighbourhoods (approximate) — while every accuracy test
(golden, f64 oracle parity) runs on the CPU, where the exact sweeps run.
This tool ties the two together: it replays the shared steady-state
sequence (io/dataset.steady_state_sequence, the bench.py configuration,
device hulls via runner.replay) as three legs,

  gpu_default : GPU, sparse 1-NN + window covariances  (the bench config)
  gpu_exact   : GPU, DDLO_NN_IMPL=exact + DDLO_KNN_IMPL=exact
  cpu_exact   : CPU, exact sweeps (the config all accuracy tests run in)

and reports ATE vs the synthetic ground truth plus the pairwise ATE
between legs. Bars: ATE(default vs exact) < 1 cm, ATE vs ground truth
< 5 cm (BASELINE.md). The reference's own accuracy story is exactly its
trajectory dumps (odom.cc:704-709).

The backend env vars are read at trace time, so each leg runs in its own
child process, one after another; the parent never imports JAX, so only
one process at a time holds the card. Writes a JSON report.

    python tools/accuracy.py [--scans 64] [--legs gpu_default,gpu_exact] \
        [--out results/accuracy.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EXACT = {"DDLO_NN_IMPL": "exact", "DDLO_KNN_IMPL": "exact"}
LEGS = {
    "gpu_default": {"platform": "gpu", "env": {}},
    "gpu_exact": {"platform": "gpu", "env": EXACT},
    "cpu_exact": {"platform": "cpu", "env": dict(EXACT, JAX_PLATFORMS="cpu")},
}


def run_child(name: str, n_scans: int, out_npz: str, timeout_s: float):
    spec = LEGS[name]
    env = dict(os.environ)
    env.update(spec["env"])
    cmd = [
        sys.executable, os.path.abspath(__file__),
        "--child", "--scans", str(n_scans), "--npz", out_npz,
        "--require-platform", spec["platform"],
    ]
    r = subprocess.run(
        cmd, cwd=REPO, env=env, timeout=timeout_s,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"{name} child failed:\n{(r.stderr or r.stdout)[-1200:]}"
        )
    return r.stdout


def child_main(n_scans: int, npz_path: str, require_platform: str):
    import jax
    import numpy as np

    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import runner
    from dynamic_direct_lidar_odometry.io import dataset
    from dynamic_direct_lidar_odometry.utils import devtime

    if jax.devices()[0].platform != require_platform:
        raise RuntimeError(
            f"wanted {require_platform}, got {jax.devices()[0].platform}"
        )
    devtime.enable_compile_cache()

    cfg = cfg_lib.bench_config()
    seq = dataset.steady_state_sequence(n_scans=n_scans)
    res = runner.replay(cfg, seq, hulls="device")
    ate_gt = runner.ate_rmse(res.poses, seq.gt_poses, res.stamps, seq.stamps)
    np.savez(
        npz_path,
        poses=res.poses,
        stamps=res.stamps,
        ate_gt=ate_gt,
        n_keyframes=res.num_keyframes,
        dropped=res.dropped_scans,
    )
    print(f"ate_vs_gt={ate_gt:.4f} m  keyframes={res.num_keyframes}  "
          f"device={jax.devices()[0].device_kind}")


def pairwise_ate(a, b):
    """RMSE between two legs' trajectories, aligned by scan STAMP (not
    raw index): if either leg dropped scans mid-run, index alignment
    would silently compare mismatched scans."""
    import numpy as np

    for v in (a, b):
        if int(v.get("dropped", 0)) != 0:
            raise RuntimeError(
                f"leg dropped {int(v['dropped'])} scans; pairwise ATE "
                "would compare misaligned trajectories"
            )
    sa, sb = np.asarray(a["stamps"]), np.asarray(b["stamps"])
    common, ia, ib = np.intersect1d(sa, sb, return_indices=True)
    if len(common) == 0:
        return float("nan")
    d = a["poses"][ia] - b["poses"][ib]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--out", default=os.path.join(REPO, "results", "accuracy.json"))
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--npz", default="")
    ap.add_argument("--require-platform", default="gpu")
    args = ap.parse_args()

    if args.child:
        child_main(args.scans, args.npz, args.require_platform)
        return 0

    import numpy as np

    legs = args.legs.split(",")
    results = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in legs:
            npz = os.path.join(tmpdir, f"{name}.npz")
            print(f"[accuracy] running {name} ...", flush=True)
            out = run_child(name, args.scans, npz, timeout_s=3600)
            print(f"[accuracy] {name}: {out.strip()}", flush=True)
            d = np.load(npz)
            results[name] = {k: d[k] for k in d.files}

    report = {
        "sequence": f"steady_state_sequence(n_scans={args.scans}), 64x2048, "
                    "bench_config (device hulls via runner.replay)",
        "ate_vs_gt_m": {k: float(v["ate_gt"]) for k, v in results.items()},
        "ate_pairwise_m": {
            f"{a}_vs_{b}": pairwise_ate(results[a], results[b])
            for i, a in enumerate(legs) for b in legs[i + 1:]
        },
        "bars": {"default_vs_exact_lt_m": 0.01, "vs_gt_lt_m": 0.05},
    }
    ok = all(v < 0.05 for v in report["ate_vs_gt_m"].values())
    if "gpu_default" in results and "gpu_exact" in results:
        ok = ok and report["ate_pairwise_m"]["gpu_default_vs_gpu_exact"] < 0.01
    report["pass"] = bool(ok)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
