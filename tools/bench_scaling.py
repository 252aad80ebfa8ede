"""Record the multi-host scaling artifact (BASELINE.md scaling target).

Runs tools/bench_registrations.py over a process-topology matrix at
CONSTANT total device count — 1x4, 2x2, 4x1 (processes x local devices)
on a virtual CPU mesh — so the efficiency number isolates the cost of
crossing the jax.distributed process boundary (the multi-host tax:
collectives ride the distributed backend instead of staying in-process)
rather than conflating it with physical-core oversubscription. On real
hosts the same flag matrix runs one process per host with real local
devices.

Optionally adds the one-GPU anchor (registrations/s per device).
Writes results/scaling.json.

    python tools/bench_scaling.py [--gpu] [--batch 32] [--n 4096]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "tools", "bench_registrations.py")


def run_case(num_procs: int, local_devices: int, batch: int, n: int,
             iters: int, timeout_s: float = 900.0):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    cmd = [
        sys.executable, BENCH, "--batch", str(batch), "--n", str(n),
        "--iters", str(iters), "--json",
        "--num-processes", str(num_procs),
        "--local-devices", str(local_devices),
    ]
    r = subprocess.run(
        cmd, cwd=REPO, env=env, timeout=timeout_s,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"{num_procs}x{local_devices} failed:\n"
            + (r.stderr or r.stdout)[-1200:]
        )
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            obj = json.loads(line)
            if "registrations_per_s" in obj.get("metric", ""):
                return obj
        except json.JSONDecodeError:
            continue
    raise RuntimeError(f"no JSON from {num_procs}x{local_devices}:\n"
                       + r.stdout[-800:])


def run_gpu_anchor(batch: int, n: int, iters: int):
    cmd = [
        sys.executable, BENCH, "--batch", str(batch), "--n", str(n),
        "--iters", str(iters), "--json",
    ]
    r = subprocess.run(
        cmd, cwd=REPO, timeout=1800, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError("gpu anchor failed:\n"
                           + (r.stderr or r.stdout)[-1200:])
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            obj = json.loads(line)
            if "registrations_per_s" in obj.get("metric", ""):
                return obj
        except json.JSONDecodeError:
            continue
    raise RuntimeError("no JSON from gpu anchor:\n" + r.stdout[-800:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--gpu", action="store_true",
                    help="also run the one-GPU anchor")
    ap.add_argument("--pt", action="store_true",
                    help="also run the point-parallel latency curve "
                         "(tools/bench_pt_latency.py) and embed it")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "scaling.json"))
    args = ap.parse_args()

    cases = [(1, 4), (2, 2), (4, 1)]
    rows = {}
    for np_, ld in cases:
        print(f"[scaling] {np_} process(es) x {ld} device(s) ...", flush=True)
        rows[f"{np_}x{ld}"] = run_case(np_, ld, args.batch, args.n, args.iters)
        print(f"[scaling] -> {rows[f'{np_}x{ld}']}", flush=True)

    base = rows["1x4"]["value"]
    report = {
        "unit": "registrations/s, batched GICP (batch=%d, n=%d points), "
                "constant 4 virtual CPU devices" % (args.batch, args.n),
        "cases": rows,
        "efficiency_vs_1proc": {
            k: round(v["value"] / base, 3) for k, v in rows.items()
        },
        "note": "constant total devices -> efficiency isolates the "
                "jax.distributed process-boundary tax (adding devices "
                "would conflate core oversubscription with distribution "
                "cost)",
    }
    if args.gpu:
        print("[scaling] one-GPU anchor ...", flush=True)
        report["gpu_1"] = run_gpu_anchor(args.batch, args.n, args.iters)
        print(f"[scaling] -> {report['gpu_1']}", flush=True)

    if args.pt:
        # point-parallel per-step latency curve: the pt axis gets a
        # measured latency table next to the dp numbers
        print("[scaling] pt-latency curve ...", flush=True)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "bench_pt_latency.py")],
            cwd=REPO, env=env, timeout=1800,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError("pt latency failed:\n"
                               + (r.stderr or r.stdout)[-1200:])
        for line in reversed(r.stdout.strip().splitlines()):
            try:
                report["pt_latency"] = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
        print(f"[scaling] -> {report.get('pt_latency')}", flush=True)

    report["pass_80pct_at_2proc"] = bool(
        report["efficiency_vs_1proc"]["2x2"] >= 0.8
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
