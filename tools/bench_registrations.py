"""Scaling bench: batched GICP registrations/s across the device mesh.

The BASELINE.json north-star unit: independent scan-pair registrations
sharded over ``dp`` with psum-reduced Gauss-Newton blocks over ``pt``.
Runs on whatever devices exist (the real chip, or a CPU mesh via
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).

Single process:

    python tools/bench_registrations.py [--batch 32] [--n 4096] [--pt 1]

Multi-process (the multi-HOST topology — one JAX process per host; on
this rig, N local processes with virtual CPU devices):

    # orchestrator: spawns N workers, prints the scaling table
    python tools/bench_registrations.py --num-processes 2 \
        [--local-devices 4] [--batch 32] [--n 4096]

    # or launch workers yourself (one per host on a real slice)
    python tools/bench_registrations.py --num-processes 2 --process-id 0 \
        --coordinator host0:9876 ...
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32,
                    help="GLOBAL batch of registrations")
    ap.add_argument("--n", type=int, default=4096, help="points per cloud")
    ap.add_argument("--pt", type=int, default=1, help="point-shard group")
    ap.add_argument("--iters", type=int, default=5)
    # multi-process topology
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="virtual CPU devices per process (spawn mode)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON line at the end")
    return ap.parse_args(argv)


def orchestrate(args) -> int:
    """Spawn --num-processes workers on this machine (CPU rig for the
    multi-host topology) and print process 0's report."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..")
    env["JAX_PLATFORMS"] = "cpu"
    n_local = args.local_devices or 4
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_local}"
    cmd_base = [
        sys.executable, os.path.abspath(__file__),
        "--batch", str(args.batch), "--n", str(args.n),
        "--pt", str(args.pt), "--iters", str(args.iters),
        "--num-processes", str(args.num_processes),
        "--coordinator", f"127.0.0.1:{port}",
    ] + (["--json"] if args.json else [])
    import tempfile

    # non-lead workers log to temp files (an unread PIPE can fill and
    # deadlock a chatty worker; DEVNULL would eat crash tracebacks)
    logs = []
    procs = []
    for pid in range(args.num_processes):
        if pid == 0:
            procs.append(subprocess.Popen(
                cmd_base + ["--process-id", "0"], env=env,
            ))
            logs.append(None)
        else:
            f = tempfile.NamedTemporaryFile(
                mode="w+", prefix=f"ddlo_bench_p{pid}_", suffix=".log",
                delete=False,
            )
            logs.append(f)
            procs.append(subprocess.Popen(
                cmd_base + ["--process-id", str(pid)], env=env,
                stdout=f, stderr=subprocess.STDOUT, text=True,
            ))
    rc = 0
    for pid, p in enumerate(procs):
        p.wait()
        rc |= p.returncode
        if p.returncode != 0 and logs[pid] is not None:
            logs[pid].seek(0)
            print(
                f"--- worker {pid} failed (rc={p.returncode}) ---\n"
                + logs[pid].read()[-4000:],
                file=sys.stderr,
            )
    for f in logs:
        if f is not None:
            f.close()
            os.unlink(f.name)
    return rc


def run(args) -> None:
    if args.num_processes > 1:
        # must happen before any other JAX call
        from dynamic_direct_lidar_odometry.parallel import distributed

        distributed.initialize(
            args.coordinator, args.num_processes, args.process_id
        )

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamic_direct_lidar_odometry.ops import covariance, gicp
    from dynamic_direct_lidar_odometry.parallel import distributed, sharding

    ndev = len(jax.devices())
    nproc = jax.process_count()
    lead = jax.process_index() == 0
    if args.num_processes > 1:
        mesh = distributed.global_mesh(pt=args.pt)
    else:
        mesh = sharding.make_mesh(ndev, pt=args.pt)
    if lead:
        print(
            f"processes={nproc} devices={ndev} "
            f"mesh=(dp={ndev // args.pt}, pt={args.pt}) "
            f"batch={args.batch} n={args.n}"
        )

    rng = np.random.default_rng(0)
    B, N = args.batch, args.n
    src = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    dT = rng.uniform(-0.1, 0.1, (B, 1, 3)).astype(np.float32)
    tgt = src + dT
    mask = np.ones((B, N), bool)

    vcov = jax.jit(jax.vmap(
        lambda p, m: covariance.plane_covariances(p, m, k=10)
    ))
    settings = gicp.GICPSettings(max_iterations=16, compute_residuals=False)
    align = sharding.batched_align(mesh, settings, point_sharded=args.pt > 1)
    guess = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    if args.num_processes > 1:
        sl = distributed.process_batch_slice(B)
        local = {
            "sp": src[sl], "sm": mask[sl],
            "sc": np.asarray(vcov(jnp.asarray(src[sl]), jnp.asarray(mask[sl]))),
            "tp": tgt[sl], "tm": mask[sl],
            "tc": np.asarray(vcov(jnp.asarray(tgt[sl]), jnp.asarray(mask[sl]))),
            "g": guess[sl],
        }
        gb = distributed.make_global_batch(mesh, local)
        arrs = (gb["sp"], gb["sm"], gb["sc"], gb["tp"], gb["tm"], gb["tc"],
                gb["g"])
    else:
        covs = vcov(jnp.asarray(src), jnp.asarray(mask))
        tcovs = vcov(jnp.asarray(tgt), jnp.asarray(mask))
        arrs = (jnp.asarray(src), jnp.asarray(mask), covs,
                jnp.asarray(tgt), jnp.asarray(mask), tcovs,
                jnp.asarray(guess))
        arrs = tuple(sharding.shard_batch(mesh, a) for a in arrs)

    from dynamic_direct_lidar_odometry.utils import devtime

    out = devtime.sync(align(*arrs))
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = align(*arrs)
    devtime.sync(out)
    dt = (time.perf_counter() - t0) / args.iters
    rps = B / dt
    conv = int(jnp.sum(out.converged))
    if lead:
        print(f"converged: {conv}/{B}")
        print(
            f"registrations/s: {rps:.1f}  ({rps / ndev:.1f} per device, "
            f"{dt * 1e3:.1f} ms per batch)"
        )
        if args.json:
            print(json.dumps({
                "metric": "registrations_per_s",
                "value": round(rps, 2),
                "per_device": round(rps / ndev, 2),
                "processes": nproc,
                "devices": ndev,
                "batch": B,
                "n_points": N,
                "pt": args.pt,
            }))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.num_processes > 1 and args.process_id is None:
        return orchestrate(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
