"""Worker process for the multi-host (multi-process) distributed test.

Spawned N times by tests/test_multihost.py (and usable standalone).
Each process gets 2 virtual CPU devices, joins the jax.distributed
coordination service, builds the GLOBAL (dp, pt) mesh, assembles its
local slice of a deterministic batch into global arrays, runs the
sharded batched GICP align, and (process 0) dumps the gathered poses.

This is the process topology of a real multi-host deployment — one
process per host, dp across hosts, pt (GN psum groups) within a host —
minus the hardware (SURVEY.md §5 'Distributed communication backend').
"""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pt", type=int, default=1)
    ap.add_argument("--local-devices", type=int, default=2)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.local_devices}"
    )

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamic_direct_lidar_odometry.ops import covariance, gicp
    from dynamic_direct_lidar_odometry.parallel import distributed, sharding

    distributed.initialize(args.coordinator, args.nproc, args.pid)
    assert jax.process_count() == args.nproc
    assert jax.device_count() == args.local_devices * args.nproc
    mesh = distributed.global_mesh(pt=args.pt)

    # deterministic global batch (identical on every process)
    B, N = 8, 256
    rng = np.random.default_rng(42)
    src = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    dT = rng.uniform(-0.05, 0.05, (B, 1, 3)).astype(np.float32)
    tgt = (src + dT).astype(np.float32)
    mask = np.ones((B, N), bool)

    # this process's slice of the batch — covariances computed locally
    sl = distributed.process_batch_slice(B)
    vcov = jax.jit(jax.vmap(
        lambda p, m: covariance.plane_covariances(p, m, k=10)
    ))
    local = {
        "src": src[sl],
        "smask": mask[sl],
        "scovs": np.asarray(vcov(jnp.asarray(src[sl]), jnp.asarray(mask[sl]))),
        "tgt": tgt[sl],
        "tmask": mask[sl],
        "tcovs": np.asarray(vcov(jnp.asarray(tgt[sl]), jnp.asarray(mask[sl]))),
        "guess": np.tile(np.eye(4, dtype=np.float32), (sl.stop - sl.start, 1, 1)),
    }
    gbatch = distributed.make_global_batch(mesh, local)

    settings = gicp.GICPSettings(max_iterations=8, compute_residuals=False)
    align = sharding.batched_align(mesh, settings, point_sharded=args.pt > 1)
    out = align(
        gbatch["src"], gbatch["smask"], gbatch["scovs"],
        gbatch["tgt"], gbatch["tmask"], gbatch["tcovs"], gbatch["guess"],
    )
    jax.block_until_ready(out)

    from jax.experimental import multihost_utils

    T_all = multihost_utils.process_allgather(out.T, tiled=True)
    conv_all = multihost_utils.process_allgather(out.converged, tiled=True)
    if jax.process_index() == 0:
        np.savez(args.out, T=np.asarray(T_all), converged=np.asarray(conv_all))
    multihost_utils.sync_global_devices("ddlo-multihost-done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
