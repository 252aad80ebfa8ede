"""Multi-process (multi-host topology) distributed test.

Spawns 2 JAX processes (2 virtual CPU devices each) joined via
``jax.distributed``, runs the dp-sharded batched GICP align over the
4-device global mesh, and checks the result against the same batch run
single-process — proving the cross-host path (parallel/distributed.py)
computes exactly what the single-host path does.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(nproc: int, out_path: str, pt: int = 1, timeout=420):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # the worker sets its own JAX_PLATFORMS/XLA_FLAGS before importing jax
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable, WORKER,
                "--coordinator", f"127.0.0.1:{port}",
                "--nproc", str(nproc), "--pid", str(pid),
                "--out", out_path, "--pt", str(pt),
            ],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in outs:
        assert rc == 0, f"worker failed:\n{stdout}\n{stderr[-2000:]}"


def _single_process_reference():
    """The same deterministic batch, computed in this (8-CPU-device)
    process with the plain single-host sharding path."""
    import jax
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry.ops import covariance, gicp
    from dynamic_direct_lidar_odometry.parallel import sharding

    B, N = 8, 256
    rng = np.random.default_rng(42)
    src = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    dT = rng.uniform(-0.05, 0.05, (B, 1, 3)).astype(np.float32)
    tgt = (src + dT).astype(np.float32)
    mask = np.ones((B, N), bool)
    vcov = jax.jit(jax.vmap(
        lambda p, m: covariance.plane_covariances(p, m, k=10)
    ))
    scovs = vcov(jnp.asarray(src), jnp.asarray(mask))
    tcovs = vcov(jnp.asarray(tgt), jnp.asarray(mask))
    mesh = sharding.make_mesh(4, pt=1)
    settings = gicp.GICPSettings(max_iterations=8, compute_residuals=False)
    align = sharding.batched_align(mesh, settings, point_sharded=False)
    guess = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    out = align(
        jnp.asarray(src), jnp.asarray(mask), scovs,
        jnp.asarray(tgt), jnp.asarray(mask), tcovs, guess,
    )
    return np.asarray(out.T), np.asarray(out.converged), dT


@pytest.mark.slow
def test_two_process_dp_matches_single_process(tmp_path):
    out_npz = os.path.join(tmp_path, "mh.npz")
    _spawn(2, out_npz, pt=1)
    got = np.load(out_npz)
    T_ref, conv_ref, dT = _single_process_reference()
    # both paths recover the per-pair translations
    est_t = got["T"][:, :3, 3]
    np.testing.assert_allclose(est_t, dT[:, 0, :], atol=5e-3)
    # and agree with the single-process run to numerical noise
    np.testing.assert_allclose(got["T"], T_ref, atol=1e-4)
    assert got["converged"].all() and conv_ref.all()


@pytest.mark.slow
def test_two_process_scaling_efficiency():
    """BASELINE.md scaling bar: batched registrations/s through the
    2-process jax.distributed topology stays >= 80 % of the 1-process
    rate at CONSTANT total device count (the process-boundary tax; see
    tools/bench_scaling.py and SCALING_r03.json for the recorded
    artifact)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_scaling

    base = bench_scaling.run_case(1, 4, batch=16, n=2048, iters=3)
    two = bench_scaling.run_case(2, 2, batch=16, n=2048, iters=3)
    eff = two["value"] / base["value"]
    assert eff >= 0.8, f"2-process efficiency {eff:.2f} < 0.8"
