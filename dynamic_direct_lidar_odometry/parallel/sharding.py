"""Multi-device scale-out: device meshes, sharded batched registration,
sharded batched pipeline replay.

The reference is a single-host CPU program whose only parallelism is
OpenMP ``parallel for`` over points plus detached publisher threads
(SURVEY.md §2; nano_gicp_impl.hpp:284-339, CMakeLists.txt:16-23). The
scale-out here replaces that with two mesh axes:

- ``dp`` (data parallel): *independent* odometry streams / registrations
  sharded across devices — replay of many sequences, config sweeps,
  multi-robot fleets. No collectives cross this axis.
- ``pt`` (point parallel): the source-point axis of one registration
  sharded across devices. The 6x6/6x1 Gauss-Newton normal equations and the
  scalar error re-evaluations are ``psum``-reduced over ``pt`` — the
  collective equivalent of the reference's per-thread OpenMP H/b partials
  (nano_gicp_impl.hpp:284-339, reduction at :326-339). The target cloud
  (and its covariances) is replicated over ``pt`` so every shard can
  query 1-NN against the full target.

Everything here composes with ``jit``; the mesh follows ``jax.devices()``
order, which suits GPUs joined all to all (NVLink), where every order is
equally close.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.ops import gicp

DP_AXIS = "dp"
PT_AXIS = "pt"


def make_mesh(
    n_devices: Optional[int] = None,
    pt: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, pt) mesh over the first ``n_devices`` devices.

    ``pt`` is the point-parallel group size; ``dp = n_devices // pt``.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % pt != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by pt={pt}")
    dp = n_devices // pt
    dev = np.asarray(devices[:n_devices]).reshape(dp, pt)
    return Mesh(dev, (DP_AXIS, PT_AXIS))


def batched_align(
    mesh: Mesh,
    settings: gicp.GICPSettings = gicp.GICPSettings(),
    point_sharded: bool = True,
):
    """A jitted batch-of-registrations aligner sharded over the mesh.

    Batch axis -> ``dp``; source point axis -> ``pt`` (if
    ``point_sharded``), with H/b/error psum'd inside each LM iteration.
    This is the BASELINE.json north-star unit: batched registrations/s
    with collective-reduced normal equations.

    Call with (src_pts (B,N,3), src_mask (B,N), src_covs (B,N,3,3),
    tgt_pts (B,M,3), tgt_mask (B,M), tgt_covs (B,M,3,3), guess (B,4,4)).
    """
    pt_axis = PT_AXIS if point_sharded else None

    def one(sp, sm, sc, tp, tm, tc, g):
        return gicp.align(sp, sm, sc, tp, tm, tc, g, settings, axis_name=pt_axis)

    vone = jax.vmap(one)

    dp = P(DP_AXIS)
    dppt = P(DP_AXIS, PT_AXIS) if point_sharded else dp
    in_specs = (dppt, dppt, dppt, dp, dp, dp, dp)
    out_specs = gicp.GICPResult(
        T=dp,
        converged=dp,
        iterations=dp,
        final_error=dp,
        final_hessian=dp,
        num_inliers=dp,
        residuals=dppt,
        correspondences=dppt,
        pose_trace=dp,
    )
    f = jax.shard_map(
        vone, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(f)


def batched_pipeline_step(cfg: DDLOConfig, mesh: Mesh):
    """A jitted batch-of-streams DDLO transition sharded over ``dp``.

    Each mesh ``dp`` group advances ``B/dp`` independent odometry streams
    one scan; there is no cross-stream communication (the reference's
    process graph is one stream, SURVEY.md §1 — batched replay is the new
    scale axis).

    Call with (states, raw_points (B,HW,3), raw_mask (B,HW), stamps (B,)).
    """

    def one(state, pts, mask, ts):
        return pipeline.step(cfg, state, pts, mask, ts)

    vstep = jax.vmap(one)
    spec = P(DP_AXIS)
    f = jax.shard_map(
        vstep,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(f)


def point_parallel_pipeline_step(cfg: DDLOConfig, mesh: Mesh):
    """A jitted batch-of-streams DDLO transition with BOTH mesh axes
    live: streams over ``dp`` AND each stream's GICP point loops sharded
    over ``pt`` (scan replicated per pt group; normal equations psum'd,
    covariances/residuals all-gathered — odometry.step point-parallel
    mode).

    The INTENDED single-stream latency scale axis (the reference bounds
    per-scan cost with OpenMP threads over points,
    nano_gicp_impl.hpp:249,292; here the same point axis spans devices)
    — its correctness on four H100s is checked by ``chip_smoke.py
    --four``; its latency benefit is not measured yet. Call like
    :func:`batched_pipeline_step`.
    """
    pt_size = mesh.shape[PT_AXIS]
    if cfg.capacity.max_points % pt_size != 0:
        raise ValueError(
            f"capacity.max_points={cfg.capacity.max_points} must divide "
            f"by pt={pt_size}"
        )

    def one(state, pts, mask, ts):
        return pipeline.step(
            cfg, state, pts, mask, ts,
            axis_name=PT_AXIS, pt_size=pt_size,
        )

    vstep = jax.vmap(one)
    dp = P(DP_AXIS)
    f = jax.shard_map(
        vstep,
        mesh=mesh,
        in_specs=(dp, dp, dp, dp),
        out_specs=(dp, dp),
        check_vma=False,
    )
    return jax.jit(f)


def shard_batch(mesh: Mesh, tree, point_sharded_leaves=()):
    """Place a batch pytree on the mesh, batch axis over ``dp``."""
    sh = NamedSharding(mesh, P(DP_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def batched_init_state(cfg: DDLOConfig, raw_points, raw_mask, stamps):
    """vmapped pipeline.init_state over a leading batch axis (host-side
    helper; shard the result with :func:`shard_batch`)."""
    return jax.vmap(
        lambda p, m, t: pipeline.init_state(cfg, p, m, t)
    )(raw_points, raw_mask, stamps)
