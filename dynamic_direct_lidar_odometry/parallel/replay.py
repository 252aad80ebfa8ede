"""Batched multi-stream replay over a device mesh.

The reference processes ONE sensor stream per process (SURVEY.md §1).
The device scale axis is many *independent* streams at once — multi-robot
fleets, config sweeps, dataset-wide re-processing — sharded over the
mesh ``dp`` axis with zero cross-stream communication:

    states (B, ...) --step--> states', outputs      [one scan, all streams]

Per-scan host work (map accumulation, recorders) is what makes the
single-stream :func:`runner.replay` a host loop; here the whole scan loop
runs as one device computation per scan step across the batch, and only
the pose trail is pulled back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.config import DDLOConfig
from dynamic_direct_lidar_odometry.parallel import sharding


@dataclasses.dataclass
class BatchReplayResult:
    poses: np.ndarray  # (B, S-1, 3)
    quats: np.ndarray  # (B, S-1, 4)
    num_keyframes: np.ndarray  # (B,)
    final_states: pipeline.DDLOState  # batched pytree


def replay_batch(
    cfg: DDLOConfig,
    points: np.ndarray,  # (B, S, HW, 3)
    masks: np.ndarray,  # (B, S, HW)
    stamps: np.ndarray,  # (B, S)
    mesh: Optional[Mesh] = None,
) -> BatchReplayResult:
    """Replay B independent scan streams of S scans each.

    With a mesh, streams shard over ``dp``; without one, the batch runs
    vmapped on the default device. The per-scan transition is identical
    to the single-stream runner's (pipeline.step).
    """
    B, S = points.shape[:2]

    init = jax.vmap(lambda p, m, t: pipeline.init_state(cfg, p, m, t))(
        jnp.asarray(points[:, 0]),
        jnp.asarray(masks[:, 0]),
        jnp.asarray(stamps[:, 0].astype(np.float32)),
    )

    if mesh is not None:
        step = sharding.batched_pipeline_step(cfg, mesh)
        init = sharding.shard_batch(mesh, init)
    else:
        step = jax.jit(
            jax.vmap(lambda st, p, m, t: pipeline.step(cfg, st, p, m, t))
        )

    state = init
    poses, quats = [], []
    for s in range(1, S):
        pts = jnp.asarray(points[:, s])
        msk = jnp.asarray(masks[:, s])
        ts = jnp.asarray(stamps[:, s].astype(np.float32))
        if mesh is not None:
            pts = sharding.shard_batch(mesh, pts)
            msk = sharding.shard_batch(mesh, msk)
            ts = sharding.shard_batch(mesh, ts)
        state, out = step(state, pts, msk, ts)
        poses.append(out.odom.pose)
        quats.append(out.odom.rotq)

    poses = np.asarray(jnp.stack(poses, axis=1))
    quats = np.asarray(jnp.stack(quats, axis=1))
    return BatchReplayResult(
        poses=poses,
        quats=quats,
        num_keyframes=np.asarray(
            jnp.sum(state.odom.store.valid.astype(jnp.int32), axis=-1)
        ),
        final_states=state,
    )
