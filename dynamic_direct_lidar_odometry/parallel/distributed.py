"""Multi-host (multi-process) scale-out via ``jax.distributed``.

The reference runs three processes on one host wired by ROS loopback
topics (SURVEY.md §1); it has no cross-host story. This framework's
cross-host axis is the BASELINE.md north star: batched independent
registrations sharded over every device of every host, with the in-
registration Gauss-Newton reduction as a collective (``psum`` over the
``pt`` mesh axis — see parallel/sharding.py).

This module is the process-topology layer under that: one JAX process
per host, ``jax.distributed.initialize`` for the coordination service,
a GLOBAL mesh spanning all processes' devices, and helpers to assemble
global arrays from process-local shards (hosts never materialize the
full batch).

Works identically on real multi-host GPU machines and on a multi-process
CPU rig (each process given N virtual devices) — which is how
tests/test_multihost.py and ``tools/bench_registrations.py
--num-processes 2`` exercise it without multi-host hardware.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamic_direct_lidar_odometry.parallel.sharding import DP_AXIS, PT_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the multi-process JAX runtime (one call per process, before
    any other JAX API). Arguments fall back to the standard environment
    variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``) so launchers can stay declarative."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(pt: int = 1) -> Mesh:
    """A (dp, pt) mesh over ALL devices of ALL processes.

    ``jax.devices()`` is globally consistent across processes after
    ``initialize``; every process must call this with the same ``pt``.
    A ``pt`` group must not straddle hosts (the GN psum should stay on
    the host's device interconnect, not the network), so ``pt`` must divide the per-process device count.
    """
    devs = jax.devices()
    n_local = jax.local_device_count()
    if pt > 1 and n_local % pt != 0:
        raise ValueError(
            f"pt={pt} must divide local device count {n_local} so psum "
            "groups stay intra-host"
        )
    if len(devs) % pt != 0:
        raise ValueError(f"{len(devs)} devices not divisible by pt={pt}")
    dev = np.asarray(devs).reshape(len(devs) // pt, pt)
    return Mesh(dev, (DP_AXIS, PT_AXIS))


def process_batch_slice(global_batch: int) -> slice:
    """The slice of a dp-sharded global batch this process owns (equal
    split in process order — matching ``global_mesh``'s device order)."""
    n = jax.process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes"
        )
    per = global_batch // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)


def make_global_batch(mesh: Mesh, local_tree, point_sharded_leaves=()):
    """Assemble dp-sharded GLOBAL arrays from this process's local shard
    of the batch (leading axis). No host ever holds the full batch —
    the cross-host analogue of ``sharding.shard_batch``."""
    sh = NamedSharding(mesh, P(DP_AXIS))

    def one(x):
        x = np.asarray(x)
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(sh, x, global_shape)

    return jax.tree.map(one, local_tree)
