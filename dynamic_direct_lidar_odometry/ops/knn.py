"""Nearest-neighbor search: the exact tiled sweep, and the one place
that picks an implementation by platform.

The reference builds a kd-tree per cloud and runs per-point 1-NN / k-NN
queries (``include/nano_gicp/impl/nanoflann_impl.hpp:1265-1540``,
used from ``nano_gicp_impl.hpp:235-275,375-441``). Here the exact search
is a *brute-force tiled sweep*:

    ||q - t||^2 = ||q||^2 + ||t||^2 - 2 q.t

The cross term is a (Q_chunk x 3) @ (3 x T_chunk) matmul, and the running
min/top-k reduction never materializes the full Q x T distance matrix
(chunked ``lax.scan`` over both sides). Unlike a kd-tree it batches
exactly under ``vmap``.

Numerics: the expansion cancels catastrophically in low precision (a GPU
f32 matmul may run as TF32 unless pinned), so candidate *selection* runs
the cross matmul at ``Precision.HIGHEST`` and the returned squared
distances are re-computed exactly as ``||q - t[idx]||^2`` on the selected
pairs — selection tolerates ~1e-4 ties, residuals must not.

:func:`on_gpu` chooses per platform at lowering time: the GPU takes the
block-sparse Pallas kernel (:mod:`.nn_pallas`), every other platform the
exact sweep, which is also the tests' reference.

Invalid points must be pre-masked to the far-away :data:`cloud.SENTINEL`
(see :meth:`Cloud.sanitized`) so they lose every min-reduction naturally.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamic_direct_lidar_odometry.ops import nn_pallas

# NumPy scalar (a jnp literal here would initialize the XLA backend at
# import, breaking jax.distributed.initialize ordering)
_BIG = np.float32(3.0e12)  # > (2 * SENTINEL)^2 is not needed; per-chunk guard


def on_gpu(gpu, default, *args):
    """``gpu(*args)`` when the program is lowered for a CUDA device,
    ``default(*args)`` for every other platform. The choice is made at
    lowering time (``lax.platform_dependent``), so one traced program
    serves the CPU tests and the card, also under ``vmap`` and
    ``shard_map``."""
    return jax.lax.platform_dependent(*args, cuda=gpu, default=default)


def nn1_within(
    query: jnp.ndarray,
    target: jnp.ndarray,
    radius: float,
    prep: nn_pallas.SparseTarget | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN that is exact for every query whose nearest target lies within
    ``radius``: the block-sparse kernel on the GPU (queries with nothing
    inside the radius report a squared distance >= radius^2), the exact
    sweep elsewhere. ``prep`` is the hoisted
    :func:`nn_pallas.prepare_sparse_target` of ``target``."""

    def gpu(q, t):
        p = nn_pallas.prepare_sparse_target(t) if prep is None else prep
        return nn_pallas.nn1_sparse_prepared(q, p, radius)

    return on_gpu(gpu, nn1, query, target)


def _pad_to_multiple(x: jnp.ndarray, m: int, fill) -> jnp.ndarray:
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x
    width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
    return jnp.pad(x, width, constant_values=fill)


@partial(jax.jit, static_argnames=("query_chunk", "target_chunk"))
def nn1(
    query: jnp.ndarray,
    target: jnp.ndarray,
    query_chunk: int = 1024,
    target_chunk: int = 8192,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brute-force 1-NN: for each query point the index + squared distance
    of its nearest target point.

    Replaces ``KdTreeFLANN::nearestKSearch(pt, 1, ...)`` inside the GICP
    correspondence update (nano_gicp_impl.hpp:249-258).

    Args:
      query: (Q, 3) float32, invalid rows at SENTINEL.
      target: (T, 3) float32, invalid rows at SENTINEL.

    Returns:
      (idx (Q,) int32, sqdist (Q,) float32)
    """
    Q = query.shape[0]
    q = _pad_to_multiple(query, query_chunk, 0.0)
    t = _pad_to_multiple(target, target_chunk, 1.0e6)
    Tn = t.shape[0]

    q_chunks = q.reshape(-1, query_chunk, 3)
    t_chunks = t.reshape(-1, target_chunk, 3)
    t_sq = jnp.sum(t_chunks * t_chunks, axis=-1)  # (nt, C_t)

    def per_query_chunk(qc):
        q_sq = jnp.sum(qc * qc, axis=-1)  # (C_q,)

        def scan_target(carry, xs):
            best_d, best_i, base = carry
            tc, tc_sq = xs
            # (C_q, C_t) squared distances via one matmul
            cross = jnp.dot(qc, tc.T, precision=jax.lax.Precision.HIGHEST)
            d = q_sq[:, None] + tc_sq[None, :] - 2.0 * cross
            cd = jnp.min(d, axis=1)
            ci = jnp.argmin(d, axis=1).astype(jnp.int32) + base
            take = cd < best_d
            return (
                jnp.where(take, cd, best_d),
                jnp.where(take, ci, best_i),
                base + tc.shape[0],
            ), None

        init = (
            jnp.full((query_chunk,), _BIG, jnp.float32),
            jnp.zeros((query_chunk,), jnp.int32),
            jnp.int32(0),
        )
        (best_d, best_i, _), _ = jax.lax.scan(scan_target, init, (t_chunks, t_sq))
        return best_i, best_d

    idx, _ = jax.lax.map(per_query_chunk, q_chunks)
    idx = idx.reshape(-1)[:Q]
    diff = query - t[idx]
    sqd = jnp.sum(diff * diff, axis=-1)
    return idx, sqd


@partial(jax.jit, static_argnames=("k", "query_chunk", "target_chunk"))
def knn(
    query: jnp.ndarray,
    target: jnp.ndarray,
    k: int,
    query_chunk: int = 1024,
    target_chunk: int = 8192,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brute-force k-NN with a running top-k merge over target chunks.

    Replaces the k=10/20 neighborhood queries of the covariance estimator
    (nano_gicp_impl.hpp:385-396). Like the kd-tree version, a query point
    contained in the target set returns itself as its own 0-distance
    neighbor.

    Returns:
      (idx (Q, k) int32, sqdist (Q, k) float32), ascending by distance.
    """
    Q = query.shape[0]
    q = _pad_to_multiple(query, query_chunk, 0.0)
    t = _pad_to_multiple(target, target_chunk, 1.0e6)
    t_chunks = t.reshape(-1, target_chunk, 3)
    t_sq = jnp.sum(t_chunks * t_chunks, axis=-1)

    q_chunks = q.reshape(-1, query_chunk, 3)

    def per_query_chunk(qc):
        q_sq = jnp.sum(qc * qc, axis=-1)

        def scan_target(carry, xs):
            best_d, best_i, base = carry
            tc, tc_sq = xs
            cross = jnp.dot(qc, tc.T, precision=jax.lax.Precision.HIGHEST)
            d = q_sq[:, None] + tc_sq[None, :] - 2.0 * cross  # (C_q, C_t)
            cd, ci = jax.lax.top_k(-d, k)  # chunk-local k smallest
            cd = -cd
            ci = ci.astype(jnp.int32) + base
            # merge with carry: 2k candidates -> k best
            md = jnp.concatenate([best_d, cd], axis=1)
            mi = jnp.concatenate([best_i, ci], axis=1)
            sel_d, sel_pos = jax.lax.top_k(-md, k)
            sel_i = jnp.take_along_axis(mi, sel_pos, axis=1)
            return (-sel_d, sel_i, base + tc.shape[0]), None

        init = (
            jnp.full((query_chunk, k), _BIG, jnp.float32),
            jnp.zeros((query_chunk, k), jnp.int32),
            jnp.int32(0),
        )
        (best_d, best_i, _), _ = jax.lax.scan(scan_target, init, (t_chunks, t_sq))
        return best_i, best_d

    idx, _ = jax.lax.map(per_query_chunk, q_chunks)
    idx = idx.reshape(-1, k)[:Q]
    diff = query[:, None, :] - t[idx]  # (Q, k, 3)
    sqd = jnp.sum(diff * diff, axis=-1)
    # exact distances can reorder near-ties from the approximate merge
    order = jnp.argsort(sqd, axis=1)
    return (
        jnp.take_along_axis(idx, order, axis=1),
        jnp.take_along_axis(sqd, order, axis=1),
    )
