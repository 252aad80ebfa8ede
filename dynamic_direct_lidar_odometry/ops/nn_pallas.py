"""Block-sparse 1-NN for the GICP correspondence search, as a Pallas
kernel for the GPU (Triton route).

The GICP correspondence update needs, per linearization, the nearest
target point of every source point (``update_correspondences``,
nano_gicp_impl.hpp:235-275 — a kd-tree query per point in the
reference). The exact XLA sweep (:func:`.knn.nn1`) computes every
(query, target) pair, ~1e9 at 16k x 64k, and writes each distance tile to
device memory before reducing it. Only pairs inside the correspondence
gate matter, and point clouds arrive Morton (z-order) sorted, so a tile
of consecutive queries and a chunk of consecutive targets each occupy a
compact box:

- XLA computes per query-TILE and target-CHUNK axis-aligned boxes, tests
  them for overlap dilated by the gate radius, and turns the overlap
  mask into a per-tile ascending list of active chunk ids;
- the kernel runs one program per query tile, loops over its own list
  (dynamic trip count), loads each target chunk, and keeps the running
  (best distance, best index) per query in registers. Distances are
  computed by direct differencing (8 f32 FLOP per pair on the CUDA
  cores, no ``|q|^2+|t|^2-2qt`` cancellation; a K=3 contraction gains
  nothing from the tensor cores). No distance tile leaves the SM.

Every query whose true nearest target lies within the radius sees that
target's chunk, so the result is exact for every pair the gate keeps;
a query with nothing inside the radius reports a distance >= radius^2.

Layout: queries and targets go in structure-of-arrays form, padded to
four coordinate rows, because the Triton route needs power-of-two block
shapes. Padded rows sit at the far sentinel.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# distance of a query that swept no chunk; anything >= this loses
_BIG = np.float32(3.0e12)
# padded rows sit here (like cloud.SENTINEL), far from data
_FAR = 1.0e6

# Tile shape: the fastest of a q_tile x t_chunk x num_warps sweep over
# {32, 64, 128} x {64, 128, 256} x {2, 4, 8} at bench width (PERF.md).
Q_TILE = 32  # queries per program
T_CHUNK = 128  # targets per loop step
NUM_WARPS = 8
NUM_STAGES = 2  # Triton pipelines the next chunk's loads


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class SparseTarget(NamedTuple):
    """Loop-invariant target-side preparation: the padded SoA target and
    its per-chunk boxes. gicp.align prepares this once per registration,
    outside the LM loop, because the target never moves."""

    tt: jnp.ndarray  # (4, n_chunks * T_CHUNK) SoA target, row 3 zero
    t_lo: jnp.ndarray  # (n_chunks, 3) chunk box minima
    t_hi: jnp.ndarray  # (n_chunks, 3) chunk box maxima
    n: int  # original (unpadded) target row count, static


def _pad_rows(x: jnp.ndarray, m: int, fill) -> jnp.ndarray:
    pad = (-x.shape[0]) % m
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)), constant_values=fill)
    return x


def _soa4(x: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) -> (4, N): coordinates as rows, a zero fourth row."""
    return jnp.concatenate([x.T, jnp.zeros((1, x.shape[0]), x.dtype)])


def prepare_sparse_target(target: jnp.ndarray, t_chunk: int = T_CHUNK) -> SparseTarget:
    """Pad the target to whole chunks and compute the chunk boxes.
    Invalid target rows must already sit at the far sentinel: their
    chunks' boxes then never overlap a real query tile and are skipped,
    which is what makes a padded slot-major submap cost only its valid
    points."""
    t = _pad_rows(target, t_chunk, _FAR)
    tb = t.reshape(-1, t_chunk, 3)
    return SparseTarget(
        tt=_soa4(t), t_lo=tb.min(axis=1), t_hi=tb.max(axis=1), n=target.shape[0]
    )


def chunk_lists(overlap: jnp.ndarray):
    """(n_tiles, n_chunks) bool overlap -> (counts (n_tiles, 1), ids
    (n_tiles, L)) with each tile's active chunk ids first and ascending.
    L is n_chunks rounded up to a power of two; the tail holds 0 and is
    never read, since the kernel loops ``j < count``. Ascending order
    keeps the sequential sweep's tie rule: the earliest target wins."""
    n_tiles, n_chunks = overlap.shape
    ids = jnp.broadcast_to(jnp.arange(n_chunks, dtype=jnp.int32), overlap.shape)
    lst = jnp.sort(jnp.where(overlap, ids, jnp.int32(n_chunks)), axis=1)
    lst = jnp.where(lst < n_chunks, lst, 0)
    lst = jnp.pad(lst, ((0, 0), (0, _next_pow2(n_chunks) - n_chunks)))
    counts = jnp.sum(overlap.astype(jnp.int32), axis=1, keepdims=True)
    return counts, lst


def _nn1_sparse_kernel(cnt_ref, lst_ref, q_ref, t_ref, idx_ref, dist_ref, *, t_chunk):
    """One query tile against its active target chunks.

    cnt_ref: (1,) int32 active-chunk count   lst_ref: (L,) int32 chunk ids
    q_ref: (4, QT) SoA query tile            t_ref: (4, Tp) SoA target
    idx_ref: (QT,) int32                     dist_ref: (QT,) f32
    """
    qx = q_ref[0, :][:, None]
    qy = q_ref[1, :][:, None]
    qz = q_ref[2, :][:, None]
    qt = qx.shape[0]

    def body(j, carry):
        best_d, best_i = carry
        base = lst_ref[j] * t_chunk
        sl = pl.ds(pl.multiple_of(base, t_chunk), t_chunk)
        dx = qx - t_ref[0, sl][None, :]
        dy = qy - t_ref[1, sl][None, :]
        dz = qz - t_ref[2, sl][None, :]
        d = dx * dx + dy * dy + dz * dz  # (QT, TC)
        cd = jnp.min(d, axis=1)
        ci = jnp.argmin(d, axis=1).astype(jnp.int32) + base
        # strict <: an earlier chunk keeps a tie
        take = cd < best_d
        return jnp.where(take, cd, best_d), jnp.where(take, ci, best_i)

    init = (jnp.full((qt,), _BIG, jnp.float32), jnp.zeros((qt,), jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, cnt_ref[0], body, init)
    idx_ref[...] = best_i
    dist_ref[...] = best_d


def nn1_sparse_prepared(
    query: jnp.ndarray,
    prep: SparseTarget,
    radius: float,
    q_tile: int = Q_TILE,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Radius-pruned 1-NN against a :func:`prepare_sparse_target` result:
    (idx (Q,) int32, sqdist (Q,) f32), exact for every query whose true
    nearest target lies within ``radius``; any other query reports a
    squared distance >= radius^2. Traced inline (no jit wrapper) so that
    callers inside while loops keep the prep arrays as loop constants.

    Args:
      query: (Q, 3) f32, invalid rows at the far sentinel.
      interpret: run the kernel in the Pallas interpreter (tests on CPU).
    """
    Q = query.shape[0]
    Tp = prep.tt.shape[1]
    n_chunks = prep.t_lo.shape[0]
    t_chunk = Tp // n_chunks

    q = _pad_rows(query, q_tile, _FAR)
    Qp = q.shape[0]
    n_tiles = Qp // q_tile

    # Tile boxes and the dilated overlap test. Sentinel rows (masked
    # points and padding) are left out of the boxes, so an all-sentinel
    # tile gets an empty box and sweeps nothing.
    qb = q.reshape(n_tiles, q_tile, 3)
    q_real = jnp.all(qb < 0.5 * _FAR, axis=-1, keepdims=True)
    q_lo = jnp.min(jnp.where(q_real, qb, jnp.inf), axis=1)
    q_hi = jnp.max(jnp.where(q_real, qb, -jnp.inf), axis=1)
    overlap = jnp.all(
        (q_lo[:, None, :] - radius <= prep.t_hi[None, :, :])
        & (q_hi[:, None, :] + radius >= prep.t_lo[None, :, :]),
        axis=-1,
    )
    counts, lst = chunk_lists(overlap)
    L = lst.shape[1]

    idx, dist = pl.pallas_call(
        partial(_nn1_sparse_kernel, t_chunk=t_chunk),
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((None, 1), lambda i: (i, 0)),
            pl.BlockSpec((None, L), lambda i: (i, 0)),
            pl.BlockSpec((4, q_tile), lambda i: (0, i)),
            pl.BlockSpec((4, Tp), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((q_tile,), lambda i: (i,)),
            pl.BlockSpec((q_tile,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Qp,), jnp.int32),
            jax.ShapeDtypeStruct((Qp,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="ddlo_nn1_sparse",
    )(counts, lst, _soa4(q), prep.tt)

    idx = jnp.minimum(idx[:Q], prep.n - 1)
    return idx, dist[:Q]


@partial(
    jax.jit, static_argnames=("radius", "q_tile", "t_chunk", "interpret")
)
def nn1_sparse_pallas(
    query: jnp.ndarray,
    target: jnp.ndarray,
    radius: float,
    q_tile: int = Q_TILE,
    t_chunk: int = T_CHUNK,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Standalone form of :func:`nn1_sparse_prepared` (prep included).
    A radius larger than the clouds' extent makes every chunk active,
    which turns it into an exact dense 1-NN."""
    return nn1_sparse_prepared(
        query, prepare_sparse_target(target, t_chunk), radius, q_tile,
        interpret=interpret,
    )
