"""Point-cloud preprocessing filters with static shapes.

Static-shape equivalents of the PCL filter chain in
``OdomNode::preprocessPoints`` (odom.cc:442-478) and its setup
(odom.cc:114-131):

- row/col downsampling of an organized cloud  -> index mask,
- negative crop box around the sensor         -> predicate mask,
- voxel-grid centroid downsampling            -> lexsort + segment-mean.

PCL filters physically shrink the cloud; here every filter returns the same
fixed-capacity buffers with an updated validity mask (or, for the voxel
grid, a new fixed-capacity cloud of per-voxel centroids). This keeps every
shape static under ``jit`` and makes the whole chain `vmap`-able.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.core.cloud import SENTINEL


def rowcol_downsample_mask(
    H: int, W: int, row_step: int, col_step: int
) -> jnp.ndarray:
    """Keep-every-(row_step, col_step) mask over an organized H x W cloud.

    Matches the index mask built at odom.cc:124-130 (ExtractIndices with
    keepOrganized=true -> here simply a boolean mask over the H*W buffer).
    """
    rows = (jnp.arange(H) % row_step) == 0
    cols = (jnp.arange(W) % col_step) == 0
    return (rows[:, None] & cols[None, :]).reshape(-1)


def decimate(points, mask, H: int, W: int, row_step: int, col_step: int):
    """Row/col decimation of an organized cloud, preferring a STATIC
    strided slice over masking.

    The decimation pattern (keep rows r%row_step==0, cols c%col_step==0
    — exactly :func:`rowcol_downsample_mask`) is static, so when the
    buffer is organized (H*W rows) the dead rows are SLICED out of the
    buffer: every downstream sort/scan shrinks row_step*col_step-fold
    (10x at the DOALS col=10 preset — the 131k voxel argsort was the
    preprocess and keyframe-add hot spot). Valid points keep their
    relative order, so the stable Morton sort groups and sums
    bit-identically to the masked form. Falls back to masking when the
    buffer is not the full organized image. Shared by preprocess, the
    pipeline's keyframe re-filter, and tools/attribute_bench's probe —
    one definition, so the attribution cannot drift from the pipeline.

    Returns (points, mask) — possibly smaller arrays.
    """
    if (row_step > 1 or col_step > 1) and points.shape[0] == H * W:
        pts = points.reshape(H, W, -1)[::row_step, ::col_step]
        return (
            pts.reshape(-1, points.shape[-1]),
            mask.reshape(H, W)[::row_step, ::col_step].reshape(-1),
        )
    return points, mask & rowcol_downsample_mask(H, W, row_step, col_step)


@jax.jit
def crop_box_mask(
    points: jnp.ndarray,
    size: float | jnp.ndarray,
    translation: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Negative crop box: True for points OUTSIDE [-size, size]^3 (+trans).

    pcl::CropBox with setNegative(true) (odom.cc:114-119); the second crop
    instance is translated to the current pose because its input cloud is
    world-frame (odom.cc:909-912).
    """
    p = points if translation is None else points - translation
    inside = jnp.all(jnp.abs(p) <= size, axis=-1)
    return ~inside


@partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    res: float | jnp.ndarray,
    capacity: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Voxel-grid filter: one centroid per occupied voxel.

    Same semantics as pcl::VoxelGrid (odom.cc:121-122, used at
    odom.cc:469-475): points are binned at resolution ``res`` and each
    occupied voxel contributes the centroid of its points. Output order is
    lexicographic in voxel coordinates (PCL's order differs; no consumer
    depends on order).

    Implementation: integer voxel coords -> ``lexsort`` -> group-id by
    change flags -> ``segment_sum`` centroid. All static shapes; voxels
    beyond ``capacity`` are dropped (count the mask if that matters).

    Returns:
      (out_points (capacity, 3) with invalid rows at SENTINEL,
       out_mask (capacity,) bool)
    """
    # ONE argsort on a 30-bit MORTON (z-order) key instead of a 3-key
    # lexsort. Group boundaries still compare the exact integer voxel
    # coords, so a key collision can only SPLIT a voxel into extra
    # centroids (if two colliding voxels interleave in the tie-order) —
    # never merge distant points into a phantom centroid.
    #
    # Morton order (vs the round-2 murmur hash key, which was spatially
    # RANDOM) makes consecutive output points spatially local, so the
    # fixed-size point chunks the block-sparse NN kernel AABB-prunes over
    # (ops/nn_pallas.py) are tight boxes instead of whole-cloud spans —
    # this ordering is what makes the pruning actually skip work.
    big = jnp.int32(2**30)
    ik = jnp.floor(points / res).astype(jnp.int32)
    ik = jnp.where(mask[:, None], ik, big)  # invalid rows: distinct group

    # 10 bits per axis, biased by +512: voxels within +-512 cells of the
    # origin get unique interleaved keys; coords outside clamp (their key
    # collides but exact-coord grouping still splits them correctly —
    # only the ordering quality degrades out there).
    u = jnp.clip(ik + 512, 0, 1023).astype(jnp.uint32)

    def spread3(v):  # spread 10 bits so consecutive bits are 3 apart
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    key = (spread3(u[:, 0]) << 2) | (spread3(u[:, 1]) << 1) | spread3(u[:, 2])
    key = jnp.where(mask, key, jnp.uint32(0xFFFFFFFF))  # invalid sort last

    order = jnp.argsort(key)
    iks = ik[order]
    ps = points[order]
    ms = mask[order]

    prev = jnp.concatenate([iks[:1] - 1, iks[:-1]], axis=0)
    new_group = jnp.any(iks != prev, axis=1)
    gid = jnp.cumsum(new_group) - 1  # 0-based group id in sorted order
    # groups beyond capacity (and the invalid-sentinel group) overflow into
    # the scratch slot `capacity`
    gid = jnp.where((gid < capacity) & ms, gid, capacity)

    w = ms.astype(points.dtype)
    sums = jax.ops.segment_sum(ps * w[:, None], gid, num_segments=capacity + 1)
    cnts = jax.ops.segment_sum(w, gid, num_segments=capacity + 1)
    sums, cnts = sums[:capacity], cnts[:capacity]

    out_mask = cnts > 0
    out = sums / jnp.maximum(cnts, 1.0)[:, None]
    out = jnp.where(out_mask[:, None], out, SENTINEL)
    return out, out_mask


@partial(jax.jit, static_argnames=("capacity",))
def compact(
    points: jnp.ndarray, mask: jnp.ndarray, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack valid points to the front of a ``capacity``-sized buffer.

    The masked-buffer analogue of PCL's physical shrmoving; useful before
    handing a heavily-masked cloud to the NN sweep so padded work is
    bounded by ``capacity`` instead of the source buffer size.
    """
    n = points.shape[0]
    # stable partition: valid points keep relative order
    key = jnp.where(mask, 0, 1)
    order = jnp.argsort(key, stable=True)
    ps = points[order][:capacity]
    ms = mask[order][:capacity]
    ps = jnp.where(ms[:, None], ps, SENTINEL)
    if capacity > n:
        ps = jnp.pad(ps, ((0, capacity - n), (0, 0)), constant_values=SENTINEL)
        ms = jnp.pad(ms, (0, capacity - n))
    return ps, ms
