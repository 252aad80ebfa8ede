"""Assignment + OBB IoU oracles.

- hungarian.solve/assign vs scipy.optimize.linear_sum_assignment
  (the reference's Munkres port, src/tracking/hungarian.cpp, is also
  optimal, so costs must agree exactly),
- obb_iou (bbox_iou.h:129-155) vs a rasterized intersection oracle and
  axis-aligned analytic cases.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dynamic_direct_lidar_odometry.ops import bbox as bbox_ops
from dynamic_direct_lidar_odometry.ops import hungarian


@pytest.mark.parametrize("n,m,seed", [(5, 5, 0), (8, 8, 1), (3, 7, 2), (7, 3, 3)])
def test_hungarian_matches_scipy(n, m, seed):
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 10, (n, m)).astype(np.float32)
    col = np.asarray(
        hungarian.assign(
            jnp.asarray(cost), jnp.ones(n, bool), jnp.ones(m, bool)
        )
    )
    ri, ci = linear_sum_assignment(cost)
    # optimal total cost must match (assignments may differ on ties)
    ours = sum(cost[r, c] for r, c in enumerate(col) if c >= 0)
    theirs = cost[ri, ci].sum()
    # rectangular: ours assigns min(n, m) pairs like scipy
    assert (col >= 0).sum() == min(n, m)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_hungarian_respects_masks():
    rng = np.random.default_rng(4)
    cost = rng.uniform(0, 1, (6, 6)).astype(np.float32)
    rv = np.array([True, True, False, True, False, True])
    cv = np.array([True, False, True, True, True, False])
    col = np.asarray(
        hungarian.assign(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv))
    )
    assert np.all(col[~rv] == -1)
    for r, c in enumerate(col):
        if c >= 0:
            assert cv[c]
    used = [c for c in col if c >= 0]
    assert len(used) == len(set(used))  # one row per column


def _raster_iou(b1, b2, res=0.02):
    """Monte-Carlo-free rasterized IoU oracle using the same quirk as the
    reference: state[3] is used directly as the rotation angle."""

    def corners(b):
        cx, cy, r, w, h = b[0], b[1], b[3], b[4], b[5]
        R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]])
        d = np.array(
            [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
        )
        return d @ R.T + [cx, cy]

    c1, c2 = corners(b1), corners(b2)
    lo = np.minimum(c1.min(0), c2.min(0)) - res
    hi = np.maximum(c1.max(0), c2.max(0)) + res
    xs = np.arange(lo[0], hi[0], res)
    ys = np.arange(lo[1], hi[1], res)
    X, Y = np.meshgrid(xs, ys)
    P = np.stack([X.ravel(), Y.ravel()], -1)

    def inside(b, P):
        cx, cy, r = b[0], b[1], b[3]
        R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]])
        q = (P - [cx, cy]) @ R  # world -> box frame
        return (np.abs(q[:, 0]) <= b[4] / 2) & (np.abs(q[:, 1]) <= b[5] / 2)

    i1, i2 = inside(b1, P), inside(b2, P)
    inter_area = (i1 & i2).sum() * res * res
    z1 = (b1[2] - b1[6] / 2, b1[2] + b1[6] / 2)
    z2 = (b2[2] - b2[6] / 2, b2[2] + b2[6] / 2)
    hov = max(0.0, min(z1[1], z2[1]) - max(z1[0], z2[0]))
    iv = inter_area * hov
    tot = b1[4] * b1[5] * b1[6] + b2[4] * b2[5] * b2[6] - iv
    return max(iv / tot, 0.0)


def test_obb_iou_identical_box():
    b = jnp.asarray([1.0, 2.0, 0.5, 0.3, 2.0, 1.0, 1.5])
    assert abs(float(bbox_ops.obb_iou(b, b)) - 1.0) < 1e-5


def test_obb_iou_disjoint():
    b1 = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    b2 = jnp.asarray([5.0, 5.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    assert float(bbox_ops.obb_iou(b1, b2)) == 0.0


def test_obb_iou_axis_aligned_half_overlap():
    # two unit boxes offset by 0.5 in x: inter 0.5, union 1.5 -> 1/3
    b1 = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    b2 = jnp.asarray([0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    np.testing.assert_allclose(float(bbox_ops.obb_iou(b1, b2)), 1 / 3, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_obb_iou_rotated_vs_raster_oracle(seed):
    rng = np.random.default_rng(seed)
    b1 = np.array(
        [0, 0, 0, rng.uniform(-0.8, 0.8), rng.uniform(0.5, 2),
         rng.uniform(0.5, 2), rng.uniform(0.5, 2)]
    )
    b2 = np.array(
        [rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-0.4, 0.4),
         rng.uniform(-0.8, 0.8), rng.uniform(0.5, 2), rng.uniform(0.5, 2),
         rng.uniform(0.5, 2)]
    )
    got = float(bbox_ops.obb_iou(jnp.asarray(b1), jnp.asarray(b2)))
    want = _raster_iou(b1, b2)
    np.testing.assert_allclose(got, want, atol=0.02)


def _random_boxes(rng, n, spread=8.0):
    return np.stack(
        [
            rng.uniform(-spread, spread, n),  # cx
            rng.uniform(-spread, spread, n),  # cy
            rng.uniform(-1, 1, n),  # cz
            rng.uniform(-0.8, 0.8, n),  # sin(yaw/2) quirk angle
            rng.uniform(0.3, 2.5, n),  # l
            rng.uniform(0.3, 2.5, n),  # w
            rng.uniform(0.3, 2.5, n),  # h
        ],
        axis=-1,
    ).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_iou_matches_dense(seed):
    """Gated matrix == dense matrix on valid pairs, 0 elsewhere: the
    z-extent + circumradius gates are NECESSARY conditions for overlap,
    so with a non-binding budget nothing with IoU > 0 is dropped."""
    rng = np.random.default_rng(seed)
    D, T = 24, 20
    dets = _random_boxes(rng, D)
    trks = _random_boxes(rng, T)
    dv = rng.uniform(size=D) > 0.3
    tv = rng.uniform(size=T) > 0.3
    dense = np.asarray(bbox_ops.obb_iou_matrix(jnp.asarray(dets), jnp.asarray(trks)))
    gated = np.asarray(
        bbox_ops.obb_iou_matrix_gated(
            jnp.asarray(dets), jnp.asarray(trks),
            jnp.asarray(dv), jnp.asarray(tv), budget=D * T,
        )
    )
    valid = dv[:, None] & tv[None, :]
    np.testing.assert_allclose(gated[valid], dense[valid], atol=1e-6)
    assert np.all(gated[~valid] == 0.0)


def test_gated_iou_budget_prefers_closest_pairs():
    """Over budget, the farthest gate-surviving pairs degrade to IoU 0;
    the closest pairs keep their exact value."""
    rng = np.random.default_rng(7)
    D = T = 12
    # one tight cluster -> every pair passes the gate
    dets = _random_boxes(rng, D, spread=0.5)
    trks = _random_boxes(rng, T, spread=0.5)
    dv = np.ones(D, bool)
    tv = np.ones(T, bool)
    dense = np.asarray(bbox_ops.obb_iou_matrix(jnp.asarray(dets), jnp.asarray(trks)))
    B = 16
    gated = np.asarray(
        bbox_ops.obb_iou_matrix_gated(
            jnp.asarray(dets), jnp.asarray(trks),
            jnp.asarray(dv), jnp.asarray(tv), budget=B,
        )
    )
    # reproduce the gate: budget selection ranks only gate SURVIVORS
    dz = np.abs(dets[:, None, 2] - trks[None, :, 2])
    z_ok = dz < 0.5 * (dets[:, None, 6] + trks[None, :, 6])
    dxy = np.linalg.norm(dets[:, None, :2] - trks[None, :, :2], axis=-1)
    rad = lambda b: 0.5 * np.linalg.norm(b[:, 4:6], axis=-1)
    xy_ok = dxy <= rad(dets)[:, None] + rad(trks)[None, :]
    gate = (z_ok & xy_ok).reshape(-1)
    dxy_flat = np.where(gate, dxy.reshape(-1), np.inf)
    kept = np.argsort(dxy_flat)[:B]
    kept = kept[np.isfinite(dxy_flat[kept])]
    assert gate.sum() > B  # the budget actually binds in this scene
    flat_dense = dense.reshape(-1)
    flat_gated = gated.reshape(-1)
    np.testing.assert_allclose(flat_gated[kept], flat_dense[kept], atol=1e-6)
    dropped = np.setdiff1d(np.arange(D * T), kept)
    assert np.all(flat_gated[dropped] == 0.0)
