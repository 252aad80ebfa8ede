import numpy as np
import pytest

import jax.numpy as jnp

from dynamic_direct_lidar_odometry.io import synthetic
from dynamic_direct_lidar_odometry.ops import bbox, projection, segmentation


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


def bfs_components_oracle(ranges, eligible, theta, ang_x_deg, ang_y_deg):
    """NumPy BFS reproducing labelComponents' connectivity
    (detection.cpp:544-657): 4-neighbors, column wraparound, predicate
    atan2(d2 sin a, d1 - d2 cos a) > theta."""
    H, W = ranges.shape
    labels = -np.ones((H, W), np.int64)
    sx, cx = np.sin(np.deg2rad(ang_x_deg)), np.cos(np.deg2rad(ang_x_deg))
    sy, cy = np.sin(np.deg2rad(ang_y_deg)), np.cos(np.deg2rad(ang_y_deg))
    comp = 0
    for r0 in range(H):
        for c0 in range(W):
            if not eligible[r0, c0] or labels[r0, c0] >= 0:
                continue
            stack = [(r0, c0)]
            labels[r0, c0] = comp
            while stack:
                r, c = stack.pop()
                for dr, dc, s, co in ((-1, 0, sy, cy), (1, 0, sy, cy),
                                      (0, -1, sx, cx), (0, 1, sx, cx)):
                    rr, cc = r + dr, (c + dc) % W
                    if rr < 0 or rr >= H or not eligible[rr, cc]:
                        continue
                    if labels[rr, cc] >= 0:
                        continue
                    d1 = max(ranges[r, c], ranges[rr, cc])
                    d2 = min(ranges[r, c], ranges[rr, cc])
                    if np.arctan2(d2 * s, d1 - d2 * co) > theta:
                        labels[rr, cc] = comp
                        stack.append((rr, cc))
            comp += 1
    return labels


def partitions_equal(a, b, mask):
    """Compare two labelings up to renaming on masked pixels."""
    a, b = a[mask], b[mask]
    fa = {}
    fb = {}
    for x, y in zip(a.tolist(), b.tolist()):
        if x in fa and fa[x] != y:
            return False
        if y in fb and fb[y] != x:
            return False
        fa[x] = y
        fb[y] = x
    return True


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------


def test_project_organized_ranges():
    H, W = 16, 64
    world = synthetic.World.town(seed=1, n_static=4)
    T = np.eye(4)
    T[:3, 3] = [0, 0, 1.4]
    pts, mask = synthetic.render_scan(world, T, H=H, W=W, noise=0.0)
    ri = projection.project_organized(
        jnp.asarray(np.nan_to_num(pts)), jnp.asarray(mask),
        jnp.asarray(T[:3, 3], jnp.float32) * 0 + jnp.asarray([0.0, 0, 0]),
        H, W, minimum_range=1.0,
    )
    # points are in sensor frame here, so origin = 0
    rng_ref = np.linalg.norm(np.nan_to_num(pts), axis=1).reshape(H, W)
    got = np.asarray(ri.ranges)
    ok = np.asarray(ri.valid)
    np.testing.assert_allclose(got[ok], rng_ref[ok], rtol=1e-5)
    assert not ok[rng_ref < 1.0].any()


def test_project_residuals_spherical_roundtrip():
    H, W = 16, 64
    # single point straight ahead on ring axis
    pts = np.array([[5.0, 0.0, 0.0]], np.float32)
    res = np.array([0.7], np.float32)
    img = projection.project_residuals(
        jnp.asarray(pts), jnp.asarray(res), jnp.ones(1, bool), H, W, ang_bottom=16.6
    )
    img = np.asarray(img)
    assert img.max() == np.float32(0.7)
    assert (img > 0).sum() == 1


# ---------------------------------------------------------------------------
# ground removal
# ---------------------------------------------------------------------------


def test_ground_removal_flat_world():
    H, W = 32, 128
    world = synthetic.World(boxes=[synthetic.Box(np.array([8.0, 0, 1.0]),
                                                 np.array([2.0, 2.0, 2.0]))])
    T = np.eye(4)
    T[:3, 3] = [0, 0, 1.4]
    pts, mask = synthetic.render_scan(world, T, H=H, W=W, noise=0.0)
    ri = projection.project_organized(
        jnp.asarray(np.nan_to_num(pts)), jnp.asarray(mask),
        jnp.zeros(3), H, W, minimum_range=0.5,
    )
    g = segmentation.ground_removal(
        ri.points, ri.valid, ri.ranges,
        ground_rows=24, sensor_mount_angle=0.0, ground_angle_threshold=10.0,
    )
    gm = np.asarray(g.ground)
    # sensor-frame z: ground plane sits at z = -1.4 (sensor height)
    pz = np.nan_to_num(pts).reshape(H, W, 3)[..., 2]
    valid = np.asarray(ri.valid)
    ground_truth = valid & (np.abs(pz + 1.4) < 0.05)
    rows = np.arange(H)[:, None] >= H - 24
    # nearly all true ground pixels in the band are marked
    tp = (gm == 1) & ground_truth & rows
    recall = tp.sum() / max((ground_truth & rows).sum(), 1)
    assert recall > 0.9, recall
    # the box's vertical face (world z > 0.5) must NOT be marked ground
    box_face = valid & (pz > -0.9)
    assert ((gm == 1) & box_face).sum() == 0


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


def _two_blob_image(H=24, W=96):
    """Range image: far background + two near blobs."""
    ranges = np.full((H, W), 20.0, np.float32)
    ranges[6:14, 10:22] = 5.0
    ranges[4:20, 50:70] = 8.0
    eligible = np.ones((H, W), bool)
    return ranges, eligible


def test_label_components_matches_bfs_oracle():
    ranges, eligible = _two_blob_image()
    theta, ax, ay = 0.25, 360.0 / 96, 2 * 45.0 / 23
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay
    )
    got = np.asarray(res.labels)
    ref = bfs_components_oracle(ranges, eligible, theta, ax, ay)
    assert partitions_equal(got, ref, eligible)
    # the two blobs are distinct components
    assert got[8, 12] != got[8, 55]
    assert got[8, 12] == got[13, 21]


def test_label_components_wraps_columns():
    H, W = 8, 32
    ranges = np.full((H, W), 20.0, np.float32)
    ranges[2:6, :4] = 5.0
    ranges[2:6, -4:] = 5.0  # same object across the seam
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(np.ones((H, W), bool)),
        0.25, 360.0 / W, 2 * 45.0 / (H - 1),
    )
    got = np.asarray(res.labels)
    assert got[3, 0] == got[3, W - 1]


def test_segment_stats_gates():
    ranges, eligible = _two_blob_image()
    H, W = ranges.shape
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay
    )
    # fake world points: z from row index so delta-z gates pass for blobs
    zz = np.linspace(2.0, 0.0, H)[:, None].repeat(W, 1)
    pts = np.stack([ranges, np.zeros_like(ranges), zz], axis=-1)
    stats = segmentation.segment_stats(
        res.labels, jnp.asarray(ranges), jnp.asarray(pts),
        jnp.zeros((H, W)), jnp.float32(0.0),
        min_line_num=3, valid_point_num=10, valid_line_num=3,
        max_distance=10.0, min_delta_z=0.2, max_delta_z=4.0, max_elevation=3.0,
    )
    labels = np.asarray(res.labels)
    feas = np.asarray(stats.feasible)
    sizes = np.asarray(stats.size)
    blob1, blob2 = labels[8, 12], labels[8, 55]
    bg = labels[0, 0]
    assert feas[blob1] and feas[blob2]
    assert not feas[bg]  # max_dist 20 > 10
    assert sizes[blob1] == 8 * 12
    assert np.asarray(stats.line_count)[blob1] == 8

    roots, valid, pixel_slot = segmentation.compact_segments(
        res.labels, stats, max_objects=4
    )
    assert int(valid.sum()) == 2
    ps = np.asarray(pixel_slot)
    assert ps[8, 55] >= 0 and ps[8, 12] >= 0 and ps[0, 0] == -1
    # slot 0 = biggest (blob2: 16x20)
    assert ps[8, 55] == 0



def _stats_kwargs():
    return dict(
        min_line_num=3, valid_point_num=10, valid_line_num=3,
        max_distance=10.0, min_delta_z=0.2, max_delta_z=4.0,
        max_elevation=3.0,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_objects_matches_exact_path(seed):
    """The fused candidate-dense path (segment_objects) must reproduce
    segment_stats + compact_segments bit-for-bit whenever the candidate
    budget is not binding (its documented equivalence condition)."""
    rng = np.random.default_rng(seed)
    H, W = 24, 96
    # random blobby range image: smooth background + several near patches
    ranges = np.full((H, W), 20.0, np.float32)
    for _ in range(8):
        r0 = rng.integers(0, H - 6)
        c0 = rng.integers(0, W - 10)
        h = rng.integers(3, 7)
        w = rng.integers(4, 11)
        ranges[r0 : r0 + h, c0 : c0 + w] = rng.uniform(3.0, 8.0)
    eligible = np.ones((H, W), bool)
    eligible[rng.uniform(size=(H, W)) < 0.05] = False
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay
    )
    zz = np.linspace(2.0, 0.0, H)[:, None].repeat(W, 1).astype(np.float32)
    pts = np.stack([ranges, np.zeros_like(ranges), zz], axis=-1)
    res_img = (rng.uniform(size=(H, W)) < 0.3) * rng.uniform(
        0.0, 0.5, (H, W)
    ).astype(np.float32)
    kw = _stats_kwargs()

    stats = segmentation.segment_stats(
        res.labels, jnp.asarray(ranges), jnp.asarray(pts),
        jnp.asarray(res_img), jnp.float32(0.0), **kw,
    )
    roots_e, valid_e, ps_e = segmentation.compact_segments(
        res.labels, stats, max_objects=6
    )
    avg_e = np.asarray(stats.avg_residuum)[
        np.clip(np.asarray(roots_e), 0, H * W - 1)
    ] * np.asarray(valid_e)

    roots_f, valid_f, ps_f, avg_f = segmentation.segment_objects(
        res.labels, jnp.asarray(ranges), jnp.asarray(pts),
        jnp.asarray(res_img), jnp.float32(0.0), **kw,
        max_objects=6, candidates=64,
    )

    np.testing.assert_array_equal(np.asarray(valid_f), np.asarray(valid_e))
    np.testing.assert_array_equal(np.asarray(roots_f), np.asarray(roots_e))
    np.testing.assert_array_equal(np.asarray(ps_f), np.asarray(ps_e))
    np.testing.assert_allclose(np.asarray(avg_f), avg_e, atol=1e-6)


# ---------------------------------------------------------------------------
# bboxes
# ---------------------------------------------------------------------------


def test_pca_bbox_recovers_rotated_box():
    rng = np.random.default_rng(0)
    H, W = 1, 4096
    yaw = 0.5
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    local = np.column_stack(
        [rng.uniform(-2, 2, H * W), rng.uniform(-0.5, 0.5, H * W)]
    )
    xy = local @ R.T + np.array([4.0, -1.0])
    z = rng.uniform(0.0, 1.5, H * W)
    pts = np.column_stack([xy, z]).astype(np.float32).reshape(H, W, 3)
    pixel_slot = np.zeros((H, W), np.int32)

    objs = bbox.pca_bboxes(
        jnp.asarray(pts), jnp.asarray(pixel_slot),
        jnp.asarray([True] + [False] * 3),
        jnp.zeros(4), max_objects=4, max_dim_ratio=10.0,
    )
    st = np.asarray(objs.state)[0]
    assert bool(objs.valid[0])
    np.testing.assert_allclose(st[:2], [4.0, -1.0], atol=0.05)
    np.testing.assert_allclose(st[2], 0.75, atol=0.05)
    dims = np.sort(st[4:7])
    np.testing.assert_allclose(dims, [1.0, 1.5, 4.0], atol=0.05)
    # recovered yaw matches +-pi/2 ambiguity (PCA axis order/sign)
    got_yaw = 2 * np.arcsin(np.clip(st[3], -1, 1))
    ang = np.arctan2(np.sin(got_yaw - yaw), np.cos(got_yaw - yaw))
    assert min(abs(ang), abs(abs(ang) - np.pi / 2), abs(abs(ang) - np.pi)) < 0.1


def test_pca_bbox_dim_ratio_gate():
    # a thin line: ratio largest/2nd-largest >> 10 -> rejected
    n = 512
    pts = np.zeros((1, n, 3), np.float32)
    pts[0, :, 0] = np.linspace(0, 20, n)
    pts[0, :, 2] = np.linspace(0, 0.1, n)
    objs = bbox.pca_bboxes(
        jnp.asarray(pts), jnp.zeros((1, n), jnp.int32),
        jnp.asarray([True]), jnp.zeros(1), max_objects=1, max_dim_ratio=10.0,
    )
    assert not bool(objs.valid[0])


def test_obb_iou_axis_aligned():
    # identical boxes
    b = jnp.asarray([0.0, 0, 1.0, 0.0, 2.0, 2.0, 2.0])
    np.testing.assert_allclose(float(bbox.obb_iou(b, b)), 1.0, atol=1e-5)
    # half-overlapping (shift x by 1): inter 1*2*2=4, union 8+8-4=12
    b2 = jnp.asarray([1.0, 0, 1.0, 0.0, 2.0, 2.0, 2.0])
    np.testing.assert_allclose(float(bbox.obb_iou(b, b2)), 4 / 12, atol=1e-5)
    # disjoint
    b3 = jnp.asarray([10.0, 0, 1.0, 0.0, 2.0, 2.0, 2.0])
    np.testing.assert_allclose(float(bbox.obb_iou(b, b3)), 0.0, atol=1e-6)
    # z-disjoint
    b4 = jnp.asarray([0.0, 0, 5.0, 0.0, 2.0, 2.0, 2.0])
    np.testing.assert_allclose(float(bbox.obb_iou(b, b4)), 0.0, atol=1e-6)


def test_obb_iou_rotated():
    # 45-degree rotated square vs axis-aligned: known analytic overlap
    # (reference quirk: angle slot holds the raw value, used as radians)
    a = jnp.asarray([0.0, 0, 1.0, 0.0, 2.0, 2.0, 2.0])
    b = jnp.asarray([0.0, 0, 1.0, np.pi / 4, 2.0, 2.0, 2.0])
    # square rotated 45 deg inside same square: intersection is a regular
    # octagon with area 8*(sqrt(2)-1) = 3.3137; union = 8-... volumes x2
    inter = 8 * (np.sqrt(2) - 1) * 2.0
    union = 8.0 + 8.0 - inter
    np.testing.assert_allclose(float(bbox.obb_iou(a, b)), inter / union, atol=1e-3)


def test_obb_iou_matrix_shape():
    boxes1 = jnp.asarray(np.random.default_rng(1).uniform(0, 3, (5, 7)))
    boxes2 = jnp.asarray(np.random.default_rng(2).uniform(0, 3, (4, 7)))
    m = bbox.obb_iou_matrix(boxes1, boxes2)
    assert m.shape == (5, 4)
    assert bool((m >= 0).all() and (m <= 1).all())


def test_label_components_snake_pattern_converges():
    """A serpentine component (worst case for row/col sweep convergence:
    one sweep per turn) must still resolve to one component id."""
    H, W = 24, 96
    ranges = np.full((H, W), 20.0, np.float32)
    eligible = np.zeros((H, W), bool)
    # build a connected snake: alternating full rows joined at the ends
    for k, r in enumerate(range(2, 20, 3)):
        ranges[r, 4:92] = 5.0
        eligible[r, 4:92] = True
        if k % 2 == 0:
            ranges[r : r + 4, 91] = 5.0
            eligible[r : r + 4, 91] = True
        else:
            ranges[r : r + 4, 4] = 5.0
            eligible[r : r + 4, 4] = True
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay
    )
    got = np.asarray(res.labels)
    ids = np.unique(got[eligible & (got >= 0)])
    # contiguous equal-range snake = a single component
    assert len(ids) == 1, ids


def test_label_components_random_matches_oracle():
    rng = np.random.default_rng(3)
    H, W = 16, 64
    ranges = rng.uniform(3.0, 25.0, (H, W)).astype(np.float32)
    # smooth patches so the angle predicate creates non-trivial regions
    ranges[4:12, 8:30] = 6.0 + rng.normal(0, 0.01, (8, 22))
    ranges[2:10, 40:60] = 12.0 + rng.normal(0, 0.01, (8, 20))
    eligible = rng.random((H, W)) < 0.9
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    res = segmentation.label_components(
        jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay
    )
    got = np.asarray(res.labels)
    ref = bfs_components_oracle(ranges, eligible, theta, ax, ay)
    assert partitions_equal(got, ref, eligible)
