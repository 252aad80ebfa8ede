"""Spherical (upstream LiDAR) projection-mode coverage.

The fork hardcodes organized row-major indexing (detection.cpp:300-329)
and keeps the upstream spherical-angle path only as commented-out code
(detection.cpp:330-367). The framework implements BOTH; this module
pins the spherical path:

- row/col parity of ops.projection.lidar_grid_rowcol against a float64
  NumPy transcription of the upstream formula (detection.cpp:344-356
  with ang_res definitions from detection.cpp:82-83),
- a golden trajectory replay with detection.organized=False (the same
  regression net the organized mode has in test_golden.py).
"""

import os

import numpy as np
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.ops import projection

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "spherical_32x512_seed7.npz"
)


def _reference_rowcol(pts: np.ndarray, H: int, W: int, ang_bottom: float):
    """detection.cpp:344-356, float64, verbatim semantics."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    ang_res_x = 360.0 / float(W)  # detection.cpp:82
    ang_res_y = 2.0 * ang_bottom / float(H - 1)  # detection.cpp:83
    v_angle = np.arctan2(z, np.sqrt(x * x + y * y)) * 180.0 / np.pi
    row = (H - (v_angle + ang_bottom) / ang_res_y).astype(np.int64)
    in_fov = (row >= 0) & (row < H)
    h_angle = np.arctan2(x, y) * 180.0 / np.pi
    col = np.round(h_angle / ang_res_x).astype(np.int64)
    col = np.where(col >= W, col - W, col)
    col = np.where(col < 0, col + W, col)
    return row, col, in_fov


def test_lidar_grid_rowcol_matches_reference_formula():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    H, W, ang_bottom = 64, 2048, 17.0

    r_ref, c_ref, fov_ref = _reference_rowcol(
        pts.astype(np.float64), H, W, ang_bottom
    )
    r, c, fov = projection.lidar_grid_rowcol(
        jnp.asarray(pts), H, W, ang_bottom
    )
    r, c, fov = np.asarray(r), np.asarray(c), np.asarray(fov)

    # f32 vs f64 angle math can flip points sitting exactly on a cell
    # boundary; require bit-parity for everything off-boundary (the
    # boundary set is measure-zero and < 0.5 % of random draws)
    ang_res_y = 2.0 * ang_bottom / (H - 1)
    v = np.degrees(np.arctan2(pts[:, 2].astype(np.float64),
                              np.hypot(pts[:, 0], pts[:, 1])))
    frac_r = np.abs((H - (v + ang_bottom) / ang_res_y) % 1.0 - 0.5)
    h = np.degrees(np.arctan2(pts[:, 0].astype(np.float64),
                              pts[:, 1].astype(np.float64)))
    frac_c = np.abs((h / (360.0 / W) + 0.5) % 1.0 - 0.5)
    off_boundary = (frac_r > 1e-3) & (frac_c > 1e-3)
    assert off_boundary.mean() > 0.99

    np.testing.assert_array_equal(fov[off_boundary], fov_ref[off_boundary])
    sel = off_boundary & fov_ref
    np.testing.assert_array_equal(r[sel], r_ref[sel])
    np.testing.assert_array_equal(c[sel], c_ref[sel])


def test_spherical_projection_roundtrip():
    """Points projected on the spherical grid land in cells whose
    re-centred angles reproduce the point direction (detection's
    neighbor-angle segmentation assumes this grid geometry)."""
    rng = np.random.default_rng(3)
    n = 512
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    mask = np.ones((n,), bool)
    H, W, ang_bottom = 32, 512, 17.0
    img = projection.project_spherical(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
        jnp.zeros((3,)), H, W, ang_bottom, minimum_range=1.0,
    )
    valid = np.asarray(img.valid)
    ranges = np.asarray(img.ranges)
    pts_img = np.asarray(img.points)
    # every valid cell's stored point has the stored range
    got = np.linalg.norm(pts_img[valid], axis=-1)
    np.testing.assert_allclose(got, ranges[valid], rtol=1e-5)
    # point_index maps back into the source cloud
    idx = np.asarray(img.point_index)
    sel = idx[valid]
    assert np.all(sel >= 0) and np.all(sel < n)
    np.testing.assert_allclose(pts[sel], pts_img[valid], rtol=1e-6)


def test_spherical_golden_trajectory():
    from golden_scenes import golden_trajectory

    got = golden_trajectory(organized=False)
    want = np.load(GOLDEN)["poses"]
    np.testing.assert_allclose(got, want, atol=5e-3)
