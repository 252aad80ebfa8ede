"""Profiling / checkpoint / trajectory / PCD IO tests (SURVEY.md §5)."""

import os

import numpy as np
import jax.numpy as jnp

from dynamic_direct_lidar_odometry.io import pcd
from dynamic_direct_lidar_odometry.utils import checkpoint, profiling, trajectory


def test_accumulator_stats():
    a = profiling.Accumulator("odometry")
    for v in [1.0, 2.0, 3.0]:
        a.add(v)
    assert a.n == 3 and a.last == 3.0
    np.testing.assert_allclose(a.mean, 2.0)
    # population variance, matching boost::accumulators::variance
    # (accumulator.h:23)
    np.testing.assert_allclose(a.var, 2.0 / 3.0)
    assert a.min == 1.0 and a.max == 3.0
    assert "odometry" in a.row()


def test_profiler_stage_contextmanager():
    p = profiling.Profiler()
    with p.stage("odometry") as h:
        h.value = jnp.ones((8,)) * 2
    assert p["odometry"].n == 1
    assert "odometry" in p.dashboard()


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "T": jnp.eye(4),
        "nested": (jnp.arange(5), jnp.ones((2, 3), bool)),
    }
    path = os.path.join(tmp_path, "ck.npz")
    checkpoint.save(path, state, meta={"scan": 17})
    restored, meta = checkpoint.restore(path, state)
    assert meta["scan"] == 17
    np.testing.assert_array_equal(np.asarray(restored["T"]), np.eye(4))
    np.testing.assert_array_equal(
        np.asarray(restored["nested"][0]), np.arange(5)
    )


def test_checkpoint_shape_mismatch_raises(tmp_path):
    import pytest

    path = os.path.join(tmp_path, "ck.npz")
    checkpoint.save(path, {"a": jnp.zeros((4,))})
    with pytest.raises(ValueError, match="capacities/config changed"):
        checkpoint.restore(path, {"a": jnp.zeros((5,))})


def test_pose_recorder_tum_format(tmp_path):
    rec = trajectory.PoseRecorder()
    rec.append(1.5, [1, 2, 3], [1, 0, 0, 0])
    rec.append(1.6, [2, 2, 3], [0.707, 0, 0, 0.707])
    path = os.path.join(tmp_path, "traj.txt")
    assert rec.save(path) == 2
    arr = np.loadtxt(path)
    assert arr.shape == (2, 8)
    np.testing.assert_allclose(arr[0], [1.5, 1, 2, 3, 0, 0, 0, 1])
    # TUM order puts qw last
    np.testing.assert_allclose(arr[1, 7], 0.707)


def test_object_trajectories_save(tmp_path):
    t = trajectory.ObjectTrajectories()
    ids = np.array([3, 7, -1])
    for k in range(3):
        states = np.zeros((3, 7))
        states[:, 0] = k  # move in x
        states[:, 6] = 2.0  # height -> bottom center z = -1
        t.update(ids, states, [True, True, False], timestamp=10.0 + k)
    files = t.save(os.path.join(tmp_path, "run"))
    assert len(files) == 2
    arr = np.loadtxt(files[0])
    assert arr.shape == (3, 5)
    np.testing.assert_allclose(arr[:, 2], -1.0)  # bottom center
    np.testing.assert_allclose(arr[:, 3], [10, 11, 12])  # stamp.sec
    t.clear()
    assert t.save(os.path.join(tmp_path, "run2")) == []


def test_pcd_roundtrip_binary_and_ascii(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    mask = rng.uniform(size=100) < 0.7
    inten = rng.uniform(size=100).astype(np.float32)
    for binary in (True, False):
        path = os.path.join(tmp_path, f"m_{binary}.pcd")
        n = pcd.save_pcd(path, pts, mask, intensity=inten, binary=binary)
        assert n == mask.sum()
        loaded, extras = pcd.load_pcd(path)
        np.testing.assert_allclose(loaded, pts[mask], atol=1e-5)
        np.testing.assert_allclose(
            extras["intensity"], inten[mask], atol=1e-5
        )


def test_viz_debug_images(tmp_path):
    import numpy as np

    from dynamic_direct_lidar_odometry.utils import viz

    rng = np.random.default_rng(0)
    r = rng.uniform(0, 30, (16, 64))
    res = rng.uniform(0, 1, (16, 64))
    lab = np.full((16, 64), -1, np.int32)
    lab[4:8, 10:20] = 123
    lab[10:12, 30:40] = 456
    viz.save_debug_images(str(tmp_path), 7, r, res, lab)
    import os

    for name in ("range_000007.png", "residual_000007.png", "labels_000007.png"):
        assert os.path.exists(os.path.join(str(tmp_path), name))
    cols = viz.label_colors(lab)
    assert np.all(cols[lab == -1] == 0)
    assert np.any(cols[lab == 123] > 0)
    # distinct labels get distinct colors
    assert not np.array_equal(cols[5, 15], cols[10, 35])


def test_debug_dashboard_renders():
    import numpy as np

    from dynamic_direct_lidar_odometry import runner
    from dynamic_direct_lidar_odometry.utils import profiling

    prof = profiling.Profiler()
    prof["total"].add(12.5)
    s = runner.debug_dashboard(
        prof, 10, 100, np.array([1.0, -2.0, 0.5]),
        np.array([1.0, 0, 0, 0]), 5, 12345, 3, 42,
    )
    assert "DDLO" in s and "keyframes" in s and "12345" in s
    assert "total" in s


def test_viz_dilate():
    import numpy as np

    from dynamic_direct_lidar_odometry.utils import viz

    img = np.zeros((8, 8))
    img[4, 4] = 1.0
    out = viz.dilate(img, 3)
    assert out[3:6, 3:6].min() == 1.0 and out[0, 0] == 0.0
    np.testing.assert_array_equal(viz.dilate(img, 1), img)
