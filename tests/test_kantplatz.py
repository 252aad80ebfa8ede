"""The fork's kantplatz (Azure-Kinect organized 512x512) config path.

Runs the kantplatz preset end-to-end at a reduced geometry (the preset's
structure — organized square image, segmentation window, camera residual
grid — is preserved; 512x512 itself is a bench-scale shape)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from dynamic_direct_lidar_odometry import config as cfg_lib
from dynamic_direct_lidar_odometry import pipeline
from dynamic_direct_lidar_odometry.io import synthetic


def small_kantplatz():
    cfg = cfg_lib.kantplatz_config()
    assert cfg.detection.rows == 512 and cfg.detection.columns == 512
    assert cfg.detection.window_row_min is not None  # fork's 156..356 box
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection,
            rows=64,
            columns=64,
            ground_rows=18,
            window_row_min=8,
            window_row_max=56,
            window_col_min=8,
            window_col_max=56,
        ),
        capacity=cfg_lib.CapacityConfig(
            max_points=1024,
            max_submap_points=4096,
            max_keyframes=16,
            max_keyframe_points=1024,
            max_objects=8,
            max_tracks=8,
            nn_chunk=256,
        ),
        # the preset's 1 cm transformationEpsilon is tuned for 512x512
        # point density; at this toy 64x64 scale the optimizer needs the
        # DOALS-tight epsilon to not stop on its first undershooting step
        gicp=dataclasses.replace(
            cfg.gicp,
            s2s=dataclasses.replace(
                cfg.gicp.s2s, transformation_epsilon=5e-4
            ),
            s2m=dataclasses.replace(
                cfg.gicp.s2m, transformation_epsilon=5e-4
            ),
        ),
    )
    return cfg


def test_kantplatz_pipeline_runs_square_image():
    cfg = small_kantplatz()
    H, W = cfg.detection.rows, cfg.detection.columns
    # the kantplatz preset selects the fork's camera residual grid
    assert cfg.detection.residual_grid == "camera"
    world = synthetic.World.town(seed=11, n_static=8)
    rng = np.random.default_rng(0)
    T = np.eye(4)
    pts, mask = synthetic.render_scan(world, T, H=H, W=W, t=0.0, rng=rng)
    state = pipeline.init_state(cfg, jnp.asarray(pts), jnp.asarray(mask), 0.0)
    for i in range(1, 4):
        T[:3, 3] = [0.08 * i, 0.0, 0.0]
        pts, mask = synthetic.render_scan(world, T, H=H, W=W, t=0.1 * i, rng=rng)
        state, out = pipeline.step(
            cfg, state, jnp.asarray(pts), jnp.asarray(mask), jnp.float32(0.1 * i)
        )
    # at this toy geometry (280 voxelized points, 5.6 deg/px azimuth) the
    # scene is too degenerate for tight accuracy claims (those live in
    # test_odometry/test_golden at sane resolutions) — this asserts the
    # kantplatz config *path*: square camera grid, window, stability
    p = np.asarray(out.odom.pose)
    assert np.all(np.isfinite(p))
    assert float(np.linalg.norm(p)) < 2.0  # no divergence
    # the segmentation window keeps labels inside the configured box
    lab = np.asarray(out.detections.labels)
    assert np.all(lab[:8, :] == -1) and np.all(lab[57:, :] == -1)


# The reference's cfg/ddlo.yaml layout, reduced to the keys the
# kantplatz preset encodes; like the reference file, its DOALS top half
# is commented out, which the loader must skip.
REFERENCE_DDLO_YAML = """\
# dynamicDetection: true
# odomNode:
#   detection:
#     rows: 64
#     columns: 2048
dynamicDetection: true
odomNode:
  preprocessing:
    downsampling: {use: true, row: 2, col: 2}
    voxelFilter:
      scan: {use: true, res: 0.1}
      submap: {use: true, res: 0.1}
  keyframe: {threshD: 1.0, threshR: 0.1}
  gicp:
    minNumPoints: 10
    s2s:
      kCorrespondences: 10
      maxCorrespondenceDistance: 1.0
      maxIterations: 32
      transformationEpsilon: 0.01
    s2m:
      kCorrespondences: 20
      maxCorrespondenceDistance: 2.0
      maxIterations: 32
      transformationEpsilon: 0.01
  detection:
    rows: 512
    columns: 512
    ang_bottom: 90
    groundRows: 150
    groundAngleThreshold: 80
    minimumRange: 0.3
    residualGrid: camera
"""


def test_kantplatz_config_loads_reference_yaml(tmp_path):
    path = tmp_path / "ddlo.yaml"
    path.write_text(REFERENCE_DDLO_YAML)
    cfg = cfg_lib.load_config(str(path))
    assert cfg.detection.rows == 512 and cfg.detection.columns == 512
    assert cfg.detection.ground_rows == 150
    assert cfg.gicp.s2m.k_correspondences == 20
    # the preset encodes the same reference values
    preset = cfg_lib.kantplatz_config()
    for sect, field in [
        ("detection", "ground_rows"),
        ("detection", "residual_grid"),
        ("preprocessing", "voxel_scan"),
        ("preprocessing", "voxel_submap"),
        ("preprocessing", "downsampling"),
        ("keyframe", None),
        ("gicp", None),
    ]:
        a, b = getattr(cfg, sect), getattr(preset, sect)
        if field is not None:
            a, b = getattr(a, field), getattr(b, field)
        assert a == b, (sect, field, a, b)
