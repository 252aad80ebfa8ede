"""Smoke demo: run the full DDLO pipeline on a small synthetic sequence.

    python -m dynamic_direct_lidar_odometry.io.demo [n_scans]

Prints per-scan poses and the final ATE vs the synthetic ground truth —
the 30-second "does the whole thing work" check.
"""

from __future__ import annotations

import dataclasses
import sys


def main(n_scans: int = 8) -> int:
    from dynamic_direct_lidar_odometry import config as cfg_lib
    from dynamic_direct_lidar_odometry import runner
    from dynamic_direct_lidar_odometry.io import dataset

    cfg = cfg_lib.doals_config()
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(
            cfg.detection, rows=16, columns=256, ground_rows=4
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
    )
    import numpy as np

    # a gentle arc (~1.5 deg/scan); the default pi/2 span at few scans
    # means >10 deg/scan — beyond any real 10 Hz platform dynamics
    seq = dataset.synthetic_sequence(
        n_scans=n_scans, H=16, W=256, n_dynamic=1,
        angle_span=np.pi / 16 * (n_scans / 8),
    )
    res = runner.replay(cfg, seq, progress=True)
    ate = runner.ate_rmse(res.poses, seq.gt_poses)
    print(
        f"done: {len(res.poses)} scans, {res.num_keyframes} keyframes, "
        f"{res.map_points} map points, ATE {ate:.3f} m"
    )
    return 0 if ate < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
