"""Dynamic Direct LiDAR Odometry (DDLO) framework in JAX.

A brand-new JAX/XLA/Pallas implementation of the full DDLO pipeline
(reference: nanoshimarobot/dynamic_direct_lidar_odometry, a ROS1/C++ system):

- range-image projection with ground removal and dynamic-object segmentation,
- VGICP-style scan-to-scan and scan-to-submap registration,
- keyframe map with spaciousness-adaptive thresholds and hull-based submap
  selection,
- Kalman + Hungarian multi-object tracking with a static/dynamic status
  machine and dynamic-point removal from the map.

Everything on the hot path is a pure, statically-shaped, `jit`-compiled
function; dynamic sizes are handled with fixed-capacity buffers and validity
masks. Batches of independent registrations/pipelines `vmap`/`shard_map`
across device meshes.

This is NOT a port of the reference's C++: the kd-tree is replaced by a
block-sparse nearest-neighbor kernel (Pallas, on the GPU) over an exact
tiled sweep, OpenMP point loops by vectorized reductions, the BFS
connected-component labeling by iterated segmented min-label scans, and the ROS
node graph by pure function composition over an explicit state pytree.
"""

__version__ = "0.1.0"

from dynamic_direct_lidar_odometry.config import (  # noqa: F401
    DDLOConfig,
    capacity_for_scan,
    doals_config,
    kantplatz_config,
    load_config,
)

__all__ = [
    "DDLOConfig",
    "capacity_for_scan",
    "doals_config",
    "kantplatz_config",
    "load_config",
    # submodules (import explicitly): core, ops, odometry, detection,
    # tracking, pipeline, mapping, parallel, io, utils, runner, cli
]
