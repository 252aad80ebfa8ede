from dynamic_direct_lidar_odometry.utils import (  # noqa: F401
    checkpoint,
    profiling,
    trajectory,
)
