from dynamic_direct_lidar_odometry.parallel import sharding  # noqa: F401
