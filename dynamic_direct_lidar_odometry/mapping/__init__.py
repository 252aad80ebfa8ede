from dynamic_direct_lidar_odometry.mapping import mapper  # noqa: F401
