from dynamic_direct_lidar_odometry.core import se3, cloud  # noqa: F401
