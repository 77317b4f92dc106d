from .kitti import KittiSequence, synthetic_lidar_scan  # noqa: F401
