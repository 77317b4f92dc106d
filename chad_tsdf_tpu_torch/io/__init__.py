from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .kitti import KittiSequence, synthetic_lidar_scan  # noqa: F401
