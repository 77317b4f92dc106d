from .posegraph import (PoseGraph, optimize_poses, se3_exp, se3_log,  # noqa: F401
                        make_odometry_edges)
