"""K2 (``ops/normals_cuda.py``, ``csrc/normals.cu``) against its roofline:
the least time of ``roofline.normals_bytes`` over K2's device time a
call, from the profiler's kernels named ``normals_*`` in the traced
slice."""

from . import roofline

UNIT = "%"
# the end-to-end metric each suffix moves
MOVES = {"": "points_per_s"}


def read(rec, suffix):
    t = rec.trace
    if not t or not rec.valid_points:
        return None
    k2 = sum(s for name, s in t["kernel_s"].items() if "normals_" in name)
    if k2 <= 0:
        return None
    points = roofline.mean_over_slice(rec, rec.valid_points)
    return roofline.share_pct(roofline.normals_bytes(points),
                              k2 / t["steps"])
