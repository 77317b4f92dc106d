"""The whole insert replay against its roofline: the least time of
``roofline.insert_bytes`` over the device's busy time an insert in the
traced slice."""

from . import roofline

UNIT = "%"
# the end-to-end metric each suffix moves
MOVES = {"": "points_per_s"}


def read(rec, suffix):
    t = rec.trace
    if not t or not rec.touched or t["busy_s"] <= 0:
        return None
    points = roofline.mean_over_slice(rec, rec.valid_points)
    touched = roofline.mean_over_slice(rec, rec.touched)
    return roofline.share_pct(roofline.insert_bytes(points, touched),
                              t["busy_s"] / t["steps"])
