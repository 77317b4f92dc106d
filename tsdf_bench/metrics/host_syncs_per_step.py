"""Times the host waits for the device in a step, mean over the traced
slice: the growth of the program's ``host_syncs`` counter (every tensor
read, event or stream synchronisation of ``chad_tsdf_tpu_torch``) over
the slice's steps.  Suffixes name the end-to-end metric's cells:
``scans``, ``points``, ``save``."""

from . import spans

UNIT = "waits"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s",
         "save": "save_ms"}


def read(rec, suffix):
    p = spans.profiled(rec)
    if p is None or "host_syncs" not in p["counts"]:
        return None
    return p["counts"]["host_syncs"] / rec.trace["steps"]
