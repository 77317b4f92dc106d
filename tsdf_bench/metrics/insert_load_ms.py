"""Host milliseconds an insert spends uploading its cloud, mean over the
traced slice: the span ``chad.insert.load`` (``InsertGraph.load``: the
points, position and count into the graph's input buffers, a pageable
host-to-device copy) over the ``chad.insert`` spans.  Suffixes name the
end-to-end metric's cells: ``scans``, ``points``."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.insert.load", "chad.insert")
