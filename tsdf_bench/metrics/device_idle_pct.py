"""Share of the traced slice in which no operation ran on the device:
100 less the union of the device operations' intervals (torch.profiler)
over the slice's length.  Suffixes name the end-to-end metric's cells:
``scans``, ``points``, ``save``."""

UNIT = "%"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s",
         "save": "save_ms"}


def read(rec, suffix):
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
