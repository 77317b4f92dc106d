"""Host time inside each ``TSDFMap.insert`` call of the window, mean (the
API layer: ``core/map.py``, whatever of the step it does before it
returns).  Suffixes name the end-to-end metric's cells: ``scans``,
``points``."""

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s"}


def read(rec, suffix):
    return sum(s["call_s"] for s in rec.steps) / len(rec.steps) * 1e3
