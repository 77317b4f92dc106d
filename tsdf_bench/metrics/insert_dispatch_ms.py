"""Host milliseconds an insert spends choosing its backend, mean over the
traced slice: the span ``chad.insert.dispatch`` (``TSDFMap.
_dispatch_config``, a subsample's ``np.unique``) over the ``chad.insert``
spans.  Suffixes name the end-to-end metric's cells: ``scans``,
``points``."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.insert.dispatch", "chad.insert")
