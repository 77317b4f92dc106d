"""Host milliseconds of an insert that none of its stages' spans covers,
mean over the traced slice: the self time of ``chad.insert`` (the call
less its ``.rotate``, ``.dispatch``, ``.load``, ``.replay`` / ``.step``,
``.capture`` and ``.overflow_check`` children).  Suffixes name the
end-to-end metric's cells: ``scans``, ``points``."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"scans": "scans_per_s", "points": "points_per_s"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.insert", "chad.insert", "self_s")
