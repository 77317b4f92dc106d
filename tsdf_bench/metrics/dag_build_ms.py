"""Host milliseconds a save spends hash-consing its submaps into the DAG,
mean over the traced slice: the spans ``chad.finalize.dag``
(``core/submap.py`` ``build_submap``) over the ``chad.save`` spans."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.finalize.dag", "chad.save")
