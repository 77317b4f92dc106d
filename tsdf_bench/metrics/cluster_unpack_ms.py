"""Host milliseconds a save spends unpacking the compacted clusters of
its submaps, mean over the traced slice: the spans
``chad.finalize.unpack`` (``core/submap.py`` ``_unpack_cluster_buf``)
over the ``chad.save`` spans."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.finalize.unpack", "chad.save")
