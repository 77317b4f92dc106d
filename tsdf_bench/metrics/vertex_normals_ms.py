"""Host milliseconds a save spends on the mesh's vertex normals, mean
over the traced slice: the span ``chad.save.normals`` (``mesh/mc.py``
``_vertex_normals``) over the ``chad.save`` spans."""

from . import spans

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    return spans.mean_ms(rec, "chad.save.normals", "chad.save")
