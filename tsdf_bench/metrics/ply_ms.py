"""``last_metrics["ply_ms"]`` after each save, mean: the span
``chad.save.ply``, the mesh written to its PLY file (``mesh/ply.py``
``write_ply``)."""

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    v = [s["save_metrics"]["ply_ms"] for s in rec.steps
         if "ply_ms" in s.get("save_metrics", {})]
    return sum(v) / len(v) if v else None
