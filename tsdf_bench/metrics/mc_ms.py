"""``last_metrics["mc_ms"]`` after each save, mean: marching cubes on the
device (``mesh/device_mc.py``) through its read-back."""

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    v = [s["save_metrics"]["mc_ms"] for s in rec.steps
         if "mc_ms" in s.get("save_metrics", {})]
    return sum(v) / len(v) if v else None
