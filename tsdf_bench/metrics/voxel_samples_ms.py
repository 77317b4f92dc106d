"""``last_metrics["voxel_samples_ms"]`` after each save, mean: the host
DAG walk of ``TSDFMap.voxel_samples``."""

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "save_ms"}


def read(rec, suffix):
    v = [s["save_metrics"]["voxel_samples_ms"] for s in rec.steps
         if "voxel_samples_ms" in s.get("save_metrics", {})]
    return sum(v) / len(v) if v else None
