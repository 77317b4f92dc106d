"""Mean latency of the window's scans during whose ``insert`` a submap
was finished (``len(TSDFMap.submaps)`` grew): the rotation's finalize and
DAG build (``core/submap.py``, ``core/dag.py``) on top of the insert."""

UNIT = "ms"
# the end-to-end metric each suffix moves
MOVES = {"": "scan_p95_ms"}


def read(rec, suffix):
    lat = [s["lat_ms"] for s in rec.steps if s["grew"]]
    return sum(lat) / len(lat) if lat else None
