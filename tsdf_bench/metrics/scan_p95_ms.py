"""95th percentile over all scans of the window of the time from the call
of ``insert`` to the end of that scan's device work."""

import numpy as np

UNIT = "ms"


def read(rec, suffix):
    return float(np.percentile([s["lat_ms"] for s in rec.steps], 95))
