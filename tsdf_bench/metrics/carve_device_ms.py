"""Device milliseconds of one carve, mean over the carves timed in the
traced slice: the growth of the program's ``carve_device_us`` counter
(the carve's device time between the events that bracket its graph
replay, folded in once the device has passed them, with no host wait)
over the growth of ``carve_timed`` (the carves folded in), in ms.  None
where the program has no such counters or timed no carve."""

from . import spans

UNIT = "ms"
# the end-to-end metric it moves
MOVES = {"": "scans_per_s"}


def read(rec, suffix):
    p = spans.profiled(rec)
    if p is None:
        return None
    counts = p["counts"]
    n = counts.get("carve_timed", 0)
    if not n or "carve_device_us" not in counts:
        return None
    return counts["carve_device_us"] / n / 1e3
