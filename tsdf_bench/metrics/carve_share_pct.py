"""The carve's share of the device's work in the traced slice:
``carve_device_ms`` over the device's busy milliseconds a step (the union
of its operations' intervals over the slice, over the slice's steps),
times 100.  Whether the carve still sets the pace.  None where
``carve_device_ms`` reads nothing."""

from . import carve_device_ms

UNIT = "%"
# the end-to-end metric it moves
MOVES = {"": "scans_per_s"}


def read(rec, suffix):
    ms = carve_device_ms.read(rec, suffix)
    t = rec.trace
    if ms is None or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * ms / (t["busy_s"] * 1e3 / t["steps"])
