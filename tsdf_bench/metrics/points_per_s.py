"""Points inserted in the window over the window, which ends in a
synchronisation of the device."""

UNIT = "points/s"


def read(rec, suffix):
    return sum(s["points"] for s in rec.steps) / rec.window_s
