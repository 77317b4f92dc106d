"""Scans inserted in the window over the window, which closes when every
scan's device work is done and every submap rotated out is finished."""

UNIT = "scans/s"


def read(rec, suffix):
    return len(rec.steps) / rec.window_s
