"""Seconds from the start of the run's process (the harness's first
statement) to the first timed call: imports, kernel builds or loads, the
traffic, the map and the warm-up steps."""

UNIT = "s"


def read(rec, suffix):
    return rec.setup_s
