"""Total time inside ``TSDFMap.save`` over the saves of the window."""

UNIT = "ms"


def read(rec, suffix):
    return sum(s["save_s"] for s in rec.steps) / len(rec.steps) * 1e3
