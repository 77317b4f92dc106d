"""The byte counts and the peak that the roofline shares are taken
against: NVIDIA H100 SXM, 3.35 TB/s of HBM3 at the full 700 W (NVIDIA's
data sheet).  A card set below 700 W reads lower; each run reports the
card's name and power limit in its ``device`` object."""

HBM_BYTES_PER_S = 3.35e12


def normals_bytes(points: int) -> int:
    """K2's least traffic: each valid point read once (12 B) and its
    normal written once (12 B)."""
    return 24 * points


def insert_bytes(points: int, touched_voxels: int) -> int:
    """An insert's least traffic whatever implements it: the cloud read
    once (12 B a point) and the signed-distance sum and weight of every
    voxel the update touches read and written once (16 B), the touched
    voxels counted by the reference from the cloud."""
    return 12 * points + 16 * touched_voxels


def share_pct(least_bytes: float, seconds: float):
    """100 x the least time over the time taken; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_bytes / HBM_BYTES_PER_S / seconds


def mean_over_slice(rec, per_template: dict):
    ks = rec.trace["templates"]
    return sum(per_template[k] for k in ks) / len(ks)
