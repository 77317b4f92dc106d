"""KITTI odometry streaming harness — the port's numpy copy of
``chad_tsdf_tpu/io/kitti.py`` (the port imports nothing of that package).

Readers for the KITTI odometry layout:
  <root>/sequences/<seq>/velodyne/000000.bin ...  (float32 x,y,z,reflectance)
  <root>/poses/<seq>.txt                          (3x4 row-major cam0 poses)
  <root>/sequences/<seq>/calib.txt                (Tr: velodyne->cam0)

No dataset ships with this repo; ``KittiSequence.available`` says whether
the files are there.  ``stream_scans`` yields (points_world (N,3) f32,
scanner_position (3,) f32) ready for ``TSDFMap.insert``, and
:func:`synthetic_lidar_scan` makes a KITTI-shaped scan from a seed, bit for
bit the JAX package's.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One scan: (N, 4) float32 x, y, z, reflectance."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_poses(path: str) -> np.ndarray:
    """(T, 4, 4) homogeneous cam0 poses from a KITTI poses file."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def read_calib_tr(path: str) -> np.ndarray:
    """(4, 4) velodyne->cam0 transform from calib.txt's 'Tr:' line."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("Tr"):
                vals = np.array([float(x) for x in line.split()[1:]],
                                np.float64).reshape(3, 4)
                out = np.eye(4)
                out[:3, :] = vals
                return out
    raise ValueError(f"no Tr line in {path}")


class KittiSequence:
    def __init__(self, root: str, sequence: str = "00"):
        self.root = root
        self.sequence = sequence
        self.velo_dir = os.path.join(root, "sequences", sequence, "velodyne")
        self.pose_file = os.path.join(root, "poses", f"{sequence}.txt")
        self.calib_file = os.path.join(root, "sequences", sequence,
                                       "calib.txt")

    @property
    def available(self) -> bool:
        return (os.path.isdir(self.velo_dir) and
                os.path.isfile(self.pose_file) and
                os.path.isfile(self.calib_file))

    def __len__(self) -> int:
        if not os.path.isdir(self.velo_dir):
            return 0
        return len([f for f in os.listdir(self.velo_dir)
                    if f.endswith(".bin")])

    def stream_scans(self, max_scans: int | None = None,
                     min_range: float = 2.5,
                     max_range: float = 80.0) -> Iterator[tuple]:
        """Yield (points_world (N,3) f32, scanner_position (3,) f32)."""
        poses = read_poses(self.pose_file)          # cam0 -> world
        tr = read_calib_tr(self.calib_file)         # velo -> cam0
        n = len(self) if max_scans is None else min(len(self), max_scans)
        for i in range(n):
            scan = read_velodyne_bin(
                os.path.join(self.velo_dir, f"{i:06d}.bin"))[:, :3]
            rng = np.linalg.norm(scan, axis=1)
            scan = scan[(rng > min_range) & (rng < max_range)]
            t = poses[i] @ tr                        # velo -> world
            pts = scan @ t[:3, :3].T + t[:3, 3]
            position = t[:3, 3].astype(np.float32)
            yield pts.astype(np.float32), position


def synthetic_lidar_scan(position, seed: int = 0, beams: int = 64,
                         azimuths: int = 2048,
                         max_range: float = 60.0) -> np.ndarray:
    """KITTI-shaped synthetic scan: a rotating ``beams``-channel LiDAR over
    a ground plane with scattered box obstacles (~``beams*azimuths`` points
    before range culling, ~131k like a real HDL-64E sweep).

    Deterministic in (seed); the stream of ``scripts/kitti_stream.py``, as
    of bench.py's streaming benchmark (no real dataset ships with the
    repo).
    """
    position = np.asarray(position, np.float64)
    az = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))
    a, e = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                  np.sin(e)], axis=-1).reshape(-1, 3)        # (A*B, 3)

    sensor_h = 1.7
    origin = position + np.array([0.0, 0.0, sensor_h])

    # ground plane z = 0
    t_ground = np.where(d[:, 2] < -1e-6, -origin[2] / d[:, 2], np.inf)

    # deterministic boxes (axis-aligned pillars) along the path
    rng = np.random.default_rng(seed)
    n_boxes = 40
    centres = np.stack([rng.uniform(-40, 120, n_boxes),
                        rng.uniform(-25, 25, n_boxes),
                        np.zeros(n_boxes)], axis=-1)
    half = np.stack([rng.uniform(0.3, 2.0, n_boxes),
                     rng.uniform(0.3, 2.0, n_boxes),
                     rng.uniform(1.0, 6.0, n_boxes)], axis=-1)
    t_hit = t_ground
    for c, h in zip(centres, half):
        lo = (c - h + np.array([0, 0, h[2]])) - origin
        hi = (c + h + np.array([0, 0, h[2]])) - origin
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = lo[None, :] / d
            t2 = hi[None, :] / d
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 0)
        t_box = np.where(hit, np.maximum(tmin, 1e-3), np.inf)
        t_hit = np.minimum(t_hit, t_box)

    ok = np.isfinite(t_hit) & (t_hit > 1.0) & (t_hit < max_range)
    pts = origin[None, :] + t_hit[ok, None] * d[ok]
    return pts.astype(np.float32)
