"""LiDAR traffic: a vehicle's 64-beam sweeps of a street that stays where it
is, one scan after another, as its sensor software hands them over.

The ray cast is a copy of ``chad_tsdf_tpu_torch.io.kitti.
synthetic_lidar_scan`` (an HDL-64E-shaped scan over a ground plane and box
pillars); given that function's 40 pillars of a seed, its range and no
noise, it gives the same points bit for bit.  The sensor's widths (beams,
azimuths, elevations, ranges, noise, mount height) are the configuration's
``sensor`` block; the street is its ``world`` block:

* a ground plane and ``pillars`` box pillars a period, drawn from the
  world's ``seed`` beside a road of ``road_half_m``, repeated along x every
  ``period_m``, so that the street goes on for as long as a drive does and
  never moves;
* box-shaped ``movers``, if the world lists any, that stand somewhere
  else in each sweep (see :func:`movers`): vehicles passing the sensor;
* ``templates`` sweeps, sweep ``k`` cast from the pose ``(speed_m * k,
  lane_y_m, 0)`` (``lane_y_m`` 0 where the traffic does not give it) with
  its own Gaussian range noise drawn from the run's seed, and kept in the
  sensor's frame.  With ``templates * speed_m`` one period, scan ``i`` is
  sweep ``i % templates`` moved to the pose ``(speed_m * i, lane_y_m,
  0)``: exactly what the sensor sees there, up to the noise, as the sensor
  software moves a sweep into the world frame.  ``speed_m`` 0 is a parked
  vehicle;
* with ``stop_after``, a vehicle that drives, then stops: scans ``i <
  stop_after`` are as above, and scan ``i >= stop_after`` is park sweep
  ``(i - stop_after) % park_templates`` moved to the stop pose
  ``(speed_m * stop_after, lane_y_m, 0)``.  ``stop_after`` is a whole
  number of periods, so the stop pose is the street's phase 0, where a
  sweep cast from the pose ``(0, lane_y_m, 0)`` is exactly what the sensor
  sees; the ``park_templates`` park sweeps are cast there, each with range
  noise of its own drawn from the seed apart from the drive's.

Every seed inserts the same returns of the same street; the seed draws the
noise.
"""

from __future__ import annotations

import numpy as np


def port_pillars(seed: int):
    """The 40 pillars of ``synthetic_lidar_scan``'s seed: (centres f64[n,
    3], half sizes f64[n, 3]), a pillar standing on z = 0."""
    rng = np.random.default_rng(seed)
    n_boxes = 40
    centres = np.stack([rng.uniform(-40, 120, n_boxes),
                        rng.uniform(-25, 25, n_boxes),
                        np.zeros(n_boxes)], axis=-1)
    half = np.stack([rng.uniform(0.3, 2.0, n_boxes),
                     rng.uniform(0.3, 2.0, n_boxes),
                     rng.uniform(1.0, 6.0, n_boxes)], axis=-1)
    return centres, half


def street_pillars(world: dict):
    """One period of the street: ``pillars`` boxes with x in [0,
    ``period_m``), their sides off the road (``road_half_m``) and within
    ``side_m`` of it, on either side; sizes as the port's pillars."""
    rng = np.random.default_rng(int(world["seed"]))
    n = int(world["pillars"])
    half = np.stack([rng.uniform(0.3, 2.0, n), rng.uniform(0.3, 2.0, n),
                     rng.uniform(1.0, 6.0, n)], axis=-1)
    off = rng.uniform(float(world["road_half_m"]) + half[:, 1],
                      float(world["side_m"]))
    side = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    centres = np.stack([rng.uniform(0.0, float(world["period_m"]), n),
                        side * off, np.zeros(n)], axis=-1)
    return centres, half


def movers(world: dict, k: int):
    """The world's movers in sweep ``k``: (centres f64[m, 3], half sizes
    f64[m, 3]).  A mover is a box standing on the ground, given by
    ``centre_m`` (its centre in sweep 0, world frame), ``half_m`` and
    ``step_m`` (how far it moves from one sweep to the next), so it stands
    at ``centre_m + k * step_m`` in sweep ``k`` and passes once every
    ``templates`` sweeps."""
    ms = world.get("movers", [])
    centres = np.array([np.asarray(m["centre_m"], np.float64) +
                        k * np.asarray(m["step_m"], np.float64)
                        for m in ms]).reshape(-1, 3)
    half = np.array([m["half_m"] for m in ms], np.float64).reshape(-1, 3)
    return centres, half


def repeat(centres, half, period: float, x_lo: float, x_hi: float):
    """The pillars copied every ``period`` along x, those whose footprint
    reaches into [x_lo, x_hi]."""
    j = np.arange(np.floor((x_lo - 4.0) / period),
                  np.ceil((x_hi + 4.0) / period) + 1)
    c = (centres[None, :, :] + np.stack(
        [j * period, 0 * j, 0 * j], -1)[:, None, :]).reshape(-1, 3)
    h = np.broadcast_to(half, (len(j),) + half.shape).reshape(-1, 3)
    keep = (c[:, 0] + h[:, 0] >= x_lo) & (c[:, 0] - h[:, 0] <= x_hi)
    return c[keep], h[keep]


def _azimuth_rows(lo, hi, origin, azimuths: int):
    """The azimuth indices whose rays can cross the footprint [lo, hi] (x,
    y) seen from ``origin``, with two indices' margin; None for all."""
    x0, y0 = lo[0] - origin[0], lo[1] - origin[1]
    x1, y1 = hi[0] - origin[0], hi[1] - origin[1]
    if x0 <= 0.0 <= x1 and y0 <= 0.0 <= y1:
        return None
    mid = np.arctan2((y0 + y1) / 2, (x0 + x1) / 2)
    ang = np.arctan2([y0, y0, y1, y1], [x0, x1, x0, x1])
    dev = (ang - mid + np.pi) % (2 * np.pi) - np.pi
    step = 2 * np.pi / azimuths
    first = int(np.floor((mid + dev.min() + np.pi) / step)) - 2
    last = int(np.ceil((mid + dev.max() + np.pi) / step)) + 2
    return np.arange(first, last + 1) % azimuths


def ray_cast(position, boxes, beams: int = 64, azimuths: int = 2048,
             max_range: float = 60.0, ground_range: float | None = None,
             elevation_deg=(-24.8, 2.0), mount_height: float = 1.7):
    """The sweep's returns: (origin f64[3], ranges f64[M], unit rays
    f64[M, 3]), in the order ``synthetic_lidar_scan`` emits its points.
    ``boxes`` are (centres, half sizes); the ground returns up to
    ``ground_range`` (``max_range`` where None), the pillars up to
    ``max_range``.  A pillar is tested only against the rays of the
    azimuths that can reach it, which leaves every range as it is."""
    position = np.asarray(position, np.float64)
    az = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)
    el = np.deg2rad(np.linspace(elevation_deg[0], elevation_deg[1], beams))
    a, e = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                  np.sin(e)], axis=-1).reshape(-1, 3)
    origin = position + np.array([0.0, 0.0, mount_height])
    t_ground = np.where(d[:, 2] < -1e-6, -origin[2] / d[:, 2], np.inf)
    if ground_range is not None:
        t_ground = np.where(t_ground < ground_range, t_ground, np.inf)
    t_hit = t_ground
    rows = np.arange(beams)
    for c, h in zip(*boxes):
        lo = (c - h + np.array([0, 0, h[2]])) - origin
        hi = (c + h + np.array([0, 0, h[2]])) - origin
        az_rows = _azimuth_rows(lo + origin, hi + origin, origin, azimuths)
        sel = slice(None) if az_rows is None else \
            (az_rows[:, None] * beams + rows[None, :]).reshape(-1)
        ds = d[sel]
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = lo[None, :] / ds
            t2 = hi[None, :] / ds
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 0)
        t_box = np.where(hit, np.maximum(tmin, 1e-3), np.inf)
        t_hit[sel] = np.minimum(t_hit[sel], t_box)
    ok = np.isfinite(t_hit) & (t_hit > 1.0) & (t_hit < max_range)
    return origin, t_hit[ok], d[ok]


def returns(origin, ranges, rays) -> np.ndarray:
    """f32 points of a sweep."""
    return (origin[None, :] + ranges[:, None] * rays).astype(np.float32)


def sweep(position, boxes, sensor: dict):
    """``ray_cast`` with the widths of a configuration's ``sensor``."""
    return ray_cast(position, boxes, int(sensor["beams"]),
                    int(sensor["azimuths"]), float(sensor["max_range_m"]),
                    float(sensor["ground_range_m"]),
                    sensor["elevation_deg"],
                    float(sensor["mount_height_m"]))


class Traffic:
    """``step(i)`` -> (points f32[N, 3], position f32[3], template index).
    ``templates`` holds the drive's sweeps, then the park sweeps."""

    def __init__(self, conf: dict, params: dict, seed: int):
        sensor, world = conf["sensor"], conf["world"]
        self.speed = float(params["speed_m"])
        self.lane = float(params.get("lane_y_m", 0.0))
        self.mount = float(sensor["mount_height_m"])
        n_templates = int(params["templates"])
        period = float(world["period_m"])
        if self.speed and abs(self.speed * n_templates - period) > 1e-9:
            raise ValueError(f"{n_templates} templates of {self.speed} m "
                             f"are not the street's period of {period} m")
        self.n_drive = n_templates
        self.stop_after = None if params.get("stop_after") is None \
            else int(params["stop_after"])
        n_park = int(params.get("park_templates", 0))
        if (self.stop_after is None) != (n_park == 0):
            raise ValueError("stop_after and park_templates go together")
        if self.stop_after is not None and (
                self.stop_after < 0 or self.stop_after % n_templates):
            raise ValueError(f"stop_after {self.stop_after} is not a "
                             f"multiple of the {n_templates} templates, so "
                             f"the stop pose is not the street's phase 0")
        seed = seed % (1 << 63)
        reach = float(sensor["max_range_m"])
        street = street_pillars(world)

        def cast(k: int, x: float, stream: int) -> np.ndarray:
            boxes = repeat(*street, period, x - reach, x + reach)
            if world.get("movers"):
                boxes = tuple(np.concatenate([b, m]) for b, m in
                              zip(boxes, movers(world, k)))
            origin, ranges, rays = sweep([x, self.lane, 0.0], boxes, sensor)
            noise = np.random.default_rng([seed, stream, k]).normal(
                0.0, float(sensor["range_noise_m"]), ranges.shape[0])
            origin = origin - np.array([x, self.lane, 0.0])
            return returns(origin, ranges + noise, rays)

        self.templates = [cast(k, self.speed * k, 2)
                          for k in range(n_templates)]
        self.templates += [cast(k, 0.0, 3) for k in range(n_park)]
        # each sweep moved to the pose it was last handed over at
        self._moved = [np.empty_like(t) for t in self.templates]
        self._at: list = [None] * len(self.templates)

    def template(self, i: int) -> int:
        """The index in ``templates`` of scan ``i``'s sweep."""
        if self.stop_after is None or i < self.stop_after:
            return i % self.n_drive
        return self.n_drive + (i - self.stop_after) % (
            len(self.templates) - self.n_drive)

    def pose(self, i: int) -> np.ndarray:
        if self.stop_after is not None:
            i = min(i, self.stop_after)
        return np.float32([self.speed * i, self.lane, 0.0])

    def position(self, i: int) -> np.ndarray:
        return self.pose(i) + np.float32([0.0, 0.0, self.mount])

    def points(self, i: int) -> np.ndarray:
        """Scan ``i`` in the world frame, in a fresh array."""
        return self.templates[self.template(i)] + self.pose(i)

    def step(self, i: int):
        """Scan ``i`` in the world frame (the map copies it before
        ``insert`` returns), its position and template.  Each sweep is
        moved into a buffer of its own, again only when its pose differs
        from the last time, so a parked vehicle's scans cost nothing to
        hand over.  The sums are those of ``points(i)``, taken over the flat
        rows: a broadcast over rows of 3 runs numpy's inner loop 3 values at
        a time (1 ms a sweep against 0.3)."""
        k = self.template(i)
        pose = self.pose(i)
        if not np.array_equal(self._at[k], pose):
            t = self.templates[k]
            np.add(t.reshape(-1), np.tile(pose, len(t)),
                   out=self._moved[k].reshape(-1))
            self._at[k] = pose
        return self._moved[k], self.position(i), k
