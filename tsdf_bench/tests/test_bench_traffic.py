"""The traffic generators: the LiDAR copy against the port's, a street
that stays where it is, and the same inputs from the same seed."""

import numpy as np
import pytest

from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from tsdf_bench import run
from tsdf_bench.traffic import lidar, sphere

pytestmark = pytest.mark.usefixtures("kept_cells")

SENSOR = {"beams": 64, "azimuths": 256, "elevation_deg": [-24.8, 2.0],
          "max_range_m": 120.0, "ground_range_m": 50.0,
          "range_noise_m": 0.02, "mount_height_m": 1.73}
WORLD = {"seed": 3, "period_m": 2.46, "pillars": 2, "road_half_m": 3.0,
         "side_m": 25.0}
CONF = {"sensor": SENSOR, "world": WORLD}
DRIVE = {"speed_m": 0.82, "templates": 3}


def test_lidar_copy_is_the_ports_at_noise_0():
    for pos, seed in (([3.5, -1.0, 0.0], 11), ([0.0, 0.0, 0.0], 0)):
        want = synthetic_lidar_scan(pos, seed=seed)
        got = lidar.returns(*lidar.ray_cast(pos, lidar.port_pillars(seed)))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_every_scan_is_the_street_seen_from_its_pose():
    """Scan i, made from a template, is the sweep cast at its own pose
    through the same street, up to the noise and f32 rounding."""
    quiet = {"sensor": dict(SENSOR, range_noise_m=0.0), "world": WORLD}
    t = lidar.Traffic(quiet, DRIVE, 5)
    street = lidar.street_pillars(WORLD)
    for i in (0, 4, 11):
        x = 0.82 * i
        boxes = lidar.repeat(*street, WORLD["period_m"], x - 120, x + 120)
        want = lidar.returns(*lidar.sweep([x, 0.0, 0.0], boxes, SENSOR))
        got = t.points(i)
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4


def test_the_street_stays_off_the_road():
    c, h = lidar.street_pillars(dict(WORLD, pillars=64))
    assert (np.abs(c[:, 1]) - h[:, 1] >= WORLD["road_half_m"]).all()
    assert ((c[:, 0] >= 0) & (c[:, 0] < WORLD["period_m"])).all()


def test_lidar_sizes_and_seeds():
    a, b = lidar.Traffic(CONF, DRIVE, 2**31 + 99), \
        lidar.Traffic(CONF, DRIVE, 2**31 + 99)
    c = lidar.Traffic(CONF, DRIVE, 5)
    for i in range(4):
        assert np.array_equal(a.points(i), b.points(i))
        assert a.points(i).shape == c.points(i).shape
    assert not np.array_equal(a.points(0), c.points(0))
    # scan 4 is template 1 moved 4 x 0.82 m along x
    assert np.array_equal(a.points(4), a.templates[1] + np.float32(
        [0.82 * 4, 0, 0]))
    pts, pos, k = a.step(5)
    assert k == 2 and np.array_equal(pts, a.points(5))
    assert np.array_equal(pos, np.float32([0.82 * 5, 0, 1.73]))


def test_templates_must_span_the_period():
    with pytest.raises(ValueError, match="period"):
        lidar.Traffic(CONF, {"speed_m": 0.82, "templates": 2}, 1)


def test_cells_read_the_configurations_widths():
    for cell in ("kitti_drive", "kitti_parked"):
        _, _, spec, conf = run.cell_spec(cell, {"sensor": {"azimuths": 64}})
        assert set(spec["params"]) == {"speed_m", "templates"}
        t = run.traffic_of(spec, conf, 1)
        assert len(t.templates) == spec["params"]["templates"]
        assert len(t.templates[0]) <= 64 * conf["sensor"]["beams"]


def test_sphere_clouds():
    conf = {"cloud": {"points": 4096, "radius_m": 5.0}}
    t = sphere.Traffic(conf, {"templates": 2}, 2**31 + 7)
    r = np.linalg.norm(t.points(0).astype(np.float64), axis=1)
    assert t.points(0).shape == (4096, 3)
    assert np.allclose(r, 5.0, atol=1e-5)
    assert not np.array_equal(t.points(0), t.points(1))
    assert np.array_equal(t.points(2), t.points(0))
