"""A save of many submaps, on the CPU at a size a test run holds: the car
that drives, then stops; the lead-in; the reference's mesh of every
submap, fused as ``TSDFMap.voxel_samples`` fuses them; and the faults of a
save that the check has to catch."""

import numpy as np
import pytest
import torch

import chad_tsdf_tpu_torch
from chad_tsdf_tpu_torch.core import map as map_mod
from chad_tsdf_tpu_torch.ops import morton
from tsdf_bench import check, run
from tsdf_bench.reference import tsdf_ref as R
from tsdf_bench.traffic import lidar

pytestmark = pytest.mark.usefixtures("kept_cells")

CELL = "kitti_drive_save"
# 16 scans of 0.82 m (groups from scans 0, 7 and 14), then the stop: two
# finished submaps and the active one when the window starts
SMALL = {"sensor": {"azimuths": 96}, "lead_in": 16, "warm_steps": 1,
         "params": {"stop_after": 16},
         "map_config": {"block_capacity": 1 << 16,
                        "touched_capacity": 1 << 13, "max_points": 1 << 13}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_run(seed=2**31 + 5, seconds=1.0):
    return run.run_cell(CELL, seed, seconds, False, device="cpu",
                        overrides=SMALL)


class ParentTraffic(lidar.Traffic):
    """``lidar.Traffic`` as it was before the car could stop, kept
    verbatim."""

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
        seed = seed % (1 << 63)
        reach = float(sensor["max_range_m"])
        street = lidar.street_pillars(world)
        self.templates = []
        for k in range(n_templates):
            x = self.speed * k
            boxes = lidar.repeat(*street, period, x - reach, x + reach)
            if world.get("movers"):
                boxes = tuple(np.concatenate([b, m]) for b, m in
                              zip(boxes, lidar.movers(world, k)))
            origin, ranges, rays = lidar.sweep([x, self.lane, 0.0], boxes,
                                               sensor)
            noise = np.random.default_rng([seed, 2, k]).normal(
                0.0, float(sensor["range_noise_m"]), ranges.shape[0])
            origin = origin - np.array([x, self.lane, 0.0])
            self.templates.append(lidar.returns(origin, ranges + noise,
                                                rays))
        self._moved = [np.empty_like(t) for t in self.templates]
        self._at: list = [None] * n_templates

    def pose(self, i: int) -> np.ndarray:
        return np.float32([self.speed * i, self.lane, 0.0])

    def points(self, i: int) -> np.ndarray:
        return self.templates[i % len(self.templates)] + self.pose(i)

    def step(self, i: int):
        k = i % len(self.templates)
        pose = self.pose(i)
        if not np.array_equal(self._at[k], pose):
            t = self.templates[k]
            np.add(t.reshape(-1), np.tile(pose, len(t)),
                   out=self._moved[k].reshape(-1))
            self._at[k] = pose
        return self._moved[k], self.position(i), k


def traffic(cell, small=None, seed=2**31 + 9, cls=None):
    _, _, spec, conf = run.cell_spec(cell, {"sensor": {"azimuths": 96},
                                            **(small or {})})
    return (cls or lidar.Traffic)(conf, spec["params"], seed)


def same(a, b):
    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a, b))


@pytest.mark.parametrize("cell", ["kitti_parked", "kitti_parked_carve",
                                  "kitti_drive"])
def test_the_lidar_cells_traffic_is_unchanged(cell):
    """Without ``stop_after`` every template and every scan is the
    parent's, byte for byte."""
    a, b = traffic(cell), traffic(cell, cls=ParentTraffic)
    assert len(a.templates) == len(b.templates)
    for x, y in zip(a.templates, b.templates):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for i in (0, 5, 13, 14, 13, 45, 61):
        assert a.template(i) == i % len(b.templates)
        assert same(a.step(i), b.step(i))
        assert np.array_equal(a.points(i), b.points(i))


def test_scans_before_the_stop_are_the_drives():
    a = traffic(CELL)
    _, _, spec, conf = run.cell_spec(CELL, {"sensor": {"azimuths": 96}})
    drive = {k: spec["params"][k] for k in ("speed_m", "templates")}
    b = ParentTraffic(conf, drive, 2**31 + 9)
    stop = spec["params"]["stop_after"]
    assert len(a.templates) == 8 + spec["params"]["park_templates"]
    for x, y in zip(a.templates, b.templates):
        assert np.array_equal(x, y)
    for i in (0, 7, 8, 21, stop - 1):
        assert a.template(i) == i % 8
        assert same(a.step(i), b.step(i))


def test_park_scans_sit_at_the_stop_pose():
    a = traffic(CELL)
    quiet = traffic(CELL, {"sensor": {"azimuths": 96, "range_noise_m": 0.0}})
    stop = 40
    at = np.float32([0.82 * stop, 0.0, 1.73])
    for i in range(stop, stop + 20):
        k = a.template(i)
        assert k == 8 + (i - stop) % 8
        assert np.array_equal(a.position(i), at)
        pts, pos, kk = a.step(i)
        assert kk == k and np.array_equal(pos, at)
        assert np.array_equal(pts, a.templates[k] + a.pose(i))
        # without noise a park sweep is the drive's sweep of phase 0
        assert np.array_equal(quiet.templates[k], quiet.templates[0])
    # each park sweep has noise of its own, apart from the drive's
    assert not np.array_equal(a.templates[8], a.templates[0])
    assert not np.array_equal(a.templates[8], a.templates[9])
    # the stop pose is the street's phase 0: scan 40 sees what scan 0 saw
    assert np.abs(quiet.points(stop) - quiet.points(0) -
                  np.float32([0.82 * stop, 0, 0])).max() < 1e-4


def test_a_stop_off_the_streets_phase_raises():
    with pytest.raises(ValueError, match="multiple"):
        traffic(CELL, {"params": {"stop_after": 12}})


@pytest.mark.parametrize("params", [{"park_templates": 0},
                                    {"stop_after": None}])
def test_a_stop_needs_its_park_sweeps(params):
    with pytest.raises(ValueError, match="together"):
        traffic(CELL, {"params": params})


def test_lead_in_only_inserts(monkeypatch):
    saves = []
    save = map_mod.TSDFMap.save

    def counted(self, path):
        save(self, path)
        saves.append(len(self.submaps))
    monkeypatch.setattr(map_mod.TSDFMap, "save", counted)
    out, rec = run.run_record(CELL, 3, 0.3, False, device="cpu",
                              overrides=SMALL)
    assert len(saves) == SMALL["warm_steps"] + len(rec.steps)
    # the lead-in's rotations are finished by the first save
    assert saves[0] == 2
    assert out["correct"], out["checks"]


def test_sound_run_checks_every_submap():
    out = one_run()
    checks = out["checks"]
    assert out["failed"] == 0
    assert {"w_mismatch", "sd_off_share", "leaf_off_share",
            "mesh_off_share"} <= set(checks)
    assert out["correct"], checks


def test_one_group_meshes_as_before():
    """On one submap the fused reference's vertices are the active
    reference's, bit for bit."""
    _, _, spec, conf = run.cell_spec("sphere_save",
                                     {"cloud": {"points": 4096}})
    sem = R.Semantics.from_map_config(conf["map_config"])
    t = run.traffic_of(spec, conf, 2**31 + 3)
    ref = check.Reference(t, sem, "cpu").voxels(list(range(11)))
    code, _ = R.leaf_codes(ref, sem.sdf_trunc)
    want = R.mesh_vertices(ref.keys, R.decode_sd(code, sem.sdf_trunc),
                           sem.sdf_res).numpy()
    got = check.mesh_reference([ref], sem)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) > 1000


def test_fusion_is_the_ports_voxel_samples():
    """On a CPU map driven through 3 submaps, the reference's fusion of the
    map's own codes is ``voxel_samples`` within 1e-6 m."""
    bench, _, cell, conf = run.cell_spec(CELL, SMALL)
    r = run.Runner(cell, conf, run.traffic_of(cell, conf, 11), "cpu")
    for _ in range(SMALL["lead_in"] + 3):
        r.step(save=False)
    m = r.map
    subs = m._all_submaps()
    assert len(subs) == 3
    trunc = conf["map_config"].get("sdf_trunc", 0.1)
    parts = [tuple(torch.from_numpy(a) for a in check.read_leaves(
        *m.leaf_arrays(sm), trunc)) for sm in subs]
    keys, sd = check.fused_samples(parts, trunc)
    codes, want = m.voxel_samples()
    pk = R.pack_key(torch.from_numpy(
        morton.np_decode63(codes).astype(np.int64)))
    order = torch.argsort(pk)
    assert torch.equal(keys, pk[order])
    shared = torch.unique(torch.cat([p[0] for p in parts]),
                          return_counts=True)[1] > 1
    assert shared.sum() > 1000              # the fusion is exercised
    gap = (sd.double() - torch.from_numpy(want)[order].double()).abs()
    assert gap.max() <= 1e-6


def leave_out_oldest(monkeypatch):
    samples = map_mod.TSDFMap.voxel_samples

    def without_oldest(self, submaps=None):
        subs = self._all_submaps() if submaps is None else submaps
        return samples(self, subs[1:])
    monkeypatch.setattr(map_mod.TSDFMap, "voxel_samples", without_oldest)


def first_submap_only(monkeypatch):
    make = chad_tsdf_tpu_torch.MapConfig
    monkeypatch.setattr(chad_tsdf_tpu_torch, "MapConfig", lambda **kw: make(
        **{**kw, "mesh_first_submap_only": True}))


def unweighted(monkeypatch):
    def mean(self, submaps=None):
        subs = self._all_submaps() if submaps is None else submaps
        parts = [self._leaf_voxels(sm) for sm in subs]
        codes = np.concatenate([c for c, _, _ in parts])
        sd = np.concatenate([s for _, s, _ in parts]).astype(np.float64)
        u, inv = np.unique(codes, return_inverse=True)
        return u, (np.bincount(inv, weights=sd) /
                   np.bincount(inv)).astype(np.float32)
    monkeypatch.setattr(map_mod.TSDFMap, "voxel_samples", mean)


SAVE_FAULTS = {"leave_out_oldest": leave_out_oldest,
               "first_submap_only": first_submap_only,
               "unweighted": unweighted}


@pytest.mark.parametrize("fault", sorted(SAVE_FAULTS))
def test_save_fault_is_caught(fault, monkeypatch):
    SAVE_FAULTS[fault](monkeypatch)
    out = one_run()
    mesh = out["checks"]["mesh_off_share"]
    assert mesh["value"] > mesh["limit"], out["checks"]
    assert not out["correct"]


def test_reference_meshes_the_first_submap_where_configured():
    _, _, spec, conf = run.cell_spec(CELL, SMALL)
    sem = R.Semantics.from_map_config(conf["map_config"])
    t = run.traffic_of(spec, conf, 5)
    groups = R.submap_groups([t.position(i) for i in range(18)], sem)
    ref = check.Reference(t, sem, "cpu")
    vox = [ref.voxels(g) for g in groups]
    first = R.Semantics.from_map_config({**conf["map_config"],
                                         "mesh_first_submap_only": True})
    assert np.array_equal(check.mesh_reference(vox, first),
                          check.mesh_reference(vox[:1], sem))
    assert not np.array_equal(check.mesh_reference(vox, sem),
                              check.mesh_reference(vox[:1], sem))
