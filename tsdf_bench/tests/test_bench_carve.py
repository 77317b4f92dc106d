"""``correct`` for a carving map, on the CPU at a size a test run holds: the
port's carving ``TSDFMap`` equals the reference's carve on the parked
street, with and without a passing car; the check catches a carve that is
off, denser than configured, or run before its insert's band; and with
carving off the reference is the one the existing cells were judged by,
byte for byte."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import chad_tsdf_tpu_torch
from chad_tsdf_tpu_torch.core import graph as graph_mod
from tsdf_bench import check, control, run, trial
from tsdf_bench.reference import tsdf_ref as R
from tsdf_bench.traffic import lidar

TRIAL = "tsdf_bench/trials/kitti_parked_carve.json"
# the small sizes of test_bench_correct.py; a touched list that holds every
# block one small sweep's carve touches (~10,600)
SMALL = {"sensor": {"azimuths": 96}, "warm_steps": 8,
         "map_config": {"block_capacity": 1 << 16,
                        "touched_capacity": 1 << 15, "max_points": 1 << 13}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def overrides(car: bool = True) -> dict:
    """The trial's carving overrides at the small sizes; without the car,
    the static street seen from the same place."""
    out = run.load_json(TRIAL)
    out["map_config"] = {**out["map_config"], **SMALL["map_config"]}
    out.update({k: v for k, v in SMALL.items() if k != "map_config"})
    if not car:
        del out["world"]
    return out


def one_run(ov, seed=2**31 + 5, seconds=1.0):
    return run.run_cell("kitti_parked", seed, seconds, False, device="cpu",
                        overrides=ov)


@pytest.mark.parametrize("seed", [2**31 + 5, 7, 4_000_000_011])
@pytest.mark.parametrize("car", [False, True], ids=["street", "car"])
def test_carving_run_is_correct(car, seed):
    out = one_run(overrides(car), seed)
    checks = out["checks"]
    assert out["failed"] == 0
    assert checks["w_mismatch"]["value"] == 0, checks
    assert checks["sd_off_share"]["value"] <= 0.01, checks
    assert out["correct"]


def carve_first(monkeypatch):
    """Each insert's carve before its band (inside ``InsertGraph.run_step``,
    on the padded points the step ingests), the carve after it a no-op that
    writes zero carve metrics."""
    step = graph_mod.InsertGraph.run_step
    carve = graph_mod.InsertGraph.run_carve

    def carve_then_band(self):
        rows = torch.arange(self.points.shape[0], dtype=torch.int32)
        pts = torch.where((rows < self.n_points)[:, None], self.points, 0.0)
        if self.packed:
            pts = graph_mod.integrate.unpack_points(
                graph_mod.integrate.pack_points_device(
                    pts, self.position, self.config.sdf_res),
                self.position, self.config)
        self._pts = pts
        carve(self)
        step(self)

    def no_carve(self):
        self.out[len(graph_mod.INSERT_KEYS):].zero_()
    monkeypatch.setattr(graph_mod.InsertGraph, "run_step", carve_then_band)
    monkeypatch.setattr(graph_mod.InsertGraph, "run_carve", no_carve)


def in_config(change):
    def fault(monkeypatch):
        make = chad_tsdf_tpu_torch.MapConfig
        monkeypatch.setattr(chad_tsdf_tpu_torch, "MapConfig",
                            lambda **kw: make(**{**kw, **change}))
    return fault


FAULTS = {"off": in_config({"carve_steps": 0}),
          "subsample_1": in_config({"carve_subsample": 1}),
          "stride_1": in_config({"carve_stride": 1.0}),
          "carve_first": carve_first}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_carve_fault_is_caught(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = one_run(overrides())
    assert out["checks"]["w_mismatch"]["value"] > 0, out["checks"]
    assert not out["correct"]


def test_control_is_not_correct_when_carving():
    ov = overrides()
    _, _, spec, _ = run.cell_spec("kitti_parked", ov)
    nums = control.control_numbers("kitti_parked", 7, steps=24,
                                   device="cpu", overrides=ov)
    assert not check.judge(nums, spec["limits"]), nums


def parent_voxels(ref, steps):
    """``check.Reference.voxels`` as it was before the reference learnt
    carving, kept verbatim."""
    first = ref.traffic.position(steps[0])
    mult: dict = {}
    for i in steps:
        k = (i % len(ref.traffic.templates),
             tuple(ref.traffic.position(i).tolist()))
        mult[k] = mult.get(k, (i, 0))[0], mult.get(k, (i, 0))[1] + 1
    parts = []
    for (k, _), (i, m) in mult.items():
        keys, sd = R.scan_samples(ref.traffic.points(i),
                                  ref.traffic.position(i), first,
                                  ref.sem, ref.device, ref.dtype)
        v = R.reduce_samples(keys, sd)
        ref.touched[k] = int(v.keys.shape[0])
        parts.append((v, m))
    return R.combine(parts)


@pytest.mark.parametrize("cell,small", [
    ("kitti_parked", {"sensor": {"azimuths": 96}}),
    ("sphere_insert", {"cloud": {"points": 4096}})])
def test_reference_without_carving_is_unchanged(cell, small):
    _, _, spec, conf = run.cell_spec(cell, small)
    sem = R.Semantics.from_map_config(conf["map_config"])
    assert sem.carve_steps == 0
    traffic = run.traffic_of(spec, conf, 2**31 + 3)
    steps = list(range(2 * len(traffic.templates) + 3))
    new, old = check.Reference(traffic, sem, "cpu"), \
        check.Reference(traffic, sem, "cpu")
    got, want = new.voxels(steps), parent_voxels(old, steps)
    for f in ("keys", "sums", "counts", "abs_sums", "inserts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert new.touched == old.touched


def test_semantics_read_carving():
    sem = R.Semantics.from_map_config(run.load_json(TRIAL)["map_config"])
    assert (sem.carve_steps, sem.carve_stride, sem.carve_subsample,
            sem.carve_weight) == (128, 2.0, 2, 1.0)
    assert R.Semantics().carve_steps == 0
    with pytest.raises(ValueError, match="carve_weight"):
        R.Semantics(carve_steps=8, carve_weight=0.5)
    R.Semantics(carve_steps=0, carve_weight=0.5)


def test_carve_samples_of_one_ray():
    """A ray along +x from the origin to a return at 1.0 m: samples at
    0.05, 0.15, ..., 0.85 m (t < 1.0 - 0.1), voxel x = floor(t / 0.05)."""
    sem = R.Semantics(carve_steps=16, carve_subsample=1)
    keys, counts = R.carve_samples(np.float32([[1.0, 0.0, 0.0]]),
                                   [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], sem)
    want = [int(np.floor(np.float32(np.float32(i + 0.5) * np.float32(0.1))
                         * np.float32(20.0))) for i in range(9)]
    assert R.unpack_key(keys)[:, 0].tolist() == sorted(want)
    assert (R.unpack_key(keys)[:, 1:] == 0).all()
    assert counts.tolist() == [1] * 9


def test_carve_counts_only_in_allocated_blocks():
    sem = R.Semantics(carve_steps=16, carve_subsample=1)
    keys, counts = R.carve_samples(np.float32([[1.0, 0.0, 0.0]]),
                                   [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], sem)
    blocks = R.block_keys(keys)
    none = R.carve_voxels(keys, counts, blocks[:0], sem)
    assert none.keys.numel() == 0
    first = R.carve_voxels(keys, counts, torch.unique(blocks)[:1], sem)
    assert torch.equal(first.keys, keys[blocks == blocks.min()])
    assert torch.allclose(first.mean, torch.full_like(first.mean, 0.1))


class ParentTraffic(lidar.Traffic):
    """``lidar.Traffic`` as it was before the street took movers and a
    lane and before ``step`` added the pose over flat rows, kept verbatim
    but for ``self.lane`` and ``self.stop_after``, which ``pose`` now
    reads."""

    def __init__(self, conf: dict, params: dict, seed: int):
        sensor, world = conf["sensor"], conf["world"]
        self.speed = float(params["speed_m"])
        self.lane = 0.0
        self.stop_after = None
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
            origin, ranges, rays = lidar.sweep([x, 0.0, 0.0], boxes, sensor)
            noise = np.random.default_rng([seed, 2, k]).normal(
                0.0, float(sensor["range_noise_m"]), ranges.shape[0])
            origin = origin - np.array([x, 0.0, 0.0])
            self.templates.append(lidar.returns(origin, ranges + noise,
                                                rays))
        self._buf = np.empty((max(len(t) for t in self.templates), 3),
                             np.float32)

    def step(self, i: int):
        k = i % len(self.templates)
        t = self.templates[k]
        out = self._buf[:len(t)]
        np.add(t, self.pose(i), out=out)
        return out, self.position(i), k


@pytest.mark.parametrize("params", [
    {"speed_m": 0.0, "templates": 8}, {"speed_m": 0.82, "templates": 8}],
    ids=["parked", "drive"])
@pytest.mark.parametrize("movers", [None, []], ids=["absent", "empty"])
def test_street_without_movers_is_unchanged(params, movers):
    """With no movers and no lane the generator is the parent's, byte for
    byte: the existing cells' traffic does not move."""
    conf = run.load_json("tsdf_bench/configs/kitti_hdl64.json")
    conf["sensor"]["azimuths"] = 96
    if movers is not None:
        conf["world"]["movers"] = movers
    a = lidar.Traffic(conf, params, 2**31 + 9)
    b = ParentTraffic(conf, params, 2**31 + 9)
    assert len(a.templates) == len(b.templates)
    for x, y in zip(a.templates, b.templates):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for i in (0, 5, 13, 14, 13):
        for x, y in zip(a.step(i), b.step(i)):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_the_car_passes_once_every_cycle():
    """The car shows in every sweep of the cycle, clear of the parked
    car's body, and the cycle repeats."""
    ov = overrides()
    _, _, spec, conf = run.cell_spec("kitti_parked", ov)
    t = run.traffic_of(spec, conf, 5)
    n = spec["params"]["templates"]
    car = conf["world"]["movers"][0]
    half = np.asarray(car["half_m"])
    lane = spec["params"]["lane_y_m"]
    assert car["centre_m"][1] - half[1] > lane + 0.9 + 1.0
    assert car["centre_m"][1] + half[1] < conf["world"]["road_half_m"]
    assert np.array_equal(t.position(7)[:2], [0.0, lane])
    for k in range(n):
        c = np.asarray(car["centre_m"]) + k * np.asarray(car["step_m"])
        p = t.points(k).astype(np.float64)
        on = (np.abs(p[:, :2] - c[:2]) <= half[:2] + 0.1).all(1) & \
            (p[:, 2] > 0.05) & (p[:, 2] <= 2 * half[2] + 0.1)
        assert on.sum() > 20, k
    assert np.array_equal(t.points(n), t.points(0))


def test_trial_reports_the_carve_blocks():
    out = trial.trial("kitti_parked", 3, 0.3, False, overrides(),
                      device="cpu")
    assert out["result"]["correct"], out["result"]["checks"]
    n = run.load_json(TRIAL)["params"]["templates"]
    assert set(out["carve_blocks"]) == {str(k) for k in range(n)}
    assert max(out["carve_blocks"].values()) <= \
        SMALL["map_config"]["touched_capacity"]
    assert out["check_s"] > 0


def test_trial_prints_nothing_when_jax_is_loaded(monkeypatch, capsys,
                                                 tmp_path):
    """A JAX module loaded by the time a run ends: no line printed or
    written, exit 3, as ``run.main``."""
    def fake(name, seed, seconds, trace, overrides, device="cuda"):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"workload": name, "seed": seed, "result": {}}
    monkeypatch.setattr(trial, "trial", fake)
    out = tmp_path / "lines.jsonl"
    rc = trial.main(["--workload", "kitti_parked", "--overrides", TRIAL,
                     "--seeds", "1", "2", "--seconds", "1",
                     "--out", str(out)])
    got = capsys.readouterr()
    assert rc == 3
    assert got.out == "" and "jax" in got.err
    assert not out.exists()


def test_trial_prints_a_line_a_seed(monkeypatch, capsys, tmp_path):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(trial, "trial", lambda name, seed, *a, **k: {
        "workload": name, "seed": seed})
    out = tmp_path / "lines.jsonl"
    rc = trial.main(["--workload", "kitti_parked", "--overrides", TRIAL,
                     "--seeds", "1", "2", "--seconds", "1",
                     "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert [json.loads(x)["seed"] for x in lines] == [1, 2]
    assert out.read_text().splitlines() == lines


@pytest.mark.card
def test_carving_trial_on_the_card(card):
    out = trial.trial("kitti_parked", 2**31 + 23, 2.0, False,
                      run.load_json(TRIAL))
    checks = out["result"]["checks"]
    assert checks["w_mismatch"]["value"] == 0, checks
    assert out["result"]["correct"], checks
    assert max(out["carve_blocks"].values()) <= run.load_json(TRIAL)[
        "map_config"]["touched_capacity"]
