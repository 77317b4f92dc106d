"""The carving cell ``kitti_parked_carve`` on the CPU at a size a test run
holds: ``correct`` with and without the passing car; a touched capacity
that holds a sweep's insert but not its carve fails every step through
the map's ``overflow["touched"]`` and is not ``correct``; the cell's files
are ``kitti_parked``'s under the trial's overrides; and the carve readers
read nothing from a program without the carve's counters."""

import pytest
import torch

from tsdf_bench import run
from tsdf_bench.metrics import carve_device_ms, carve_share_pct

CELL = "kitti_parked_carve"
TRIAL = "tsdf_bench/trials/kitti_parked_carve.json"
# the small sizes of test_bench_carve.py: a sweep's insert touches up to
# ~7,400 blocks there, its carve ~10,600
SMALL = {"sensor": {"azimuths": 96}, "warm_steps": 8,
         "map_config": {"block_capacity": 1 << 16,
                        "touched_capacity": 1 << 15, "max_points": 1 << 13}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(car: bool = True, touched: int = 1 << 15) -> dict:
    out = {**SMALL, "map_config": {**SMALL["map_config"],
                                   "touched_capacity": touched}}
    if not car:
        out["world"] = {"movers": []}
    return out


@pytest.mark.parametrize("seed", [2**31 + 5, 7, 4_000_000_011])
@pytest.mark.parametrize("car", [False, True], ids=["street", "car"])
def test_carve_cell_is_correct(car, seed):
    out = run.run_cell(CELL, seed, 1.0, False, device="cpu",
                       overrides=small(car))
    checks = out["checks"]
    assert out["failed"] == 0
    assert checks["w_mismatch"]["value"] == 0, checks
    assert checks["sd_off_share"]["value"] <= 0.01, checks
    assert out["correct"]


def test_carve_past_the_touched_cap_fails_every_step():
    """8,192 touched blocks hold each small sweep's insert, not its
    carve: the map warns that samples were dropped, the window's close
    reads the carve's lost blocks in ``overflow["touched"]`` (the same
    sweeps not carved lose nothing), and the run fails every step."""
    ov = small(touched=1 << 13)
    _, _, spec, conf = run.cell_spec(CELL, ov)
    from chad_tsdf_tpu_torch import MapConfig, TSDFMap
    traffic = run.traffic_of(spec, conf, 11)
    touched = {}
    for steps in (0, conf["map_config"]["carve_steps"]):
        m = TSDFMap(config=MapConfig(**{**conf["map_config"],
                                        "carve_steps": steps}),
                    device="cpu")
        for i in range(len(traffic.templates)):
            pts, pos, _ = traffic.step(i)
            m.insert(pts, pos)
        if steps:
            with pytest.warns(UserWarning, match="touched_overflow"):
                touched[steps] = m.stats()["overflow"]["touched"]
        else:
            touched[steps] = m.stats()["overflow"]["touched"]
        del m
    assert touched[0] == 0 < touched[conf["map_config"]["carve_steps"]]

    out = run.run_cell(CELL, 11, 1.0, False, device="cpu", overrides=ov)
    assert out["attempted"] > 0
    assert out["failed"] == out["attempted"]
    assert not out["correct"]


def test_cell_is_kitti_parked_under_the_trial():
    """The cell's configuration and traffic are ``kitti_parked``'s with
    the trial's overrides and 20 warm-up steps (each template once), so
    the cell and the trial cannot drift apart."""
    _, _, parked, parked_conf = run.cell_spec("kitti_parked",
                                              run.load_json(TRIAL))
    _, entry, cell, conf = run.cell_spec(CELL)
    assert entry["config"] == conf["name"] == "kitti_hdl64_carve"
    assert conf["map_config"] == parked_conf["map_config"]
    assert conf["sensor"] == parked_conf["sensor"]
    world = {k: v for k, v in parked_conf["world"].items() if k != "assumed"}
    assert conf["world"] == world
    for k, v in parked_conf["world"]["assumed"].items():
        assert conf["assumed"][k] == v, k
    assert conf["reduced"] == []
    parked = {**parked, "config": "kitti_hdl64_carve", "warm_steps": 20}
    assert cell == parked
    assert cell["warm_steps"] == cell["params"]["templates"]


class _Rec:
    def __init__(self, trace):
        self.trace = trace


@pytest.mark.parametrize("profiled", [
    None,
    {"spans": [("chad.insert", 0.0, 1.0)], "counts": {"inserts": 1}},
    {"spans": [("chad.insert", 0.0, 1.0)],
     "counts": {"carve_device_us": 0, "carve_timed": 0}}],
    ids=["no_spans", "no_counters", "none_timed"])
def test_carve_readers_read_nothing_without_the_counters(profiled,
                                                         monkeypatch):
    from chad_tsdf_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "profiled", lambda: profiled)
    rec = _Rec({"steps": 10, "busy_s": 0.08, "window_s": 0.1})
    assert carve_device_ms.read(rec, "") is None
    assert carve_share_pct.read(rec, "") is None
    monkeypatch.delattr(timing, "profiled")
    assert carve_device_ms.read(rec, "") is None
    assert carve_share_pct.read(_Rec(None), "") is None


def test_carve_readers_arithmetic(monkeypatch):
    from chad_tsdf_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "profiled", lambda: {
        "spans": [("chad.insert", 0.0, 1.0)],
        "counts": {"carve_device_us": 65_000, "carve_timed": 10}})
    rec = _Rec({"steps": 10, "busy_s": 0.08, "window_s": 0.1})
    assert carve_device_ms.read(rec, "") == pytest.approx(6.5)
    assert carve_share_pct.read(rec, "") == pytest.approx(81.25)
