"""Every cell, listed in BENCHMARK.json or kept beside it, resolves its
files and readers by name."""

import importlib
import json
import os

import pytest

from tsdf_bench import run

from .conftest import KEPT

with open(os.path.join(os.path.dirname(run.HERE), "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


@pytest.mark.parametrize("cell", CELLS + [w["name"] for w in KEPT])
def test_cell_resolves(cell, kept_cells):
    bench, entry, spec, conf = run.cell_spec(cell)
    assert spec["config"] == entry["config"] == conf["name"]
    gen = importlib.import_module(f"tsdf_bench.traffic.{spec['generator']}")
    assert callable(gen.Traffic)
    assert spec["step"] in ("insert", "insert_save")
    assert set(spec["limits"]) >= {"w_mismatch", "sd_off_share"}
    from chad_tsdf_tpu_torch import MapConfig
    MapConfig(**conf["map_config"])
    for trace in (False, True):
        for m in run.cell_metrics(bench, cell, trace):
            mod, _ = run.reader(m["name"])
            assert callable(mod.read)


def test_readers_declare_unit_and_moved_metric():
    with open(os.path.join(os.path.dirname(run.HERE), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod, suffix = run.reader(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if "moves" in m:
            assert mod.MOVES[suffix] == m["moves"], m["name"]
