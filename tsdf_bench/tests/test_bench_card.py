"""On a card: one short run of every cell, correct and with its metrics
(``python3 -m pytest tsdf_bench/tests -m card``)."""

import json

import pytest

from tsdf_bench import run

with open(run.os.path.join(run.os.path.dirname(run.HERE),
                           "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    out = run.run_cell(cell, 2**31 + 21, 2.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert "setup_s" in out["metrics"]
