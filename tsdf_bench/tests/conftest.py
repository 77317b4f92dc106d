"""Tests of the benchmark harness.  Tests that need a CUDA card carry the
``card`` marker and skip without one; the decision is made in the
``card`` fixture, never while a module is imported."""

import os

import pytest
import torch

from tsdf_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    """The harness reads BENCHMARK.json from the checkout's root, where
    its command runs."""
    monkeypatch.chdir(ROOT)


# Cells whose files the harness keeps although BENCHMARK.json does not
# list them (PERF.md, Open questions): their entries as a manifest would
# give them.
KEPT = [{"name": "kitti_drive", "config": "kitti_hdl64", "traffic": "drive",
         "chips": 1},
        {"name": "kitti_drive_save", "config": "kitti_hdl64",
         "traffic": "drive_stop_save", "chips": 1},
        {"name": "sphere_save", "config": "sphere_1m",
         "traffic": "insert_save", "chips": 1}]


@pytest.fixture
def kept_cells(monkeypatch):
    """``run.cell_spec`` finds the kept cells besides the listed ones."""
    load = run.load_json

    def with_kept(path):
        out = load(path)
        if path == "BENCHMARK.json":
            out["workloads"] = out["workloads"] + KEPT
        return out
    monkeypatch.setattr(run, "load_json", with_kept)
