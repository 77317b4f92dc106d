"""The arithmetic of the timed metrics, on synthetic readings."""

import types

import numpy as np
import pytest

from tsdf_bench import run
from tsdf_bench.metrics import (device_idle_pct, finalize_scan_ms,
                                insert_call_ms, mc_ms, ply_ms, points_per_s,
                                save_ms, scan_p95_ms, scans_per_s,
                                voxel_samples_ms)


def test_latency_is_event_end_less_call_start():
    # calls at 0, 10 and 20 ms after the start event; the device ends each
    # scan's work 5, 12 and 40 ms after it
    lat = run.latencies_ms([0.0, 0.010, 0.020], [0.005, 0.012, 0.040])
    assert lat == pytest.approx([5.0, 2.0, 20.0])


def record(lat, grew, call_s=0.002, points=100, save_s=None):
    rec = run.Record()
    rec.window_s = 2.0
    rec.steps = [{"lat_ms": a, "grew": g, "call_s": call_s,
                  "points": points, "save_s": save_s}
                 for a, g in zip(lat, grew)]
    return rec


def test_end_to_end_readers():
    lat = list(range(1, 101))                     # 1..100 ms
    grew = [i % 7 == 6 for i in range(100)]
    rec = record(lat, grew, save_s=0.25)
    assert scans_per_s.read(rec, "") == pytest.approx(50.0)
    assert scan_p95_ms.read(rec, "") == pytest.approx(
        np.percentile(lat, 95))
    assert points_per_s.read(rec, "") == pytest.approx(5000.0)
    assert save_ms.read(rec, "") == pytest.approx(250.0)
    assert insert_call_ms.read(rec, "scans") == pytest.approx(2.0)
    want = np.mean([a for a, g in zip(lat, grew) if g])
    assert finalize_scan_ms.read(rec, "") == pytest.approx(want)


def test_finalize_reads_nothing_without_finishes():
    assert finalize_scan_ms.read(record([3.0, 4.0], [False, False]),
                                 "") is None


@pytest.mark.parametrize("mod,key", [(voxel_samples_ms, "voxel_samples_ms"),
                                     (mc_ms, "mc_ms"), (ply_ms, "ply_ms")])
def test_save_split_readers(mod, key):
    """The mean of ``last_metrics[key]`` over the window's saves; nothing
    where no step saved."""
    rec = record([1.0, 2.0, 3.0], [False] * 3)
    for s, ms in zip(rec.steps, (10.0, 20.0, 60.0)):
        s["save_metrics"] = {key: ms}
    assert mod.read(rec, "") == pytest.approx(30.0)
    assert mod.read(record([1.0], [False]), "") is None


def ev(start, end, name="k"):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_union_and_gaps():
    # busy [10, 30) (two overlapping kernels) and [50, 60) in [0, 100) us
    dev = [ev(10, 20, "a"), ev(15, 30, "b"), ev(50, 60, "a")]
    cpu = [ev(30, 50, "aten::copy_"), ev(0, 100, "bench.step")]
    t = run.reduce_trace(dev, cpu, 0.0, 100.0)
    assert t["busy_s"] == pytest.approx(30e-6)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["kernel_s"]["a"] == pytest.approx(20e-6)
    gaps = dict((n, s) for n, s in t["idle_gaps"])
    assert t["idle_gaps"][0] == ["host: bench.step", pytest.approx(40e-6)]
    assert gaps["host: aten::copy_"] == pytest.approx(20e-6)
    rec = run.Record()
    rec.trace = t
    assert device_idle_pct.read(rec, "scans") == pytest.approx(70.0)


def test_idle_reads_nothing_without_device_work():
    rec = run.Record()
    rec.trace = {"busy_s": 0.0, "window_s": 1.0}
    assert device_idle_pct.read(rec, "scans") is None
