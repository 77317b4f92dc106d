"""The readers of the program's spans and counters, on synthetic spans
and synthetic ``Record``s."""

import types

import pytest

from tsdf_bench import run
from tsdf_bench.metrics import (cluster_unpack_ms, dag_build_ms,
                                host_syncs_per_step, insert_dispatch_ms,
                                insert_load_ms, insert_self_ms, spans,
                                vertex_normals_ms)


def test_self_time_with_nested_and_adjacent_children():
    # an insert [0, 10): dispatch [1, 2) and load [2, 5) adjacent, a replay
    # [6, 9) holding a span of its own [7, 8)
    got = spans.table([("chad.insert.load", 2.0, 5.0),
                       ("chad.insert", 0.0, 10.0),
                       ("chad.insert.dispatch", 1.0, 2.0),
                       ("x.inner", 7.0, 8.0),
                       ("chad.insert.replay", 6.0, 9.0),
                       ("chad.insert", 12.0, 14.0)])
    assert got["chad.insert"] == {"count": 2, "total_s": 12.0,
                                  "self_s": 3.0 + 2.0}
    assert got["chad.insert.replay"]["self_s"] == 2.0
    assert got["chad.insert.load"] == {"count": 1, "total_s": 3.0,
                                       "self_s": 3.0}
    # children plus self make up the parent
    kids = sum(got[k]["total_s"] for k in ("chad.insert.dispatch",
                                           "chad.insert.load",
                                           "chad.insert.replay"))
    assert kids + got["chad.insert"]["self_s"] == \
        got["chad.insert"]["total_s"]


def test_innermost_pieces():
    pieces = spans.innermost([("a", 1.0, 9.0), ("b", 2.0, 4.0),
                              ("c", 4.0, 5.0)], 0.0, 10.0)
    assert pieces == [(0.0, 1.0, "outside"), (1.0, 2.0, "a"),
                      (2.0, 4.0, "b"), (4.0, 5.0, "c"), (5.0, 9.0, "a"),
                      (9.0, 10.0, "outside")]


def test_idle_by_span():
    # the device busy [1, 3) and [6, 7) in [0, 10); the host in a [0, 5)
    # holding b [2, 4), then in c [5, 8)
    busy = [[1.0, 3.0], [6.0, 7.0]]
    got = spans.idle_by_span(busy, [("a", 0.0, 5.0), ("b", 2.0, 4.0),
                                    ("c", 5.0, 8.0)], 0.0, 10.0)
    assert got == pytest.approx({"a": 1.0 + 1.0, "b": 1.0, "c": 2.0,
                                 "outside": 2.0})
    assert sum(got.values()) == pytest.approx(10.0 - 3.0)
    assert spans.idle_by_span([], [], 0.0, 2.0) == {"outside": 2.0}


def rec_with(monkeypatch, span_list, counts=None, steps=4):
    rec = run.Record()
    rec.trace = {"steps": steps, "busy_s": 1.0, "window_s": 2.0}
    monkeypatch.setattr(spans, "profiled", lambda r: {
        "spans": span_list, "counts": counts or {}} if r.trace else None)
    return rec


def test_insert_readers(monkeypatch):
    two = [("chad.insert", 0.0, 0.010), ("chad.insert.dispatch", 0.001,
                                         0.002),
           ("chad.insert.load", 0.002, 0.006),
           ("chad.insert", 0.020, 0.024),
           ("chad.insert.load", 0.021, 0.023)]
    rec = rec_with(monkeypatch, two, {"host_syncs": 2}, steps=2)
    assert insert_dispatch_ms.read(rec, "scans") == pytest.approx(0.5)
    assert insert_load_ms.read(rec, "points") == pytest.approx(3.0)
    assert insert_self_ms.read(rec, "scans") == pytest.approx(
        (10 - 1 - 4 + 4 - 2) / 2)
    assert host_syncs_per_step.read(rec, "scans") == pytest.approx(1.0)


def test_save_readers(monkeypatch):
    one = [("chad.save", 0.0, 1.0), ("chad.save.snapshot", 0.0, 0.4),
           ("chad.finalize", 0.1, 0.4), ("chad.finalize.unpack", 0.1, 0.15),
           ("chad.finalize.dag", 0.15, 0.35),
           ("chad.save.normals", 0.6, 0.7)]
    rec = rec_with(monkeypatch, one)
    assert cluster_unpack_ms.read(rec, "") == pytest.approx(50.0)
    assert dag_build_ms.read(rec, "") == pytest.approx(200.0)
    assert vertex_normals_ms.read(rec, "") == pytest.approx(100.0)


def test_none_where_a_span_is_absent(monkeypatch):
    rec = rec_with(monkeypatch, [("chad.insert", 0.0, 1.0)])
    assert insert_load_ms.read(rec, "points") is None
    assert cluster_unpack_ms.read(rec, "") is None
    assert host_syncs_per_step.read(rec, "save") is None   # no counter
    rec.trace = None                                    # an untraced run
    assert insert_self_ms.read(rec, "scans") is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent program has no ``timing.profiled``: every reader gives
    None and raises nothing."""
    from chad_tsdf_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "profiled")
    rec = run.Record()
    rec.trace = {"steps": 2, "busy_s": 1.0, "window_s": 2.0}
    for mod in (insert_dispatch_ms, insert_load_ms, insert_self_ms,
                cluster_unpack_ms, dag_build_ms, vertex_normals_ms,
                host_syncs_per_step):
        assert mod.read(rec, "") is None, mod.__name__


def ev(start, end, name="k"):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end))


def test_reduce_trace_is_unchanged():
    """``run.reduce_trace`` on a fixed input gives what it gave before the
    spans existed, whole."""
    dev = [ev(10, 20, "void k1<int>(float*)"), ev(15, 30, "k2"),
           ev(50, 60, "void k1<int>(float*)"), ev(95, 120, "k2")]
    cpu = [ev(30, 50, "aten::copy_"), ev(0, 100, "bench.step"),
           ev(60, 95, "chad.insert.load")]
    assert run.reduce_trace(dev, cpu, 0.0, 100.0) == {
        "busy_s": pytest.approx(35e-6),
        "window_s": pytest.approx(100e-6),
        "kernel_s": {"void k1<int>(float*)": pytest.approx(20e-6),
                     "k2": pytest.approx(40e-6)},
        "device_ops": [["k2", pytest.approx(40e-6)],
                       ["void k1", pytest.approx(20e-6)]],
        "idle_gaps": [["host: chad.insert.load", pytest.approx(35e-6)],
                      ["host: aten::copy_", pytest.approx(20e-6)],
                      ["host: bench.step", pytest.approx(10e-6)]]}


def test_trace_spans_on_the_cpu(kept_cells):
    """``trace_spans`` on a small ``sphere_save`` on the CPU: every save's
    stage spans and its self time make up the save, the idle time (all of
    the slice, with no device) is split by span, and the turns time the
    calls."""
    from tsdf_bench import trace_spans
    out = trace_spans.report(
        "sphere_save", 2**31 + 11, turns=1, device="cpu",
        overrides={"cloud": {"points": 2048}, "warm_steps": 1,
                   "trace_steps": 2,
                   "map_config": {"block_capacity": 1 << 13,
                                  "max_points": 1 << 13}})
    t = out["spans"]
    assert t["chad.save"]["count"] == 2 == t["chad.insert"]["count"]
    kids = sum(v["total_s"] for k, v in t.items()
               if k.startswith("chad.save."))
    assert kids + t["chad.save"]["self_s"] == pytest.approx(
        t["chad.save"]["total_s"])
    assert out["busy_s"] == 0.0
    assert sum(out["idle_by_span"].values()) == pytest.approx(
        out["window_s"])
    assert out["counts"]["inserts"] == 2 and out["counts"]["finishes"] == 2
    assert len(out["turns"]) == 1 and out["turns"][0]["traced_ms"] > 0
