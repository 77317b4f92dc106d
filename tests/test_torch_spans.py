"""The port's spans and counters (``chad_tsdf_tpu_torch/utils/timing.py``):
a span leaves the profiler alone while none runs, nests under one, and
feeds ``last_metrics``; the counters of a CPU map's stream equal the
counts its code gives."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.utils import timing

N = 1024
CFG = MapConfig(max_points=N, block_capacity=8192, touched_capacity=8192,
                accumulate_impl="fused", tile_nb=16, mesh_impl="host",
                max_pending_finalize=1)
ORIGIN = np.zeros(3, np.float32)
FAR = np.float32([7.0, 0.0, 0.0])         # past submap_distance: rotates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(seed, centre=ORIGIN):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d + centre).astype(np.float32)


# two inserts at the origin, then one beyond the submap distance: a rotation
STREAM = [(_sphere(1), ORIGIN), (_sphere(2), ORIGIN), (_sphere(3, FAR), FAR)]


def _raise(*args, **kw):
    raise AssertionError("a profiler range was opened")


def test_span_leaves_the_profiler_alone_while_none_runs(monkeypatch,
                                                        tmp_path):
    """With the profiler off no span opens a profiler range (both entry
    points, ``record_function``'s and the operator range's, patched to
    raise), through a whole stream and save; ``.ms`` is set.  The
    operator range raises under a profiler, so the patch is the one a span
    would reach."""
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    with timing.span("chad.test", args=3) as s:
        pass
    assert s.ms is not None and s.ms >= 0.0
    m = TSDFMap(config=CFG, device="cpu")
    for pts, pos in STREAM:
        m.insert(pts, pos)
    m.save(str(tmp_path / "mesh.ply"))
    with pytest.raises(AssertionError, match="profiler range"):
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("chad.test"):
                pass


def test_no_range_opens_while_a_graph_is_captured(monkeypatch):
    """Under a profiler, a span opened during a CUDA graph capture times
    its block but opens no range and is not kept."""
    monkeypatch.setattr(timing, "_capturing", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("chad.captured") as s:
            pass
    assert s.ms is not None
    assert not [e for e in prof.events() if e.name == "chad.captured"]


def test_span_ranges_are_no_user_annotations():
    """A span's range is an operator's, not a user annotation: the
    profiler would mirror an annotation onto the device's timeline as an
    interval over the kernels launched inside it, read there as device
    work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("chad.kind", args=1):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "chad.kind"]
    assert not ev.is_user_annotation()


def _ranges(prof) -> list:
    """(name, start, end) of the profiler's ``chad.*`` ranges, in order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("chad.")),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(ranges, parent) -> list:
    """The names of ``parent``'s direct children, in order."""
    inner = [r for r in ranges if r != parent and _inside(r, parent)]
    return [r[0] for r in inner
            if not any(q != r and _inside(r, q) for q in inner)]


def test_spans_nest_under_the_profiler(tmp_path):
    """A CPU map's three inserts (the third rotates) and a save emit the
    ``chad.*`` ranges in the profiler with their stated nesting, and the
    program's own record of them (``timing.profiled``) holds the same
    spans."""
    m = TSDFMap(config=CFG, device="cpu")
    with timing.span("chad.unprofiled"):     # ends an earlier stretch
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for pts, pos in STREAM:
            m.insert(pts, pos)
        m.save(str(tmp_path / "mesh.ply"))
    ranges = _ranges(prof)
    inserts = [r for r in ranges if r[0] == "chad.insert"]
    assert [_children(ranges, r) for r in inserts] == [
        ["chad.insert.rotate", "chad.insert.dispatch", "chad.insert.load",
         "chad.insert.step"],
        ["chad.insert.dispatch", "chad.insert.load", "chad.insert.step"],
        ["chad.insert.rotate", "chad.insert.dispatch", "chad.insert.load",
         "chad.insert.step"]]
    (save,) = [r for r in ranges if r[0] == "chad.save"]
    assert _children(ranges, save) == [
        "chad.save.snapshot", "chad.save.voxel_samples", "chad.save.mc",
        "chad.save.normals", "chad.save.ply"]
    (snap,) = [r for r in ranges if r[0] == "chad.save.snapshot"]
    # the drain materializes the rotated-out stub first, then finishes it;
    # then the active map's snapshot is finalized
    assert _children(ranges, snap) == [
        "chad.finalize.counters", "chad.finalize.compact",
        "chad.finalize", "chad.finalize"]
    fins = [r for r in ranges if r[0] == "chad.finalize"]
    assert [_children(ranges, r) for r in fins] == [
        ["chad.finalize.d2h", "chad.finalize.unpack", "chad.finalize.dag"],
        ["chad.finalize.counters", "chad.finalize.counters",
         "chad.finalize.compact", "chad.finalize.d2h",
         "chad.finalize.unpack", "chad.finalize.dag"]]
    for r in ranges:                 # every stage inside its parent span
        parent = r[0].rsplit(".", 1)[0]
        if parent in ("chad.insert", "chad.save"):
            assert any(_inside(r, q) for q in ranges if q[0] == parent), r
    rec = timing.profiled()
    assert sorted(n for n, _, _ in rec["spans"]) == \
        sorted(n for n, _, _ in ranges)


def test_profiled_holds_the_last_profiled_stretch():
    """A span opened with no profiler running ends the stretch: the next
    profiled span starts a new record."""
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("chad.first"):
            timing.count("inserts")
    with timing.span("chad.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("chad.second"):
            pass
    rec = timing.profiled()
    assert [n for n, _, _ in rec["spans"]] == ["chad.second"]
    assert rec["counts"]["inserts"] == 0


def _grew(before: dict) -> dict:
    now = timing.counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def test_counters_over_a_stream(tmp_path):
    """Four inserts with two rotations past ``max_pending_finalize`` = 1,
    then a save: each call's counter growth is the count its code gives
    (fused inserts run their fallback inside the insert: no wait)."""
    cfg = CFG
    m = TSDFMap(config=cfg, device="cpu")
    # the scan's rows (unpadded: the graph pads on the device), the
    # position and the point count cross to the device (InsertGraph.load)
    h2d = N * 12 + 12 + 4
    c = timing.counts()
    m.insert(_sphere(1), ORIGIN)
    assert _grew(c) == {"inserts": 1, "h2d_bytes": h2d}
    c = timing.counts()
    m.insert(_sphere(2), ORIGIN)
    assert _grew(c) == {"inserts": 1, "h2d_bytes": h2d}
    c = timing.counts()
    m.insert(_sphere(3, FAR), FAR)            # rotation 1: left pending
    assert _grew(c) == {"inserts": 1, "h2d_bytes": h2d, "rotations": 1}
    c = timing.counts()
    m.insert(_sphere(4, 2 * FAR), 2 * FAR)    # rotation 2: two pending > 1
    g = _grew(c)
    # the oldest stub's finish: its counter read-back and the wait for its
    # copy
    assert g.pop("d2h_bytes") > 0
    assert g == {"inserts": 1, "h2d_bytes": h2d, "host_syncs": 2,
                 "rotations": 1, "finishes": 1, "finishes_in_insert": 1}
    c = timing.counts()
    m.save(str(tmp_path / "mesh.ply"))
    g = _grew(c)
    assert g.pop("d2h_bytes") > 0
    # the drained stub (counters, copy) 2; the active map's block count 1;
    # its finalize: four overflow counters, two counts, the buffer and the
    # origin, 8; the mesh's own look at the block count 1
    assert g == {"finishes": 2, "host_syncs": 12}
    assert len(m.submaps) == 2 and not m._pending


def test_save_metrics_are_the_spans(tmp_path, monkeypatch):
    """``last_metrics`` after a save keeps its keys (``grid_ms`` with
    ``save_grid``) and takes their values from the save's spans."""
    monkeypatch.chdir(tmp_path)
    m = TSDFMap(config=dataclasses.replace(CFG, save_grid=True),
                device="cpu")
    m.insert(_sphere(1), ORIGIN)
    with profile(activities=[ProfilerActivity.CPU]):
        m.save(str(tmp_path / "mesh.ply"))
    lm = m.last_metrics
    assert {"sub_fin_ms", "mesh_ms", "voxel_samples_ms", "mc_ms",
            "normals_ms", "grid_ms", "ply_ms"} <= set(lm)
    ms = {n: (b - a) * 1e3 for n, a, b in timing.profiled()["spans"]
          if n.startswith("chad.save.")}
    for key, name in (("sub_fin_ms", "snapshot"), ("mc_ms", "mc"),
                      ("voxel_samples_ms", "voxel_samples"),
                      ("normals_ms", "normals"), ("grid_ms", "grid"),
                      ("ply_ms", "ply")):
        assert lm[key] == pytest.approx(ms[f"chad.save.{name}"]), key
    assert lm["mesh_ms"] == pytest.approx(
        lm["voxel_samples_ms"] + lm["mc_ms"] + lm["normals_ms"])
