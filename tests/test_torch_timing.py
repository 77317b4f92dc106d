"""The port's ``utils/timing.py`` on the CPU against the JAX package's
``chad_tsdf_tpu/utils/timing.py``: ``profile_insert``'s state and metrics
under ``test_torch_fused.compare``'s gate and its report's stage names and
line count; ``StageTimer``'s nesting and order; ``trace`` writing a
Chrome trace; ``JsonMetricsSink`` writing the JAX sink's keys for the same
insert, with int values."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu.utils import JsonMetricsSink as JaxJsonMetricsSink
from chad_tsdf_tpu.utils import timing as j_timing
from chad_tsdf_tpu_torch import TSDFMap
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.utils import (JsonMetricsSink, StageTimer,
                                       profile_insert, trace)
from chad_tsdf_tpu_torch.utils import timing
from tests.test_torch_fused import compare

N = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _cfg():
    return MapConfig(max_points=N, block_capacity=8192, touched_capacity=8192)


def test_profile_insert_matches_jax():
    cfg = _cfg()
    jcfg = JaxMapConfig(**dataclasses.asdict(cfg))
    pts = _sphere()
    origin = origin_blocks_for_position(np.zeros(3, np.float32), cfg)
    js, jm, jreport = j_timing.profile_insert(
        j_create_state(jcfg, origin), jnp.asarray(pts), jnp.int32(N),
        jnp.zeros(3, jnp.float32), jcfg)
    ts, tm, treport = profile_insert(
        create_state(cfg, origin, "cpu"), torch.from_numpy(pts), N,
        torch.zeros(3), cfg)
    compare(js, ts)
    assert {k: int(v) for k, v in tm.items()} == \
        {k: int(v) for k, v in jm.items()}
    names = [line[:8].strip() for line in treport.splitlines()]
    assert names == [line[:8].strip() for line in jreport.splitlines()]
    assert names == ["mc+norm", "smp sort", "pool upd", "total"]
    for line in treport.splitlines():
        float(line[8:])                      # "{name:<8} {ms:8.2f}"


def test_stage_timer_nesting_and_order():
    t = StageTimer("cpu")
    with t.stage("outer"):
        with t.stage("inner"):
            pass
        with t.stage("second", sync_on=torch.zeros(1)):
            pass
    t.mark("a")
    t.mark("b")
    names = [name for name, _ in t.stages]
    # a nested stage ends, and is listed, before the stage around it
    assert names == ["inner", "second", "outer", "a", "b"]
    ms = dict(t.stages)
    assert all(v >= 0.0 for v in ms.values())
    assert ms["outer"] >= ms["inner"] + ms["second"]
    lines = t.report().splitlines()
    assert [x.split()[0] for x in lines] == names + ["total"]
    assert float(lines[-1].split()[1]) >= ms["outer"]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir), device="cpu") as where:
        assert where == str(logdir)
        (torch.ones(64) * 2).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as fh:
        assert "traceEvents" in json.load(fh)


def test_json_metrics_sink_matches_jax(tmp_path):
    """One insert into each package's map, written as demo_kitti writes it:
    the JAX keys, all ints; the port's insert (the sort-based backend, no
    fallback to settle) does not wait for the device."""
    kw = dict(max_points=N, block_capacity=8192, touched_capacity=8192)
    pts = _sphere()
    pos = np.zeros(3, np.float32)
    out = {}
    for name, m, sink_cls in (
            ("jax", JaxTSDFMap(config=JaxMapConfig(**kw)),
             JaxJsonMetricsSink),
            ("port", TSDFMap(config=MapConfig(**kw), device="cpu"),
             JsonMetricsSink)):
        path = tmp_path / f"{name}.jsonl"
        sink = sink_cls(str(path))
        syncs = timing.COUNTS["host_syncs"]
        met = m.insert(pts, pos)
        if name == "port":
            assert timing.COUNTS["host_syncs"] == syncs
        sink.write({"scan": 1, "n_points": N, **met})
        sink.write({"scan": 2, "raw": torch.tensor(7, dtype=torch.int32)})
        sink.close()
        out[name] = [json.loads(x) for x in path.read_text().splitlines()]
    j, t = out["jax"][0], out["port"][0]
    assert set(t) == set(j)
    for k in j:
        if k != "ts":
            assert t[k] == j[k] and type(t[k]) is int, k
    assert out["port"][1]["raw"] == 7 and len(out["port"]) == 2
