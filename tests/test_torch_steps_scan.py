"""The port's ``insert_steps_scan`` (the same cloud ``reps`` times) on the
CPU, against the JAX package's ``insert_steps_scan`` (a ``lax.scan`` over
the insert) under ``test_torch_fused.compare``'s gate: directory keys
equal, weights exact, sd within 1e-4 per weight.  On a dense cloud
(r = 0.25) and a sparse one (r = 5, whose fused inserts fall back), under
``fused`` (the JAX Pallas kernels in interpret mode) and ``pallas`` (under
``pltpu.force_tpu_interpret_mode``; that kernel rounds sd to bf16, so the
port's ``pallas`` scan meets the 1e-4 gate against the JAX ``xla`` scan and
1e-3 per weight against the JAX ``pallas`` one).

On the card ``insert_steps_scan`` replays a captured CUDA graph
(``core.graph.InsertGraph`` on a copy of the state, the fused/tile fallback
an IF node decided on the device).  Here a stand-in graph whose replay
re-runs the captured body in Python drives the same code: the state copy,
the carried fields, the fallback's branch (the IF node's plain version)
and the cache, bit-equal to a loop of ``insert_step``; and a failed capture
raises."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import graph, integrate
from chad_tsdf_tpu_torch.core.state import (clone_state, create_state,
                                            origin_blocks_for_position)
from tests.test_torch_fused import compare

N = 2048
REPS = 3
FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
          "point_overflow", "sample_overflow", "block_overflow",
          "touched_overflow", "tile_overflow")
CLOUDS = {"dense": 0.25, "sparse": 5.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(r, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _cfg(impl):
    return MapConfig(max_points=N, block_capacity=8192, touched_capacity=8192,
                     accumulate_impl=impl)


def _origin(cfg):
    return origin_blocks_for_position(np.zeros(3, np.float32), cfg)


@pytest.fixture(scope="module")
def jax_scans():
    """JAX ``insert_steps_scan`` results by (impl, cloud), computed once
    each: the compile is shared by the two clouds of one backend."""
    cache = {}

    def get(impl, cloud):
        if (impl, cloud) not in cache:
            jcfg = JaxMapConfig(**dataclasses.asdict(_cfg(impl)))
            ctx = (pltpu.force_tpu_interpret_mode() if impl == "pallas"
                   else contextlib.nullcontext())
            with ctx:
                cache[impl, cloud] = j_integrate.insert_steps_scan(
                    j_create_state(jcfg, _origin(_cfg(impl))),
                    jnp.asarray(_sphere(CLOUDS[cloud])), jnp.int32(N),
                    jnp.zeros(3, jnp.float32), jcfg, REPS)
        return cache[impl, cloud]
    return get


def _port_scan(cfg, pts, reps=REPS, state=None):
    state = create_state(cfg, _origin(cfg), "cpu") if state is None \
        else state
    return integrate.insert_steps_scan(
        state, torch.from_numpy(pts), N, torch.zeros(3), cfg, reps)


def _port_loop(cfg, pts, reps=REPS, state=None):
    state = create_state(cfg, _origin(cfg), "cpu") if state is None \
        else state
    for _ in range(reps):
        state, _ = integrate.insert_step(state, torch.from_numpy(pts), N,
                                         torch.zeros(3), cfg)
    return state


def _bit_equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _compare_bf16(j_state, t_state):
    """``compare`` with the sd gate of the JAX ``pallas`` kernel, whose
    one-hot product rounds sd to bf16: 1e-3 per weight, as
    tests/test_torch_accumulate.py holds K5 to ``accumulate_pallas``."""
    nbk = int(j_state.n_blocks)
    np.testing.assert_array_equal(t_state.dir_keys.numpy(),
                                  np.asarray(j_state.dir_keys))
    assert int(t_state.n_blocks) == nbk
    sl_j = np.asarray(j_state.dir_slots)[:nbk]
    sl_t = t_state.dir_slots.numpy()[:nbk]
    wj = np.asarray(j_state.pool_w)[sl_j]
    np.testing.assert_array_equal(t_state.pool_w.numpy()[sl_t], wj)
    err = np.abs(t_state.pool_sd.numpy()[sl_t] -
                 np.asarray(j_state.pool_sd)[sl_j]) / np.maximum(wj, 1)
    assert err.max() < 1e-3, err.max()


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("cloud", ["dense", "sparse"])
def test_steps_scan_matches_jax(impl, cloud, jax_scans):
    """``fused`` against the JAX fused scan under ``compare``'s gate;
    ``pallas`` under that gate against the JAX scan's f32 twin (``xla``)
    and with the bf16 gate against the JAX ``pallas`` scan."""
    cfg = _cfg(impl)
    ts = _port_scan(cfg, _sphere(CLOUDS[cloud]))
    if impl == "fused":
        compare(jax_scans(impl, cloud), ts)
    else:
        compare(jax_scans("xla", cloud), ts)
        _compare_bf16(jax_scans(impl, cloud), ts)
    assert int(ts.tile_overflow) == int(jax_scans(impl, cloud).tile_overflow)
    falls_back = impl == "fused" and cloud == "sparse"
    assert (int(ts.tile_overflow) > 0) == falls_back


class _StandInGraph:
    """A ``torch.cuda.CUDAGraph`` stand-in; ``replay`` is set to the
    captured body once the capture is done."""

    def replay(self):
        raise AssertionError("replayed before capture")


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Send ``insert_steps_scan`` on the CPU through ``InsertGraph`` with a
    stand-in graph that re-runs its body (the stand-in's "capture" runs it
    once and puts the graph's state copy back: a capture records, it does
    not run)."""
    monkeypatch.setattr(graph, "use_graph", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    capture = graph.InsertGraph.capture

    def stand_in_capture(self):
        saved = clone_state(self.state)
        capture(self)
        for f in FIELDS:
            getattr(self.state, f).copy_(getattr(saved, f))
        self.graph.replay = lambda: self._step(eager=False)

    monkeypatch.setattr(graph.InsertGraph, "capture", stand_in_capture)
    monkeypatch.setattr(integrate, "_GRAPHS",
                        integrate.GraphCache(integrate.MAX_GRAPH_BYTES))
    return integrate._GRAPHS


@pytest.mark.parametrize("impl", ["fused", "tile", "pallas", "xla", "seg"])
@pytest.mark.parametrize("cloud", ["dense", "sparse"])
def test_step_graph_equals_loop(impl, cloud, stand_in_graphs):
    """Bit-equal to a loop of ``insert_step`` (tests/test_integrate.py's
    test for the JAX scan), then once more from that state through the
    cached graph, whose every rep is a replay."""
    cfg = _cfg(impl)
    pts = _sphere(CLOUDS[cloud])
    scan = _port_scan(cfg, pts)
    loop = _port_loop(cfg, pts)
    _bit_equal(scan, loop)
    (g,) = stand_in_graphs.values()
    fallback = impl in ("fused", "tile") and cloud == "sparse"
    assert (int(scan.tile_overflow) > 0) == fallback
    assert g.replays == REPS - 1
    assert set(g.body_launches) == set()     # no kernel on the CPU
    scan = _port_scan(cfg, pts, 2, scan)
    _bit_equal(scan, _port_loop(cfg, pts, 2, loop))
    assert len(stand_in_graphs) == 1 and g.replays == REPS - 1 + 2


def test_steps_scan_reps(stand_in_graphs):
    """``reps=1`` is one insert and captures nothing, ``reps=0`` returns
    the state untouched, a negative count raises."""
    cfg = _cfg("fused")
    pts = _sphere(CLOUDS["sparse"])
    _bit_equal(_port_scan(cfg, pts, 1), _port_loop(cfg, pts, 1))
    assert not len(stand_in_graphs)
    state = create_state(cfg, _origin(cfg), "cpu")
    assert _port_scan(cfg, pts, 0, state) is state
    with pytest.raises(ValueError):
        _port_scan(cfg, pts, -1)


def test_failed_capture_raises(monkeypatch, stand_in_graphs):
    """A capture that fails raises and leaves nothing cached: no fallback
    to the eager loop.  The stage hook is off while capturing and back
    after."""
    seen = []

    def hook(name):
        seen.append(name)

    @contextlib.contextmanager
    def failing(g):
        seen.append(("capture", integrate.STAGE_HOOK))
        yield
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "graph", failing)
    monkeypatch.setattr(integrate, "STAGE_HOOK", hook)
    with pytest.raises(RuntimeError, match="capturing"):
        _port_scan(_cfg("fused"), _sphere(CLOUDS["dense"]))
    assert not len(stand_in_graphs)
    assert ("capture", None) in seen
    assert integrate.STAGE_HOOK is hook
