"""``TSDFMap.insert`` through its CUDA graphs (``core/graph.py``), on the
CPU.

Every chunk of an insert goes through the map's ``InsertGraph`` on its
own active state.  On the card the graph is captured and replayed, with
the fused/tile fallback as a conditional IF node (``ops/conditional.py``);
on the CPU, and with ``graphs_enabled = False``, its step runs eagerly,
the fallback unconditionally.  Here a stand-in graph whose replay re-runs
the captured body in Python drives the card's code: the stand-in's
"capture" runs the body once and puts the state back, and the IF node is
the kernel's plain version (the body runs where the count is positive).
Held bit for bit against the eager step (pools, directory, slot order,
counters, every metric of every insert): clouds of different ``n`` in one
bucket under every backend, dense and sparse (the fused and tile fallback
taken), a stream with two rotations whose stubs are drained after, packed
ingest and carving on and off, the ``state`` setter and ``merge`` between
inserts; a failed capture raises.  Also the IF node's plain version, the
byte bound of the graph caches and ``clear_graphs``, and one map held
against the JAX package's ``TSDFMap`` (directory keys equal, sd within
one codec step, as tests/test_torch_map.py holds the eager map).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu_torch import TSDFMap
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import graph, integrate
from chad_tsdf_tpu_torch.core.state import clone_state
from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from chad_tsdf_tpu_torch.ops import conditional
from chad_tsdf_tpu_torch.utils import timing

N = 2048
STEP = 0.1 / 127          # one 8-bit codec step at trunc = 0.1
FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
          "origin_blocks", "point_overflow", "sample_overflow",
          "block_overflow", "touched_overflow", "tile_overflow")
INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StandInGraph:
    """A ``torch.cuda.CUDAGraph`` stand-in; ``replay`` is set to the
    captured body once the capture is done."""

    def replay(self):
        raise AssertionError("replayed before capture")


@pytest.fixture
def stand_in(monkeypatch):
    """Send CPU inserts through ``InsertGraph`` with a stand-in graph.  The
    stand-in's capture runs the body once on the CPU, then restores the
    state and the metric vector: a capture records, it does not run."""
    monkeypatch.setattr(graph, "use_graph", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    capture = graph.InsertGraph.capture

    def stand_in_capture(self):
        saved, out = clone_state(self.state), self.out.clone()
        capture(self)
        for f in FIELDS:
            getattr(self.state, f).copy_(getattr(saved, f))
        self.out.copy_(out)
        self.graph.replay = lambda: self._step(eager=False)
        if self.carve_graph is not None:
            self.carve_graph.replay = self.run_carve

    monkeypatch.setattr(graph.InsertGraph, "capture", stand_in_capture)
    monkeypatch.setattr(integrate, "_GRAPHS",
                        integrate.GraphCache(integrate.MAX_GRAPH_BYTES))


def _sphere(n, r, seed=0, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r + np.asarray(centre)).astype(np.float32)


def _cfg(**kw):
    return MapConfig(**{**dict(max_points=N, block_capacity=8192,
                               touched_capacity=8192, mesh_impl="host"),
                        **kw})


def _maps(cfg):
    """(graph map, map that runs its graphs' step eagerly) of one
    config."""
    eager = TSDFMap(config=cfg, device="cpu")
    eager.graphs_enabled = False
    return TSDFMap(config=cfg, device="cpu"), eager


def _same_state(a, b, what):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


def _same_maps(g, e):
    """Active and rotated-out states bit-equal."""
    assert len(g._pending) == len(e._pending)
    _same_state(g.state, e.state, "active")
    for i, (p, q) in enumerate(zip(g._pending, e._pending)):
        _same_state(p.raw_state, q.raw_state, f"rotated-out {i}")


def _insert_both(g, e, pts, pos):
    syncs = timing.COUNTS["host_syncs"]
    mg = g.insert(pts, pos)
    # the previous insert was settled when its metrics were read below
    assert timing.COUNTS["host_syncs"] == syncs
    me = e.insert(pts, pos)
    assert dict(mg) == dict(me)
    return mg


# clouds of different n in one bucket: a count baked into the graph would
# leave the later clouds' rows in or out
SIZES = (N, 1500, 1999, 1024)
CLOUDS = {"dense": 0.25, "sparse": 5.0}


@pytest.mark.parametrize("impl", ["fused", "tile", "pallas", "xla", "seg"])
@pytest.mark.parametrize("cloud", ["dense", "sparse"])
def test_graph_insert_equals_eager(impl, cloud, stand_in):
    """Four clouds of different ``n`` in one bucket: one graph, captured
    after the eager first insert and replayed for the other three, each
    insert bit-equal to the eager map's; the fused and tile fallback is
    taken on the sparse sphere and not on the dense one."""
    g, e = _maps(_cfg(accumulate_impl=impl))
    pos = np.zeros(3, np.float32)
    for i, n in enumerate(SIZES):
        _insert_both(g, e, _sphere(N, CLOUDS[cloud], seed=i)[:n], pos)
        _same_maps(g, e)
    (gr,) = g._graphs.values()
    assert gr.replays == len(SIZES) - 1 and gr.state is g.state
    falls_back = impl in ("fused", "tile") and cloud == "sparse"
    assert (int(g.state.tile_overflow) > 0) == falls_back


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("carving", [False, True])
def test_graph_stream_with_two_rotations(packed, carving, stand_in):
    """A KITTI-shaped stream under ``seg`` with two rotations: the stubs
    hold copies of the graphs' state, which the next submap resets in
    place, so after the stream and after the drain both maps agree bit for
    bit (states, then the DAG's counters and voxel samples)."""
    cfg = _cfg(accumulate_impl="seg", packed_ingest=packed,
               submap_distance=2.0,
               carve_steps=64 if carving else 0, carve_subsample=4)
    g, e = _maps(cfg)
    carved = 0
    for i in range(6):
        scan = synthetic_lidar_scan([1.1 * i, 0.0, 0.0], seed=i)
        pts = scan[:: len(scan) // 1800][:1800 - 37 * i]
        met = _insert_both(g, e, pts, np.float32([1.1 * i, 0.0, 1.7]))
        carved += met.get("n_carve_samples", 0)
    assert (carved > 0) == carving
    _same_maps(g, e)
    assert len(g._pending) == 2
    (gr,) = g._graphs.values()
    assert gr.state is g.state
    assert all(p.raw_state.pool_sd is not g.state.pool_sd
               for p in g._pending)
    assert g.stats() == e.stats()
    for a, b in zip(g.voxel_samples(), e.voxel_samples()):
        np.testing.assert_array_equal(a, b)


def test_graph_state_setter_and_merge(stand_in):
    """``merge`` leaves the active state and its graph alone; the
    ``state`` setter with another state drops the graphs, and the next
    insert captures anew on the new state; ``finalize_active`` keeps them
    for the next submap."""
    cfg = _cfg(accumulate_impl="fused")
    g, e = _maps(cfg)
    other = TSDFMap(config=cfg, device="cpu")
    other.graphs_enabled = False
    other.insert(_sphere(N, 1.0, seed=9, centre=(3.0, 0.0, 0.0)),
                 np.float32([3.0, 0.0, 0.0]))
    pos = np.zeros(3, np.float32)
    for m in (g, e):
        m.insert(_sphere(N, 1.0, seed=1), pos)
        m.insert(_sphere(N, 1.0, seed=2)[:1800], pos)
        m.merge(other)
    (gr,) = g._graphs.values()
    _insert_both(g, e, _sphere(N, 1.0, seed=3), pos)
    assert g._graphs.values() == [gr] and gr.replays == 2
    _same_maps(g, e)

    g.state = clone_state(g.state)
    e.state = clone_state(e.state)
    assert not len(g._graphs) and g._gstate is None
    _insert_both(g, e, _sphere(N, 1.0, seed=4), pos)
    (gr2,) = g._graphs.values()
    assert gr2 is not gr and gr2.state is g.state and gr2.replays == 0
    _insert_both(g, e, _sphere(N, 5.0, seed=5), pos)
    _same_maps(g, e)

    g.finalize_active()
    e.finalize_active()
    assert g._graphs.values() == [gr2] and g.state is None
    _insert_both(g, e, _sphere(N, 1.0, seed=6), pos)
    assert g.state is gr2.state and gr2.replays == 2
    _same_maps(g, e)
    assert g.stats() == e.stats()


def test_failed_capture_raises(monkeypatch, stand_in):
    """A capture that fails raises and caches nothing: no fallback to the
    eager insert.  The stage hook is off while capturing and back after."""
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
    g = TSDFMap(config=_cfg(accumulate_impl="fused"), device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        g.insert(_sphere(N, 1.0), np.zeros(3, np.float32))
    assert not len(g._graphs)
    assert ("capture", None) in seen
    assert integrate.STAGE_HOOK is hook


@pytest.mark.parametrize("value", [INT32_MAX, 7, 1, 0, -1, -INT32_MAX - 1])
def test_set_conditional_plain(value):
    """The IF node's plain version: the body runs where the count is
    positive (the one-thread kernel's ``*flag > 0``)."""
    flag = torch.tensor(value, dtype=torch.int32)
    assert conditional.set_conditional_plain(flag) == (value > 0)
    ran = []
    conditional.if_positive(flag, lambda: ran.append(True))
    assert ran == ([True] if value > 0 else [])


def test_pack_points_device_bit_equal():
    """The graph's packing equals ``pack_points`` bit for bit: random
    points, exact half steps (round half to even), and points beyond the
    clip on both sides."""
    rng = np.random.default_rng(5)
    res = 0.05
    step = res / 8.0
    pos = np.float32([1.25, -3.5, 1.7])
    pts = np.concatenate([
        rng.uniform(-60.0, 60.0, (4096, 3)),
        pos + step * (np.arange(-8, 8)[:, None] + 0.5) * np.ones((1, 3)),
        pos + np.asarray([[300.0, -300.0, 0.0], [-1e4, 1e4, 5.0]]),
    ]).astype(np.float32)
    want = integrate.pack_points(pts, pos, res)
    got = integrate.pack_points_device(torch.from_numpy(pts),
                                       torch.from_numpy(pos), res)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int16
    assert {-32767, 32767} <= set(np.unique(want).tolist())


class _Sized:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_graph_cache_byte_bound():
    """The least recently used graphs go once a new one takes the cache
    past its bytes; the newest always stays; ``get`` refreshes."""
    c = integrate.GraphCache(100)
    a, b, d = _Sized(40), _Sized(50), _Sized(30)
    c.put("a", a)
    c.put("b", b)
    assert c.nbytes() == 90 and len(c) == 2
    assert c.get("a") is a                  # now b is the oldest
    c.put("d", d)
    assert c.values() == [a, d] and c.nbytes() == 70
    big = _Sized(500)
    c.put("big", big)
    assert c.values() == [big]
    c.clear()
    assert not len(c) and c.nbytes() == 0


def test_steps_scan_graphs_bounded_and_cleared(stand_in):
    """``insert_steps_scan``'s cache holds each graph's state copy in its
    bytes; a second cloud shape past the bound evicts the first, and
    ``clear_graphs`` empties it."""
    from chad_tsdf_tpu_torch.core.state import (create_state, state_nbytes,
                                                origin_blocks_for_position)
    cfg = _cfg(accumulate_impl="seg")
    origin = origin_blocks_for_position(np.zeros(3), cfg)
    pos = torch.zeros(3)
    st = create_state(cfg, origin, "cpu")
    pts = torch.from_numpy(_sphere(N, 1.0))
    integrate.insert_steps_scan(st, pts, N, pos, cfg, 2)
    (g1,) = integrate._GRAPHS.values()
    assert g1.nbytes > state_nbytes(st)
    integrate._GRAPHS.max_bytes = g1.nbytes
    half = pts[:N // 2].contiguous()
    integrate.insert_steps_scan(create_state(cfg, origin, "cpu"), half,
                                N // 2, pos, cfg, 2)
    (g2,) = integrate._GRAPHS.values()
    assert g2 is not g1
    integrate.clear_graphs()
    assert not len(integrate._GRAPHS)


def test_graph_map_matches_jax(stand_in):
    """The graph map (``fused``, two inserts: the eager first, then a
    replay) against the JAX ``TSDFMap`` under ``xla`` on the same clouds:
    voxel codes equal, sd within one codec step."""
    cfg = _cfg(max_points=4096, block_capacity=4096, touched_capacity=4096,
               accumulate_impl="fused")
    jm = JaxTSDFMap(config=JaxMapConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, accumulate_impl="xla"))))
    tm = TSDFMap(config=cfg, device="cpu")
    pos = np.asarray([0.05, -0.02, 0.01], np.float32)
    for seed in (3, 4):
        pts = _sphere(4096, 1.0, seed)
        jm.insert(pts, pos)
        tm.insert(pts, pos)
    assert len(tm._graphs) == 1 and tm._graphs.values()[0].replays == 1
    jc, jsd = jm.voxel_samples()
    tc, tsd = tm.voxel_samples()
    np.testing.assert_array_equal(tc, jc)
    assert np.abs(tsd - jsd).max() <= STEP + 1e-7
