"""The carve's lossy drops and its device time, on the CPU, and the
carve's own graph on the card.

``core/carve.py`` looks a carve's blocks up only as far as
``touched_capacity``; the blocks ranked past it are lost and counted in
the state's ``touched_overflow``, as an insert's are (their samples never
in ``n_carve_dropped``, the erosion rule's drops), which the map reads at
its check, at a rotation's drain and in ``stats()``, on one device and
sharded.  A carving map's inserts count ``carve_inserts``, and its carves'
time ``carve_device_us`` / ``carve_timed`` (``utils/timing.py``
``CarveClock``: events on the card, the host clock here).  With carving off the map reads and counts nothing
new.  On the card the carve is a second graph replayed after the insert's
(``core/graph.py``), held bit for bit against the eager carve.

No JAX here: the test marked ``card`` runs on the card, where JAX is not
installed (``python3 -m pytest tests/test_torch_carve_overflow.py -m
card``)."""

import dataclasses

import numpy as np
import pytest
import torch

from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import carve, integrate
from chad_tsdf_tpu_torch.core.state import (INT32_MAX, ActiveMapState,
                                            clone_state, create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from chad_tsdf_tpu_torch.utils import timing

CFG = MapConfig(max_points=4096, block_capacity=4096, touched_capacity=1024,
                block_bits=7, accumulate_impl="xla", normals_impl="xla",
                carve_steps=40, carve_stride=2.0, carve_subsample=1,
                carve_weight=1.0)
POS = np.zeros(3, np.float32)
# the wall's insert touches 36 blocks, its carve 90
INSERT_BLOCKS, CARVE_BLOCKS = 36, 90
CARVE_KEYS = ("carve_inserts", "carve_device_us", "carve_timed")
FIELDS = tuple(f.name for f in dataclasses.fields(ActiveMapState))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wall(x=1.9, n=600, half=1.0, seed=3):
    """n points on the plane X=x, spread over [-half, half]^2 in (y, z)."""
    rng = np.random.default_rng(seed)
    yz = rng.uniform(-half, half, (n, 2))
    return np.column_stack([np.full(n, x, np.float32),
                            yz[:, 0], yz[:, 1]]).astype(np.float32)


WALL = _wall()


def _pad(points, n_max=CFG.max_points):
    out = np.zeros((n_max, 3), np.float32)
    out[:len(points)] = points
    return torch.from_numpy(out)


def _walled_state():
    """The wall inserted into an empty map (the scatter insert)."""
    state = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    state, m = integrate.insert_step(state, _pad(WALL), len(WALL),
                                     torch.from_numpy(POS), CFG)
    assert int(m["n_touched_blocks"]) == INSERT_BLOCKS
    return state


def _sample_blocks():
    """The block key of every valid carve sample of the wall."""
    b, _ = carve.carve_sample_keys(*_pad(WALL).unbind(1), len(WALL),
                                   torch.from_numpy(POS),
                                   torch.from_numpy(
                                       origin_blocks_for_position(POS, CFG)),
                                   CFG)
    return b[b != INT32_MAX]


def _carve(state, cap):
    return carve.carve_step(state, _pad(WALL), len(WALL),
                            torch.from_numpy(POS),
                            dataclasses.replace(CFG, touched_capacity=cap))


@pytest.mark.parametrize("short", [1, 10, CARVE_BLOCKS - 8])
def test_carve_counts_the_blocks_past_the_cap_as_touched(short):
    """A touched cap ``short`` blocks below the carve's: ``touched_overflow``
    grows by exactly those blocks, and their samples are in none of the
    metrics; the blocks under the cap are carved as under a cap that holds
    every block, the others not at all."""
    keys = _sample_blocks()
    blocks = torch.unique(keys)
    assert blocks.numel() == CARVE_BLOCKS
    cap = CARVE_BLOCKS - short
    lost = int((keys >= blocks[cap]).sum())
    assert lost > 0

    before = _walled_state()
    st, m = _carve(clone_state(before), cap)
    assert st.touched_overflow.dtype == torch.int32
    assert int(st.touched_overflow) == short
    assert int(m["n_carve_samples"]) + int(m["n_carve_dropped"]) + lost == \
        keys.numel()
    assert int(m["n_carve_dropped"]) >= 0
    assert int(st.block_overflow) == 0

    full, fm = _carve(clone_state(before), CARVE_BLOCKS)
    assert int(full.touched_overflow) == 0
    nb = int(before.n_blocks)
    dkeys, rows = before.dir_keys[:nb], before.dir_slots[:nb].long()
    kept = rows[dkeys < blocks[cap]]
    gone = rows[dkeys >= blocks[cap]]
    for f in ("pool_sd", "pool_w"):
        assert torch.equal(getattr(st, f)[kept], getattr(full, f)[kept]), f
        assert torch.equal(getattr(st, f)[gone], getattr(before, f)[gone]), f
    assert not torch.equal(full.pool_w[gone], before.pool_w[gone])
    assert int(m["n_carve_samples"]) < int(fm["n_carve_samples"])


@pytest.mark.parametrize("cap", [CARVE_BLOCKS, CARVE_BLOCKS + 1, 1024])
def test_carve_loses_nothing_at_capacity(cap):
    """A cap that holds every block of the carve loses nothing: hits and
    erosion drops add up to the valid samples."""
    st, m = _carve(_walled_state(), cap)
    assert int(st.touched_overflow) == 0
    assert int(m["n_carve_samples"]) + int(m["n_carve_dropped"]) == \
        _sample_blocks().numel()


def test_carve_loss_adds_to_the_inserts():
    """The carve's lost blocks add to what the state counted before, and
    the insert after the carve keeps them."""
    st, _ = _carve(_walled_state(), CARVE_BLOCKS - 10)
    st, _ = _carve(st, CARVE_BLOCKS - 10)
    assert int(st.touched_overflow) == 20
    tight = dataclasses.replace(CFG, touched_capacity=INSERT_BLOCKS - 6)
    st, _ = integrate.insert_step(st, _pad(WALL), len(WALL),
                                  torch.from_numpy(POS), tight)
    assert int(st.touched_overflow) == 26


def test_stats_reports_and_warns_the_carve_loss():
    """A touched cap that holds the insert's blocks and not the carve's:
    ``stats()["overflow"]["touched"]`` counts the carve's lost blocks, and
    the map warns once that samples were dropped, naming
    ``touched_capacity``."""
    cap = INSERT_BLOCKS + 12
    m = TSDFMap(config=dataclasses.replace(CFG, touched_capacity=cap),
                device="cpu")
    m.insert(WALL, POS)
    with pytest.warns(UserWarning, match=r"touched_overflow = \d+ .*dropped"
                      r".*touched_capacity"):
        s = m.stats()
    assert s["overflow"]["touched"] == CARVE_BLOCKS - cap
    assert set(s["overflow"]) == {"points", "samples", "blocks", "touched",
                                  "tile"}


def test_carve_loss_before_a_rotation_is_reported_at_the_drain():
    """A carve loses blocks in the insert just before a rotation, long
    before the map's check: the rotated-out map's drain warns of them, and
    the new active map starts clean."""
    cap = INSERT_BLOCKS + 12
    m = TSDFMap(config=dataclasses.replace(CFG, touched_capacity=cap),
                device="cpu")
    m.insert(WALL, POS)
    far = POS + np.float32([CFG.submap_distance + 1.0, 0.0, 0.0])
    m.insert(WALL[:16] + far, far)                  # rotates
    assert len(m._pending) == 1
    assert int(m.state.touched_overflow) == 0
    with pytest.warns(RuntimeWarning,
                      match=f"'touched_overflow': {CARVE_BLOCKS - cap}"):
        m.stats()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_carve_counts_the_lost_blocks_once(n_shards):
    """The sharded carve loses the blocks that the one-device carve of
    the same map loses, counts them once (on shard 0), and reports the
    same metrics; the sharded map's ``stats()`` warns of them."""
    from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh

    cfg = dataclasses.replace(CFG, max_points=1024,
                              touched_capacity=INSERT_BLOCKS + 12)
    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(n_shards,
                                                     device="cpu"))
    ref = TSDFMap(config=cfg, device="cpu")
    sm_met = smap.insert(WALL, POS)
    ref_met = ref.insert(WALL, POS)
    for k in ("n_carve_samples", "n_carve_dropped", "n_carved_voxels"):
        assert sm_met[k] == ref_met[k], k
    lost = [int(st.touched_overflow) for st in smap.state_stack]
    assert lost == [CARVE_BLOCKS - cfg.touched_capacity] + [0] * (
        n_shards - 1)
    for mp in (smap, ref):
        with pytest.warns(UserWarning,
                          match=r"touched_overflow = \d+ .*dropped"):
            assert mp.stats()["overflow"]["touched"] == sum(lost)


def _grown(before):
    now = timing.counts()
    return {k: now[k] - before[k] for k in now}


def test_carving_off_reads_and_counts_nothing_new():
    """With carving off an insert is the eager insert alone, the counters
    grow as before (one insert, no host wait, no carve counter); the
    overflow check reads the four lossy counters and ``stats()`` the five
    keys it had in the ten waits it took, carving or not."""
    off = dataclasses.replace(CFG, carve_steps=0)
    m = TSDFMap(config=off, device="cpu")
    st = create_state(off, origin_blocks_for_position(POS, off), "cpu")
    for seed in (3, 4):
        pts = _wall(seed=seed)
        c0 = timing.counts()
        m.insert(pts, POS)
        grown = _grown(c0)
        assert grown["inserts"] == 1 and grown["host_syncs"] == 0
        assert all(grown[k] == 0 for k in CARVE_KEYS), grown
        st, _ = integrate.insert_step(st, _pad(pts), len(pts),
                                      torch.from_numpy(POS), off)
    for f in FIELDS:
        assert torch.equal(getattr(m.state, f), getattr(st, f)), f

    carving = TSDFMap(config=CFG, device="cpu")
    carving.insert(WALL, POS)
    for mp in (m, carving):
        c0 = timing.counts()
        mp._warn_overflow()
        assert _grown(c0)["host_syncs"] == 4
        c0 = timing.counts()
        s = mp.stats()
        assert _grown(c0)["host_syncs"] == 10
        assert len(s["overflow"]) == 5


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_each_carving_insert_is_timed_once(impl):
    """On the CPU every carve is timed by the host clock, a fused
    insert's too (it runs after the fallback, inside the insert):
    ``carve_timed`` and ``carve_inserts`` grow by one an insert,
    ``carve_device_us`` by a positive whole number of microseconds; the
    clock adds no host wait (no insert waits for anything)."""
    cfg = dataclasses.replace(CFG, max_points=1024, accumulate_impl=impl,
                              tile_nb=8)
    m = TSDFMap(config=cfg, device="cpu")
    c0 = timing.counts()
    for seed in (5, 6, 7):
        ci = timing.counts()
        m.insert(_wall(2.0, n=900, seed=seed), POS)
        assert _grown(ci)["host_syncs"] == 0
        assert _grown(ci)["carve_inserts"] == 1
    grown = _grown(c0)
    assert grown["carve_inserts"] == grown["carve_timed"] == 3
    assert grown["carve_device_us"] > 0
    assert isinstance(timing.COUNTS["carve_device_us"], int)


class _Event:
    """A ``torch.cuda.Event`` stand-in: ``done`` says whether the device
    has passed it; every record is logged."""
    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.done = False

    def record(self):
        _Event.log.append(self)
        self.t = len(_Event.log)
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time would wait"
        return 0.25 * (end.t - self.t)


def _zero_counts(monkeypatch):
    monkeypatch.setattr(timing, "COUNTS",
                        {"carve_device_us": 0, "carve_timed": 0})


def _counts(us, n):
    return {"carve_device_us": us, "carve_timed": n}


def test_carve_clock_folds_done_pairs_without_waiting(monkeypatch):
    """On CUDA the clock brackets each carve by a pair of events from a
    ring and folds a pair in only once its end event is done, oldest first,
    when a carve starts; a carve that finds the ring all pending goes
    untimed.  Nothing waits."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(timing, "CLOCK_RING", 2)
    _zero_counts(monkeypatch)
    _Event.log = []
    clock = timing.CarveClock("cuda")
    with clock:
        pass                               # pair A: events 1, 2
    with clock:
        pass                               # pair B: events 3, 4
    with clock:
        pass                               # the ring is pending: untimed
    assert len(_Event.log) == 4 and timing.COUNTS == _counts(0, 0)
    _Event.log[1].done = _Event.log[0].done = True
    clock.fold()
    assert timing.COUNTS == _counts(250, 1)
    for e in _Event.log:
        e.done = True
    with clock:                            # folds B, reuses a pair
        pass
    assert timing.COUNTS == _counts(500, 2)
    assert len(_Event.log) == 6 and len({id(e) for e in _Event.log}) == 4


def test_carve_clock_on_the_cpu_times_the_host_at_once(monkeypatch):
    _zero_counts(monkeypatch)
    ticks = iter([10.0, 10.0015])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    with timing.CarveClock("cpu"):
        pass
    assert timing.COUNTS == _counts(1500, 1)


@pytest.fixture
def card():
    """The CUDA card of a test marked ``card``; skips without one (decided
    here, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("touched", [1 << 15, 1 << 11])
def test_carve_graph_equals_the_eager_carve_on_the_card(card, touched):
    """A KITTI-shaped stream under ``seg`` with packed ingest, carved: the
    map's insert graph then its carve's graph equal the eager insert and
    carve bit for bit (every field and every metric; under a touched cap
    too small for the carve, the lost blocks' count too), the graph
    inserts wait on the card only to capture, and every replayed carve is
    timed once the card is done."""
    cfg = MapConfig(max_points=32768, block_capacity=1 << 17,
                    touched_capacity=touched, accumulate_impl="seg",
                    packed_ingest=True, carve_steps=64, carve_subsample=2)
    g = TSDFMap(config=cfg, device=card)
    e = TSDFMap(config=cfg, device=card)
    e.graphs_enabled = False
    n = 6
    c0 = timing.counts()
    for i in range(n):
        scan = synthetic_lidar_scan([0.4 * i, 0.0, 0.0], seed=i)
        pts = scan[:: max(1, len(scan) // 30000)][:30000 - 97 * i]
        pos = np.float32([0.4 * i, 0.0, 1.7])
        ci = timing.counts()
        mg = g.insert(pts, pos)
        gi = _grown(ci)
        assert gi["host_syncs"] == gi["graph_captures"] <= 1, gi
        me = e.insert(pts, pos)
        assert dict(mg) == dict(me), i
    for f in FIELDS:
        assert torch.equal(getattr(g.state, f), getattr(e.state, f)), f
    ovf = g.stats()["overflow"]
    assert ovf == e.stats()["overflow"]
    assert (ovf["touched"] > 0) == (touched < 1 << 15)
    assert ovf == dict(ovf, points=0, samples=0, blocks=0, tile=0)
    (gr,) = g._graphs.values()
    assert gr.carve_graph is not None and gr.replays == n - 1
    torch.cuda.synchronize(card)
    g._carve_clock.fold()
    e._carve_clock.fold()
    grown = _grown(c0)
    # the graph map's first carve ran in its eager warm-up, untimed
    assert grown["carve_timed"] == (n - 1) + n
    assert grown["carve_inserts"] == 2 * n
    assert grown["carve_device_us"] > 0
