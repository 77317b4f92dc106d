"""The fused and tile inserts' fallback in ``TSDFMap.insert`` on the CPU:
the map's graph step runs it eagerly inside the insert (unconditionally,
core/graph.py), with no host read, and the map at every read point (the
next insert, ``state``, ``stats``, ``save``, a rotation, a read of the
insert's metrics) is bit-equal to the same inserts settled at once
(``integrate.insert_step``, the order the JAX package's ``lax.cond``
gives).  A small ``tile_nb`` forces the tiles' block lists to overflow, so
the fallback is needed; the map's state is held to the JAX package's tiled
insert (interpret mode) with tests/test_torch_fused.py's gate.
``integrate.insert_step_deferred`` and ``settle``, which the sharded map
defers with, are held to the map's insert."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import integrate
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.scripts.kitti_stream import count_host_reads
from chad_tsdf_tpu_torch.utils import timing

FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
          "point_overflow", "sample_overflow", "block_overflow",
          "touched_overflow", "tile_overflow")
N = 1024
FAR = np.float32([7.0, 0.0, 0.0])       # beyond submap_distance: rotates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(impl):
    return MapConfig(max_points=N, block_capacity=8192, touched_capacity=8192,
                     accumulate_impl=impl, tile_nb=16, mesh_impl="host")


def _sphere(seed, r=1.0, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r + np.asarray(centre)).astype(np.float32)


SCANS = [(_sphere(1), np.zeros(3, np.float32)),
         (_sphere(2, r=1.2), np.float32([0.1, 0.0, 0.0])),
         (_sphere(3, centre=FAR), FAR)]


def _settled_at_once(impl, scans):
    """The reference: each scan through ``insert_step`` (settled at once)
    in a fresh state; the rotation of the third scan starts a new one."""
    cfg = _cfg(impl)
    states = []
    st = None
    for pts, pos in scans:
        if st is None or np.linalg.norm(pos - scans[0][1]) > \
                cfg.submap_distance:
            if st is not None:
                states.append(st)
            st = create_state(cfg, origin_blocks_for_position(pos, cfg),
                              "cpu")
        st, _ = integrate.insert_step(st, torch.from_numpy(pts), N,
                                      torch.from_numpy(pos), cfg)
    return states + [st]


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _inserted(m, scans):
    """``scans`` into ``m``, asserting that no call reads a tensor on the
    host or waits for the device; returns the last insert's metrics."""
    syncs = timing.COUNTS["host_syncs"]
    with count_host_reads() as reads:
        for pts, pos in scans:
            met = m.insert(pts, pos)
    assert reads == {}
    assert timing.COUNTS["host_syncs"] == syncs
    return met


@pytest.mark.parametrize("impl", ["fused", "tile"])
def test_deferred_insert_reads_nothing(impl):
    """Two inserts, each running its fallback: no call reads a tensor on
    the host or waits, reading the metrics neither, and the map equals
    the two inserts settled at once."""
    m = TSDFMap(config=_cfg(impl), device="cpu")
    met = _inserted(m, SCANS[:2])
    syncs = timing.COUNTS["host_syncs"]
    met.raw("n_blocks")                       # nothing left to settle
    assert timing.COUNTS["host_syncs"] == syncs
    _same(m.state, _settled_at_once(impl, SCANS[:2])[0])
    assert int(m.state.tile_overflow) > 0     # and the fallback was needed


@pytest.mark.parametrize("impl", ["fused", "tile"])
@pytest.mark.parametrize("point", ["next_insert", "state", "stats", "save",
                                   "rotation", "metrics"])
def test_deferred_equals_settled_at_once(impl, point, tmp_path):
    m = TSDFMap(config=_cfg(impl), device="cpu")
    met = _inserted(m, SCANS[:1])
    once = _settled_at_once(impl, SCANS[:1])[0]
    if point == "next_insert":
        _inserted(m, SCANS[1:2])
        # the second insert's fallback ran inside it: the map is the first
        # insert settled, then the second's main accumulate and the
        # fallback its tail holds back, which is needed
        cfg = _cfg(impl)
        ref, rmet, tail = integrate.insert_step_deferred(
            once, torch.from_numpy(SCANS[1][0]), N,
            torch.from_numpy(SCANS[1][1]), cfg)
        assert tail is not None and tail.needed()
        ref = integrate.settle(tail, ref, rmet)
        _same(m.state, ref)
        _same(m.state, _settled_at_once(impl, SCANS[:2])[0])
    elif point == "state":
        _same(m.state, once)
    elif point == "stats":
        s = m.stats()
        _same(m.state, once)
        assert s["overflow"]["tile"] == int(once.tile_overflow) > 0
    elif point == "save":
        m.save(str(tmp_path / "m.ply"))
        _same(m.state, once)
    elif point == "rotation":
        _inserted(m, SCANS[1:])               # rotates the first map out
        assert len(m._pending) == 1
        rotated, active = _settled_at_once(impl, SCANS)
        _same(m._pending[0].raw_state, rotated)
        _same(m.state, active)
    else:
        # n_new_blocks and n_blocks count the fallback's blocks, as
        # insert_step's do
        want = integrate.insert_step(
            create_state(_cfg(impl), origin_blocks_for_position(
                SCANS[0][1], _cfg(impl)), "cpu"),
            torch.from_numpy(SCANS[0][0]), N, torch.from_numpy(SCANS[0][1]),
            _cfg(impl))[1]
        assert met["n_new_blocks"] == int(want["n_new_blocks"])
        assert met["n_blocks"] == int(want["n_blocks"]) == \
            int(once.n_blocks)
        _same(m.state, once)


@pytest.fixture(scope="module")
def jax_tiled():
    """The JAX package's tiled insert of the first scan (interpret mode),
    the one reference of the module: K1 and K4 share one coverage rule, so
    it is the fused insert's map too (its fused interpret run alone takes
    ~25 s here; tests/test_torch_fused.py holds the port to it)."""
    cfg = JaxMapConfig(**dataclasses.asdict(_cfg("tile")))
    pts, pos = SCANS[0]
    return j_integrate.insert_step_tiled(
        j_create_state(cfg, origin_blocks_for_position(pos, _cfg("tile"))),
        jnp.asarray(pts), jnp.int32(N), jnp.asarray(pos), cfg,
        interpret=True)


@pytest.mark.parametrize("impl", ["fused", "tile"])
def test_deferred_matches_jax(impl, jax_tiled):
    """The map's settled state against the JAX package's insert: directory
    keys equal, weights exact, sd within 1e-4 per weight, equal counters
    and metrics."""
    js, jm = jax_tiled
    m = TSDFMap(config=_cfg(impl), device="cpu")
    met = m.insert(*SCANS[0])
    ts = m.state
    np.testing.assert_array_equal(ts.dir_keys.numpy(),
                                  np.asarray(js.dir_keys))
    nb = int(js.n_blocks)
    assert int(ts.n_blocks) == nb
    sj = np.asarray(js.dir_slots)[:nb]
    st = ts.dir_slots.numpy()[:nb]
    wj = np.asarray(js.pool_w)[sj]
    np.testing.assert_array_equal(ts.pool_w.numpy()[st], wj)
    err = np.abs(ts.pool_sd.numpy()[st] - np.asarray(js.pool_sd)[sj]) / \
        np.maximum(wj, 1)
    assert err.max() < 1e-4
    for f in FIELDS[5:]:
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    assert int(ts.tile_overflow) > 0
    for k in ("n_valid_samples", "n_touched_blocks", "n_new_blocks",
              "n_blocks"):
        assert met[k] == int(jm[k]), k
