"""The port's checkpoints (``chad_tsdf_tpu_torch/io/checkpoint.py``) on the
CPU: the cases of tests/test_checkpoint.py, the sharded one included (8
shards resumed on 4 and on one device), and checkpoints that cross
packages — one written by the JAX package loads into the port and one
written by the port loads into the JAX package, single-device and sharded,
with equal states and voxel samples."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from chad_tsdf_tpu import MapConfig as JaxMapConfig
from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.io import load_checkpoint as j_load
from chad_tsdf_tpu.io import save_checkpoint as j_save
from chad_tsdf_tpu.parallel import ShardedTSDFMap as JaxShardedTSDFMap
from chad_tsdf_tpu.parallel import make_mesh as jax_make_mesh
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
from chad_tsdf_tpu_torch.io import checkpoint as t_checkpoint
from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh

SMALL = dict(max_points=2048, block_capacity=4096, touched_capacity=4096,
             accumulate_impl="xla")
STATE_FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
                "origin_blocks", "point_overflow", "sample_overflow",
                "block_overflow", "touched_overflow", "tile_overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_points(n, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _map(**kw):
    return TSDFMap(config=MapConfig(**{**SMALL, **kw}), device="cpu")


def _two_part_map(m):
    """A finalized submap and an active one 6 m away (tests/test_checkpoint
    .py's first case)."""
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    m._start_submap(np.array([6.0, 0, 0], np.float32))
    m.insert(sphere_points(1024, seed=1) + np.array([6, 0, 0], np.float32),
             np.array([6.0, 0, 0]))
    return m


def _state_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def test_roundtrip_active_and_finalized(tmp_path):
    m = _two_part_map(_map())
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p, device="cpu")
    assert len(m2.submaps) == len(m.submaps)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(m2.state, f), getattr(m.state, f)), f
    c1, s1 = m.voxel_samples()
    c2, s2 = m2.voxel_samples()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)
    mesh1, mesh2 = m.extract_mesh(), m2.extract_mesh()
    np.testing.assert_array_equal(mesh1.vertices, mesh2.vertices)
    np.testing.assert_array_equal(mesh1.faces, mesh2.faces)


def test_resume_continues_dedup(tmp_path):
    """Hash-consing keeps working after a load: the same geometry added
    again makes no new unique node."""
    m = _map()
    pts = sphere_points(1024, seed=2)
    m.insert(pts, np.zeros(3))
    m.finalize_active()
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p, device="cpu")
    u_before = [lv.uniques_n for lv in m2.levels.nodes]
    m2._start_submap(np.zeros(3, np.float32))
    m2.insert(pts, np.zeros(3))
    m2.finalize_active()
    assert [lv.uniques_n for lv in m2.levels.nodes] == u_before
    assert m2.submaps[0].root_addr_tsdf == m2.submaps[1].root_addr_tsdf


def test_insert_continues_after_load(tmp_path):
    m = _map()
    m.insert(sphere_points(1024, seed=3), np.zeros(3))
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p, device="cpu")
    before = int(m2.state.n_blocks)
    m2.insert(sphere_points(1024, seed=4, r=1.2), np.zeros(3))
    assert int(m2.state.n_blocks) >= before


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_elastic_recovery_after_crash(tmp_path, impl):
    """Reload the last checkpoint, re-integrate the scans since, and get
    the uninterrupted run bit for bit; under ``fused`` the checkpoint is
    taken right after an insert whose fallback was needed."""
    scans = [(sphere_points(1024, r=1.0 + 0.1 * i, seed=10 + i),
              np.zeros(3, np.float32)) for i in range(5)]
    kw = dict(accumulate_impl=impl, tile_nb=16)
    oracle = _map(**kw)
    for pts, pos in scans:
        oracle.insert(pts, pos)
    victim = _map(**kw)
    for pts, pos in scans[:3]:
        victim.insert(pts, pos)
    ckpt = str(tmp_path / "mid.npz")
    if impl == "fused":
        assert int(victim.state.tile_overflow) > 0
    save_checkpoint(ckpt, victim)
    victim.insert(*scans[3])          # integrated but never checkpointed
    del victim                        # the crash
    recovered = load_checkpoint(ckpt, device="cpu")
    for pts, pos in scans[3:]:
        recovered.insert(pts, pos)
    for f in ("pool_sd", "pool_w", "dir_keys", "tile_overflow"):
        assert torch.equal(getattr(recovered.state, f),
                           getattr(oracle.state, f)), f
    c1, s1 = oracle.voxel_samples()
    c2, s2 = recovered.voxel_samples()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)


def test_counters_roundtrip_and_compact_pool(tmp_path):
    """Dedup counters survive a load exactly and the active pool is
    stored as its occupied prefix."""
    m = _map()
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    m._start_submap(np.zeros(3, np.float32))
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    m._start_submap(np.zeros(3, np.float32))
    m.insert(sphere_points(512, seed=3), np.zeros(3))
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p, device="cpu")
    assert m2.stats() == m.stats()    # uniques AND dupes identical
    z = np.load(p)
    assert z["active_pool_sd"].shape[0] == int(m.state.n_blocks)
    assert z["active_pool_sd"].shape[0] < SMALL["block_capacity"]


def test_version_1_and_drain_on_save(tmp_path):
    """A version-1 file (no dedup counters, five counters) loads; saving
    drains a pending rotation first."""
    m = _map()
    m.insert(sphere_points(1024), np.zeros(3))
    m.insert(sphere_points(1024) + np.float32([7, 0, 0]),
             np.float32([7, 0, 0]))
    assert len(m._pending) == 1
    p = str(tmp_path / "v2.npz")
    save_checkpoint(p, m)
    assert not m._pending and len(m.submaps) == 1
    z = dict(np.load(p))
    meta = json.loads(bytes(z["__meta__"]).decode())
    meta["format_version"] = 1
    del meta["level_counters"]
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    z["active_counters"] = z["active_counters"][:5]
    p1 = str(tmp_path / "v1.npz")
    np.savez_compressed(p1, **z)
    m1 = load_checkpoint(p1, device="cpu")
    assert int(m1.state.tile_overflow) == 0
    np.testing.assert_array_equal(m1.voxel_samples()[0],
                                  m.voxel_samples()[0])
    meta["format_version"] = 3
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(p1, **z)
    with pytest.raises(ValueError):
        load_checkpoint(p1, device="cpu")


def test_jax_checkpoint_loads_into_port(tmp_path):
    jm = JaxTSDFMap(config=JaxMapConfig(**SMALL))
    _two_part_map(jm)
    p = str(tmp_path / "jax.npz")
    j_save(p, jm)
    tm = load_checkpoint(p, device="cpu")
    want = _state_arrays(jm.state)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(tm.state, f).numpy(), want[f])
    assert tm.config == MapConfig(**SMALL)
    assert tm.stats() == jm.stats()
    cj, sj = jm.voxel_samples()
    ct, st = tm.voxel_samples()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)


def test_port_checkpoint_loads_into_jax(tmp_path):
    tm = _two_part_map(_map())
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, tm)
    jm = j_load(p)
    want = _state_arrays(tm.state)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jm.state, f)),
                                      want[f])
    assert jm.stats() == tm.stats()
    cj, sj = jm.voxel_samples()
    ct, st = tm.voxel_samples()
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(sj, st)


def test_load_defaults_to_cuda_and_refuses_a_mesh(tmp_path, monkeypatch):
    """Loading defaults to the card and raises without one; a mesh (once
    refused, now ported) resumes the map sharded on its devices."""
    m = _map()
    m.insert(sphere_points(512), np.zeros(3))
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(p)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(p, mesh=make_mesh(2))
    sm = load_checkpoint(p, device="cpu", mesh=make_mesh(2, device="cpu"))
    assert isinstance(sm, ShardedTSDFMap) and sm.n_shards == 2
    assert sum(int(st.n_blocks) for st in sm.state_stack) == \
        int(m.state.n_blocks)
    for got, want in zip(sm.voxel_samples(), m.voxel_samples()):
        np.testing.assert_array_equal(got, want)
    assert t_checkpoint.FORMAT_VERSION == 2


def _sharded_cfg():
    return MapConfig(max_points=512, block_capacity=4096,
                     touched_capacity=2048, accumulate_impl="xla")


def test_sharded_checkpoint_topology_elastic(tmp_path):
    """An 8-shard map checkpointed and resumed on one device and on 4
    shards: voxel samples equal; after more scans into the 8- and the
    4-shard map, codes equal and sd within two codec steps on 98%."""
    pts = sphere_points(4096, r=2.0, seed=13)
    pos = np.zeros(3, np.float32)
    m8 = ShardedTSDFMap(config=_sharded_cfg(),
                        mesh=make_mesh(8, device="cpu"))
    m8.insert(pts, pos)
    c0, s0 = m8.voxel_samples()
    p = str(tmp_path / "sharded.npz")
    save_checkpoint(p, m8)
    m1 = load_checkpoint(p, device="cpu")
    for got, want in zip(m1.voxel_samples(), (c0, s0)):
        np.testing.assert_array_equal(got, want)
    m4 = load_checkpoint(p, mesh=make_mesh(4, device="cpu"))
    for got, want in zip(m4.voxel_samples(), (c0, s0)):
        np.testing.assert_array_equal(got, want)
    more = sphere_points(2048, r=1.0, seed=14)
    m4.insert(more, pos)
    m8.insert(more, pos)
    c4, s4 = m4.voxel_samples()
    c8, s8 = m8.voxel_samples()
    np.testing.assert_array_equal(c4, c8)
    assert (np.abs(s4 - s8) <= 2 * 0.1 / 127).mean() > 0.98
    assert m4.stats()["n_shards"] == 4


def test_sharded_checkpoint_crosses_packages(tmp_path):
    """A JAX 8-shard map's checkpoint resumes on a 4-shard port mesh, and
    a port 8-shard map's on a 4-device JAX mesh: voxel samples equal."""
    pts = sphere_points(4096, r=2.0, seed=15)
    pos = np.zeros(3, np.float32)
    jm = JaxShardedTSDFMap(
        config=JaxMapConfig(**dataclasses.asdict(_sharded_cfg())),
        mesh=jax_make_mesh(8))
    jm.insert(pts, pos)
    pj = str(tmp_path / "jax.npz")
    j_save(pj, jm)
    tm4 = load_checkpoint(pj, mesh=make_mesh(4, device="cpu"))
    for got, want in zip(tm4.voxel_samples(), jm.voxel_samples()):
        np.testing.assert_array_equal(got, want)

    tm = ShardedTSDFMap(config=_sharded_cfg(),
                        mesh=make_mesh(8, device="cpu"))
    tm.insert(pts, pos)
    pt = str(tmp_path / "port.npz")
    save_checkpoint(pt, tm)
    jm4 = j_load(pt, mesh=jax_make_mesh(4))
    for got, want in zip(jm4.voxel_samples(), tm.voxel_samples()):
        np.testing.assert_array_equal(got, want)
