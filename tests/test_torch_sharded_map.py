"""The port's ``ShardedTSDFMap`` (``chad_tsdf_tpu_torch/parallel/
sharded_map.py``) on the CPU, with tests/test_sharded_map.py's cases: one
shard equal to ``TSDFMap`` bit for bit (under ``xla`` and under ``fused``,
whose fallback is deferred); eight shards against the single-device map
and against the JAX ``ShardedTSDFMap`` on the same scans; rotation and
``save``; inserts that read nothing on the host and use the smallest
bucket; packed ingest; a deferred rotation equal to the synchronous
finalize; the overflow warning; the stubs' byte bound; and entry points
that default to the card."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.parallel import ShardedTSDFMap as JaxShardedTSDFMap
from chad_tsdf_tpu.parallel import make_mesh as jax_make_mesh
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import map as t_map
from chad_tsdf_tpu_torch.core import submap as t_submap
from chad_tsdf_tpu_torch.core.dag import NodeLevels
from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh, sharded
from chad_tsdf_tpu_torch.scripts.kitti_stream import count_host_reads
from chad_tsdf_tpu_torch.utils import timing

CFG = MapConfig(max_points=512, block_capacity=4096, touched_capacity=2048,
                accumulate_impl="xla")
STEP = CFG.sdf_trunc / 127          # one 8-bit codec step
POS = np.zeros(3, np.float32)
FAR = np.float32([8.0, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_points(n, r=2.0, seed=0, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.float32(centre) + d * r).astype(np.float32)


def _smap(cfg=CFG, n=8, **kw):
    return ShardedTSDFMap(config=cfg, mesh=make_mesh(n, device="cpu"), **kw)


@pytest.fixture(scope="module")
def eight():
    """tests/test_sharded_map.py's first case through both packages: one
    4,096-point sphere into 8 shards, and the single-device port map of
    the same cloud in 512-point chunks."""
    pts = sphere_points(4096)
    smap = _smap()
    smap.insert(pts, POS)
    jmap = JaxShardedTSDFMap(config=JaxMapConfig(**dataclasses.asdict(CFG)),
                             mesh=jax_make_mesh(8))
    jmap.insert(pts, POS)
    ref = TSDFMap(config=CFG, device="cpu")
    for beg in range(0, 4096, CFG.max_points):
        ref.insert(pts[beg:beg + CFG.max_points], POS)
    return smap, jmap, ref


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_sharded_map_n1_matches_single_device_exactly(impl):
    """At one shard the step IS the single-device insert: pools, slot
    order and voxel samples bit-equal to TSDFMap; under ``fused`` the
    fallback is deferred to the next settle as in TSDFMap."""
    cfg = MapConfig(max_points=1024, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl=impl, tile_nb=8)
    pts = sphere_points(1024, r=1.5)
    smap = _smap(cfg, 1)
    ref = TSDFMap(config=cfg, device="cpu")
    for pts_i in (pts, pts * 1.2):
        syncs = timing.COUNTS["host_syncs"]
        m = smap.insert(pts_i, POS)
        grew = timing.COUNTS["host_syncs"] - syncs
        ref.insert(pts_i, POS)
    if impl == "fused":
        assert smap._deferred is not None
    # the second insert waits only to settle the first's fused tail
    assert grew == (1 if impl == "fused" else 0)
    assert m["route_overflow"] == 0
    st, rs = smap.state_stack[0], ref.state
    for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
              "tile_overflow"):
        assert torch.equal(getattr(st, f), getattr(rs, f)), f
    codes_s, sd_s = smap.voxel_samples()
    codes_r, sd_r = ref.voxel_samples()
    np.testing.assert_array_equal(codes_s, codes_r)
    np.testing.assert_array_equal(sd_s, sd_r)


def test_sharded_map_matches_single_device_and_jax(eight):
    smap, jmap, ref = eight
    assert smap.last_metrics["route_overflow"] == 0
    assert smap.last_metrics["route_sent"] == \
        jmap.last_metrics["route_sent"]
    codes_s, sd_s = smap.voxel_samples()
    codes_r, sd_r = ref.voxel_samples()
    np.testing.assert_array_equal(codes_s, codes_r)
    # normals differ at shard cuts vs 512-point chunk cuts; 8-bit codes
    assert (np.abs(sd_s - sd_r) <= 2 * STEP).mean() > 0.98
    codes_j, sd_j = jmap.voxel_samples()
    np.testing.assert_array_equal(codes_s, codes_j)
    assert np.abs(sd_s - sd_j).max() <= STEP + 1e-7

    mesh_s, mesh_r = smap.extract_mesh(), ref.extract_mesh()
    assert abs(len(mesh_s.vertices) - len(mesh_r.vertices)) <= \
        0.02 * len(mesh_r.vertices) + 2
    rr = np.linalg.norm(mesh_s.vertices, axis=1)
    assert np.abs(rr - 2.0).max() < 3 * CFG.sdf_res


def test_sharded_map_rotation_and_save(tmp_path):
    smap = _smap()
    smap.insert(sphere_points(2048, r=1.5), POS)
    smap.insert(sphere_points(2048, r=1.5, seed=2, centre=FAR), FAR)
    assert len(smap._pending) == 1 and len(smap.submaps) == 0
    assert smap.n_submaps == 1
    stats = smap.stats()                     # drains the pending rotation
    assert len(smap.submaps) == 1 and not smap._pending
    assert stats["n_submaps"] == 1 and stats["n_shards"] == 8
    assert stats["active_blocks"] > 0
    assert not any(stats["overflow"].values())

    out = tmp_path / "sharded.ply"
    smap.save(str(out))
    assert out.exists() and out.stat().st_size > 0
    v = smap.extract_mesh().vertices
    near0 = np.abs(np.linalg.norm(v, axis=1) - 1.5) < 3 * CFG.sdf_res
    near1 = np.abs(np.linalg.norm(v - FAR, axis=1) - 1.5) < 3 * CFG.sdf_res
    assert near0.sum() > 50 and near1.sum() > 50
    assert (near0 | near1).all()
    smap.finalize_active()
    assert smap.n_submaps == 2 and smap.state_stack is None


def test_sharded_insert_is_read_free_and_bucketed():
    """Metrics stay on the device (``LazyMetrics.raw``), the insert reads
    nothing on the host, and a small scan pads to the smallest bucket."""
    cfg = MapConfig(max_points=1 << 15, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    smap = _smap(cfg)
    smap.insert(sphere_points(1024, seed=3), POS)
    with count_host_reads() as reads:
        m = smap.insert(sphere_points(4096), POS)
    assert reads == {}, reads
    raw = m.raw("n_blocks")
    assert torch.is_tensor(raw)
    assert [k[0] for k in smap._steps] == [min(cfg.buckets)]
    assert min(cfg.buckets) < cfg.max_points
    assert m["n_blocks"] > 0


def test_sharded_packed_ingest_agrees():
    cfg = MapConfig(max_points=1 << 12, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    pts = sphere_points(4096, r=1.5)
    m_plain = _smap(cfg)
    m_plain.insert(pts, POS)
    m_packed = _smap(dataclasses.replace(cfg, packed_ingest=True))
    m_packed.insert(pts, POS)
    c1, s1 = m_plain.voxel_samples()
    c2, s2 = m_packed.voxel_samples()
    common, i1, i2 = np.intersect1d(c1, c2, return_indices=True)
    assert common.shape[0] >= 0.95 * max(c1.shape[0], c2.shape[0])
    assert float(np.median(np.abs(s1[i1] - s2[i2]))) < 0.004


def test_sharded_rotation_defers_and_matches_sync():
    """A rotation does no finalize work (no read, no compaction): the stub
    keeps the shards' pools until the drain, which builds the same DAG as
    the synchronous finalize of the same states."""
    smap = _smap()
    smap.insert(sphere_points(2048, r=1.5, seed=21), POS)
    lv_sync = NodeLevels(use_native=False)
    sm_sync = t_submap.finalize_sharded(
        sharded.gather_states(smap.state_stack), lv_sync, CFG,
        list(smap._positions))
    smap.insert(sphere_points(2048, r=1.5, seed=22, centre=FAR), FAR)
    pending = smap._pending[0]
    assert pending.inner is None and pending.state_stack is not None
    assert pending.pinned_bytes == 8 * 2 * CFG.block_capacity * 512 * 4
    smap._drain_pending()
    assert pending.inner is not None and pending.state_stack is None
    c1, w1 = lv_sync.walk_leaf_clusters(sm_sync.root_addr_tsdf)
    c2, w2 = smap.levels.walk_leaf_clusters(smap.submaps[0].root_addr_tsdf)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(w1, w2)


def test_sharded_stubs_bounded_by_bytes(monkeypatch):
    """The map's byte bound on pending stubs counts every shard's pools."""
    monkeypatch.setattr(t_map, "_MAX_PENDING_BYTES",
                        8 * 2 * CFG.block_capacity * 512 * 4)
    smap = _smap()
    for i in range(3):
        c = np.float32([8.0 * i, 0.0, 0.0])
        smap.insert(sphere_points(1024, r=1.5, seed=i, centre=c), c)
    # two rotations: the second stub exceeds the bound, the first drains
    assert len(smap._pending) == 1 and len(smap.submaps) == 1


def test_sharded_overflow_warns():
    cfg = MapConfig(max_points=2048, block_capacity=64, touched_capacity=32,
                    accumulate_impl="xla")
    smap = _smap(cfg, 1)
    smap.insert(sphere_points(2048, r=2.0, seed=30), POS)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        smap.stats()
    msgs = [str(r.message) for r in rec]
    assert any("block_capacity" in m or "touched_capacity" in m
               for m in msgs), msgs


def test_sharded_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedTSDFMap(config=CFG)
    mesh = make_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.n_shards == 4 and mesh.group is None
