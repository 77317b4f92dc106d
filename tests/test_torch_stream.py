"""The port's streaming surface on the CPU against the JAX package: the
KITTI-shaped scan generator bit for bit; the density dispatch choosing the
same backend; packed ingest against plain ingest; a 6-scan packed stream
with two deferred rotations against the JAX ``TSDFMap``, and its DAG
counters and ``stats()`` against the JAX finalize of the same states;
deferred rotation
against a drain after every insert; ``max_pending_finalize``; and the
stream script's helpers.  Inputs come from numpy seeds and go through
both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import state as j_state
from chad_tsdf_tpu.core import submap as j_submap
from chad_tsdf_tpu.io import kitti as j_kitti
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.core import map as t_map
from chad_tsdf_tpu_torch.core import state as t_state
from chad_tsdf_tpu_torch.core import submap as t_submap
from chad_tsdf_tpu_torch.io import kitti as t_kitti
from chad_tsdf_tpu_torch.scripts import kitti_stream
from chad_tsdf_tpu_torch.utils import timing

STEP = 0.1 / 127          # one 8-bit codec step at trunc = 0.1
N = 4096


def _cfg(**kw):
    return MapConfig(**{**dict(max_points=N, block_capacity=1 << 14,
                               touched_capacity=1 << 13, mesh_impl="host"),
                        **kw})


def _jax(cfg):
    return JaxMapConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: intra-op threads buy nothing and, when the
    suite runs on several workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n, r=1.0, seed=420):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _stream(n_scans=6, spacing=3.0, n=N):
    """KITTI-shaped scans subsampled to ``n`` points, ``spacing`` m apart:
    at 3 m, scans 2 and 4 each lie 6 m from their submap's first scan and
    rotate it out."""
    out = []
    for i in range(n_scans):
        scan = t_kitti.synthetic_lidar_scan([spacing * i, 0.0, 0.0], seed=i)
        out.append((scan[:: max(1, len(scan) // n)][:n].copy(),
                    np.float32([spacing * i, 0.0, 1.7])))
    return out


# the port-only tests: 1024-point scans into a small pool
SMALL = dict(max_points=1024, block_capacity=1 << 13,
             touched_capacity=1 << 12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_lidar_scan_bit_equal(seed):
    pos = [1.5 * seed, 0.25, 0.0]
    j = j_kitti.synthetic_lidar_scan(pos, seed=seed)
    t = t_kitti.synthetic_lidar_scan(pos, seed=seed)
    assert t.dtype == np.float32 and t.shape == j.shape
    assert t.shape[0] > 80_000 and t.tobytes() == j.tobytes()


@pytest.mark.parametrize("cloud", ["dense", "sparse"])
def test_dispatch_config_matches_jax(cloud, monkeypatch):
    """Host numpy on both sides: with the JAX package told it is on a TPU
    and the port's map told it is on a card, both send the dense sphere to
    the config's own backend and the LiDAR scan to ``sparse_impl``."""
    pts = (_sphere(1 << 16, 1.0) if cloud == "dense"
           else t_kitti.synthetic_lidar_scan([0.0, 0.0, 0.0], seed=0))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for sparse_impl in ("seg", "pallas"):
        cfg = MapConfig(sparse_impl=sparse_impl)
        tm = TSDFMap(config=cfg, device="cpu")
        assert tm._dispatch_config(pts) is cfg          # no dispatch on CPU
        tm.device = torch.device("cuda")
        got = tm._dispatch_config(pts)
        want = JaxTSDFMap(config=_jax(cfg))._dispatch_config(pts)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.accumulate_impl == ("auto" if cloud == "dense"
                                       else sparse_impl)
    # an explicit backend is never overridden
    tm = TSDFMap(config=MapConfig(accumulate_impl="fused"), device="cpu")
    tm.device = torch.device("cuda")
    assert tm._dispatch_config(pts).accumulate_impl == "fused"


def _density_numpy(chunk, block):
    """The JAX package's density estimate (``TSDFMap._dispatch_config``),
    written out: points per distinct block over every stride-th row."""
    stride = max(1, len(chunk) // 8192)
    sub = chunk[::stride]
    b = np.floor(sub / block).astype(np.int64)
    key = (b[:, 0] << 42) ^ (b[:, 1] << 21) ^ b[:, 2]
    return stride * len(sub) / max(1, np.unique(key).shape[0])


def _density_cloud(name):
    rng = np.random.default_rng(17)
    if name == "lidar":
        return t_kitti.synthetic_lidar_scan([3.0, -2.0, 0.0], seed=4)
    if name == "sphere":
        return _sphere(1 << 16, 5.0)
    if name == "odd sizes":
        return (rng.normal(size=(8193, 3)) * 30).astype(np.float32)
    if name == "one point":
        return np.float32([[-0.3, 0.2, -7.9]])
    # negative, huge and non-finite coordinates: numpy's cast gives
    # INT64_MIN for NaN, the infinities and what int64 cannot hold
    pts = rng.uniform(-3e3, 3e3, (20011, 3)).astype(np.float32)
    pts[::7, 0] = np.nan
    pts[1::11, 1] = np.inf
    pts[2::13, 2] = -np.inf
    pts[3::17] = np.float32(3e20)
    pts[4::19] = np.float32(-3e20)
    return pts


@pytest.mark.parametrize("cloud", ["lidar", "sphere", "odd sizes",
                                   "one point", "extremes"])
def test_block_density_matches_numpy(cloud, monkeypatch):
    """``block_density`` (the native count of distinct blocks, and its
    numpy fallback) equals the JAX package's ``np.unique`` estimate
    exactly, so both packages dispatch every cloud alike."""
    pts = np.ascontiguousarray(_density_cloud(cloud), np.float32)
    from chad_tsdf_tpu_torch import native
    assert native.available(), "g++ did not build csrc/chadrt.cpp"
    with np.errstate(invalid="ignore"):
        want = _density_numpy(pts, 8.0 * 0.05)
        assert t_map.block_density(pts, 8.0 * 0.05) == want
        monkeypatch.setattr(native, "distinct_block_keys",
                            lambda *a: None)
        assert t_map.block_density(pts, 8.0 * 0.05) == want


def test_packed_ingest_agrees_with_plain():
    """tests/test_map.py's bar: up to the 3.1 mm input quantization the
    packed map is the plain one (voxel sets overlap >= 95%, shared voxels
    agree on signed distance)."""
    cfg = _cfg(accumulate_impl="seg")
    pts, pos = _sphere(N), np.zeros(3, np.float32)
    m_plain = TSDFMap(config=cfg, device="cpu")
    m_plain.insert(pts, pos)
    m_packed = TSDFMap(config=dataclasses.replace(cfg, packed_ingest=True),
                       device="cpu")
    m_packed.insert(pts, pos)
    c1, s1 = m_plain.voxel_samples()
    c2, s2 = m_packed.voxel_samples()
    common, i1, i2 = np.intersect1d(c1, c2, return_indices=True)
    assert common.shape[0] >= 0.95 * max(c1.shape[0], c2.shape[0])
    diff = np.abs(s1[i1] - s2[i2])
    assert float(np.median(diff)) < 0.004
    assert float(np.mean(diff)) < 0.01
    # the packed insert IS the plain insert of the dequantized points
    # (q * step + position, each operation rounded to f32), bit for bit
    step = np.float32(cfg.sdf_res / 8.0)
    q = t_integrate.pack_points(pts, pos, cfg.sdf_res)
    m_deq = TSDFMap(config=cfg, device="cpu")
    m_deq.insert(q.astype(np.float32) * step + pos, pos)
    for f in ("dir_keys", "pool_sd", "pool_w"):
        assert torch.equal(getattr(m_deq.state, f),
                           getattr(m_packed.state, f)), f
    # tests/test_map.py's second bar: the surface stays put
    radii = np.linalg.norm(m_packed.extract_mesh().vertices, axis=1)
    assert np.abs(radii - 1.0).max() < 2 * cfg.sdf_res
    assert np.sqrt(((radii - 1.0) ** 2).mean()) < 0.02


def _voxel_diff(a, b):
    """(# codes in only one of the two maps, |sd diff| on the rest)."""
    (ca, sa), (cb, sb) = a.voxel_samples(), b.voxel_samples()
    common, ia, ib = np.intersect1d(ca, cb, assume_unique=True,
                                    return_indices=True)
    return (ca.shape[0] + cb.shape[0] - 2 * common.shape[0],
            np.abs(sa[ia] - sb[ib]))


def _jax_state(state):
    """The port's state as the JAX package's (``state_to_numpy``)."""
    return j_state.ActiveMapState(
        **{k: jnp.asarray(v) for k, v in t_state.state_to_numpy(state).items()})


def test_stream_with_two_rotations_matches_jax_map():
    """Six packed scans under ``seg`` through both ``TSDFMap``s: two
    rotations, deferred until the drain; submap count, anchors,
    trajectories, ``stats()`` keys and overflow counts equal.  The voxels
    are held statistically: the JAX map runs compiled, and XLA's CPU code
    contracts multiply-adds, which turns the normal of an ill-conditioned
    plane fit and breaks DDA ties on the packed points' 6.25 mm lattice
    differently from the port's separately rounded operations.  Measured
    here: 2,201 of 154,340 voxel codes in only one map (1.4%), 0.32% of
    the shared voxels beyond one codec step, 9,610 against 9,614 active
    blocks.  The exact comparisons are tests/test_torch_seg.py's (states,
    entry for entry) and the next test's (the DAG)."""
    cfg = _cfg(accumulate_impl="seg", packed_ingest=True)
    scans = _stream()
    assert kitti_stream.expected_rotations(scans, cfg) == 2
    jm = JaxTSDFMap(config=_jax(cfg))
    tm = TSDFMap(config=cfg, device="cpu")
    for pts, pos in scans:
        jm.insert(pts, pos)
        syncs = timing.COUNTS["host_syncs"]
        tm.insert(pts, pos)
        # no seg insert waits for the device, rotations included
        assert timing.COUNTS["host_syncs"] == syncs
    assert len(tm._pending) == 2 and not tm.submaps
    assert tm.n_submaps == 2 == jm.n_submaps
    js, ts = jm.stats(), tm.stats()
    assert not tm._pending and len(tm.submaps) == 2
    assert set(ts) == set(js)
    assert ts["n_submaps"] == js["n_submaps"] == 2
    assert ts["overflow"] == js["overflow"]
    assert not any(ts["overflow"].values())
    assert abs(ts["active_blocks"] - js["active_blocks"]) <= \
        1e-3 * js["active_blocks"]
    for a, b in zip(tm.submaps, jm.submaps):
        np.testing.assert_array_equal(a.anchor, b.anchor)
        np.testing.assert_array_equal(np.asarray(a.positions),
                                      np.asarray(b.positions))
        assert abs(a.n_voxels - b.n_voxels) <= 1e-3 * b.n_voxels
    n_diff, sd_diff = _voxel_diff(tm, jm)
    assert n_diff <= 0.02 * sd_diff.shape[0]
    assert (sd_diff > STEP + 1e-7).mean() <= 0.01
    assert np.median(sd_diff) == 0.0


def test_stream_dag_and_stats_match_jax_finalize():
    """The DAG of a rotating stream, exactly: the port's rotated-out and
    active states go to the JAX package as numpy, the JAX package
    finalizes them its deferred way, and per-level uniques and dupes, the
    submaps' roots, clusters and voxels and every ``stats()`` value must
    equal what the port's own drain built."""
    cfg = _cfg(accumulate_impl="seg", packed_ingest=True)
    tm = TSDFMap(config=cfg, device="cpu")
    for pts, pos in _stream():
        tm.insert(pts, pos)
    jm = JaxTSDFMap(config=_jax(cfg))
    for p in tm._pending:
        jm._pending.append(j_submap.start_finalize(
            _jax_state(p.raw_state), jm.config, p.positions,
            anchor=p.anchor))
    jm.state = _jax_state(tm.state)
    assert jm.n_submaps == tm.n_submaps == 2
    js, ts = jm.stats(), tm.stats()
    assert ts == js
    assert [d["uniques"] for d in ts["node_levels"]][-1] > 1000
    for a, b in zip(tm.submaps, jm.submaps):
        assert (a.n_clusters, a.n_voxels, a.root_addr_tsdf,
                a.root_addr_weight) == (b.n_clusters, b.n_voxels,
                                        b.root_addr_tsdf, b.root_addr_weight)
    n_diff, sd_diff = _voxel_diff(tm, jm)
    assert n_diff == 0 and not sd_diff.any()


def _levels_equal(a, b):
    assert a.levels.stats() == b.levels.stats()
    for x, y in zip(a.levels.nodes, b.levels.nodes):
        np.testing.assert_array_equal(x.raw, y.raw)
    np.testing.assert_array_equal(a.levels.leaf_clusters.raw,
                                  b.levels.leaf_clusters.raw)


def test_deferred_rotation_equals_draining_every_insert():
    cfg = _cfg(accumulate_impl="seg", packed_ingest=True, **SMALL)
    scans = _stream(n=1024)
    deferred = TSDFMap(config=cfg, device="cpu")
    drained = TSDFMap(config=cfg, device="cpu")
    for pts, pos in scans:
        deferred.insert(pts, pos)
        drained.insert(pts, pos)
        drained._drain_pending()
        assert not drained._pending
    assert len(deferred._pending) == 2 and len(drained.submaps) == 2
    assert deferred.stats() == drained.stats()
    _levels_equal(deferred, drained)
    for a, b in zip(deferred.submaps, drained.submaps):
        assert dataclasses.astuple(a)[:2] == dataclasses.astuple(b)[:2]
    deferred.finalize_active()
    drained.finalize_active()
    assert deferred.n_submaps == 3 == drained.n_submaps
    assert deferred.state is None
    _levels_equal(deferred, drained)


@pytest.mark.parametrize("bound", ["count", "bytes"])
def test_max_pending_finalize_bounds_the_stubs(bound, monkeypatch):
    """More rotations than ``max_pending_finalize`` (or than fit in the
    map's byte bound on pinned pools): the oldest stub is materialized at
    the rotation, and a stub holds the rotated-out state until then.  At
    the default config the count decides: the byte bound is four default
    pools."""
    pool = 2 * SMALL["block_capacity"] * 512 * 4
    default = MapConfig()
    assert t_map._MAX_PENDING_BYTES == \
        default.max_pending_finalize * 2 * default.block_capacity * 512 * 4
    if bound == "bytes":
        monkeypatch.setattr(t_map, "_MAX_PENDING_BYTES", pool + pool // 2)
    cfg = _cfg(accumulate_impl="seg", max_pending_finalize=(
        1 if bound == "count" else 4), **SMALL)
    m = TSDFMap(config=cfg, device="cpu")
    for pts, pos in _stream(5, spacing=6.0, n=1024):   # every scan rotates
        m.insert(pts, pos)
        assert len(m._pending) <= 1
    assert m.n_submaps == 4 and len(m.submaps) == 3
    stub = m._pending[0]
    assert isinstance(stub, t_submap.PendingSubmap)
    assert stub.raw_state is not None and stub.buf is None
    assert stub.pinned_bytes == pool
    if bound == "bytes":
        return
    with pytest.warns(RuntimeWarning, match="touched_overflow"):
        tiny = TSDFMap(config=_cfg(accumulate_impl="seg", **{
            **SMALL, "touched_capacity": 64}), device="cpu")
        for pts, pos in _stream(2, spacing=6.0, n=1024):
            tiny.insert(pts, pos)                  # no warning yet
        tiny.stats()                               # the drain warns


def test_undrained_rotation_warns_at_del():
    """A rotated-out map whose ``block_capacity`` overflowed warns when the
    map goes away without a drain (the drain would have warned); the
    active map after it overflows nothing, and the inserts read nothing."""
    import gc
    import warnings

    cfg = _cfg(accumulate_impl="seg", **{**SMALL, "block_capacity": 64})
    scans = _stream(2, spacing=6.0, n=1024)
    m = TSDFMap(config=cfg, device="cpu")
    m.insert(*scans[0])
    m.insert(scans[1][0][:16], scans[1][1])        # rotates; a few points
    assert len(m._pending) == 1
    assert int(m._pending[0].raw_state.block_overflow) > 0
    assert not any(int(getattr(m.state, k)) for k in
                   ("point_overflow", "sample_overflow", "block_overflow",
                    "touched_overflow"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        del m
        gc.collect()
    msgs = [str(r.message) for r in rec
            if issubclass(r.category, RuntimeWarning)]
    assert any("block_overflow" in s for s in msgs), msgs


def test_empty_map_stats_and_rotation():
    m = TSDFMap(config=_cfg(), device="cpu")
    assert m.stats()["n_submaps"] == 0 and "overflow" not in m.stats()
    far = np.float32([[500.0, 0.0, 0.0]])          # outside the local extent
    m.insert(far, np.zeros(3, np.float32))
    m.insert(far, np.float32([6.0, 0.0, 0.0]))     # rotates an empty map out
    assert m.n_submaps == 1
    with pytest.warns(RuntimeWarning, match="point_overflow"):
        s = m.stats()
    assert s["n_submaps"] == 1 and s["active_blocks"] == 0
    assert s["overflow"]["points"] == 1
    assert m.submaps[0].n_clusters == 0


def test_stream_script_helpers():
    cfg = kitti_stream.stream_config()
    assert (cfg.block_capacity, cfg.touched_capacity, cfg.packed_ingest) == \
        (1 << 16, 1 << 15, True)
    assert kitti_stream.stream_config(sparse_impl="pallas").sparse_impl == \
        "pallas"
    scans = kitti_stream.make_scans(2)
    np.testing.assert_array_equal(
        scans[1][0], j_kitti.synthetic_lidar_scan([1.5, 0.0, 0.0], seed=1))
    np.testing.assert_array_equal(scans[1][1], np.float32([1.5, 0.0, 1.7]))
    positions = [(None, np.float32([1.5 * i, 0.0, 1.7])) for i in range(12)]
    assert kitti_stream.expected_rotations(positions, cfg) == 2
    small = _cfg(accumulate_impl="seg", packed_ingest=True, **SMALL)
    m, dt, n_pts, metrics, reads = kitti_stream.timed_stream(
        _stream(3, n=1024), small, "cpu")
    assert reads == {} and dt > 0 and n_pts == 2 * 1024
    assert len(metrics) == 2 and m.n_submaps == 1
    assert int(m.state.tile_overflow) == 0
