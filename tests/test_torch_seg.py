"""The port's sparse ``seg`` backend and packed ingest on the CPU against
the JAX package: ``pack_points`` bit for bit; ``sparse_seg_entry_stream``
entry for entry; ``insert_step`` under ``seg`` for a fresh and a
steady-state insert (directory and weights exact, ``pool_sd`` within 1e-5
and within one 16-bit quantum per sample, metrics equal); the tiny and the all-unique cloud of
tests/test_integrate.py's entry-bucket test; the port's ``seg`` against the
port's scatter backend; a voxel with more than 512 samples, where the
port's integer sum is the exact one; and that a ``seg`` insert reads no
tensor on the host.  Same inputs, made from a numpy seed, through both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu_torch import MapConfig
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.core.state import (INT32_MAX, create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from chad_tsdf_tpu_torch.scripts.kitti_stream import count_host_reads

N = 4096
CFG = MapConfig(max_points=N, block_capacity=1 << 14,
                touched_capacity=1 << 13, accumulate_impl="seg")
JCFG = JaxMapConfig(**dataclasses.asdict(CFG))
QUANTUM = CFG.sdf_trunc / 32767      # one 16-bit signed-distance quantum
# Compiled for the CPU, XLA contracts multiply-adds that eager JAX and the
# port round separately: about one sample in a hundred lands on the next
# quantum.  So against the compiled JAX functions (one compile for all
# cases; eager JAX takes minutes under a loaded test run) a voxel's sum may
# differ by one quantum per sample in it, and nothing else may differ.
J_ENTRIES = jax.jit(j_integrate.sparse_seg_entry_stream,
                    static_argnames=("config",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: intra-op threads buy nothing and, when the
    suite runs on several workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _lidar():
    scan = synthetic_lidar_scan([0.0, 0.0, 0.0], seed=3)
    return scan[:: max(1, len(scan) // N)][:N].astype(np.float32)


def _cloud(name):
    """(points f32[n, 3], scanner position f32[3]) of a named test cloud."""
    if name == "dense sphere":
        return _sphere(N), np.zeros(3, np.float32)
    if name == "lidar":
        return _lidar(), np.float32([0, 0, 1.7])
    if name == "tiny":
        return _sphere(64), np.zeros(3, np.float32)
    if name == "all unique":
        # widely scattered points: nearly every DDA sample has its own voxel
        rng = np.random.default_rng(11)
        return (rng.uniform(-100, 100, (N, 3)).astype(np.float32),
                np.zeros(3, np.float32))
    raise KeyError(name)


def _padded(pts):
    pad = np.zeros((N, 3), np.float32)
    pad[:len(pts)] = pts
    return pad


def _insert_both(pts, pos, times, cfg=CFG, jcfg=JCFG):
    """``times`` inserts of one cloud through the JAX package and the port;
    returns (jax state, jax metrics, port state, port metrics)."""
    origin = origin_blocks_for_position(pos, cfg)
    jst = j_create_state(jcfg, origin)
    tst = create_state(cfg, origin, "cpu")
    pad = _padded(pts)
    for _ in range(times):
        jst, jm = j_integrate.insert_step(
            jst, jnp.asarray(pad), jnp.int32(len(pts)), jnp.asarray(pos),
            jcfg)
        tst, tm = t_integrate.insert_step(
            tst, torch.from_numpy(pad.copy()), len(pts),
            torch.from_numpy(pos), cfg)
    return jst, jm, tst, tm


def _assert_states_equal(jst, tst, atol=None, per_sample=True):
    """Directory, weights and counters exact; ``pool_sd`` within one
    quantum per sample of the voxel (``per_sample``) and, where given,
    within ``atol``."""
    assert int(jst.n_blocks) == int(tst.n_blocks)
    np.testing.assert_array_equal(tst.dir_keys.numpy(),
                                  np.asarray(jst.dir_keys))
    np.testing.assert_array_equal(tst.dir_slots.numpy(),
                                  np.asarray(jst.dir_slots))
    w = tst.pool_w.numpy()
    np.testing.assert_array_equal(w, np.asarray(jst.pool_w))
    diff = np.abs(tst.pool_sd.numpy() - np.asarray(jst.pool_sd))
    if per_sample:
        assert (diff <= w * QUANTUM + 1e-7).all()
    if atol is not None:
        assert diff.max() <= atol
    for name in ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow", "tile_overflow"):
        assert int(getattr(tst, name)) == int(getattr(jst, name)), name
    assert int(tst.tile_overflow) == 0


def test_pack_points_bit_equal():
    rng = np.random.default_rng(5)
    pts = np.concatenate([_lidar(),
                          rng.uniform(-500, 500, (256, 3)).astype(np.float32)])
    pos = np.float32([1.5, -0.25, 1.7])
    for res in (0.05, 0.1):
        j = j_integrate.pack_points(pts, pos, res)
        t = t_integrate.pack_points(pts, pos, res)
        assert t.dtype == np.int16 and t.tobytes() == j.tobytes()
    assert np.abs(t).max() == 32767          # the far points clamp


def _port_entries(cloud):
    pts, pos = _cloud(cloud)
    origin = origin_blocks_for_position(pos, CFG)
    return (pts, pos, origin, t_integrate.sparse_seg_entry_stream(
        torch.from_numpy(_padded(pts)), len(pts), torch.from_numpy(pos),
        torch.from_numpy(origin), CFG))


def _assert_entries_equal(je, te, exact_sums):
    """Entry for entry: e_b everywhere, e_okey / e_w on the live prefix
    (JAX leaves running sums beyond it, the port zeros); e_sd_q exact, or
    within one quantum per sample of the voxel."""
    e_total = int(je[4])
    assert int(te[4]) == e_total and e_total > 0
    assert int(te[5]) == int(je[5])                    # n_valid_samples
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je[0]))
    assert (te[0].numpy()[e_total:] == INT32_MAX).all()
    for i in (1, 3):
        np.testing.assert_array_equal(te[i].numpy()[:e_total],
                                      np.asarray(je[i])[:e_total])
    diff = np.abs(te[2].numpy()[:e_total] -
                  np.asarray(je[2])[:e_total].astype(np.int64))
    if exact_sums:
        assert not diff.any()
    else:
        assert (diff <= te[3].numpy()[:e_total]).all()
        assert (diff != 0).mean() < 0.1
    for i in (1, 2, 3):
        assert not te[i][e_total:].any()
    assert te[2].dtype == torch.int64 and te[3].dtype == torch.int32


@pytest.mark.parametrize("cloud", ["dense sphere", "lidar"])
def test_entry_stream_same_samples_matches_jax(cloud, monkeypatch):
    """Sort, segmented sum and compaction on the SAME samples (the port's,
    handed to the JAX function in place of its own ``compute_samples``):
    every field of every entry exact."""
    _, _, _, te = _port_entries(cloud)

    def reduce(bkey, payload):
        batch = j_integrate.SampleBatch(bkey, payload, jnp.int32(0),
                                        jnp.int32(0))
        monkeypatch.setattr(j_integrate, "compute_samples",
                            lambda *a, **k: batch)
        return j_integrate.sparse_seg_entry_stream(None, None, None, None,
                                                   JCFG)[:6]

    je = jax.jit(reduce)(jnp.asarray(te[6].bkey.numpy()),
                         jnp.asarray(te[6].payload.numpy()))
    _assert_entries_equal(je, te, exact_sums=True)


@pytest.mark.parametrize("cloud", ["dense sphere", "lidar"])
def test_entry_stream_matches_jax(cloud):
    """From the points on, each package computing its own samples: blocks,
    offsets, counts and totals exact; sums within a quantum per sample
    (0.8% of the sphere's 16,934 sums and 5.1% of the scan's differ, by 1-2
    quanta; against eager JAX one of the sphere's does, by one)."""
    pts, pos, origin, te = _port_entries(cloud)
    je = J_ENTRIES(jnp.asarray(_padded(pts)), jnp.int32(len(pts)),
                   jnp.asarray(pos), jnp.asarray(origin), config=JCFG)
    _assert_entries_equal(je, te, exact_sums=False)


@pytest.mark.parametrize("cloud", ["dense sphere", "lidar"])
def test_seg_insert_matches_jax(cloud):
    """Fresh and steady-state insert: after each, the port's state equals
    the JAX package's; ``pool_sd`` within 1e-5 after the fresh insert (two
    inserts double a voxel's quanta: up to 1.3e-5 on the sphere)."""
    pts, pos = _cloud(cloud)
    for times in (1, 2):
        jst, jm, tst, tm = _insert_both(pts, pos, times)
        _assert_states_equal(jst, tst, atol=1e-5 if times == 1 else None)
        for k in jm:
            assert int(tm[k]) == int(jm[k]), k
        assert tm["host_reads"] == 0


@pytest.mark.parametrize("cloud", ["tiny", "all unique"])
def test_seg_entry_counts_small_and_full(cloud):
    """The JAX package's smallest (S/4) and largest (S) entry buckets; the
    port's one capacity S must equal both."""
    pts, pos = _cloud(cloud)
    jst, _, tst, _ = _insert_both(pts, pos, 1)
    # 100 m from the scanner an f32 coordinate's last bit is 7.6e-6 m, more
    # than a quantum: tests/test_integrate.py's 1e-5 is the bound there
    _assert_states_equal(jst, tst, atol=1e-5, per_sample=cloud == "tiny")


@pytest.mark.parametrize("cloud", ["dense sphere", "lidar", "all unique"])
def test_seg_matches_port_scatter_backend(cloud):
    """tests/test_integrate.py's differential on the port: ``seg`` against
    ``xla`` after two inserts."""
    pts, pos = _cloud(cloud)
    states = {}
    for impl in ("seg", "xla"):
        cfg = dataclasses.replace(CFG, accumulate_impl=impl)
        st = create_state(cfg, origin_blocks_for_position(pos, cfg), "cpu")
        for _ in range(2):
            st, m = t_integrate.insert_step(
                st, torch.from_numpy(_padded(pts)), len(pts),
                torch.from_numpy(pos), cfg)
        states[impl] = (st, m)
    (a, ma), (b, mb) = states["seg"], states["xla"]
    assert torch.equal(a.dir_keys, b.dir_keys)
    assert torch.equal(a.dir_slots, b.dir_slots)
    assert torch.equal(a.pool_w, b.pool_w)
    assert float((a.pool_sd - b.pool_sd).abs().max()) <= 1e-5
    for k in ("n_valid_samples", "n_touched_blocks", "n_blocks"):
        assert int(ma[k]) == int(mb[k]), k
    assert int(a.tile_overflow) == 0 == int(b.tile_overflow)


def test_voxel_beyond_512_samples_is_exact():
    """4096 points in one voxel put 4096 samples into it.  The JAX package
    carries a voxel's sum of 16-bit quanta in f32, exact only while count x
    32767 < 2^24 (512 samples); the port sums integers, so it must equal
    the exact integer sum for every voxel, this one included."""
    rng = np.random.default_rng(2)
    pts = (np.float32([1.025, 0.525, 0.275]) +
           rng.uniform(-0.02, 0.02, (N, 3))).astype(np.float32)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, CFG)
    e_b, e_okey, e_sd_q, e_w, e_total, _, batch = \
        t_integrate.sparse_seg_entry_stream(
            torch.from_numpy(pts), N, torch.from_numpy(pos),
            torch.from_numpy(origin), CFG)
    n = int(e_total)
    assert int(e_w.max()) > 512

    bkey = batch.bkey.numpy().astype(np.int64)
    payload = batch.payload.numpy().astype(np.int64)
    live = bkey != INT32_MAX
    voxel = (bkey[live] << 9) | (payload[live] >> 16)
    q = ((payload[live] & 0xFFFF) ^ 0x8000) - 0x8000      # sign-extend
    uniq, inv, counts = np.unique(voxel, return_inverse=True,
                                  return_counts=True)
    sums = np.zeros(uniq.shape[0], np.int64)
    np.add.at(sums, inv, q)
    got_voxel = (e_b.numpy()[:n].astype(np.int64) << 9) | e_okey.numpy()[:n]
    np.testing.assert_array_equal(got_voxel, uniq)
    np.testing.assert_array_equal(e_w.numpy()[:n], counts)
    np.testing.assert_array_equal(e_sd_q.numpy()[:n], sums)
    # where f32 could not hold the sum, the exact one is the port's
    big = np.abs(sums) >= 2 ** 24
    assert big.any()


def test_seg_insert_reads_nothing_on_the_host():
    pts, pos = _cloud("lidar")
    st = create_state(CFG, origin_blocks_for_position(pos, CFG), "cpu")
    pad, p = torch.from_numpy(_padded(pts)), torch.from_numpy(pos)
    q = torch.from_numpy(t_integrate.pack_points(_padded(pts), pos,
                                                 CFG.sdf_res))
    with count_host_reads() as reads:
        st, m = t_integrate.insert_step(st, pad, len(pts), p, CFG)
        st, m = t_integrate.insert_step_packed(st, q, len(pts), p, CFG)
    assert reads == {}
    assert int(m["n_blocks"]) > 0
    with count_host_reads() as reads:       # the counter does count
        int(m["n_blocks"])
        m["n_valid_samples"].item()
    assert reads.get("__int__") == 1 and reads.get("item", 0) >= 1
