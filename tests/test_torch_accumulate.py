"""The port's sort-path accumulate on the CPU, through K5's plain version,
against the JAX package: ``group_touched_blocks`` table for table; K5
(``accumulate_segments``) against ``accumulate_pallas(interpret=True)``
(weights exact, sd within 1e-3 per sample: the TPU kernel's bf16 one-hot)
and against the f32 scatter ``accumulate_xla`` (weights exact, sd within
1e-4 per unit weight); ``update_pool`` on the K5 route against the JAX
``update_pool`` under ``xla`` (JAX's ``pallas`` route does not run on the
CPU); the ``pallas`` and ``tile`` backends against the JAX package on a
2048-point sphere; and the fused fallback through K5 against its scatter
route."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu.ops import accumulate as j_acc
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.ops import accumulate as t_acc

TRUNC = 0.1


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(n, r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _cfg(impl, n=2048, cap=8192):
    return MapConfig(max_points=n, block_capacity=cap, touched_capacity=cap,
                     accumulate_impl=impl)


def _jax(cfg):
    """The JAX package's MapConfig with the port's config's fields."""
    return JaxMapConfig(**dataclasses.asdict(cfg))


def _assert_tables_equal(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy().ravel(),
                                      np.asarray(a).ravel())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_touched_blocks_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cb, t_cap = 512, 128
    slots = rng.permutation(cb - 8)[:t_cap].astype(np.int32)
    dead = rng.random(t_cap) < 0.4
    slots[dead] = cb - 1
    starts = rng.integers(0, 10000, t_cap).astype(np.int32)
    lens = np.where(dead, 0, rng.integers(1, 60, t_cap)).astype(np.int32)
    j = j_acc.group_touched_blocks(jnp.asarray(starts), jnp.asarray(lens),
                                   jnp.asarray(slots), t_cap, cb)
    t = t_acc.group_touched_blocks(_t(starts), _t(lens), _t(slots), t_cap,
                                   cb)
    _assert_tables_equal(j, t)


def test_group_tables_bounded_by_live_members():
    """tests/test_integrate.py's case: 3 live blocks, the rest reserved; the
    last live group's glen stops at the live prefix, as in JAX."""
    cb, t_cap = 256, 64
    slots = np.asarray([5, 9, 200] + [cb - 1] * (t_cap - 3), np.int32)
    starts = np.arange(t_cap, dtype=np.int32)
    lens = np.full(t_cap, 4, np.int32)
    j = j_acc.group_touched_blocks(jnp.asarray(starts), jnp.asarray(lens),
                                   jnp.asarray(slots), t_cap, cb)
    t = t_acc.group_touched_blocks(_t(starts), _t(lens), _t(slots), t_cap,
                                   cb)
    _assert_tables_equal(j, t)
    ng, gstart, glen = int(t[0][0]), t[1].numpy(), t[2].numpy()
    assert ng == 3 and (gstart[:ng] + glen[:ng]).max() <= 3
    assert int(glen[:ng].sum()) == 3


def _segments(rng, cb, t_cap, s_n, n_blocks, long_block=None):
    """Block-sorted payload over n_blocks blocks with scattered slots, and
    the member tables (starts, lens, slots) padded with dead entries."""
    blocks = np.sort(rng.integers(0, n_blocks, s_n))
    if long_block is not None:
        blocks = np.sort(np.concatenate([blocks,
                                         np.full(long_block, n_blocks)]))
    offs = rng.integers(0, 512, blocks.shape[0]).astype(np.int32)
    sd = rng.uniform(-TRUNC, TRUNC, blocks.shape[0]).astype(np.float32)
    uniq, first, counts = np.unique(blocks, return_index=True,
                                    return_counts=True)
    slot_of = rng.permutation(cb - t_acc.GROUP)[:len(uniq)].astype(np.int32)
    pad = t_cap - len(uniq)
    starts = np.concatenate([first, np.zeros(pad)]).astype(np.int32)
    lens = np.concatenate([counts, np.zeros(pad)]).astype(np.int32)
    slots = np.concatenate([slot_of, np.full(pad, cb - 1)]).astype(np.int32)
    slot_per_sample = np.repeat(slot_of, counts)
    return offs, sd, starts, lens, slots, slot_per_sample


def test_k5_plain_matches_jax_kernel_and_scatter():
    """The shapes of tests/test_integrate.py::test_pallas_interpret_matches_xla
    (64-row pool, 32 member slots, 4096 samples over < 32 blocks)."""
    rng = np.random.default_rng(9)
    cb, t_cap, s_n = 64, 32, 4096
    offs, sd, starts, lens, slots, sps = _segments(rng, cb, t_cap, s_n, 30)
    payload = j_integrate.pack_payload(jnp.asarray(offs), jnp.asarray(sd),
                                       TRUNC)
    okey, sdq = j_integrate.unpack_payload(payload, TRUNC)
    zeros = jnp.zeros((cb, 512), jnp.float32)
    x_sd, x_w = j_acc.accumulate_xla(zeros, zeros, jnp.asarray(sps), okey,
                                     sdq, jnp.ones(s_n, bool))
    groups = j_acc.group_touched_blocks(jnp.asarray(starts),
                                        jnp.asarray(lens),
                                        jnp.asarray(slots), t_cap, cb)
    k_sd, k_w = j_acc.accumulate_pallas(
        zeros, zeros, *groups,
        jnp.concatenate([payload, jnp.zeros(j_acc.CHUNK, jnp.int32)]),
        touched_capacity=t_cap, sd_scale=TRUNC / 32767.0, interpret=True)

    tables = t_acc.group_touched_blocks(_t(starts), _t(lens), _t(slots),
                                        t_cap, cb)[4:]
    pool_sd = torch.zeros((cb, 512))
    pool_w = torch.zeros((cb, 512))
    got_sd, got_w = t_acc.accumulate_segments(pool_sd, pool_w, *tables,
                                              _t(payload), TRUNC)
    assert got_sd is pool_sd and got_w is pool_w        # in place
    got_sd, got_w = got_sd.numpy(), got_w.numpy()
    np.testing.assert_array_equal(got_w, np.asarray(k_w))
    np.testing.assert_array_equal(got_w, np.asarray(x_w))
    w = np.maximum(np.asarray(x_w), 1)
    # the TPU kernel's bf16 one-hot: sd within 1e-3 per sample
    assert (np.abs(got_sd - np.asarray(k_sd)) / w).max() < 1e-3
    # the f32 twin: 1e-4 per unit weight (the gate of tests/test_fused.py)
    assert (np.abs(got_sd - np.asarray(x_sd)) / w).max() < 1e-4


def test_k5_long_segment_sums_in_int64():
    """One block with 70,000 samples at the top of the sd grid in one cell:
    70,000 x 32,767 overflows int32.  The plain version equals the exact
    integer sum scaled once, and the f32 scatter within 1e-4 per weight."""
    rng = np.random.default_rng(3)
    cb, t_cap, long_n = 64, 8, 70000
    offs, sd, starts, lens, slots, sps = _segments(rng, cb, t_cap, 512, 4,
                                                   long_block=long_n)
    offs[-long_n:] = 17
    sd[-long_n:] = TRUNC
    payload = j_integrate.pack_payload(jnp.asarray(offs), jnp.asarray(sd),
                                       TRUNC)
    okey, sdq = j_integrate.unpack_payload(payload, TRUNC)
    zeros = jnp.zeros((cb, 512), jnp.float32)
    x_sd, x_w = j_acc.accumulate_xla(zeros, zeros, jnp.asarray(sps), okey,
                                     sdq, jnp.ones(offs.shape[0], bool))
    tables = t_acc.group_touched_blocks(_t(starts), _t(lens), _t(slots),
                                        t_cap, cb)[4:]
    got_sd, got_w = t_acc.accumulate_segments(
        torch.zeros((cb, 512)), torch.zeros((cb, 512)), *tables,
        _t(payload), TRUNC)
    long_slot = int(slots[np.argmax(lens)])
    assert int(lens.max()) >= long_n > 65536
    assert float(got_w[long_slot, 17]) == long_n
    exact = np.float32(long_n * 32767) * np.float32(TRUNC / 32767.0)
    assert float(got_sd[long_slot, 17]) == float(exact)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(x_w))
    w = np.maximum(np.asarray(x_w), 1)
    assert (np.abs(got_sd.numpy() - np.asarray(x_sd)) / w).max() < 1e-4


def test_k5_skips_dead_members():
    """Dead entries (reserved slot) add nothing, even with samples."""
    cb = 64
    payload = _t(np.asarray([(3 << 16) | 100] * 8, np.int32))
    tables = (_t(np.asarray([0, 4], np.int32)), _t(np.asarray([4, 4],
                                                              np.int32)),
              _t(np.asarray([5, cb - 1], np.int32)))
    sd, w = t_acc.accumulate_segments(torch.zeros((cb, 512)),
                                      torch.zeros((cb, 512)), *tables,
                                      payload, TRUNC)
    assert float(w.sum()) == 4 and float(w[5, 3]) == 4
    assert float(w[cb - 1].abs().sum()) == 0 and float(sd[cb - 1].abs()
                                                       .sum()) == 0


def _edge_tables(chunk):
    """Members of lengths 0, 1, C-1, C, C+1 and 3C+5 on live slots, two dead
    members with samples (reserved slot), packed back to back."""
    cb = 64
    lens = np.asarray([0, 1, chunk - 1, 7, chunk, chunk + 1, 5, 3 * chunk + 5],
                      np.int32)
    slots = np.asarray([3, 9, 1, cb - 1, 20, 4, cb - 1, 11], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return cb, starts, lens, slots


def _assert_chunks_cover(lens, slots, cb, chunk):
    """plan_chunks_plain's list: every kept sample lies in exactly one
    chunk; a member's chunks are contiguous and in order; dead members and
    the reserved slot give none; multi-chunk members get scratch rows
    0, 1, ... in member order.  Returns the chunks per member."""
    member, index, row = (a.numpy() for a in t_acc.plan_chunks_plain(
        _t(lens), _t(slots), cb, chunk))
    live = (slots != cb - 1) & (lens > 0)
    hits = {m: np.zeros(lens[m], np.int32) for m in range(len(lens))}
    for m, k in zip(member, index):
        assert live[m]
        lo = k * chunk
        hi = min(lo + chunk, lens[m])
        assert 0 <= lo < hi
        hits[m][lo:hi] += 1
    for m in range(len(lens)):
        np.testing.assert_array_equal(hits[m], 1 if live[m] else 0)
        ks = index[member == m]
        np.testing.assert_array_equal(ks, np.arange(ks.shape[0]))
    assert (np.diff(member) >= 0).all()
    nch = np.where(live, -(-lens // chunk), 0)
    np.testing.assert_array_equal(
        row, np.where(nch > 1, np.cumsum(nch > 1) - 1, -1))
    # the device list's capacity and scratch rows bound this list
    cap, rows = t_acc._chunk_sizes(len(lens), int(lens.sum()), chunk)
    assert member.shape[0] <= cap and int((nch > 1).sum()) <= rows
    return nch


@pytest.mark.parametrize("chunk", [8, 4096])
def test_plan_chunks_plain_covers_each_sample_once(chunk):
    cb, _, lens, slots = _edge_tables(chunk)
    nch = _assert_chunks_cover(lens, slots, cb, chunk)
    assert list(nch) == [0, 1, 1, 0, 1, 2, 0, 4]


def test_chunk_sizes_bound_random_tables():
    """For disjoint segments of a payload, the list never outgrows its
    capacity nor the multi-chunk members the scratch rows."""
    rng = np.random.default_rng(11)
    for _ in range(50):
        chunk = int(rng.choice([8, 64, 4096]))
        t = int(rng.integers(1, 200))
        lens = rng.integers(0, 4 * chunk, t).astype(np.int32)
        slots = np.where(rng.random(t) < 0.2, 63, 5).astype(np.int32)
        s = int(lens.sum()) + int(rng.integers(0, chunk))
        member, _, row = t_acc.plan_chunks_plain(_t(lens), _t(slots), 64,
                                                 chunk)
        cap, rows = t_acc._chunk_sizes(t, s, chunk)
        assert member.shape[0] <= cap
        assert int(row.max()) < rows


def _chunked_plain(pool_sd, pool_w, starts, lens, slots, payload, chunk):
    """K5 as the kernel runs it: per chunk int64 cell partials, a member's
    chunk partials summed in chunk order, then scaled once, added once."""
    cb = pool_sd.shape[0]
    member, index, _ = t_acc.plan_chunks_plain(lens, slots, cb, chunk)
    m = member.to(torch.int64)
    lo = index.to(torch.int64) * chunk
    clen = torch.clamp(lens.to(torch.int64)[m] - lo, max=chunk)
    first = starts.to(torch.int64)[m] + lo
    cid = torch.repeat_interleave(torch.arange(m.shape[0]), clen)
    pos = torch.arange(cid.shape[0]) - torch.repeat_interleave(
        torch.cumsum(clen, 0) - clen, clen)
    p = payload.to(torch.int64)[first[cid] + pos]
    cell = cid * 512 + ((p >> 16) & 0x1FF)
    part_q = torch.zeros(m.shape[0] * 512, dtype=torch.int64)
    part_q.index_add_(0, cell, (p << 48) >> 48)
    part_w = torch.zeros_like(part_q)
    part_w.index_add_(0, cell, torch.ones_like(cell))
    tot_q = torch.zeros((lens.shape[0], 512), dtype=torch.int64)
    tot_w = torch.zeros_like(tot_q)
    for c in range(m.shape[0]):                  # chunk order
        tot_q[m[c]] += part_q[c * 512:(c + 1) * 512]
        tot_w[m[c]] += part_w[c * 512:(c + 1) * 512]
    _, dscale = t_acc.sd_scales(TRUNC)
    for mm in torch.unique(m).tolist():
        row = int(slots[mm])
        hit = tot_w[mm] != 0
        pool_sd[row, hit] = (pool_sd[row, hit] +
                             tot_q[mm, hit].to(torch.float32) * dscale)
        pool_w[row, hit] = pool_w[row, hit] + tot_w[mm, hit].to(torch.float32)
    return pool_sd, pool_w


@pytest.mark.parametrize("chunk", [8, 64, 4096])
def test_chunked_accumulate_equals_plain(chunk):
    """Chunk partials summed then scaled once equal the plain K5 bit for bit,
    on random segments with one long block and on the edge lengths."""
    rng = np.random.default_rng(chunk)
    cb, t_cap = 64, 16
    offs, sd, starts, lens, slots, _ = _segments(rng, cb, t_cap, 3000, 8,
                                                 long_block=3 * chunk + 5)
    payload = np.asarray(j_integrate.pack_payload(
        jnp.asarray(offs), jnp.asarray(sd), TRUNC))
    ecb, estarts, elens, eslots = _edge_tables(chunk)
    epay = rng.integers(-2**31, 2**31 - 1, int(elens.sum()),
                        dtype=np.int64).astype(np.int32)
    for cb_, tables, pay in ((cb, (starts, lens, slots), payload),
                             (ecb, (estarts, elens, eslots), epay)):
        tables = tuple(_t(a) for a in tables)
        got = (torch.zeros((cb_, 512)), torch.zeros((cb_, 512)))
        want = (torch.zeros((cb_, 512)), torch.zeros((cb_, 512)))
        for _ in range(2):                       # the second adds onto rows
            _chunked_plain(*got, *tables, _t(pay), chunk)
            t_acc.accumulate_segments_plain(*want, *tables, _t(pay), TRUNC)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float(want[1].sum()) == 2 * float(
            tables[1][tables[2] != cb_ - 1].sum())


def test_chunked_accumulate_matches_jax_kernel():
    """The chunked accumulate (chunk 32: most members have several chunks)
    against accumulate_pallas(interpret=True) at the shapes of
    test_k5_plain_matches_jax_kernel_and_scatter: weights exact, sd within
    1e-3 per sample (the TPU kernel's bf16 one-hot)."""
    rng = np.random.default_rng(9)
    cb, t_cap, s_n = 64, 32, 4096
    offs, sd, starts, lens, slots, _ = _segments(rng, cb, t_cap, s_n, 30)
    payload = j_integrate.pack_payload(jnp.asarray(offs), jnp.asarray(sd),
                                       TRUNC)
    zeros = jnp.zeros((cb, 512), jnp.float32)
    groups = j_acc.group_touched_blocks(jnp.asarray(starts),
                                        jnp.asarray(lens),
                                        jnp.asarray(slots), t_cap, cb)
    k_sd, k_w = j_acc.accumulate_pallas(
        zeros, zeros, *groups,
        jnp.concatenate([payload, jnp.zeros(j_acc.CHUNK, jnp.int32)]),
        touched_capacity=t_cap, sd_scale=TRUNC / 32767.0, interpret=True)
    tables = t_acc.group_touched_blocks(_t(starts), _t(lens), _t(slots),
                                        t_cap, cb)[4:]
    assert int(t_acc.plan_chunks_plain(tables[1], tables[2], cb, 32)[2]
               .max()) > 10
    got_sd, got_w = _chunked_plain(torch.zeros((cb, 512)),
                                   torch.zeros((cb, 512)), *tables,
                                   _t(payload), 32)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(k_w))
    w = np.maximum(np.asarray(k_w), 1)
    assert (np.abs(got_sd.numpy() - np.asarray(k_sd)) / w).max() < 1e-3


def test_chip_boundary_table_on_cpu():
    """chip_smoke's chunk-boundary table (profile_insert.py
    boundary_inputs) at a small size on the CPU: its chunk list covers every
    kept sample once, and the chunked accumulate equals the plain one bit
    for bit."""
    from chad_tsdf_tpu_torch.profile_insert import boundary_inputs
    chunk = 64
    cfg = MapConfig(block_capacity=512, touched_capacity=64)
    pools, tables, payload, stats = boundary_inputs(cfg, "cpu", chunk)
    starts, lens, slots = tables
    nch = _assert_chunks_cover(lens.numpy(), slots.numpy(), 512, chunk)
    assert list(nch[:13]) == [1, 1, 2, 0, 3, 4, 1, 0, 13, 5, 1, 0, 1]
    assert not nch[13:].any()
    assert int(lens.sum()) == payload.shape[0] == stats["samples"]
    want = (pools[0].clone(), pools[1].clone())
    t_acc.accumulate_segments_plain(*want, *tables, payload, TRUNC)
    _chunked_plain(*pools, *tables, payload, chunk)
    assert torch.equal(pools[0], want[0]) and torch.equal(pools[1], want[1])
    assert float(want[1].sum()) == stats["kept_samples"]


def test_plan_chunks_wrapper_on_cpu_is_plain():
    cb, starts, lens, slots = _edge_tables(t_acc.CHUNK)
    got = t_acc.plan_chunks(_t(lens), _t(slots), cb, int(lens.sum()))
    want = t_acc.plan_chunks_plain(_t(lens), _t(slots), cb, t_acc.CHUNK)
    assert [int(a.shape[0]) for a in got] == [9, 9, 8]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chunk_sizes_outgrown_by_overlapping_segments():
    """chip_smoke's overflow table: five live members over one 5C-sample
    range need more multi-chunk rows than disjoint segments could, which is
    what the device plan flags (and then adds nothing)."""
    c = t_acc.CHUNK
    lens = np.full(16, 0, np.int32)
    lens[:5] = 5 * c
    slots = np.full(16, 63, np.int32)
    slots[:5] = np.arange(5)
    member, _, row = t_acc.plan_chunks_plain(_t(lens), _t(slots), 64, c)
    cap, rows = t_acc._chunk_sizes(16, 5 * c, c)
    assert member.shape[0] == 25 and cap == 16 + 5
    assert int(row.max()) + 1 == 5 > rows == 4


def test_k5_launch_refuses_cpu_tensors():
    """The kernel entry never falls back to the plain version."""
    cb, starts, lens, slots = _edge_tables(8)
    pool = torch.zeros((cb, 512))
    with pytest.raises(ValueError, match="CUDA"):
        t_acc.launch_segments(pool, pool.clone(), _t(starts), _t(lens),
                              _t(slots), torch.zeros(100, dtype=torch.int32),
                              TRUNC)


@pytest.mark.parametrize("impl,device,expect", [
    ("pallas", "cpu", True), ("pallas", "cuda", True),
    ("xla", "cpu", False), ("xla", "cuda", False),
    ("auto", "cpu", False), ("auto", "cuda", True),
    ("fused", "cpu", False), ("fused", "cuda", True),
    ("tile", "cpu", False), ("tile", "cuda", True),
])
def test_segment_kernel_route(impl, device, expect):
    """_use_pallas of the JAX package with CUDA in the TPU's role."""
    cfg = MapConfig(accumulate_impl=impl)
    assert t_integrate._use_segment_kernel(cfg, torch.device(device)) \
        is expect


def _compare_states(j_state, t_state, sd_tol=1e-4):
    np.testing.assert_array_equal(t_state.dir_keys.numpy(),
                                  np.asarray(j_state.dir_keys))
    nbk = int(j_state.n_blocks)
    assert int(t_state.n_blocks) == nbk
    sl_j = np.asarray(j_state.dir_slots)[:nbk]
    sl_t = t_state.dir_slots.numpy()[:nbk]
    np.testing.assert_array_equal(sl_t, sl_j)
    wj = np.asarray(j_state.pool_w)[sl_j]
    np.testing.assert_array_equal(t_state.pool_w.numpy()[sl_t], wj)
    err = np.abs(t_state.pool_sd.numpy()[sl_t] -
                 np.asarray(j_state.pool_sd)[sl_j]) / np.maximum(wj, 1)
    assert err.max() < sd_tol, err.max()
    for name in ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow", "tile_overflow"):
        assert int(getattr(t_state, name)) == int(getattr(j_state, name)), \
            name


@pytest.mark.parametrize("cap,t_cap", [
    (4096, 4096),    # everything fits
    (128, 64),       # touched and block capacity overflow
])
def test_update_pool_k5_route_matches_jax(cap, t_cap):
    """The same block-sorted batch through the JAX update_pool (scatter) and
    the port's on the K5 route, twice, so the second adds onto live rows."""
    cfg = MapConfig(max_points=2048, block_capacity=cap,
                    touched_capacity=t_cap, accumulate_impl="xla")
    pos = np.asarray([0.1, 0.0, -0.2], np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    jst = j_create_state(_jax(cfg), origin)
    batch = j_integrate.sort_samples(j_integrate.compute_samples(
        jnp.asarray(_sphere(2048, 1.0, 2)), jnp.int32(2048),
        jnp.asarray(pos), jst.origin_blocks, _jax(cfg)))
    t_cfg = dataclasses.replace(cfg, accumulate_impl="pallas")
    tst = create_state(t_cfg, origin, "cpu")
    t_batch = t_integrate.SampleBatch(*(_t(a) for a in batch))
    for _ in range(2):
        jst, jm = j_integrate.update_pool(jst, batch, _jax(cfg))
        tst, tm = t_integrate.update_pool(tst, t_batch, t_cfg)
        for key in jm:
            assert int(tm[key]) == int(jm[key]), key
    _compare_states(jst, tst)
    assert (int(tst.touched_overflow) > 0) == (t_cap < 4096)


def test_pallas_backend_matches_jax_xla():
    """insert_step under accumulate_impl='pallas' (global sample sort + K5's
    plain version) against the JAX package's scatter backend."""
    pts = _sphere(2048, 1.0, 0)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, _cfg("xla"))
    js, jm = j_integrate.insert_step(
        j_create_state(_jax(_cfg("xla")), origin), jnp.asarray(pts),
        jnp.int32(2048), jnp.asarray(pos), _jax(_cfg("xla")))
    ts, tm = t_integrate.insert_step(create_state(_cfg("pallas"), origin,
                                                  "cpu"),
                                     _t(pts), 2048, _t(pos), _cfg("pallas"))
    _compare_states(js, ts)
    for key in jm:
        assert int(tm[key]) == int(jm[key]), key
    assert tm["host_reads"] == 0


@pytest.mark.parametrize("radius,expect_fallback", [
    (0.25, False),   # dense: every tile fits its block list
    (5.0, True),     # sparse: the fallback runs
])
def test_tile_backend_matches_jax_tile(radius, expect_fallback):
    """insert_step under accumulate_impl='tile' (plain DDA grids -> K4 -> K3
    -> fallback) against the JAX package's insert_step_tiled in interpret
    mode."""
    cfg = _cfg("tile")
    pts = _sphere(2048, radius, 1)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    js, jm = j_integrate.insert_step_tiled(
        j_create_state(_jax(cfg), origin), jnp.asarray(pts), jnp.int32(2048),
        jnp.asarray(pos), _jax(cfg), interpret=True)
    ts, tm = t_integrate.insert_step(create_state(cfg, origin, "cpu"),
                                     _t(pts), 2048, _t(pos), cfg)
    _compare_states(js, ts)
    assert (int(ts.tile_overflow) > 0) == expect_fallback
    for key in jm:
        assert int(tm[key]) == int(jm[key]), key
    assert tm["host_reads"] == 1


def test_fused_fallback_through_k5(monkeypatch):
    """The fused path's fallback on a sparse cloud with update_pool on the
    K5 route (as on CUDA) gives the map of its scatter route, which
    tests/test_torch_fused.py holds against the JAX package's fused
    insert."""
    cfg = _cfg("fused")
    pts = _sphere(2048, 5.0, 0)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    scatter, _ = t_integrate.insert_step(create_state(cfg, origin, "cpu"),
                                         _t(pts), 2048, _t(pos), cfg)
    calls = []
    plain = t_acc.accumulate_segments_plain

    def counting(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(t_integrate, "_use_segment_kernel",
                        lambda config, device: True)
    monkeypatch.setattr(t_acc, "accumulate_segments_plain", counting)
    ts, _ = t_integrate.insert_step(create_state(cfg, origin, "cpu"),
                                    _t(pts), 2048, _t(pos), cfg)
    assert calls and int(ts.tile_overflow) > 0
    assert torch.equal(ts.dir_keys, scatter.dir_keys)
    assert torch.equal(ts.dir_slots, scatter.dir_slots)
    assert torch.equal(ts.pool_w, scatter.pool_w)
    err = (ts.pool_sd - scatter.pool_sd).abs() / scatter.pool_w.clamp(min=1)
    assert float(err.max()) < 1e-4
    for name in ("n_blocks", "block_overflow", "touched_overflow",
                 "tile_overflow"):
        assert int(getattr(ts, name)) == int(getattr(scatter, name)), name


@pytest.mark.parametrize("impl", ["pallas", "tile"])
def test_map_accepts_ported_backends(impl):
    """TSDFMap takes the newly ported backends; its voxels match the
    scatter backend's."""
    pts = _sphere(4096, 1.0, 3)
    pos = np.asarray([0.05, -0.02, 0.01], np.float32)
    maps = {}
    for name in (impl, "xla"):
        m = TSDFMap(config=MapConfig(max_points=4096, block_capacity=4096,
                                     touched_capacity=4096,
                                     accumulate_impl=name), device="cpu")
        m.insert(pts, pos)
        maps[name] = m.voxel_samples()
    np.testing.assert_array_equal(maps[impl][0], maps["xla"][0])
    assert np.abs(maps[impl][1] - maps["xla"][1]).max() <= 0.1 / 127 + 1e-7
