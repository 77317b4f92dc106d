"""K4 on a block-sorted sample stream (``tile_accum.tile_partials_sorted``,
the ``sample_tile`` insert's K4) on the CPU, against the JAX package.

* Its plain version against the JAX package's ``tile_partials`` in
  interpret mode on the unpacked payloads, at nb 8, 128 and 256 (one
  module fixture runs the JAX kernel once per nb): block lists and overflow
  masks equal, weights exact, sd within 1e-4 per weight
  (tests/test_fused.py:58-59).
* Its plain version bit-equal to the general K4's plain version on the
  unpacked stream, over run lengths, tile counts, invalid tails and nb
  (hypothesis).
* The payload word carries the general K4's quantized sd: quantizing the
  unpacked sd gives back the word's q for every q the grid holds.
* A tile whose valid keys descend is refused.
* ``sample_tiled_update`` at ``sparse_tile_nb`` 4,096 (no list can
  overflow: a tile holds at most 1024 runs) against the JAX package's sort
  path on its own sorted batch, which is what its sample-tiled insert
  computes when no list overflows (its Pallas K4 at nb 4,096 unrolls 8,192
  rounds a tile and is not run in interpret mode here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu.ops import tile_accum as j_tile
from chad_tsdf_tpu_torch import MapConfig
from chad_tsdf_tpu_torch.core import integrate
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.ops import tile_accum
from chad_tsdf_tpu_torch.scripts import kitti_stream
from tests.test_torch_fused import compare

INT32_MAX = 2**31 - 1
TILE = tile_accum.TILE
TRUNC = 0.1
POS = np.zeros(3, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(rng, s):
    """Random payload words: offsets in [0, 512), q over the whole grid."""
    okey = rng.integers(0, 512, s).astype(np.int32)
    q = rng.integers(-32767, 32768, s).astype(np.int32)
    return (okey << 16) | (q & 0xFFFF)


def _runs(rng, n, lo, hi, start):
    """Ascending keys from ``start`` in runs of lo..hi samples, n of them."""
    lens = rng.integers(lo, hi + 1, n)
    keys = start + np.cumsum(rng.integers(1, 50, lens.shape[0]))
    return np.repeat(keys, lens)[:n]


def _stream():
    """Five tiles of one ascending stream: runs of 1-12 samples (~160 blocks:
    over nb 8 and 128), runs of 1-3 (~500: over 256), one block, a valid
    head then invalid samples, and an all-invalid tile."""
    rng = np.random.default_rng(16)
    t0 = _runs(rng, TILE, 1, 12, 0)
    t1 = _runs(rng, TILE, 1, 3, int(t0[-1]))
    t2 = np.full(TILE, t1[-1] + 7)
    t3 = np.full(TILE, INT32_MAX)
    t3[:300] = _runs(rng, 300, 1, 12, int(t2[-1]))
    t4 = np.full(TILE, INT32_MAX)
    bkey = np.concatenate([t0, t1, t2, t3, t4]).astype(np.int32)
    return bkey, _payload(rng, bkey.shape[0])


NBS = (8, 128, 256)


@pytest.fixture(scope="module")
def jax_sorted():
    """The JAX package's K4 on the unpacked stream, once per nb."""
    bkey, payload = _stream()
    okey, sd = j_integrate.unpack_payload(jnp.asarray(payload), TRUNC)
    return bkey, payload, {
        nb: j_tile.tile_partials(jnp.asarray(bkey)[None], okey[None],
                                 sd[None], nb=nb, interpret=True)
        for nb in NBS}


@pytest.mark.parametrize("nb", NBS)
def test_sorted_plain_matches_jax(nb, jax_sorted):
    bkey, payload, ref = jax_sorted
    j = ref[nb]
    t = tile_accum.tile_partials_sorted(torch.from_numpy(bkey),
                                        torch.from_numpy(payload), nb, TRUNC)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    w = np.asarray(j[2])
    np.testing.assert_array_equal(t[2].numpy(), w)
    err = np.abs(t[1].numpy() - np.asarray(j[1])) / np.maximum(w, 1)
    assert err.max() < 1e-4, err.max()
    assert int(t[4][0]) == 0
    # a tile overflows where it holds more than nb runs
    tiles = bkey.reshape(-1, TILE)
    runs = np.array([np.unique(x[x != INT32_MAX]).shape[0] for x in tiles])
    assert runs[1] > 256 and 128 < runs[0] < 256 and runs[2] == 1
    per_tile = t[3].reshape(-1, TILE).sum(1).numpy()
    np.testing.assert_array_equal(per_tile > 0, runs > nb)


def _general(bkey, payload, nb):
    """The general K4's plain version on the unpacked stream."""
    okey, sd = integrate.unpack_payload(payload, TRUNC)
    return tile_accum.tile_partials_plain(bkey[None], okey[None], sd[None],
                                          nb, TRUNC)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), tiles=st.integers(1, 3),
       lo=st.integers(1, 12), span=st.integers(0, 40),
       invalid=st.integers(0, 3 * TILE),
       nb=st.sampled_from([1, 3, 8, 64, 128, 200, 1100]))
def test_sorted_plain_equals_general_plain(seed, tiles, lo, span, invalid,
                                           nb):
    rng = np.random.default_rng(seed)
    s = tiles * TILE
    bkey = _runs(rng, s, lo, lo + span, 0).astype(np.int32)
    bkey[s - min(invalid, s):] = INT32_MAX
    bkey_t = torch.from_numpy(bkey)
    payload = torch.from_numpy(_payload(rng, s))
    got = tile_accum.tile_partials_sorted(bkey_t, payload, nb, TRUNC)
    want = _general(bkey_t, payload, nb)
    for a, b in zip(got[:4], want):
        assert torch.equal(a, b)
    assert int(got[4][0]) == 0


@pytest.mark.parametrize("trunc", sorted({TRUNC, 0.05, 0.3,
                                          kitti_stream.stream_config()
                                          .sdf_trunc}))
def test_unpacked_sd_quantizes_back_to_the_word(trunc):
    """quantize_sd(unpack_payload(word)) == q for every q in
    [-32767, 32767]: the general K4 re-quantizes the unpacked sd to the
    word's q, which is why the sorted kernel may take the word itself."""
    q = torch.arange(-32767, 32768, dtype=torch.int32)
    okey = torch.arange(q.shape[0], dtype=torch.int32) % 512
    payload = (okey << 16) | (q & 0xFFFF)
    ok, sd = integrate.unpack_payload(payload, trunc)
    assert torch.equal(ok, okey)
    assert torch.equal(tile_accum.quantize_sd(sd, trunc), q)
    assert torch.equal(integrate.pack_payload(ok, sd, trunc), payload)


@pytest.mark.parametrize("where", ["descent", "valid after invalid"])
def test_sorted_plain_refuses_unsorted_tiles(where):
    bkey = np.arange(2 * TILE, dtype=np.int32) // 4
    if where == "descent":
        bkey[TILE + 500], bkey[TILE + 501] = bkey[TILE + 501] + 1, 0
    else:
        bkey[700:TILE - 1] = INT32_MAX
    payload = torch.zeros(2 * TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="not ascending"):
        tile_accum.tile_partials_sorted(torch.from_numpy(bkey), payload, 8,
                                        TRUNC)
    # each tile is checked on its own: a tile may start below the last
    ok = np.concatenate([np.arange(TILE), np.arange(TILE)]).astype(np.int32)
    out = tile_accum.tile_partials_sorted(torch.from_numpy(ok), payload, 8,
                                          TRUNC)
    assert int(out[3].sum()) == 2 * (TILE - 8)


def test_sample_tiled_update_nb4096_matches_jax():
    """A list of 4,096 blocks over a sparse sphere's sorted samples: no
    tile overflows, and the state equals the JAX package's sort path on
    its own sorted batch (directory keys, weights exact, sd within 1e-4 per
    weight)."""
    cfg = MapConfig(max_points=1024, block_capacity=8192,
                    touched_capacity=8192, accumulate_impl="sample_tile",
                    max_steps=4, sparse_tile_nb=4096)
    jcfg = JaxMapConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(1024, 3))
    pts = (d / np.linalg.norm(d, axis=1, keepdims=True) * 5.0).astype(
        np.float32)
    origin = origin_blocks_for_position(POS, cfg)
    batch = j_integrate.sort_samples(j_integrate.compute_samples(
        jnp.asarray(pts), jnp.int32(1024), jnp.asarray(POS),
        jnp.asarray(origin), jcfg))
    js, jm = j_integrate.update_pool(j_create_state(jcfg, origin), batch,
                                     jcfg)
    tb = integrate.SampleBatch(*(torch.from_numpy(np.array(a))
                                 for a in batch))
    assert tb.bkey.shape[0] == 4 * TILE
    ts, tm, tile_ovf, make_fallback = integrate.sample_tiled_update(
        create_state(cfg, origin, "cpu"), tb, cfg)
    assert int(tile_ovf) == 0
    ts = integrate.settle(integrate.FallbackTail(tile_ovf, make_fallback,
                                                 cfg), ts, tm)
    compare(js, ts)
    assert int(ts.tile_overflow) == 0
    for key in ("n_valid_samples", "n_new_blocks", "n_blocks"):
        assert int(tm[key]) == int(jm[key]), key
    assert int(tm["n_blocks"]) > 0
