"""Parity of the port's tile kernels' plain versions with the JAX package:
K4 (``tile_partials``) against ``tile_partials(interpret=True)`` — block
lists, overflow masks and weights exact, sd sums within 1e-4 (the port
sums on the 16-bit SD_QUANT grid) — and K3 + ``plan_merge`` against the
JAX ``update_pool_tiled`` — directory exact, weights exact."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu.ops import tile_accum as j_tile
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.core.state import create_state as t_create_state
from chad_tsdf_tpu_torch.core.state import origin_blocks_for_position
from chad_tsdf_tpu_torch.ops import tile_accum as t_tile

INT32_MAX = 2**31 - 1
TILE = t_tile.TILE


def _t(a):
    return torch.from_numpy(np.array(a))


def _grids(k, n, distinct, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    t = n // TILE
    base = np.repeat(rng.integers(0, 1 << 20, (t,)), TILE)
    bkey = (base[None, :] + rng.integers(0, distinct, (k, n))).astype(
        np.int32)
    bkey[rng.uniform(size=(k, n)) < invalid] = INT32_MAX
    okey = rng.integers(0, 512, (k, n)).astype(np.int32)
    sd = rng.uniform(-0.1, 0.1, (k, n)).astype(np.float32)
    return bkey, okey, sd


@pytest.mark.parametrize("k,distinct,nb", [
    (4, 6, 16),      # every tile fits its list
    (10, 40, 16),    # lists overflow: ovfmask marks the rest
    (3, 1, 8),       # one block per tile
])
def test_k4_plain_matches_jax(k, distinct, nb):
    bkey, okey, sd = _grids(k, 2 * TILE, distinct, k + distinct)
    j = j_tile.tile_partials(jnp.asarray(bkey), jnp.asarray(okey),
                             jnp.asarray(sd), nb=nb, interpret=True)
    t = t_tile.tile_partials(_t(bkey), _t(okey), _t(sd), nb, 0.1)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0,
                               atol=1e-4)
    assert (int(t[3].sum()) > 0) == (distinct > nb)


def test_k4_overflow_keeps_smallest_keys():
    n, nb = TILE, 8
    bkey = np.arange(n, dtype=np.int32)[::-1].copy().reshape(1, n)
    okey = np.zeros((1, n), np.int32)
    sd = np.full((1, n), 0.05, np.float32)
    pk, psd, pw, ovf = t_tile.tile_partials(_t(bkey), _t(okey), _t(sd), nb,
                                            0.1)
    assert int(ovf.sum()) == n - nb
    np.testing.assert_array_equal(pk.numpy().ravel(), np.arange(nb))
    np.testing.assert_array_equal(pw.numpy()[:, 0], np.ones(nb))
    np.testing.assert_allclose(psd.numpy()[:, 0], 0.05, atol=2e-6)


def test_plan_merge_matches_jax():
    rng = np.random.default_rng(5)
    cb, p = 4096, 3000
    slots = np.sort(rng.integers(0, cb - 8, p)).astype(np.int32)
    slots[-200:] = cb - 1                    # dead rows: reserved slot
    n_live = p - 200
    j = j_tile.plan_merge(jnp.asarray(slots), jnp.int32(n_live), cb, 512)
    t = t_tile.plan_merge(_t(slots), torch.tensor(n_live, dtype=torch.int32),
                          cb, 512)
    for a, b in zip(j[:4], t[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]).ravel())


def _sphere(n, r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


@pytest.mark.parametrize("r", [0.25, 1.0])
def test_update_pool_tiled_matches_jax(r):
    """The same partial rows merged by the JAX package's update_pool_tiled
    (row scatter on the CPU) and by the port's (plan_merge + K3's plain
    version), twice, so the second merge adds onto live rows."""
    cfg = MapConfig(max_points=2048, block_capacity=4096,
                    touched_capacity=4096, accumulate_impl="tile")
    jcfg = JaxMapConfig(**dataclasses.asdict(cfg))
    pts = _sphere(2048, r, 3)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    jst = j_create_state(jcfg, origin)
    pj = jnp.asarray(pts)
    bkey, okey, _ = j_integrate.point_keys(pj, jnp.int32(2048),
                                           jst.origin_blocks, jcfg)
    spts, sb, so = j_integrate.sort_points(pj, bkey, okey)
    s_bkey, s_okey, sd, n_valid, _ = j_integrate.compute_sample_grids(
        spts, sb, so, jnp.asarray(pos), jst.origin_blocks, jcfg)
    pk, psd, pw, _ = j_tile.tile_partials(s_bkey, s_okey, sd, nb=48,
                                          interpret=True)
    tst = t_create_state(cfg, origin, "cpu")
    zero = jnp.int32(0)
    for _ in range(2):
        jst, jm = j_integrate.update_pool_tiled(
            jst, pk, psd, pw, zero, n_valid, zero, zero, jcfg,
            interpret=True)
        tst, tm = t_integrate.update_pool_tiled(
            tst, _t(pk), _t(psd), _t(pw), torch.tensor(0, dtype=torch.int32),
            int(n_valid), 0, 0, cfg)
        for key in ("n_touched_blocks", "n_new_blocks", "n_blocks"):
            assert int(tm[key]) == int(jm[key]), key
    np.testing.assert_array_equal(tst.dir_keys.numpy(),
                                  np.asarray(jst.dir_keys))
    nbk = int(jst.n_blocks)
    np.testing.assert_array_equal(tst.dir_slots.numpy()[:nbk],
                                  np.asarray(jst.dir_slots)[:nbk])
    np.testing.assert_array_equal(tst.pool_w.numpy(), np.asarray(jst.pool_w))
    np.testing.assert_allclose(tst.pool_sd.numpy(), np.asarray(jst.pool_sd),
                               rtol=0, atol=1e-5)
