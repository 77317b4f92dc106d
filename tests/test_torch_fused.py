"""The port's fused insert (K2 -> K1 -> K3, fallback through K4) on the CPU,
through the kernels' plain versions, against the JAX package's
``insert_step_fused(interpret=True)``: directory keys equal, weights
exact, signed-distance sums within 1e-4 per unit weight (the gate of
tests/test_fused.py), for a dense cloud and a sparse one that falls back.
Plus determinism, incremental inserts, and a state carried from the JAX
package into the port."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.utils import timing
from chad_tsdf_tpu_torch.core.state import (ActiveMapState, create_state,
                                            origin_blocks_for_position,
                                            state_from_numpy, state_to_numpy)


def _sphere(n, r=5.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _cfg(n, impl="fused", cap=8192):
    return MapConfig(max_points=n, block_capacity=cap, touched_capacity=cap,
                     accumulate_impl=impl)


def _jax(cfg):
    """The JAX package's MapConfig with the port's config's fields."""
    return JaxMapConfig(**dataclasses.asdict(cfg))


def _port_insert(state, pts, pos, cfg):
    return t_integrate.insert_step(state, torch.from_numpy(pts),
                                   pts.shape[0], torch.from_numpy(pos), cfg)


def compare(j_state, t_state):
    """The equality structure of tools/tpu_kernel_equality.py compare():
    directory keys equal, weights exact, sd within 1e-4 per weight."""
    np.testing.assert_array_equal(t_state.dir_keys.numpy(),
                                  np.asarray(j_state.dir_keys))
    nbk = int(j_state.n_blocks)
    assert int(t_state.n_blocks) == nbk
    sl_j = np.asarray(j_state.dir_slots)[:nbk]
    sl_t = t_state.dir_slots.numpy()[:nbk]
    wj = np.asarray(j_state.pool_w)[sl_j]
    np.testing.assert_array_equal(t_state.pool_w.numpy()[sl_t], wj)
    err = np.abs(t_state.pool_sd.numpy()[sl_t] -
                 np.asarray(j_state.pool_sd)[sl_j]) / np.maximum(wj, 1)
    assert err.max() < 1e-4, err.max()
    for name in ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow"):
        assert int(getattr(t_state, name)) == int(getattr(j_state, name))


@pytest.mark.parametrize("radius,expect_fallback", [
    (0.25, False),   # dense: every tile fits its block list
    (5.0, True),     # sparse: ~1 block per point, the fallback runs
])
def test_fused_insert_matches_jax(radius, expect_fallback):
    cfg = _cfg(2048)
    pts = _sphere(2048, r=radius, seed=0)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    js, jm = j_integrate.insert_step_fused(
        j_create_state(_jax(cfg), origin), jnp.asarray(pts), jnp.int32(2048),
        jnp.asarray(pos), _jax(cfg), interpret=True)
    state = create_state(cfg, origin, "cpu")
    syncs = timing.COUNTS["host_syncs"]
    ts, tm = _port_insert(state, pts, pos, cfg)
    # insert_step's one host wait: its immediate settle
    assert timing.COUNTS["host_syncs"] - syncs == 1
    compare(js, ts)
    assert int(ts.tile_overflow) == int(js.tile_overflow)
    assert (int(ts.tile_overflow) > 0) == expect_fallback
    for key in ("n_valid_samples", "n_touched_blocks", "n_new_blocks",
                "n_blocks"):
        assert int(tm[key]) == int(jm[key]), key


@pytest.mark.parametrize("radius", [0.25, 5.0])
def test_fused_matches_scatter_backend(radius):
    """Within the port: fused and scatter backends agree (weights exact)."""
    pts = _sphere(2048, r=radius, seed=4)
    pos = np.asarray([0.3, -0.1, 0.2], np.float32)
    origin = origin_blocks_for_position(pos, _cfg(2048))
    states = {}
    for impl in ("fused", "xla"):
        cfg = _cfg(2048, impl)
        states[impl], _ = _port_insert(create_state(cfg, origin, "cpu"),
                                       pts, pos, cfg)
    f, x = states["fused"], states["xla"]
    assert torch.equal(f.dir_keys, x.dir_keys)
    nbk = int(x.n_blocks)
    sf, sx = f.dir_slots[:nbk].long(), x.dir_slots[:nbk].long()
    assert torch.equal(f.pool_w[sf], x.pool_w[sx])
    err = (f.pool_sd[sf] - x.pool_sd[sx]).abs() / x.pool_w[sx].clamp(min=1)
    assert float(err.max()) < 1e-4


def test_fused_incremental_and_determinism():
    cfg = _cfg(1024, cap=2048)
    pts = _sphere(1024, seed=3)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    s1, _ = _port_insert(create_state(cfg, origin, "cpu"), pts, pos, cfg)
    s2, _ = _port_insert(create_state(cfg, origin, "cpu"), pts, pos, cfg)
    assert torch.equal(s1.pool_sd, s2.pool_sd)
    assert torch.equal(s1.pool_w, s2.pool_w)
    w1 = s1.pool_w.clone()
    s3, _ = _port_insert(s1, pts, pos, cfg)      # consumes s1 (in place)
    assert torch.equal(s3.pool_w, 2 * w1)
    assert torch.equal(s3.dir_keys, s2.dir_keys)


def test_carry_across_from_jax():
    """The JAX package inserts cloud A; its state is handed to the port as
    numpy arrays; both packages insert cloud B on top; the maps match."""
    cfg = _cfg(2048, impl="xla")
    pos = np.asarray([0.2, 0.1, -0.3], np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    a = _sphere(2048, r=1.0, seed=10)
    b = _sphere(2048, r=1.3, seed=11)
    js, _ = j_integrate.insert_step(j_create_state(_jax(cfg), origin),
                                    jnp.asarray(a), jnp.int32(2048),
                                    jnp.asarray(pos), _jax(cfg))
    fields = {f: np.asarray(getattr(js, f)) for f in
              ActiveMapState.__dataclass_fields__}
    ts = state_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(state_to_numpy(ts)["pool_w"],
                                  fields["pool_w"])
    js, _ = j_integrate.insert_step(js, jnp.asarray(b), jnp.int32(2048),
                                    jnp.asarray(pos), _jax(cfg))
    cfg_f = _cfg(2048, impl="fused")
    ts, _ = _port_insert(ts, b, pos, cfg_f)
    compare(js, ts)


def test_state_from_numpy_rejects_bad_fields():
    st = state_to_numpy(create_state(_cfg(1024, cap=64), device="cpu"))
    with pytest.raises(KeyError):
        state_from_numpy({k: v for k, v in st.items() if k != "pool_w"},
                         device="cpu")
    st["pool_sd"] = st["pool_sd"].astype(np.float64)
    with pytest.raises(TypeError):
        state_from_numpy(st, device="cpu")
