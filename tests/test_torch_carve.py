"""The port's space carving (``chad_tsdf_tpu_torch/core/carve.py``) on the
CPU, against the JAX package's ``core/carve.py`` (compiled) and the numpy
oracle of tests/test_carve.py, copied here: sample keys and pool deltas
exact on axis-aligned rays (where every f32 intermediate is exact, so
XLA's contracted multiply-adds cannot move a sample), erosion only, the
scan's own band spared, packed ingest equal to float ingest,
determinism, a stale wall eroded from the mesh, integer counters, and
the carve inside ``TSDFMap.insert`` under the ``xla``, ``seg``,
``pallas`` and ``fused`` backends; and the sharded carve
(``parallel/sharded.py`` ``make_sharded_carve``): one shard equal to the
single-device map bit for bit, a stale wall eroded on 8 shards, and a block
held by its owner and a shard that deferred it, which the JAX package
carves twice and the port once, as the single-device carve of the merged
map does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import carve as j_carve
from chad_tsdf_tpu.core import state as j_state
from chad_tsdf_tpu.parallel import sharded as j_sh
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import carve, integrate
from chad_tsdf_tpu_torch.core.state import (INT32_MAX, create_state,
                                            origin_blocks_for_position,
                                            state_from_numpy, state_to_numpy)
from chad_tsdf_tpu_torch.ops import morton
from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh, sharded

CFG = MapConfig(max_points=4096, block_capacity=4096, touched_capacity=1024,
                block_bits=7, accumulate_impl="xla", normals_impl="xla",
                carve_steps=40, carve_stride=2.0, carve_subsample=1,
                carve_weight=1.0)

AXES = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                 [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
POS = np.zeros(3, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cfg):
    return JaxMapConfig(**dataclasses.asdict(cfg))


def _pad(points, n_max):
    out = np.zeros((n_max, 3), np.float32)
    out[:len(points)] = points
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wall(x, n=400, half=0.5, seed=0):
    """n points on the plane X=x, spread over [-half, half]^2 in (y, z)."""
    rng = np.random.default_rng(seed)
    yz = rng.uniform(-half, half, (n, 2))
    return np.column_stack([np.full(n, x, np.float32),
                            yz[:, 0], yz[:, 1]]).astype(np.float32)


def _carve_oracle_counts(points, position, config, origin_blocks):
    """Per-voxel free-space sample counts from the definition (f32
    arithmetic), as in tests/test_carve.py."""
    counts = {}
    extent = config.blocks_per_axis * 8
    ov = np.asarray(origin_blocks, np.int64) * 8
    pos = np.asarray(position, np.float32)
    inv = np.float32(1.0 / config.sdf_res)
    step_m = np.float32(config.carve_stride * config.sdf_res)
    trunc = np.float32(config.sdf_trunc)
    for p in np.asarray(points, np.float32)[::config.carve_subsample]:
        d = p - pos
        r = np.float32(np.sqrt(np.float32(
            d[0] * d[0] + d[1] * d[1] + d[2] * d[2])))
        u = d / max(r, np.float32(1e-12))
        for i in range(config.carve_steps):
            t = np.float32(np.float32(i + 0.5) * step_m)
            if not t < r - trunc:
                continue
            q = pos + u * t
            lv = np.floor(q * inv).astype(np.int64) - ov
            if np.any(lv < 0) or np.any(lv >= extent):
                continue
            counts[tuple(lv)] = counts.get(tuple(lv), 0) + 1
    return counts


def _jax_state(state):
    return j_state.ActiveMapState(
        **{k: jnp.asarray(v) for k, v in state_to_numpy(state).items()})


def _ladder_state():
    """Scan A allocates corridor blocks: returns laddered along each axis
    (the port's scatter insert on the CPU)."""
    ladder = np.concatenate([AXES * k for k in
                             np.arange(0.4, 2.81, 0.2, dtype=np.float32)])
    state = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    state, _ = integrate.insert_step(state, _t(_pad(ladder, CFG.max_points)),
                                     len(ladder), _t(POS), CFG)
    return state


@pytest.fixture(scope="module")
def axis_case():
    """One carve of six 3 m axis rays into the ladder map, by the port and
    by the compiled JAX carve from the same state: (state before as numpy,
    port state after, port metrics, JAX state after, JAX metrics)."""
    before = state_to_numpy(_ladder_state())
    rays = _pad(AXES * np.float32(3.0), CFG.max_points)
    ts, tm = carve.carve_step(state_from_numpy(before, "cpu"), _t(rays), 6,
                              _t(POS), CFG)
    js, jm = j_carve.carve_step(_jax_state(state_from_numpy(before, "cpu")),
                                jnp.asarray(rays), np.int32(6),
                                jnp.asarray(POS), _jax(CFG))
    return before, ts, tm, js, jm


def test_carve_keys_match_jax_on_axis_rays():
    rays = _pad(AXES * np.float32(3.0), CFG.max_points)
    origin = origin_blocks_for_position(POS, CFG)
    tb, to = carve.carve_sample_keys(
        *_t(rays).unbind(1), 6, _t(POS), _t(origin), CFG)
    keys = jax.jit(j_carve.carve_sample_keys, static_argnames=("config",))
    jb, jo = keys(*jnp.asarray(rays).T, np.int32(6), jnp.asarray(POS),
                  jnp.asarray(origin), config=_jax(CFG))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (tb != INT32_MAX).sum() > 0


def test_carve_matches_oracle_jax_and_never_allocates(axis_case):
    """Axis-aligned rays: the pool deltas equal the oracle's per-voxel
    counts and the JAX carve's pools exactly; only allocated blocks are
    touched and nothing is allocated."""
    before, ts, tm, js, jm = axis_case
    for f in ("dir_keys", "dir_slots", "n_blocks", "block_overflow"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), before[f])
    np.testing.assert_array_equal(ts.pool_sd.numpy(), np.asarray(js.pool_sd))
    np.testing.assert_array_equal(ts.pool_w.numpy(), np.asarray(js.pool_w))
    for k in jm:
        assert int(tm[k]) == int(jm[k]), k

    live = before["dir_keys"] != INT32_MAX
    key_to_slot = dict(zip(before["dir_keys"][live].tolist(),
                           before["dir_slots"][live].tolist()))
    oracle = _carve_oracle_counts(AXES * np.float32(3.0), POS, CFG,
                                  before["origin_blocks"])
    sd1, w1 = ts.pool_sd.numpy(), ts.pool_w.numpy()
    d_w = w1 - before["pool_w"]
    total = 0
    for (lx, ly, lz), c in oracle.items():
        bkey = int(morton.encode_block(torch.tensor(lx >> 3),
                                       torch.tensor(ly >> 3),
                                       torch.tensor(lz >> 3)))
        okey = int(morton.encode_offset(torch.tensor(lx & 7),
                                        torch.tensor(ly & 7),
                                        torch.tensor(lz & 7)))
        slot = key_to_slot.get(bkey)
        if slot is None:
            continue                      # unallocated: dropped by design
        total += c
        # one f32 add of count * (trunc * w_c) onto the band's sum
        assert w1[slot, okey] == before["pool_w"][slot, okey] + \
            np.float32(c) * np.float32(CFG.carve_weight)
        assert sd1[slot, okey] == before["pool_sd"][slot, okey] + \
            np.float32(c) * np.float32(CFG.sdf_trunc * CFG.carve_weight)
    assert total > 0
    assert d_w.sum() == total * CFG.carve_weight     # nothing else changed
    assert int(tm["n_carve_samples"]) == total
    assert int(tm["n_carve_dropped"]) == sum(oracle.values()) - total


def test_carve_empty_map_drops_everything():
    state = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    wall = _wall(2.0, seed=2)
    state, m = carve.carve_step(state, _t(_pad(wall, CFG.max_points)),
                                len(wall), _t(POS), CFG)
    assert int(state.n_blocks) == 0 and not state.pool_w.any()
    assert int(m["n_carve_samples"]) == 0 == int(m["n_carved_voxels"])
    assert int(m["n_carve_dropped"]) > 0


def test_carve_spares_own_truncation_band():
    """A ray's samples stop sdf_trunc short of its return: no carve mass
    lands beyond the band-start voxel of a frontal wall."""
    wall = _wall(2.0, seed=3)
    pts = _t(_pad(wall, CFG.max_points))
    state = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    state, _ = integrate.insert_step(state, pts, len(wall), _t(POS), CFG)
    w0 = state.pool_w.clone()
    state, _ = carve.carve_step(state, pts, len(wall), _t(POS), CFG)
    d_w = (state.pool_w - w0).numpy()
    ov = state.origin_blocks.numpy()
    keys, slots = state.dir_keys.numpy(), state.dir_slots.numpy()
    live = keys != INT32_MAX
    # the stop rule runs along the ray: the longest (most oblique) ray
    # bounds a sample's x by 2 - 2 * trunc / r_max
    r_max = np.sqrt(2.0 ** 2 + 2 * 0.5 ** 2)
    x_band = int(np.floor((2.0 - 2.0 * CFG.sdf_trunc / r_max) / CFG.sdf_res))
    carved = 0
    for bkey, slot in zip(keys[live], slots[live]):
        bx = int(morton.compact3_10(torch.tensor(int(bkey))))
        for okey in np.flatnonzero(d_w[slot] != 0):
            vx = bx * 8 + int(morton.compact3_3(torch.tensor(int(okey)))) + \
                int(ov[0]) * 8
            carved += 1
            assert vx <= x_band, f"carve mass beyond the band at x={vx}"
    assert carved > 0


def test_carve_erodes_stale_wall_from_mesh():
    """A mapped wall disappears and later scans see through it: with
    carving its zero crossing and its mesh are gone while the far wall
    stays; without carving the residue persists."""
    cfg = dataclasses.replace(CFG, carve_steps=96, carve_stride=1.0)
    near = {}
    for steps in (96, 0):
        m = TSDFMap(config=dataclasses.replace(cfg, carve_steps=steps),
                    device="cpu")
        m.insert(_wall(2.0, n=800, seed=1), POS)
        if steps:
            assert np.sum(np.abs(m.extract_mesh().vertices[:, 0] - 2.0)
                          < 0.15) > 0
        for i in range(16):
            m.insert(_wall(4.0, n=800, half=1.2, seed=10 + i), POS)
        v = m.extract_mesh().vertices
        near[steps] = (int(np.sum(np.abs(v[:, 0] - 2.0) < 0.15)),
                       int(np.sum(np.abs(v[:, 0] - 4.0) < 0.15)))
    assert near[96][0] == 0 and near[96][1] > 0, near
    assert near[0][0] > 0, near


def test_carve_packed_matches_float():
    """Packed ingest carves the same decoded cloud: points on the packing
    grid round-trip, so the pools are bit-equal."""
    grid_pts = AXES * np.float32(2.5)
    pools = []
    for packed in (False, True):
        m = TSDFMap(config=dataclasses.replace(CFG, packed_ingest=packed),
                    device="cpu")
        m.insert(grid_pts, POS)
        pools.append((m.state.pool_sd.clone(), m.state.pool_w.clone()))
        assert m.last_metrics["n_carve_samples"] > 0
    assert torch.equal(pools[0][0], pools[1][0])
    assert torch.equal(pools[0][1], pools[1][1])
    q = integrate.pack_points(grid_pts, POS, CFG.sdf_res)
    st = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    _, mp = carve.carve_step_packed(st, _t(q), len(q), _t(POS), CFG)
    st = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
    _, mf = carve.carve_step(st, _t(grid_pts), len(q), _t(POS), CFG)
    assert {k: int(v) for k, v in mp.items()} == \
        {k: int(v) for k, v in mf.items()}


def test_carve_deterministic():
    wall = _wall(3.0, seed=7)
    pts = _t(_pad(wall, CFG.max_points))
    pools = []
    for _ in range(2):
        st = create_state(CFG, origin_blocks_for_position(POS, CFG), "cpu")
        st, _ = integrate.insert_step(st, pts, len(wall), _t(POS), CFG)
        st, _ = carve.carve_step(st, pts, len(wall), _t(POS), CFG)
        pools.append((st.pool_sd, st.pool_w))
    assert torch.equal(pools[0][0], pools[1][0])
    assert torch.equal(pools[0][1], pools[1][1])


def test_carve_validation():
    assert MapConfig().carve_steps == 0
    with pytest.raises(ValueError):
        MapConfig(carve_steps=8, carve_weight=0.0)
    with pytest.raises(ValueError):
        MapConfig(carve_steps=-1)


def test_carve_counters_are_integers(axis_case):
    """int32 counters that add up: hits + drops = valid samples, and
    every carved voxel got at least one sample (the JAX package sums them
    in f32)."""
    _, _, tm, _, _ = axis_case
    for k in ("n_carve_samples", "n_carved_voxels", "n_carve_dropped"):
        assert tm[k].dtype == torch.int32, k
    keys, _ = carve.carve_sample_keys(
        *_t(_pad(AXES * np.float32(3.0), CFG.max_points)).unbind(1), 6,
        _t(POS), _t(origin_blocks_for_position(POS, CFG)), CFG)
    n_valid = int((keys != INT32_MAX).sum())
    assert int(tm["n_carve_samples"]) + int(tm["n_carve_dropped"]) == n_valid
    assert 0 < int(tm["n_carved_voxels"]) <= int(tm["n_carve_samples"])


@pytest.mark.parametrize("impl", ["xla", "seg", "pallas", "fused"])
def test_carve_inside_insert(impl):
    """``TSDFMap.insert`` with carving equals the insert followed by the
    carve (``carve_step`` with the map's config, not the dispatched one),
    bit for bit, under each backend; the fused map's deferred carve runs
    after its fallback; every backend's map agrees with the scatter
    backend's (weights exact, sd within 1e-4 per weight)."""
    cfg = dataclasses.replace(CFG, max_points=1024, accumulate_impl=impl,
                              tile_nb=8)
    scans = [(_wall(2.0, n=900, seed=20), POS),
             (_wall(2.6, n=900, half=0.8, seed=21), POS)]
    m = TSDFMap(config=cfg, device="cpu")
    st = create_state(cfg, origin_blocks_for_position(POS, cfg), "cpu")
    for pts, pos in scans:
        met = m.insert(pts, pos)
        pad = _t(_pad(pts, 1024))
        st, _ = integrate.insert_step(st, pad, len(pts), _t(pos), cfg)
        st, cm = carve.carve_step(st, pad, len(pts), _t(pos), cfg)
        for k in cm:
            assert met[k] == int(cm[k]), k
    for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w"):
        assert torch.equal(getattr(m.state, f), getattr(st, f)), f
    assert met["n_carve_samples"] > 0
    if impl == "fused":
        assert int(m.state.tile_overflow) > 0     # the fallback ran
    ref = TSDFMap(config=dataclasses.replace(cfg, accumulate_impl="xla"),
                  device="cpu")
    for pts, pos in scans:
        ref.insert(pts, pos)
    a, b = m.state, ref.state
    assert torch.equal(a.dir_keys, b.dir_keys)
    nb = int(b.n_blocks)
    sa, sb = a.dir_slots[:nb].long(), b.dir_slots[:nb].long()
    assert torch.equal(a.pool_w[sa], b.pool_w[sb])
    err = (a.pool_sd[sa] - b.pool_sd[sb]).abs() / b.pool_w[sb].clamp(min=1)
    assert float(err.max()) < 1e-4


def test_carve_map_matches_jax_map():
    """The JAX ``TSDFMap`` with carving and the port's, on the ladder then
    the axis rays (the scatter backend in both): directory keys equal,
    weights exact, sd within 1e-4 per weight, equal carve counters."""
    ladder = np.concatenate([AXES * k for k in
                             np.arange(0.4, 2.81, 0.2, dtype=np.float32)])
    rays = AXES * np.float32(3.0)
    jm = JaxTSDFMap(config=_jax(CFG))
    tm = TSDFMap(config=CFG, device="cpu")
    for pts in (ladder, rays):
        jmet = jm.insert(pts, POS)
        tmet = tm.insert(pts, POS)
    for k in ("n_carve_samples", "n_carved_voxels", "n_carve_dropped"):
        assert tmet[k] == int(jmet[k]), k
    js, ts = jm.state, tm.state
    np.testing.assert_array_equal(ts.dir_keys.numpy(),
                                  np.asarray(js.dir_keys))
    nb = int(js.n_blocks)
    sj = np.asarray(js.dir_slots)[:nb]
    st = ts.dir_slots.numpy()[:nb]
    wj = np.asarray(js.pool_w)[sj]
    np.testing.assert_array_equal(ts.pool_w.numpy()[st], wj)
    err = np.abs(ts.pool_sd.numpy()[st] - np.asarray(js.pool_sd)[sj]) / \
        np.maximum(wj, 1)
    assert err.max() < 1e-4


def test_sharded_carve_n1_matches_single_device_exactly():
    """At one shard the sharded carve runs the single-device carve on the
    same scan: pools bit-equal to TSDFMap with carving, same counters."""
    wall = _wall(2.5, n=600, seed=5)
    cfg = dataclasses.replace(CFG, max_points=1024)
    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(1, device="cpu"))
    ref = TSDFMap(config=cfg, device="cpu")
    for beg in range(0, len(wall), 1024):
        sm_met = smap.insert(wall[beg:beg + 1024], POS)
        ref_met = ref.insert(wall[beg:beg + 1024], POS)
    st = smap.state_stack[0]
    assert torch.equal(st.pool_sd, ref.state.pool_sd)
    assert torch.equal(st.pool_w, ref.state.pool_w)
    for k in ("n_carve_samples", "n_carve_dropped", "n_carved_voxels"):
        assert sm_met[k] == ref_met[k], k


def test_sharded_carve_erodes_stale_wall():
    """On 8 shards a stale wall is eroded as on one device: each sample
    is applied by the one shard responsible for its block."""
    cfg = dataclasses.replace(CFG, carve_steps=96, carve_stride=1.0,
                              max_points=1024)
    m = ShardedTSDFMap(config=cfg, mesh=make_mesh(8, device="cpu"))
    m.insert(_wall(2.0, n=800, seed=1), POS)
    assert np.sum(np.abs(m.extract_mesh().vertices[:, 0] - 2.0) < 0.15) > 0
    for i in range(16):
        met = m.insert(_wall(4.0, n=800, half=1.2, seed=10 + i), POS)
    assert met["n_carve_samples"] > 0 and met["n_carve_dropped"] >= 0
    v = m.extract_mesh().vertices
    assert np.sum(np.abs(v[:, 0] - 2.0) < 0.15) == 0
    assert np.sum(np.abs(v[:, 0] - 4.0) < 0.15) > 0


def test_sharded_carve_applies_deferred_rows_once():
    """A block held by its owner AND by a shard that deferred it (a tiny
    halo capacity): the JAX package's sharded carve applies its evidence
    on both, so its hit count exceeds the single-device carve's; the
    port's applies it once.  Against the single-device carve of the
    merged state the port's merged weights are exact, its sd within
    float reassociation, its counters equal and its dropped count >= 0."""
    cfg = MapConfig(max_points=512, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    ccfg = dataclasses.replace(cfg, carve_steps=64, carve_stride=1.0,
                               carve_subsample=1, carve_weight=1.0)
    rng = np.random.default_rng(9)
    pts = (np.float32([1.5, 1.5, 1.5]) +
           rng.uniform(-0.5, 0.5, size=(8 * 512, 3))).astype(np.float32)
    mesh = make_mesh(8, device="cpu")
    origin = origin_blocks_for_position(POS, cfg)
    padded = np.zeros((8 * 512, 3), np.float32)
    n_per = np.zeros(8, np.int32)
    for i, c in enumerate(np.array_split(pts, 8)):
        padded[i * 512:i * 512 + len(c)] = c
        n_per[i] = len(c)
    bounds = sharded.key_bounds(8, cfg)
    step, _ = sharded.make_sharded_insert(cfg, mesh, halo_capacity=8)
    stack, met, _ = step(sharded.create_sharded_state(cfg, mesh, origin),
                         padded, n_per, POS, bounds)
    assert int(met["route_overflow"]) > 0            # blocks held twice
    before = sharded.state_stack_to_numpy(stack)

    merged = sharded.merge_states_host(stack, cfg, device="cpu")
    single, s_met = carve.carve_step(merged, _t(pts), len(pts), _t(POS),
                                     ccfg)
    stack, t_met = sharded.make_sharded_carve(ccfg, mesh)(
        stack, pts, len(pts), POS, bounds)
    for k in ("n_carve_samples", "n_carve_dropped", "n_carved_voxels"):
        assert int(t_met[k]) == int(s_met[k]), k
    assert int(t_met["n_carve_dropped"]) >= 0
    got = sharded.merge_states_host(stack, cfg, device="cpu")
    assert torch.equal(got.dir_keys, single.dir_keys)
    nb = int(single.n_blocks)
    assert torch.equal(got.pool_w[:nb], single.pool_w[:nb])
    assert float((got.pool_sd[:nb] - single.pool_sd[:nb]).abs().max()) \
        < 1e-4

    from jax.sharding import NamedSharding, PartitionSpec as P
    jmesh = j_sh.make_mesh(8)
    jstack = j_state.ActiveMapState(**{
        f: jax.device_put(np.stack([b[f] for b in before]),
                          NamedSharding(jmesh, P("shard")))
        for f in before[0]})
    _, j_met = j_sh.make_sharded_carve(_jax(ccfg), jmesh)(
        jstack, jnp.asarray(pts), np.int32(len(pts)), jnp.asarray(POS))
    assert int(j_met["n_carve_samples"]) > int(s_met["n_carve_samples"])
