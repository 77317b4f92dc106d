"""The port's Morton-range sharding (``chad_tsdf_tpu_torch/parallel/
sharded.py``) on the CPU, against the JAX package's
``chad_tsdf_tpu/parallel/sharded.py`` on the conftest's 8 virtual devices
(tests/test_sharding.py's cases): the host helpers exactly; the halo
routing on the same rows, every output exact; the sharded insert against
the JAX step on the same split (directory keys and weights exact, sd sums
within one 16-bit quantum per sample: compiled JAX contracts
multiply-adds) and against the port's single-device insert under the JAX
tests' own rules; a hotspot with zero drops; deferred rows lossless;
determinism; the sharded finalize against the single-device finalize and
against the JAX one on the same states; a fused scratch insert whose
fallback settles into the persistent pools."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import submap as j_submap
from chad_tsdf_tpu.core.dag import NodeLevels as JaxNodeLevels
from chad_tsdf_tpu.parallel import sharded as j_sh
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import integrate
from chad_tsdf_tpu_torch.core import submap as t_submap
from chad_tsdf_tpu_torch.core.dag import NodeLevels
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.parallel import sharded
from chad_tsdf_tpu_torch.utils import timing

CFG = MapConfig(max_points=512, block_capacity=4096, touched_capacity=2048,
                accumulate_impl="xla")
QUANTUM = CFG.sdf_trunc / 32767          # one 16-bit sd quantum
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


def sphere_points(n, r=2.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def hotspot_points(n, seed=0, half=0.2):
    rng = np.random.default_rng(seed)
    return (np.float32([1.5, 1.5, 1.5]) +
            rng.uniform(-half, half, size=(n, 3)).astype(np.float32))


def pack_shards(chunks, cap):
    pts = np.zeros((len(chunks) * cap, 3), np.float32)
    n_per = np.zeros((len(chunks),), np.int32)
    for i, c in enumerate(chunks):
        pts[i * cap:i * cap + len(c)] = c
        n_per[i] = len(c)
    return pts, n_per


def _split(pts, n_dev, split, cfg):
    chunks = sharded.morton_split(pts, n_dev, cfg.sdf_res) \
        if split == "morton" else np.array_split(pts, n_dev)
    return pack_shards(chunks, cfg.max_points)


def run_port(pts, cfg=CFG, n_dev=8, split="morton", **kw):
    mesh = sharded.make_mesh(n_dev, device="cpu")
    origin = origin_blocks_for_position(POS, cfg)
    padded, n_per = _split(pts, n_dev, split, cfg)
    step, _ = sharded.make_sharded_insert(cfg, mesh, **kw)
    stack, metrics, tails = step(
        sharded.create_sharded_state(cfg, mesh, origin), padded, n_per, POS,
        sharded.key_bounds(n_dev, cfg))
    stack, _ = sharded.settle_stack(stack, tails, mesh)
    return stack, {k: int(v) for k, v in metrics.items()}, origin


def run_jax(pts, cfg=CFG, n_dev=8, split="morton", **kw):
    jcfg = _jax(cfg)
    mesh = j_sh.make_mesh(n_dev)
    origin = origin_blocks_for_position(POS, cfg)
    padded, n_per = _split(pts, n_dev, split, cfg)
    step, _ = j_sh.make_sharded_insert(jcfg, mesh, **kw)
    stack, metrics = step(j_sh.create_sharded_state(jcfg, mesh, origin),
                          jnp.asarray(padded), jnp.asarray(n_per),
                          jnp.asarray(POS),
                          jnp.asarray(j_sh.key_bounds(n_dev, jcfg)))
    return j_sh.gather_states(stack), {k: int(v) for k, v in
                                       metrics.items()}


def run_single(pts, cfg=CFG, origin=None):
    """The port's single-device insert of the whole cloud (a pool big
    enough for it), as tests/test_sharding.py's ``run_single``."""
    sd_cfg = dataclasses.replace(cfg, max_points=max(len(pts),
                                                     cfg.max_points),
                                 block_capacity=16384,
                                 touched_capacity=8192, accumulate_impl="xla")
    state = create_state(sd_cfg, origin, "cpu")
    padded = np.zeros((sd_cfg.max_points, 3), np.float32)
    padded[:len(pts)] = pts
    state, m = integrate.insert_step(state, torch.from_numpy(padded),
                                     len(pts), torch.from_numpy(POS), sd_cfg)
    return state, sd_cfg, {k: int(v) for k, v in m.items()}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def voxels(states, allow_duplicates=False):
    """{(block key, offset): (sd sum, weight)} over per-shard states."""
    out = {}
    for st in states:
        nb = int(st.n_blocks)
        keys = _np(st.dir_keys)[:nb]
        slots = _np(st.dir_slots)[:nb]
        sd, w = _np(st.pool_sd)[slots], _np(st.pool_w)[slots]
        bi, oi = np.nonzero(w > 0)
        for k, o, x, ww in zip(keys[bi], oi, sd[bi, oi], w[bi, oi]):
            key = (int(k), int(o))
            if key in out:
                assert allow_duplicates, "shards must own disjoint voxels"
                out[key] = (out[key][0] + x, out[key][1] + ww)
            else:
                out[key] = (x, ww)
    return out


def assert_matches_single(got, want, exact_sd=False):
    assert set(got) == set(want)
    diffs = np.asarray([abs(got[k][0] - want[k][0]) for k in want])
    for k in want:
        assert got[k][1] == want[k][1]
    if not exact_sd:
        # normals differ at the n - 1 cut points of the split
        assert np.median(diffs) < 2e-3 and diffs.max() < 5e-2


def assert_shards_match_jax(t_states, j_states):
    """Per shard: directory keys and weights exact, sd sums within one
    quantum per sample."""
    assert len(t_states) == len(j_states)
    for t, j in zip(t_states, j_states):
        nb = int(t.n_blocks)
        assert nb == int(j.n_blocks)
        np.testing.assert_array_equal(_np(t.dir_keys), np.asarray(j.dir_keys))
        ts, js = _np(t.dir_slots)[:nb], np.asarray(j.dir_slots)[:nb]
        w = _np(t.pool_w)[ts]
        np.testing.assert_array_equal(w, np.asarray(j.pool_w)[js])
        diff = np.abs(_np(t.pool_sd)[ts] - np.asarray(j.pool_sd)[js])
        assert (diff <= w * QUANTUM + 1e-5).all(), diff.max()
        for f in ("point_overflow", "sample_overflow", "block_overflow",
                  "touched_overflow", "tile_overflow"):
            assert int(getattr(t, f)) == int(getattr(j, f)), f


@pytest.fixture(scope="module")
def sphere_run():
    """One sphere through the port and the JAX step on the same split."""
    pts = sphere_points(8 * CFG.max_points)
    stack, metrics, origin = run_port(pts)
    j_states, j_metrics = run_jax(pts)
    return pts, stack, metrics, origin, j_states, j_metrics


def test_host_helpers_match_jax():
    jcfg = _jax(CFG)
    for n in (1, 4, 8):
        np.testing.assert_array_equal(sharded.key_bounds(n, CFG),
                                      j_sh.key_bounds(n, jcfg))
        assert sharded.default_halo_capacity(n, CFG) == \
            j_sh.default_halo_capacity(n, jcfg)
    assert dataclasses.asdict(sharded.scratch_config(CFG)) == \
        dataclasses.asdict(j_sh.scratch_config(jcfg))
    pts = sphere_points(8192, seed=13)
    origin = origin_blocks_for_position(POS, CFG)
    np.testing.assert_array_equal(
        sharded.point_block_keys(pts, origin, CFG),
        np.asarray(j_sh.point_block_keys(pts, origin, jcfg)))
    bounds = sharded.adaptive_bounds(pts, origin, 8, CFG)
    np.testing.assert_array_equal(bounds,
                                  j_sh.adaptive_bounds(pts, origin, 8, jcfg))
    assert bounds[0] == 0 and int(bounds[-1]) == 1 << (3 * CFG.block_bits)
    for got, want in zip(sharded.owner_split(pts, bounds, origin, CFG),
                         j_sh.owner_split(pts, bounds, origin, jcfg)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(sharded.morton_split(pts, 8, CFG.sdf_res),
                         j_sh.morton_split(pts, 8, CFG.sdf_res)):
        np.testing.assert_array_equal(got, want)
    skewed = [pts[:5000], pts[5000:5100]] + [pts[:0]] * 6
    out = sharded.rebalance_chunks(skewed, 1024)
    for got, want in zip(out, j_sh.rebalance_chunks(skewed, 1024)):
        np.testing.assert_array_equal(got, want)
    assert all(len(c) <= 1024 for c in out)
    assert sum(len(c) for c in out) == 5100


def test_route_block_rows_matches_jax():
    """The same per-shard rows routed by both: local keys, received keys
    and rows, deferred and sent counts exact, with a capacity small
    enough that some segments defer."""
    n, r, width, cap = 8, 64, 16, 4
    rng = np.random.default_rng(3)
    bounds = sharded.key_bounds(n, CFG)
    keys = np.full((n, r), 2**31 - 1, np.int32)
    for s in range(n):
        live = rng.integers(20, r)
        # clustered around a few ranges, so some segments exceed ``cap``
        rngs = rng.choice(n, size=3, replace=False)
        k = np.concatenate([rng.integers(bounds[d], bounds[d + 1], size=live)
                            for d in rngs])
        keys[s, :live] = np.sort(np.unique(k))[:live]
    sd = rng.normal(size=(n, r, width)).astype(np.float32)
    w = rng.integers(0, 5, size=(n, r, width)).astype(np.float32)

    jmesh = j_sh.make_mesh(n)

    def body(k, a, b, bnd):
        me = jax.lax.axis_index("shard")
        out = j_sh._route_block_rows(k[0], a[0], b[0], bnd, me, cap, "shard")
        return tuple(x[None] for x in out)

    fn = jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=(P("shard"), P("shard"), P("shard"), P()),
        out_specs=(P("shard"),) * 6, check_vma=False))
    want = [np.asarray(x) for x in fn(jnp.asarray(keys), jnp.asarray(sd),
                                      jnp.asarray(w), jnp.asarray(bounds))]

    mesh = sharded.make_mesh(n, device="cpu")
    routed = [sharded._route_block_rows(
        torch.from_numpy(keys[s]), torch.from_numpy(sd[s]),
        torch.from_numpy(w[s]), torch.from_numpy(bounds), s, cap)
        for s in range(n)]
    recv = [mesh.exchange([x[j] for x in routed]) for j in (1, 2, 3)]
    assert sum(int(x[4]) for x in routed) > 0          # rows deferred
    for s in range(n):
        np.testing.assert_array_equal(routed[s][0].numpy(), want[0][s])
        np.testing.assert_array_equal(recv[0][s].reshape(-1).numpy(),
                                      want[1][s])
        np.testing.assert_array_equal(
            recv[1][s].reshape(-1, width).numpy(), want[2][s])
        np.testing.assert_array_equal(
            recv[2][s].reshape(-1, width).numpy(), want[3][s])
        assert int(routed[s][4]) == int(want[4][s])
        assert int(routed[s][5]) == int(want[5][s])


def test_sharded_insert_matches_jax_and_single_device(sphere_run):
    pts, stack, metrics, origin, j_states, j_metrics = sphere_run
    assert metrics["route_overflow"] == 0 and metrics["route_sent"] > 0
    for k in ("route_overflow", "route_sent", "n_valid_samples",
              "n_blocks"):
        assert metrics[k] == j_metrics[k], k
    assert_shards_match_jax(stack, j_states)

    ref, _, ref_m = run_single(pts, origin=origin)
    assert metrics["n_valid_samples"] == ref_m["n_valid_samples"]
    assert_matches_single(voxels(stack), voxels([ref]))


def test_ownership_partition(sphere_run):
    """With no deferred row every block a shard holds is in its range."""
    _, stack, _, _, _, _ = sphere_run
    bounds = sharded.key_bounds(8, CFG)
    for d, st in enumerate(stack):
        keys = st.dir_keys[:int(st.n_blocks)].numpy()
        assert (keys >= bounds[d]).all() and (keys < bounds[d + 1]).all()


def test_hotspot_zero_drops():
    """A single-hotspot cloud split at random: every shard's rows go to
    one owner, and no sample is lost."""
    pts = hotspot_points(8 * CFG.max_points, seed=7)
    stack, metrics, origin = run_port(pts, split="random")
    assert metrics["route_overflow"] == 0
    ref, _, ref_m = run_single(pts, origin=origin)
    assert metrics["n_valid_samples"] == ref_m["n_valid_samples"]
    got, want = voxels(stack), voxels([ref])
    assert set(got) == set(want)
    assert all(got[k][1] == want[k][1] for k in want)
    assert sum(int(st.n_blocks) > 0 for st in stack) == 1


def test_deferred_rows_lossless():
    """A tiny halo capacity defers rows (route_overflow > 0, as in the
    JAX step on the same split); the merged weights still equal the
    single-device insert's, and the sharded finalize merges the duplicate
    blocks before quantization: cluster codes and weight words equal."""
    pts = hotspot_points(8 * CFG.max_points, seed=9, half=0.5)
    stack, metrics, origin = run_port(pts, split="random", halo_capacity=8)
    assert metrics["route_overflow"] > 0
    j_states, j_metrics = run_jax(pts, split="random", halo_capacity=8)
    assert metrics["route_overflow"] == j_metrics["route_overflow"]
    assert_shards_match_jax(stack, j_states)

    ref, sd_cfg, ref_m = run_single(pts, origin=origin)
    got, want = voxels(stack, allow_duplicates=True), voxels([ref])
    assert set(got) == set(want)
    assert all(got[k][1] == want[k][1] for k in want)

    lv, lv2 = NodeLevels(use_native=False), NodeLevels(use_native=False)
    sm = t_submap.finalize_sharded(stack, lv, CFG, [POS])
    sm2 = t_submap.finalize(ref, lv2, sd_cfg, [POS])
    c1, _ = lv.walk_leaf_clusters(sm.root_addr_tsdf)
    c2, _ = lv2.walk_leaf_clusters(sm2.root_addr_tsdf)
    np.testing.assert_array_equal(c1, c2)
    _, w1 = lv.walk_leaf_clusters(sm.root_addr_weight)
    _, w2 = lv2.walk_leaf_clusters(sm2.root_addr_weight)
    np.testing.assert_array_equal(w1, w2)


def test_sharded_determinism():
    pts = sphere_points(8 * CFG.max_points, seed=4)
    a, _, _ = run_port(pts)
    b, _, _ = run_port(pts)
    for x, y in zip(a, b):
        assert torch.equal(x.pool_sd, y.pool_sd)
        assert torch.equal(x.pool_w, y.pool_w)
        assert torch.equal(x.dir_slots, y.dir_slots)


def test_sharded_finalize_matches_single_device_and_jax(sphere_run):
    """The port's sharded finalize against its single-device finalize
    (codes equal, words overwhelmingly equal: normals differ at the cut
    points) and against the JAX sharded finalize of the JAX states handed
    over to the port (codes and words exact)."""
    pts, stack, _, origin, j_states, _ = sphere_run
    lv = NodeLevels(use_native=False)
    sm = t_submap.finalize_sharded(stack, lv, CFG, [POS])
    codes, words = lv.walk_leaf_clusters(sm.root_addr_tsdf)
    ref, sd_cfg, _ = run_single(pts, origin=origin)
    lv2 = NodeLevels(use_native=False)
    sm2 = t_submap.finalize(ref, lv2, sd_cfg, [POS])
    c2, w2 = lv2.walk_leaf_clusters(sm2.root_addr_tsdf)
    np.testing.assert_array_equal(codes, c2)
    assert (words == w2).mean() > 0.97

    mesh = sharded.make_mesh(8, device="cpu")
    handed = sharded.state_stack_from_numpy(j_states, mesh)
    lv3 = NodeLevels(use_native=False)
    sm3 = sharded.start_finalize_sharded_global(
        handed, mesh, CFG, [POS]).finish(lv3, CFG)
    jl = JaxNodeLevels(use_native=False)
    jsm = j_submap.finalize_sharded(j_states, jl, _jax(CFG), [POS])
    for root, jroot in ((sm3.root_addr_tsdf, jsm.root_addr_tsdf),
                        (sm3.root_addr_weight, jsm.root_addr_weight)):
        for got, want in zip(lv3.walk_leaf_clusters(root),
                             jl.walk_leaf_clusters(jroot)):
            np.testing.assert_array_equal(got, want)
    assert sm3.n_voxels == jsm.n_voxels


def test_merge_and_shard_state_host_match_jax(sphere_run):
    """``merge_states_host`` / ``shard_state_host`` of the same states in
    both packages: every field equal, and the round trip onto 4 shards."""
    _, stack, _, _, j_states, _ = sphere_run
    jcfg = _jax(CFG)
    handed = [sharded.state_stack_to_numpy([st])[0] for st in stack]
    merged = sharded.merge_states_host(stack, CFG, device="cpu")
    j_merged = j_sh.merge_states_host(
        [type("S", (), d) for d in handed], jcfg)
    for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
              "origin_blocks", "tile_overflow"):
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(j_merged, f)), f)
    mesh4 = sharded.make_mesh(4, device="cpu")
    four = sharded.shard_state_host(merged, mesh4, CFG)
    j_four = j_sh.gather_states(j_sh.shard_state_host(
        j_merged, j_sh.make_mesh(4), jcfg))
    for t, j in zip(four, j_four):
        for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
    back = sharded.merge_states_host(four, CFG, device="cpu")
    assert torch.equal(back.pool_sd, merged.pool_sd)
    assert torch.equal(back.dir_keys, merged.dir_keys)
    assert len(j_states) == 8


def test_fused_scratch_fallback_settles_into_the_pools():
    """A sparse cloud forced to ``fused`` with a short block list: each
    shard's scratch insert defers its fallback (no host read), which then
    lands in the shard's persistent pool under the samples' own keys.
    The merged weights equal the single-device insert's, and the sharded
    finalize equals the single-device finalize."""
    cfg = dataclasses.replace(CFG, max_points=1024, accumulate_impl="fused",
                              tile_nb=8)
    pts = sphere_points(4 * 1024, r=4.0, seed=5)
    mesh = sharded.make_mesh(4, device="cpu")
    origin = origin_blocks_for_position(POS, cfg)
    padded, n_per = _split(pts, 4, "morton", cfg)
    step, _ = sharded.make_sharded_insert(cfg, mesh)
    stack0 = sharded.create_sharded_state(cfg, mesh, origin)
    syncs = timing.COUNTS["host_syncs"]
    stack, metrics, tails = step(stack0, padded, n_per, POS,
                                 sharded.key_bounds(4, cfg))
    # the shards' fallbacks are deferred: the step does not wait
    assert timing.COUNTS["host_syncs"] == syncs
    assert all(t is not None for t in tails)
    n_blocks0 = int(metrics["n_blocks"])
    stack, delta = sharded.settle_stack(stack, tails, mesh)
    assert sum(int(st.tile_overflow) for st in stack) > 0
    assert int(delta["n_blocks"]) > 0
    assert n_blocks0 + int(delta["n_blocks"]) == \
        sum(int(st.n_blocks) for st in stack)

    ref, sd_cfg, _ = run_single(pts, cfg=cfg, origin=origin)
    got, want = voxels(stack, allow_duplicates=True), voxels([ref])
    assert set(got) == set(want)
    assert all(got[k][1] == want[k][1] for k in want)
    lv, lv2 = NodeLevels(use_native=False), NodeLevels(use_native=False)
    c1, _ = lv.walk_leaf_clusters(t_submap.finalize_sharded(
        stack, lv, cfg, [POS]).root_addr_tsdf)
    c2, _ = lv2.walk_leaf_clusters(t_submap.finalize(
        ref, lv2, sd_cfg, [POS]).root_addr_tsdf)
    np.testing.assert_array_equal(c1, c2)
