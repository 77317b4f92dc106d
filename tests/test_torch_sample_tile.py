"""The ``sample_tile`` backend of the port and the tile kernels' long block
lists, on the CPU, against the JAX package.

* The list limit: ``MapConfig(tile_nb=128)`` under ``tile`` and ``fused``
  inserts a sparse sphere as the JAX package's tiled insert does; K4's and
  K1's plain versions at nb = 128 and 256 against ``tile_partials`` and
  ``fused_tile_partials`` in interpret mode (lists and overflow masks
  equal, weights exact, sd within 1e-4 per weight).
* K4 at K = 1, nb = 128 on a block-sorted sample stream made with numpy
  from a seed, against ``tile_partials(interpret=True)``.
* The slice: ``sample_tiled_update`` and its fallback against the JAX
  package's ``insert_step_sample_tiled(interpret=True)`` on
  tests/test_tile_accum.py's three cases, fed the JAX package's own sorted
  sample batch (so that no DDA tie broken by XLA's contracted multiply-adds
  shows): directory keys equal, weights exact, sd within 1e-4 per weight
  (tests/test_torch_fused.py's ``compare``), ``tile_overflow`` equal.
* The surface on the CPU: a ``TSDFMap`` stream dispatched to
  ``sparse_impl="sample_tile"``, ``insert_steps_scan`` through the
  stand-in graph of tests/test_torch_steps_scan.py, checkpoints in both
  directions between the packages, and a 2-shard ``ShardedTSDFMap``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.core.state import create_state as j_create_state
from chad_tsdf_tpu.io import load_checkpoint as j_load
from chad_tsdf_tpu.io import save_checkpoint as j_save
from chad_tsdf_tpu.ops import fused_integrate as j_fused
from chad_tsdf_tpu.ops import tile_accum as j_tile
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import integrate
from chad_tsdf_tpu_torch.core.state import (create_state,
                                            origin_blocks_for_position)
from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
from chad_tsdf_tpu_torch.ops import fused_integrate, tile_accum
from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh
from chad_tsdf_tpu_torch.utils import timing
from tests.test_torch_fused import compare
from tests.test_torch_steps_scan import (  # noqa: F401  (fixture)
    _StandInGraph, stand_in_graphs)

INT32_MAX = 2**31 - 1
TILE = tile_accum.TILE
STEP = 0.1 / 127          # one 8-bit codec step at trunc = 0.1
FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
          "point_overflow", "sample_overflow", "block_overflow",
          "touched_overflow", "tile_overflow")
POS = np.zeros(3, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n, r, seed, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r + np.asarray(centre)).astype(np.float32)


def _cfg(n, impl, **kw):
    return MapConfig(max_points=n, block_capacity=8192, touched_capacity=8192,
                     accumulate_impl=impl, **kw)


def _jax(cfg):
    return JaxMapConfig(**dataclasses.asdict(cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------------------
# the list limit: nb = 128 and 256
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tiled_nb128():
    """The JAX package's tiled insert of the sparse sphere at nb = 128."""
    cfg = _jax(_cfg(2048, "tile", tile_nb=128))
    origin = origin_blocks_for_position(POS, cfg)
    return j_integrate.insert_step_tiled(
        j_create_state(cfg, origin), jnp.asarray(_sphere(2048, 5.0, 1)),
        jnp.int32(2048), jnp.asarray(POS), cfg, interpret=True)


@pytest.mark.parametrize("impl", ["tile", "fused"])
def test_tile_nb_128_inserts_like_jax(impl, jax_tiled_nb128):
    """``tile_nb=128`` was refused (7-bit ranks); the sparse sphere's tiles
    overflow even 128 blocks, so the fallback runs too.  Held to the JAX
    package's tiled insert at the same nb (fused and tile share one
    coverage rule)."""
    cfg = _cfg(2048, impl, tile_nb=128)
    origin = origin_blocks_for_position(POS, cfg)
    js, jm = jax_tiled_nb128
    ts, tm = integrate.insert_step(create_state(cfg, origin, "cpu"),
                                   torch.from_numpy(_sphere(2048, 5.0, 1)),
                                   2048, torch.from_numpy(POS), cfg)
    compare(js, ts)
    assert int(ts.tile_overflow) == int(js.tile_overflow) > 0
    for key in ("n_valid_samples", "n_new_blocks", "n_blocks"):
        assert int(tm[key]) == int(jm[key]), key


@pytest.fixture(scope="module")
def sparse_sorted_points():
    """One tile of the r = 5 sparse sphere, Morton-sorted with normals and
    walked into sample grids by the port (both packages then take the same
    arrays), at K = 4 samples a point: the JAX kernel's interpret mode
    takes seconds per sample row, and the tile still holds ~2,000 distinct
    blocks."""
    cfg = _cfg(TILE, "fused", max_steps=4)
    p = torch.from_numpy(_sphere(TILE, 5.0, 0))
    pos = torch.zeros(3)
    ob = torch.from_numpy(origin_blocks_for_position(POS, cfg))
    bkey, okey, _ = integrate.point_keys_soa(p[:, 0], p[:, 1], p[:, 2],
                                             TILE, ob, cfg)
    sb, so, px, py, pz = integrate.sort_points_soa(p[:, 0], p[:, 1],
                                                   p[:, 2], bkey, okey)
    nx, ny, nz = integrate.estimate_normals_dispatch(px, py, pz, sb, so,
                                                     pos, ob, cfg)
    grids = integrate.sample_grids(px, py, pz, nx, ny, nz, sb, pos, ob,
                                   cfg)[:3]
    fargs = (px, py, pz, nx, ny, nz, sb, pos, ob * 8)
    return cfg, [a.numpy() for a in fargs], [a.numpy() for a in grids]


def _hold_tile_outputs(t, j, ovf_t, ovf_j):
    """Lists and overflow equal, weights exact, sd within 1e-4 / weight."""
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(ovf_t, ovf_j)
    w = np.asarray(j[2])
    np.testing.assert_array_equal(t[2].numpy(), w)
    err = np.abs(t[1].numpy() - np.asarray(j[1])) / np.maximum(w, 1)
    assert err.max() < 1e-4, err.max()


@pytest.mark.parametrize("nb", [128, 256])
def test_k1_k4_plain_long_lists_match_jax(nb, sparse_sorted_points):
    """K1's and K4's plain versions at nb >= 128 (the card's wide lists)
    against the JAX kernels in interpret mode, on one tile of the sparse
    sphere, where some samples still fall beyond the list."""
    cfg, fargs, grids = sparse_sorted_points
    kw = dict(nb=nb, k=cfg.dda_steps, res=cfg.sdf_res, trunc=cfg.sdf_trunc,
              extent=cfg.blocks_per_axis * 8)
    j1 = j_fused.fused_tile_partials(*map(jnp.asarray, fargs),
                                     interpret=True, **kw)
    t1 = fused_integrate.fused_tile_partials(*(_t(a) for a in fargs), **kw)
    _hold_tile_outputs(t1, j1, t1[3].sum(0).numpy(),
                       np.asarray(j1[3]).sum(0)[:3])
    j4 = j_tile.tile_partials(*map(jnp.asarray, grids), nb=nb,
                              interpret=True)
    t4 = tile_accum.tile_partials(*(_t(a) for a in grids), nb,
                                  cfg.sdf_trunc)
    _hold_tile_outputs(t4, j4, t4[3].numpy(), np.asarray(j4[3]))
    assert int(t4[3].sum()) == int(t1[3][:, 1].sum()) > 0


def test_k4_sorted_sample_stream_matches_jax():
    """K4 on the (1, S) grid of a block-sorted sample stream at nb = 128,
    as the sample-tiled insert runs it: runs of 1-12 samples a block, so
    some tiles hold more than 128 blocks, and invalid samples last."""
    rng = np.random.default_rng(14)
    s = 4 * TILE
    runs = rng.integers(1, 13, s)
    keys = np.repeat(np.cumsum(rng.integers(1, 50, s)), runs)[:s]
    bkey = keys.astype(np.int32).reshape(1, s)
    bkey[:, -300:] = INT32_MAX
    okey = rng.integers(0, 512, (1, s)).astype(np.int32)
    sd = rng.uniform(-0.1, 0.1, (1, s)).astype(np.float32)
    j = j_tile.tile_partials(jnp.asarray(bkey), jnp.asarray(okey),
                             jnp.asarray(sd), nb=128, interpret=True)
    t = tile_accum.tile_partials(_t(bkey), _t(okey), _t(sd), 128, 0.1)
    _hold_tile_outputs(t, j, t[3].numpy(), np.asarray(j[3]))
    assert int(t[3].sum()) > 0
    assert int(tile_accum.live_rows(t[0]).sum()) > 3 * 127


def test_card_limit_names_itself():
    """The card's limit on nb: what shared memory allows, named in the
    error; the plain versions take any nb."""
    assert tile_accum.max_nb(1) >= 1024 and tile_accum.max_nb(10) >= 256
    assert tile_accum.tile_smem_bytes(10, 48) == 27488 * 4
    for k in (1, 10, 11):
        m = tile_accum.max_nb(k)
        assert tile_accum.tile_smem_bytes(k, m) <= tile_accum.MAX_SMEM_BYTES
        assert tile_accum.tile_smem_bytes(k, m + 1) > \
            tile_accum.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="227 KiB"):
        tile_accum.check_tile_smem(10, tile_accum.max_nb(10) + 8)
    tile_accum.check_tile_smem(10, 256)
    grids = [torch.zeros((1, TILE), dtype=d)
             for d in (torch.int32, torch.int32, torch.float32)]
    grids[0].fill_(INT32_MAX)
    out = tile_accum.tile_partials(*grids, 4096, 0.1)
    assert out[0].shape == (4096, 1)


# --------------------------------------------------------------------------
# the slice against insert_step_sample_tiled
# --------------------------------------------------------------------------

SLICE_CASES = {
    # tests/test_tile_accum.py: ~1 point a block at r = 5, below nb = 128's
    # coverage (the fallback runs); dense at r = 0.25; nb = 8 forced
    "sparse": (2048, 5.0, 1, {}),
    "dense": (2048, 0.25, 1, {}),
    "nb8": (1024, 5.0, 2, {"sparse_tile_nb": 8}),
}


@pytest.fixture(scope="module")
def jax_slices():
    """Per case: the JAX package's sorted sample batch and its
    ``insert_step_sample_tiled`` state and metrics, computed once."""
    out = {}
    for name, (n, r, seed, kw) in SLICE_CASES.items():
        cfg = _cfg(n, "sample_tile", **kw)
        jcfg = _jax(cfg)
        origin = origin_blocks_for_position(POS, cfg)
        pts = jnp.asarray(_sphere(n, r, seed))
        batch = j_integrate.sort_samples(j_integrate.compute_samples(
            pts, jnp.int32(n), jnp.asarray(POS), jnp.asarray(origin), jcfg))
        js, jm = j_integrate.insert_step_sample_tiled(
            j_create_state(jcfg, origin), pts, jnp.int32(n),
            jnp.asarray(POS), jcfg, interpret=True)
        out[name] = (cfg, batch, js, jm)
    return out


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_sample_tiled_update_matches_jax(case, jax_slices):
    cfg, batch, js, jm = jax_slices[case]
    tb = integrate.SampleBatch(*(_t(a) for a in batch))
    state = create_state(cfg, origin_blocks_for_position(POS, cfg), "cpu")
    syncs = timing.COUNTS["host_syncs"]
    ts, tm, tile_ovf, make_fallback = integrate.sample_tiled_update(
        state, tb, cfg)
    tail = integrate.FallbackTail(tile_ovf, make_fallback, cfg)
    ts = integrate.settle(tail, ts, tm)
    # the settle's one host wait, nothing else
    assert timing.COUNTS["host_syncs"] - syncs == 1
    compare(js, ts)
    assert int(ts.tile_overflow) == int(js.tile_overflow)
    assert (int(ts.tile_overflow) > 0) == (case != "dense")
    for key in ("n_valid_samples", "n_new_blocks", "n_blocks"):
        assert int(tm[key]) == int(jm[key]), key


def test_sample_tiled_insert_is_deferred_and_deterministic():
    """The whole insert from points: its fallback deferred to the tail
    (nothing read on the host), settled equal to ``insert_step``, and two
    runs bit-equal.  S must be a multiple of 1024."""
    cfg = _cfg(2048, "sample_tile")
    pts, pos = torch.from_numpy(_sphere(2048, 5.0, 1)), torch.zeros(3)
    origin = origin_blocks_for_position(POS, cfg)
    st, met, tail = integrate.insert_step_sample_tiled(
        create_state(cfg, origin, "cpu"), pts, 2048, pos, cfg)
    st = integrate.settle(tail, st, met)
    ref, ref_met = integrate.insert_step(create_state(cfg, origin, "cpu"),
                                         pts, 2048, pos, cfg)
    _same(st, ref)
    assert int(met["n_blocks"]) == int(ref_met["n_blocks"])
    assert int(st.tile_overflow) > 0
    with pytest.raises(ValueError, match="N % 1024"):
        bad = dataclasses.replace(cfg, max_steps=3)
        integrate.insert_step(create_state(bad, origin, "cpu"), pts[:1000],
                              1000, pos, bad)


# --------------------------------------------------------------------------
# the surface
# --------------------------------------------------------------------------

SCANS = [(_sphere(2048, 5.0, 3), POS),
         (_sphere(2048, 5.0, 4, centre=(1.0, 0.0, 0.0)),
          np.float32([1.0, 0.0, 0.0])),
         (_sphere(2048, 5.0, 5, centre=(7.0, 0.0, 0.0)),
          np.float32([7.0, 0.0, 0.0]))]


def _stream_cfg(**kw):
    return MapConfig(**{**dict(max_points=2048, block_capacity=16384,
                               touched_capacity=8192, mesh_impl="host",
                               sparse_impl="sample_tile"), **kw})


def test_map_stream_dispatches_sample_tile(monkeypatch):
    """A rotating stream whose sparse scans ``_dispatch_config`` sends to
    ``sparse_impl="sample_tile"`` (on the card it dispatches; the CPU map
    is made to dispatch the same way), against the same stream under the
    scatter backend: voxel codes equal, sd within one codec step."""
    m = TSDFMap(config=_stream_cfg(), device="cpu")
    dispatch = TSDFMap._dispatch_config

    def as_on_the_card(self, chunk):
        dev, self.device = self.device, torch.device("cuda")
        try:
            return dispatch(self, chunk)
        finally:
            self.device = dev

    monkeypatch.setattr(TSDFMap, "_dispatch_config", as_on_the_card)
    assert {m._dispatch_config(p).accumulate_impl for p, _ in SCANS} == \
        {"sample_tile"}
    ref = TSDFMap(config=_stream_cfg(accumulate_impl="xla"), device="cpu")
    for pts, pos in SCANS:
        syncs = timing.COUNTS["host_syncs"]
        m.insert(pts, pos)
        grew = timing.COUNTS["host_syncs"] - syncs
        ref.insert(pts, pos)
    # an insert waits for nothing: its fallback runs inside it
    assert grew == 0
    assert m.n_submaps == 1 == ref.n_submaps
    assert int(m.state.tile_overflow) > 0
    lossy = {k: v for k, v in m.stats()["overflow"].items() if k != "tile"}
    assert not any(lossy.values()), lossy
    cm, sm = m.voxel_samples()
    cr, sr = ref.voxel_samples()
    np.testing.assert_array_equal(cm, cr)
    assert np.abs(sm - sr).max() <= STEP + 1e-7


def test_steps_scan_sample_tile(stand_in_graphs):
    """``insert_steps_scan`` under ``sample_tile`` through the stand-in
    graph (the fallback as the IF node's plain version), bit-equal to a
    loop of ``insert_step``, on the sparse sphere (fallback taken) and
    the dense one."""
    for r, falls_back in ((5.0, True), (0.25, False)):
        cfg = _cfg(2048, "sample_tile")
        pts = torch.from_numpy(_sphere(2048, r, 0))
        origin = origin_blocks_for_position(POS, cfg)
        scan = integrate.insert_steps_scan(
            create_state(cfg, origin, "cpu"), pts, 2048, torch.zeros(3), cfg,
            3)
        loop = create_state(cfg, origin, "cpu")
        for _ in range(3):
            loop, _ = integrate.insert_step(loop, pts, 2048, torch.zeros(3),
                                            cfg)
        _same(scan, loop)
        assert (int(scan.tile_overflow) > 0) == falls_back
        integrate.clear_graphs()


def test_checkpoints_cross_packages(tmp_path):
    """A ``sample_tile`` map's checkpoint loads into the JAX package, and
    the JAX package's into the port, with its config and states equal; the
    loaded port map goes on inserting under the backend."""
    cfg = _stream_cfg(accumulate_impl="sample_tile")
    tm = TSDFMap(config=cfg, device="cpu")
    for pts, pos in SCANS:
        tm.insert(pts, pos)
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, tm)
    jm = j_load(p)
    assert jm.config == _jax(cfg)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jm.state, f)),
                                      getattr(tm.state, f).numpy())
    assert jm.stats() == tm.stats()

    jm2 = JaxTSDFMap(config=_jax(cfg))
    jm2.insert(*SCANS[0])
    q = str(tmp_path / "jax.npz")
    j_save(q, jm2)
    tm2 = load_checkpoint(q, device="cpu")
    assert tm2.config == cfg
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tm2.state, f).numpy(),
                                      np.asarray(getattr(jm2.state, f)))
    tm2.insert(*SCANS[1])
    assert int(tm2.state.n_blocks) >= int(jm2.state.n_blocks)


def test_sharded_map_sample_tile_equals_single_device():
    """Two shards, each running the sample-tiled insert into its scratch
    pool (its fallback settled into the shard's pool), against
    ``TSDFMap``: voxel codes equal, sd within tests/test_torch_sharded_map
    .py's rule (normals differ where the shards cut the cloud)."""
    cfg = _stream_cfg(accumulate_impl="sample_tile")
    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(2, device="cpu"))
    ref = TSDFMap(config=cfg, device="cpu")
    for pts, pos in SCANS[:2]:
        syncs = timing.COUNTS["host_syncs"]
        met = smap.insert(pts, pos)
        grew = timing.COUNTS["host_syncs"] - syncs
        ref.insert(pts, pos)
    # the second insert settles the first's two shard tails: two waits
    assert grew == 2
    assert met["route_overflow"] == 0
    assert sum(int(s.tile_overflow) for s in smap.state_stack) > 0
    cs, ss = smap.voxel_samples()
    cr, sr = ref.voxel_samples()
    np.testing.assert_array_equal(cs, cr)
    assert (np.abs(ss - sr) <= 2 * STEP).mean() > 0.98
