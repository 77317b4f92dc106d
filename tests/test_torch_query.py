"""The port's query surface against the JAX ``TSDFMap`` on the same states:
``leaf_arrays`` / ``leaf_items``, ``raycast`` (a sphere, a glancing ray
over a floor, the cached query index invalidated by an insert), ``merge``,
and the re-anchoring of a submap with a ``corrected`` pose.  The port's
maps insert on the CPU; their active and rotated-out states go to the JAX
package as numpy (``state_to_numpy``), so both packages finalize, walk and
query the same data, and every result must be equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import state as j_state
from chad_tsdf_tpu.core import submap as j_submap
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.core import state as t_state

CFG = MapConfig(max_points=4096, block_capacity=4096, touched_capacity=4096,
                accumulate_impl="xla", mesh_impl="host")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n, r=1.0, seed=420, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r + np.asarray(centre)).astype(np.float32)


def _jax_state(state):
    fields = t_state.state_to_numpy(state)
    return j_state.ActiveMapState(
        **{k: jnp.asarray(v) for k, v in fields.items()})


def _jax_twin(tm):
    """A JAX ``TSDFMap`` holding the port map's states: its pending
    (rotated-out) states, its active state and trajectory."""
    jm = JaxTSDFMap(config=JaxMapConfig(**dataclasses.asdict(tm.config)))
    for p in tm._pending:
        jm._pending.append(j_submap.start_finalize(
            _jax_state(p.raw_state), jm.config, p.positions,
            anchor=p.anchor))
    if tm.state is not None:
        jm.state = _jax_state(tm.state)
        jm._positions = list(tm._positions)
    return jm


def _two_submap_map(config=CFG):
    """Two spheres 6 m apart: the second insert rotates the first map
    out (a pending stub until a drain)."""
    tm = TSDFMap(config=config, device="cpu")
    tm.insert(_sphere(4096, seed=5), np.zeros(3, np.float32))
    tm.insert(_sphere(4096, seed=6, centre=(6.0, 0.0, 0.0)),
              np.float32([6.0, 0.0, 0.0]))
    assert len(tm._pending) == 1
    return tm


def _equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_leaf_arrays_and_items_match_jax():
    tm = _two_submap_map()
    jm = _jax_twin(tm)
    got, want = tm.leaf_arrays(), jm.leaf_arrays()
    assert got[0].shape[0] > 1000
    _equal_arrays(got, want)
    assert [a.dtype for a in got] == [np.int32, np.float32, np.uint8]
    _equal_arrays(tm.leaf_arrays(tm.submaps[0]),
                  jm.leaf_arrays(jm.submaps[0]))
    items = list(tm.leaf_items(tm.submaps[0]))
    assert len(items) == tm.submaps[0].n_voxels
    for (c, s, w), (jc, js, jw) in zip(items[:50],
                                       jm.leaf_items(jm.submaps[0])):
        np.testing.assert_array_equal(c, jc)
        assert (s, w) == (js, jw)
    empty = TSDFMap(config=CFG, device="cpu")
    _equal_arrays(empty.leaf_arrays(),
                  JaxTSDFMap(config=jm.config).leaf_arrays())


def test_raycast_matches_jax():
    """Rays from each sphere's centre toward scanned points hit where
    JAX's hit (the second sphere's map is the active one, the first's a
    pending stub), and a ray into nothing misses."""
    tm = _two_submap_map()
    jm = _jax_twin(tm)
    centre2 = np.float64([6.0, 0.0, 0.0])
    rays = [(np.zeros(3), p / np.linalg.norm(p))
            for p in _sphere(4096, seed=5)[:4]]
    rays += [(centre2, p / np.linalg.norm(p)) for p in
             _sphere(4096, seed=6, centre=(6.0, 0.0, 0.0))[:4] - centre2]
    rays += [(np.float64([0.0, 0.0, 3.0]), np.float64([0.0, 0.0, 1.0]))]
    hits = []
    for origin, d in rays:
        got = tm.raycast(origin, d, max_dist=8.0)
        want = jm.raycast(origin, d, max_dist=8.0)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        hits.append(got)
    assert all(abs(np.linalg.norm(h - o) - 1.0) < 0.1
               for h, (o, _) in zip(hits[:8], rays))
    assert hits[8] is None


def test_raycast_glancing_incidence_matches_jax():
    """A ray descending 1:40 onto a flat floor (tests/test_map.py's case)
    must not step across the surface."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(-2.0, 2.0, (20000, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.zeros((len(xy), 1), np.float32)], axis=1)
    tm = TSDFMap(config=dataclasses.replace(CFG, max_points=20480,
                                            block_capacity=8192),
                 device="cpu")
    tm.insert(pts, np.float32([0.0, 0.0, 3.0]))
    origin = np.float64([-1.8, 0.0, 0.08])
    direction = np.float64([1.0, 0.0, -0.025])
    hit = tm.raycast(origin, direction, max_dist=8.0)
    assert hit is not None and abs(hit[2]) < 2 * tm.sdf_res, hit
    np.testing.assert_array_equal(
        hit, _jax_twin(tm).raycast(origin, direction, max_dist=8.0))


def test_raycast_cache_invalidation():
    """The cached query index follows the map: an insert (an inner
    sphere), a rotation and its drain, and a merge each give a new index,
    equal to what the JAX map computes from the same states."""
    tm = TSDFMap(config=CFG, device="cpu")
    pts1 = _sphere(4096, r=1.0)
    tm.insert(pts1, np.zeros(3, np.float32))
    d1 = pts1[0] / np.linalg.norm(pts1[0])
    h1 = tm.raycast(np.zeros(3), d1)
    assert h1 is not None and abs(np.linalg.norm(h1) - 1.0) < 0.1
    index = tm._sorted_samples()
    np.testing.assert_array_equal(tm.raycast(np.zeros(3), d1), h1)
    assert tm._sorted_samples() is not index and \
        tm._sorted_samples()[0] is index[0]          # served from the cache
    pts2 = _sphere(4096, r=0.5, seed=3)
    tm.insert(pts2, np.zeros(3, np.float32))
    d2 = pts2[0] / np.linalg.norm(pts2[0])
    h3 = tm.raycast(np.zeros(3), d2)
    assert h3 is not None and abs(np.linalg.norm(h3) - 0.5) < 0.1
    np.testing.assert_array_equal(h3, _jax_twin(tm).raycast(np.zeros(3), d2))
    # a rotation: the first map is pending, then drained by the next query
    centre = np.float64([6.0, 0.0, 0.0])
    far = _sphere(4096, seed=6, centre=centre)
    tm.insert(far, np.float32(centre))
    jm = _jax_twin(tm)
    d3 = (far[0] - centre) / np.linalg.norm(far[0] - centre)
    assert tm._pending
    hit_far = tm.raycast(centre, d3)
    assert not tm._pending
    assert hit_far is not None and \
        abs(np.linalg.norm(hit_far - centre) - 1.0) < 0.1
    np.testing.assert_array_equal(hit_far, jm.raycast(centre, d3))
    # a merge adds a third sphere
    other = TSDFMap(config=CFG, device="cpu")
    other.insert(_sphere(4096, seed=7, centre=(0.0, 6.0, 0.0)),
                 np.float32([0.0, 6.0, 0.0]))
    before = tm._sorted_samples()[0].shape[0]
    tm.merge(other)
    assert tm._sorted_samples()[0].shape[0] > before


def test_merge_matches_jax():
    """``a.merge(b)`` re-conses b's submaps (its pending and active ones
    included) into a's levels: samples, submaps and DAG counters equal
    JAX's merge of the same states."""
    ta, tb = _two_submap_map(), TSDFMap(config=CFG, device="cpu")
    tb.insert(_sphere(4096, seed=9, centre=(0.5, 0.0, 0.0)),
              np.float32([0.5, 0.0, 0.0]))
    ja, jb = _jax_twin(ta), _jax_twin(tb)
    c0 = ta.voxel_samples()[0].shape[0]           # drains ta's stub
    assert ja.voxel_samples()[0].shape[0] == c0
    ta.merge(tb)
    ja.merge(jb)
    codes, sd = ta.voxel_samples()
    assert codes.shape[0] > c0
    _equal_arrays((codes, sd), ja.voxel_samples())
    assert ta.n_submaps == ja.n_submaps == 2
    assert ta.stats() == ja.stats()
    for a, b in zip(ta.submaps, ja.submaps):
        assert (a.root_addr_tsdf, a.root_addr_weight, a.n_clusters) == \
            (b.root_addr_tsdf, b.root_addr_weight, b.n_clusters)
        np.testing.assert_array_equal(a.anchor, b.anchor)


def test_reanchor_matches_jax():
    """A submap with a hand-set ``corrected`` pose moves its voxels at
    query time exactly as JAX's ``_reanchor_codes`` moves them."""
    tm = _two_submap_map()
    jm = _jax_twin(tm)
    tm.finalize_active()
    jm.finalize_active()
    c, s = np.cos(0.1), np.sin(0.1)
    corr = np.array([[c, -s, 0.0, 0.3], [s, c, 0.0, -0.2],
                     [0.0, 0.0, 1.0, 0.05], [0.0, 0.0, 0.0, 1.0]])
    codes, _ = tm.voxel_samples()
    np.testing.assert_array_equal(tm._reanchor_codes(codes, corr),
                                  jm._reanchor_codes(codes, corr))
    tm.submaps[1].corrected = corr
    jm.submaps[1].corrected = corr
    moved = tm.voxel_samples()
    assert not np.array_equal(moved[0], codes)
    _equal_arrays(moved, jm.voxel_samples())
    _equal_arrays(tm.voxel_samples([tm.submaps[0]]),
                  jm.voxel_samples([jm.submaps[0]]))
