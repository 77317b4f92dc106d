"""The port's public surface on the CPU: ``TSDFMap(device="cpu")`` insert +
save against the JAX ``TSDFMap``, the golden sphere workload of
tests/test_mesh.py, submap rotation; that the port imports neither jax nor
the JAX package, that its own copies of ``MapConfig`` and the DAG agree
with the JAX package's, and that its entry points default to the card."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import dag as j_dag
from chad_tsdf_tpu.mesh.rmse import analytic_sphere_rmse, vertex_rmse
from chad_tsdf_tpu_torch import TSDFMap
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import dag as t_dag
from chad_tsdf_tpu_torch.core import state as t_state
from chad_tsdf_tpu_torch.core import submap as t_submap
from chad_tsdf_tpu_torch.core.map import LazyMetrics
from chad_tsdf_tpu_torch.mesh import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 0.1 / 127          # one 8-bit codec step at trunc = 0.1


def _sphere(n, r, seed, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r + np.asarray(centre)).astype(np.float32)


def _small_cfg(impl):
    return MapConfig(max_points=4096, block_capacity=4096,
                     touched_capacity=4096, accumulate_impl=impl,
                     mesh_impl="host")


def _jax(cfg):
    """The JAX package's MapConfig with the port's config's fields."""
    return JaxMapConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_map_insert_save_matches_jax(impl, tmp_path):
    pts = _sphere(4096, 1.0, 3)
    pos = np.asarray([0.05, -0.02, 0.01], np.float32)
    jm = JaxTSDFMap(config=_jax(_small_cfg("xla")))
    jm.insert(pts, pos)
    tm = TSDFMap(config=_small_cfg(impl), device="cpu")
    met = tm.insert(pts, pos)
    assert isinstance(met, LazyMetrics)
    assert not isinstance(met.raw("n_blocks"), (int, float))
    assert met["n_blocks"] == int(jm.state.n_blocks)

    jc, jsd = jm.voxel_samples()
    tc, tsd = tm.voxel_samples()
    np.testing.assert_array_equal(tc, jc)
    assert np.abs(tsd - jsd).max() <= STEP + 1e-7

    jm.save(str(tmp_path / "jax.ply"))
    tm.save(str(tmp_path / "port.ply"))
    ref, got = read_ply(str(tmp_path / "jax.ply")), \
        read_ply(str(tmp_path / "port.ply"))
    assert got.n_vertices > 0 and got.n_faces > 0
    assert vertex_rmse(got.vertices, ref.vertices)["rmse"] < STEP / 10
    assert "sub_fin_ms" in tm.last_metrics and "mesh_ms" in tm.last_metrics


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_golden_sphere_workload(impl):
    """tests/test_mesh.py's golden workload through the port.  The golden
    was written by the JAX package under jit, whose compiled traversal
    breaks one ray's axis tie differently from the IEEE evaluation of the
    port and of eager JAX (tests/test_torch_ops.py): at most 2 of its
    99804 voxel codes may differ; every shared voxel is within one codec
    step, and every port vertex lies on the golden mesh (the golden's own
    vertices around that voxel's cells have no counterpart)."""
    g = np.load(os.path.join(ROOT, "tests", "golden",
                             "sphere_r2_seed420.npz"))
    rng = np.random.default_rng(420)
    d = rng.uniform(-1.0, 1.0, (65536, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = TSDFMap(config=MapConfig(max_points=65536, block_capacity=16384,
                                 touched_capacity=8192, accumulate_impl=impl,
                                 mesh_impl="host"), device="cpu")
    m.insert((d * 2.0).astype(np.float32), np.zeros(3, np.float32))
    codes, sd = m.voxel_samples()
    common, ia, ib = np.intersect1d(codes, g["codes"], assume_unique=True,
                                    return_indices=True)
    assert codes.shape[0] + g["codes"].shape[0] - 2 * common.shape[0] <= 2
    assert np.abs(sd[ia] - g["sd"][ib]).max() <= STEP + 1e-7
    mesh = m.extract_mesh()
    r = vertex_rmse(mesh.vertices, g["vertices"])
    assert r["rmse_a_to_b"] < STEP / 10, r
    assert analytic_sphere_rmse(mesh.vertices, 2.0) < 1e-3


def test_rotation_and_finalize_match_jax(tmp_path):
    """Two scans 6 m apart rotate the active map into a submap (a pending
    stub until ``voxel_samples`` drains it); the union of both maps matches
    the JAX package's."""
    cfg = _small_cfg("xla")
    scans = [(_sphere(4096, 1.0, 5), np.zeros(3, np.float32)),
             (_sphere(4096, 1.0, 6, centre=(6.0, 0.0, 0.0)),
              np.asarray([6.0, 0.0, 0.0], np.float32))]
    jm = JaxTSDFMap(config=_jax(cfg))
    tm = TSDFMap(config=_small_cfg("fused"), device="cpu")
    for pts, pos in scans:
        jm.insert(pts, pos)
        tm.insert(pts, pos)
    assert tm.n_submaps == 1 == jm.n_submaps
    jc, jsd = jm.voxel_samples()
    tc, tsd = tm.voxel_samples()
    np.testing.assert_array_equal(tc, jc)
    assert np.abs(tsd - jsd).max() <= STEP + 1e-7
    tm.finalize_active()
    assert tm.n_submaps == 2 and tm.state is None
    tc2, _ = tm.voxel_samples()
    np.testing.assert_array_equal(tc2, jc)
    tm.save(str(tmp_path / "two.ply"))
    assert read_ply(str(tmp_path / "two.ply")).n_vertices > 0


def test_unported_options_raise(tmp_path, monkeypatch):
    # ported since: the sparse backend, packed ingest, the .grid dump,
    # device marching cubes, carving and the sample_tile backend (as the
    # backend and as the sparse one; nothing is left that raises)
    monkeypatch.chdir(tmp_path)
    for kw in ({"accumulate_impl": "seg"}, {"packed_ingest": True},
               {"accumulate_impl": "seg", "packed_ingest": True},
               {"save_grid": True}, {"mesh_impl": "device"},
               {"carve_steps": 4}, {"accumulate_impl": "sample_tile"},
               {"sparse_impl": "sample_tile"}):
        m = TSDFMap(config=MapConfig(max_points=1024, block_capacity=1024,
                                     touched_capacity=1024, **kw),
                    device="cpu")
        m.insert(_sphere(1024, 1.0, 1), np.zeros(3, np.float32))
        assert int(m.state.n_blocks) > 0
        if "save_grid" in kw or "mesh_impl" in kw:
            m.save(str(tmp_path / "m.ply"))
            assert read_ply(str(tmp_path / "m.ply")).n_faces > 0
            assert os.path.exists("hashgrid.grid") == ("save_grid" in kw)
            if "save_grid" in kw:
                os.remove("hashgrid.grid")


def test_port_imports_no_jax(tmp_path):
    """Importing the port — the KITTI module, the stream, mesh-scale,
    bench and GPU-equality scripts, ``utils``, the examples, the mesh
    modules, carving, checkpoints and the pose graph too — then a rotating
    two-scan packed ``seg`` stream with carving, ``stats()``, a save
    through device marching cubes with the ``.grid`` dump,
    ``leaf_arrays``, ``raycast``, ``merge``, a ``fused`` insert whose
    fallback runs, a checkpoint saved and loaded, a loop closure, ``insert_steps_scan`` and
    ``utils.timing.profile_insert``, and a 2-shard ``ShardedTSDFMap``
    insert on the CPU (the DAG built through the native runtime where g++
    builds it), loads neither jax nor any module of the JAX package.  It
    runs in a temporary directory: ``save`` writes ``hashgrid.grid``
    there."""
    code = """
import os, sys
import numpy as np
import chad_tsdf_tpu_torch, chad_tsdf_tpu_torch.core.map
import chad_tsdf_tpu_torch.kernels
import chad_tsdf_tpu_torch.io.kitti
import chad_tsdf_tpu_torch.scripts.kitti_stream
import chad_tsdf_tpu_torch.scripts.mesh_scale
import chad_tsdf_tpu_torch.profile_insert
import chad_tsdf_tpu_torch.utils, chad_tsdf_tpu_torch.utils.timing
import chad_tsdf_tpu_torch.examples.demo_sphere
import chad_tsdf_tpu_torch.examples.demo_kitti
import chad_tsdf_tpu_torch.examples.demo_loop_closure
import chad_tsdf_tpu_torch.examples.demo_carve
import chad_tsdf_tpu_torch.scripts.bench
import chad_tsdf_tpu_torch.scripts.gpu_equality
import chad_tsdf_tpu_torch.mesh.device_mc, chad_tsdf_tpu_torch.mesh.grid
import chad_tsdf_tpu_torch.mesh.optimize, chad_tsdf_tpu_torch.mesh.rmse
import chad_tsdf_tpu_torch.core.carve, chad_tsdf_tpu_torch.io.checkpoint
import chad_tsdf_tpu_torch.slam.posegraph
import chad_tsdf_tpu_torch.parallel, chad_tsdf_tpu_torch.parallel.distributed
from chad_tsdf_tpu_torch import TSDFMap, MapConfig
from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
rng = np.random.default_rng(0)
d = rng.normal(size=(4096, 3))
pts = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
cfg = MapConfig(max_points=4096, block_capacity=4096, touched_capacity=4096,
                accumulate_impl="seg", packed_ingest=True,
                mesh_impl="device", save_grid=True, carve_steps=8)
m = TSDFMap(config=cfg, device="cpu")
m.insert(pts, np.zeros(3, np.float32))
shift = np.float32([6.0, 0.0, 0.0])
assert m.insert(pts + shift, shift)["n_carve_samples"] > 0
assert m.stats()["n_submaps"] == 1
m.save("m.ply")
assert os.path.getsize("hashgrid.grid") > 20
assert m.raycast(np.zeros(3), pts[0]) is not None
other = TSDFMap(config=cfg, device="cpu")
other.insert(pts * 2, np.zeros(3, np.float32))
m.merge(other)
assert m.leaf_arrays()[0].shape[0] > 0
fused = MapConfig(max_points=4096, block_capacity=4096,
                  touched_capacity=4096, accumulate_impl="fused", tile_nb=16)
f = TSDFMap(config=fused, device="cpu")
f.insert(pts, np.zeros(3, np.float32))
save_checkpoint("c.npz", f)
assert int(load_checkpoint("c.npz", device="cpu").state.tile_overflow) > 0
loop = np.eye(4)
loop[:3, 3] = shift
assert m.optimize_loop_closures(loop_edges=[(0, 1, loop, 10.0)])[
    "iterations"] > 0
from chad_tsdf_tpu_torch.core import integrate
from chad_tsdf_tpu_torch.core.state import create_state
from chad_tsdf_tpu_torch.utils import StageTimer, profile_insert
import torch
t = StageTimer("cpu")
with t.stage("scan"):
    st = integrate.insert_steps_scan(create_state(fused, device="cpu"),
                                     torch.from_numpy(pts), 4096,
                                     torch.zeros(3), fused, 2)
st, _, report = profile_insert(st, torch.from_numpy(pts), 4096,
                               torch.zeros(3), fused)
assert int(st.n_blocks) > 0 and report.splitlines()[-1].startswith("total")
from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap, make_mesh
s = ShardedTSDFMap(config=MapConfig(max_points=2048, block_capacity=4096,
                                    touched_capacity=4096,
                                    accumulate_impl="xla"),
                   mesh=make_mesh(2, device="cpu"))
s.insert(pts, np.zeros(3, np.float32))
assert s.stats()["n_shards"] == 2 and s.voxel_samples()[0].shape[0] > 0
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "chad_tsdf_tpu" or k.startswith("chad_tsdf_tpu."))
assert not bad, bad
print("n_vertices", m.extract_mesh().n_vertices)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 0


def test_port_config_matches_jax():
    """The port's MapConfig copy has the JAX one's fields, defaults, derived
    properties and checks."""
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(MapConfig)]
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(JaxMapConfig)]
    assert tf == jf
    for kw in ({}, {"sdf_res": 0.1, "sdf_trunc": 0.3},
               {"max_points": 65536, "point_buckets": (8192, 20000)},
               {"max_steps": 7, "block_bits": 9}):
        t, j = MapConfig(**kw), JaxMapConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("dda_steps", "buckets", "blocks_per_axis",
                     "local_extent_m", "sample_capacity"):
            assert getattr(t, prop) == getattr(j, prop), prop
    for kw in ({"sdf_res": 0.0}, {"block_bits": 11},
               {"accumulate_impl": "nope"}, {"tile_nb": 12},
               {"normals_impl": "cuda"}, {"carve_steps": -1}):
        for cls in (MapConfig, JaxMapConfig):
            with pytest.raises(ValueError):
                cls(**kw)


@pytest.mark.parametrize("native", [False, True])
def test_port_dag_matches_jax(native):
    """The port's core/dag.py (numpy, or its native runtime built into the
    port's own _build/) builds the same node levels as the JAX package's on
    the same finalize input: two submaps of a CPU map, consed into both."""
    if native:
        from chad_tsdf_tpu_torch import native as t_native
        assert t_native.available(), "g++ did not build csrc/chadrt.cpp"
        assert os.path.dirname(t_native.SRC).startswith(
            os.path.join(ROOT, "chad_tsdf_tpu_torch"))
    cfg = _small_cfg("xla")
    levels = {"port": t_dag.NodeLevels(use_native=native),
              "jax": j_dag.NodeLevels(use_native=native)}
    roots = {k: [] for k in levels}
    for seed, r in ((7, 1.0), (8, 1.4)):
        m = TSDFMap(config=cfg, device="cpu")
        pos = np.zeros(3, np.float32)
        m.insert(_sphere(4096, r, seed), pos)
        for k, lv in levels.items():
            sm = t_submap.finalize(m.state, lv, cfg, [pos])
            roots[k].append((sm.root_addr_tsdf, sm.root_addr_weight,
                             sm.n_clusters, sm.n_voxels))
    assert roots["port"] == roots["jax"]
    tl, jl = levels["port"], levels["jax"]
    assert tl.native == jl.native == native
    assert tl.stats() == jl.stats()
    for a, b in zip(tl.nodes, jl.nodes):
        np.testing.assert_array_equal(a.raw, b.raw)
    np.testing.assert_array_equal(tl.leaf_clusters.raw, jl.leaf_clusters.raw)
    for root_t, _, _, _ in roots["port"]:
        for a, b in zip(tl.walk_leaf_clusters(root_t),
                        jl.walk_leaf_clusters(root_t)):
            np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda(monkeypatch):
    """TSDFMap, create_state and state_from_numpy run on the card unless the
    caller asks for the CPU; without a card they raise, never falling back
    to the CPU."""
    for fn in (TSDFMap.__init__, t_state.create_state,
               t_state.state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = MapConfig(max_points=1024, block_capacity=64, touched_capacity=64)
    fields = t_state.state_to_numpy(t_state.create_state(cfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TSDFMap(), lambda: t_state.create_state(cfg),
                 lambda: t_state.state_from_numpy(fields)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TSDFMap().device == torch.device("cuda")
    assert TSDFMap(device="cpu").device == torch.device("cpu")


def test_version_matches_jax():
    """The port carries the JAX package's version (its own copy of it)."""
    import chad_tsdf_tpu
    import chad_tsdf_tpu_torch
    assert chad_tsdf_tpu_torch.__version__ == chad_tsdf_tpu.__version__
