"""The port's public surface on the CPU: ``TSDFMap(device="cpu")`` insert +
save against the JAX ``TSDFMap``, the golden sphere workload of
tests/test_mesh.py, submap rotation, and that importing the port never
imports jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

from chad_tsdf_tpu import TSDFMap as JaxTSDFMap
from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.mesh.rmse import analytic_sphere_rmse, vertex_rmse
from chad_tsdf_tpu_torch import TSDFMap
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


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_map_insert_save_matches_jax(impl, tmp_path):
    pts = _sphere(4096, 1.0, 3)
    pos = np.asarray([0.05, -0.02, 0.01], np.float32)
    jm = JaxTSDFMap(config=_small_cfg("xla"))
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
    """Two scans 6 m apart rotate the active map into a submap (finalized
    synchronously in the port); the union of both maps matches the JAX
    package's."""
    cfg = _small_cfg("xla")
    scans = [(_sphere(4096, 1.0, 5), np.zeros(3, np.float32)),
             (_sphere(4096, 1.0, 6, centre=(6.0, 0.0, 0.0)),
              np.asarray([6.0, 0.0, 0.0], np.float32))]
    jm = JaxTSDFMap(config=cfg)
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


def test_unported_options_raise():
    for kw in ({"accumulate_impl": "seg"}, {"carve_steps": 4},
               {"packed_ingest": True}, {"mesh_impl": "device"}):
        with pytest.raises(NotImplementedError):
            TSDFMap(config=MapConfig(**kw), device="cpu")


def test_port_imports_no_jax():
    code = ("import sys; import chad_tsdf_tpu_torch, "
            "chad_tsdf_tpu_torch.core.map, chad_tsdf_tpu_torch.kernels; "
            "from chad_tsdf_tpu_torch import TSDFMap, MapConfig; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
