"""The port's meshing against the JAX package's on the same inputs: device
marching cubes (``mesh/device_mc.py``, run on the CPU with
``device="cpu"``) against JAX's ``marching_cubes_device`` and the port's
host marching cubes on the voxel samples of a 20k-point sphere map (a
forced retry, large coordinates, no surface, no samples); the int64 weld
key against the host's uint64 key; the analytic r = 5 sphere against the
reference's mesh; the ``.grid`` dump byte for byte; contour optimization
and the RMSE tools; and ``TSDFMap``'s mesh surface (``mesh_impl``,
``extract_mesh`` options, ``save`` with ``save_grid`` and its split).
Tolerances: vertices within 1e-6 m of JAX's (its weld keeps the first copy
of a vertex, the host and the port the last, which may differ by a
rounding of the coordinate), the port's device and host meshes equal;
optimization within 1e-5 m."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu.mesh import device_mc as j_dmc
from chad_tsdf_tpu.mesh import grid as j_grid
from chad_tsdf_tpu.mesh import optimize as j_opt
from chad_tsdf_tpu.mesh import rmse as j_rmse
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.mesh import (device_mc, grid, mc, optimize,
                                      read_ply, rmse)
from chad_tsdf_tpu_torch.ops import codec, morton

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and fight the suite's
    other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_points(n, r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _map_cfg(**kw):
    return MapConfig(**{**dict(max_points=20480, block_capacity=4096,
                               touched_capacity=4096, accumulate_impl="xla"),
                        **kw})


@pytest.fixture(scope="module")
def samples():
    """The voxel samples of a 20k-point r = 1 m sphere map (block-boundary
    cells included), as tests/test_mesh.py builds them."""
    m = TSDFMap(config=_map_cfg(), device="cpu")
    m.insert(_sphere_points(20000, 1.0, 0), np.zeros(3, np.float32))
    codes, sd = m.voxel_samples()
    assert codes.shape[0] > 1000
    return codes, sd


@pytest.fixture(scope="module")
def jax_mesh(samples):
    return j_dmc.marching_cubes_device(*samples, RES)


def _analytic_sphere(r, res=RES, band=0.1, shift=(0, 0, 0)):
    """Every voxel within ``band`` of the sphere (tests/test_mesh.py's
    ``_sphere_samples``), its grid shifted by ``shift`` voxels."""
    n = int(np.ceil((r + 2 * band) / res)) + 1
    axis = np.arange(-n, n + 1, dtype=np.int32)
    vox = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                   -1).reshape(-1, 3)
    dist = np.linalg.norm(vox.astype(np.float64) * res, axis=1) - r
    sel = np.abs(dist) <= band
    codes = morton.np_encode63(vox[sel] + np.int32(shift))
    order = np.argsort(codes)
    sd = np.clip(-dist[sel], -band, band).astype(np.float32)
    return codes[order], sd[order]


def _face_set(faces):
    return {tuple(sorted(f)) for f in faces.tolist()}


def _assert_same_mesh(got, want, atol=1e-6):
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=atol)
    assert got.faces.shape == want.faces.shape
    assert _face_set(got.faces) == _face_set(want.faces)


def _assert_equal_mesh(a, b):
    for f in ("vertices", "faces", "vertex_normals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("cell_cap,chunk", [(None, None), (1024, None),
                                             (None, 5)])
def test_device_mc_matches_jax_and_host(samples, jax_mesh, cell_cap, chunk,
                                        monkeypatch):
    """Same vertex set (in the host weld's order) and face set as JAX's
    device MC; equal to the port's host MC, order included.  Pass 1's
    exact counts size pass 2, which then runs once; ``cell_cap=1024``
    overflows and retries, as in JAX.  ``chunk`` = 5 classifies the
    blocks five at a time (chunks end inside neighbour runs)."""
    if chunk is not None:
        monkeypatch.setattr(device_mc, "_CHUNK_BLOCKS", chunk)
    passes = []
    mesh_blocks = device_mc._mesh_blocks
    monkeypatch.setattr(device_mc, "_mesh_blocks",
                        lambda *a: passes.append(a[-2]) or mesh_blocks(*a))
    dev = device_mc.marching_cubes_device(*samples, RES, cell_cap=cell_cap,
                                          device="cpu")
    assert dev.n_faces > 1000
    _assert_same_mesh(dev, jax_mesh)
    _assert_equal_mesh(dev, mc.marching_cubes(*samples, RES))
    if cell_cap is None:
        assert len(passes) == 1
    else:
        assert len(passes) > 1 and passes[0] == 1024 and passes[-1] > 1024


@pytest.mark.parametrize("shift", [(1500, -900, 37),
                                   ((1 << 20) - 200, -(1 << 20) + 100, 5)])
def test_device_mc_equals_host_at_large_coordinates(shift):
    """Far from the origin a coordinate's rounding step grows, and the
    copies of one welded vertex (interpolated from two cells) may differ
    in the last bit: the device keeps the host's copy.  The second shift
    puts z across 0, where the host key drops its bit 64."""
    codes, sd = _analytic_sphere(1.0, shift=shift)
    _assert_equal_mesh(device_mc.marching_cubes_device(codes, sd, RES,
                                                       device="cpu"),
                       mc.marching_cubes(codes, sd, RES))


@pytest.mark.parametrize("case", ["no_surface", "empty"])
def test_device_mc_no_surface_and_empty(case):
    if case == "no_surface":     # all outside: no zero crossing
        coords = np.stack(np.meshgrid(np.arange(8), np.arange(8),
                                      np.arange(8), indexing="ij"),
                          -1).reshape(-1, 3)
        codes = np.sort(morton.np_encode63(coords.astype(np.int32)))
        sd = np.full(len(codes), 0.07, np.float32)
    else:
        codes, sd = np.zeros(0, np.uint64), np.zeros(0, np.float32)
    for mesh in (device_mc.marching_cubes_device(codes, sd, RES,
                                                 device="cpu"),
                 j_dmc.marching_cubes_device(codes, sd, RES),
                 mc.marching_cubes(codes, sd, RES)):
        assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)


def test_weld_key_order_matches_host_key():
    """The int64 weld key is the host's uint64 key ``(np_encode63(lo) << 2)
    | axis`` minus 2^63 (bit 64 dropped as the host drops it), so its
    signed order is the host key's order; JAX's u32 pair gives the same
    key (tests/test_mesh.py::test_device_weld_keys' coordinates)."""
    rng = np.random.default_rng(1)
    coords = rng.integers(-(1 << 20), (1 << 20) - 1,
                          size=(4096, 3)).astype(np.int32)
    coords[:8] = [[0, 0, 0], [-1, -1, -1], [1, 1, 1], [-1, 0, 0],
                  [0, -1, 0], [0, 0, -1], [(1 << 20) - 1] * 3,
                  [-(1 << 20)] * 3]
    axis = rng.integers(0, 3, size=4096).astype(np.int32)
    host_key = (morton.np_encode63(coords) << np.uint64(2)) | \
        axis.astype(np.uint64)
    key = device_mc.weld_key(torch.from_numpy(coords).long(),
                             torch.from_numpy(axis).long()).numpy()
    np.testing.assert_array_equal(key.view(np.uint64) ^ np.uint64(1 << 63),
                                  host_key)
    np.testing.assert_array_equal(np.argsort(key, kind="stable"),
                                  np.argsort(host_key, kind="stable"))
    khi, klo = j_dmc._canonical_key_pair(
        tuple(jnp.asarray(coords[:, k])[None, :] for k in range(3)),
        jnp.asarray(axis)[None, :])
    jkey = (np.asarray(khi)[0].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(klo)[0].astype(np.uint64)
    np.testing.assert_array_equal(jkey, host_key)


def test_reference_mesh_rmse():
    """The device mesh of the analytic r = 5 m sphere against the C++
    reference's mesh (tests/golden/reference_sphere.ply), the criterion of
    tests/test_mesh.py::test_reference_mesh_rmse; the port's RMSE tool
    gives JAX's numbers."""
    ref = read_ply(os.path.join(ROOT, "tests", "golden",
                                "reference_sphere.ply")).vertices
    codes, sd = _analytic_sphere(5.0)
    mesh = device_mc.marching_cubes_device(codes, sd, RES, device="cpu")
    stats = rmse.vertex_rmse(mesh.vertices, ref)
    assert stats["rmse"] < 0.1 / 127 + 0.5 * 0.05, stats
    assert stats == j_rmse.vertex_rmse(mesh.vertices, ref)
    assert rmse.analytic_sphere_rmse(mesh.vertices, 5.0) == \
        j_rmse.analytic_sphere_rmse(mesh.vertices, 5.0) < 0.01


def test_write_grid_bytes_match_jax(samples, tmp_path):
    codes, sd = samples
    grid.write_grid(str(tmp_path / "port.grid"), codes, sd, RES)
    j_grid.write_grid(str(tmp_path / "jax.grid"), codes, sd, RES)
    got = (tmp_path / "port.grid").read_bytes()
    assert got == (tmp_path / "jax.grid").read_bytes()
    _, cells, n_complete = grid.build_cells(codes, sd)
    n_pts, n_cells = np.frombuffer(got[4:20], np.uint64)
    assert (n_pts, n_cells) == (codes.shape[0], n_complete) == \
        (codes.shape[0], cells.shape[0])


def _quantized(sd):
    """8-bit codec noise, as a finalized submap carries."""
    q = codec.encode_sd(torch.from_numpy(sd), 0.1).numpy()
    return codec.np_decode_sd(q, 0.1).astype(np.float32)


def _plane_samples(normal, offset, half=1.0, band=0.1):
    """Voxels within ``band`` of the plane n.p = offset over a square patch
    (tests/test_mesh.py's ``_plane_samples``)."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    m = int(np.ceil(half / RES))
    axis = np.arange(-m, m + 1, dtype=np.int32)
    vox = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                   -1).reshape(-1, 3)
    dist = vox.astype(np.float64) * RES @ n - offset
    keep = np.abs(dist) <= band
    return morton.np_encode63(vox[keep]), dist[keep].astype(np.float32)


@pytest.mark.parametrize("method", ["planar", "taubin"])
def test_optimize_matches_jax(method):
    """Contour optimization of a quantized tilted plane (planar) and
    sphere (taubin): the port's copy moves every vertex where JAX's does,
    within 1e-5 m."""
    if method == "planar":
        codes, sd = _plane_samples([0.2, 0.1, 1.0], 0.1234)
        fn, jfn = optimize.optimize_planar_faces, j_opt.optimize_planar_faces
    else:
        codes, sd = _analytic_sphere(1.0)
        fn, jfn = optimize.taubin_smooth, j_opt.taubin_smooth
    mesh = mc.marching_cubes(codes, _quantized(sd), RES)
    assert mesh.n_faces > 100
    got, want = fn(mesh, 5), jfn(mesh, 5)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertex_normals, want.vertex_normals,
                               rtol=0, atol=1e-5)
    assert np.abs(got.vertices - mesh.vertices).max() > 1e-4


def test_map_mesh_surface(tmp_path, monkeypatch):
    """``TSDFMap`` on the CPU: ``mesh_impl="auto"`` meshes on the host,
    ``"device"`` through device MC (its torch ops on the CPU), both the
    same mesh; ``extract_mesh``'s optimization options; ``save`` with
    ``save_grid`` writes ``hashgrid.grid`` to the working directory, equal
    to ``save_grid`` and to JAX's dump, and records its split."""
    monkeypatch.chdir(tmp_path)
    pts = _sphere_points(4096, 1.0, 3)
    meshes = {}
    for impl in ("auto", "device"):
        m = TSDFMap(config=_map_cfg(mesh_impl=impl, save_grid=True,
                                    max_points=4096), device="cpu")
        m.insert(pts, np.zeros(3, np.float32))
        calls = device_mc.CALLS["marching_cubes_device"]
        m.save(str(tmp_path / f"{impl}.ply"))
        assert device_mc.CALLS["marching_cubes_device"] - calls == \
            (impl == "device")
        assert {"sub_fin_ms", "mesh_ms", "voxel_samples_ms", "mc_ms",
                "normals_ms", "grid_ms", "ply_ms"} <= set(m.last_metrics)
        assert m.last_metrics["mesh_ms"] >= m.last_metrics["mc_ms"]
        meshes[impl] = m.extract_mesh()
        assert read_ply(str(tmp_path / f"{impl}.ply")).n_faces == \
            meshes[impl].n_faces > 0
        m.save_grid(str(tmp_path / "explicit.grid"))
        j_grid.write_grid(str(tmp_path / "jax.grid"), *m.voxel_samples(),
                          m.sdf_res)
        dump = (tmp_path / "hashgrid.grid").read_bytes()
        assert dump == (tmp_path / "explicit.grid").read_bytes() == \
            (tmp_path / "jax.grid").read_bytes()
        os.remove(tmp_path / "hashgrid.grid")
    _assert_equal_mesh(meshes["auto"], meshes["device"])
    _assert_equal_mesh(m.extract_mesh(2, "taubin"),
                       optimize.taubin_smooth(meshes["device"], 2))
    with pytest.raises(ValueError, match="optimize_method"):
        m.extract_mesh(1, "nope")
