"""Parity of the port's normals with the JAX package: K2's wrapper
(ops/normals_cuda.py) on CPU tensors, i.e. its plain version, the port's
segmented-scan form, against ``estimate_normals_pallas(interpret=True)``,
and the segmented-scan form against the JAX one.  Totals differ only by
float reassociation, so normals must agree as directions to 1e-3."""

import numpy as np
import jax.lax
import jax.numpy as jnp
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.ops import morton, normals, normals_pallas
from chad_tsdf_tpu_torch.ops import normals as t_normals
from chad_tsdf_tpu_torch.ops import normals_cuda

CFG = MapConfig()
INT32_MAX = 2**31 - 1
ORIGIN_VOXEL = np.asarray([-512 * 8] * 3, np.int32)


def _sort_cloud(pts, n_valid):
    n = pts.shape[0]
    local, _ = morton.points_to_local_voxels(
        jnp.asarray(pts), jnp.asarray(ORIGIN_VOXEL), 8192, CFG.sdf_res)
    bk = morton.encode_block(local[:, 0] >> 3, local[:, 1] >> 3,
                             local[:, 2] >> 3)
    ok = morton.encode_offset(local[:, 0] & 7, local[:, 1] & 7,
                              local[:, 2] & 7)
    invalid = jnp.arange(n) >= n_valid
    bk = jnp.where(invalid, INT32_MAX, bk)
    ok = jnp.where(invalid, INT32_MAX, ok)
    sb, so, perm = jax.lax.sort((bk, ok, jnp.arange(n, dtype=jnp.int32)),
                                num_keys=2)
    return np.asarray(pts)[np.asarray(perm)], np.asarray(sb), np.asarray(so)


def _sphere(n, r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _min_dot(jax_xyz, torch_xyz):
    a = np.stack([np.asarray(v) for v in jax_xyz], -1)
    b = np.stack([v.numpy() for v in torch_xyz], -1)
    return float(np.min(np.sum(a * b, axis=-1))), b


def _k2_pair(pts, sb, so, pos):
    j = normals_pallas.estimate_normals_pallas(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
        jnp.asarray(pts[:, 2]), jnp.asarray(sb), jnp.asarray(so),
        jnp.asarray(pos), CFG.normal_min_points, CFG.normal_max_depth,
        CFG.sdf_res, origin_voxel=jnp.asarray(ORIGIN_VOXEL), interpret=True)
    t = normals_cuda.estimate_normals(
        _t(pts[:, 0]), _t(pts[:, 1]), _t(pts[:, 2]), _t(sb), _t(so),
        _t(pos), CFG.normal_min_points, CFG.normal_max_depth)
    return j, t


@pytest.mark.parametrize("n,r,n_valid", [
    (2048, 1.0, 2048),     # dense: plane fits dominate
    (2048, 5.0, 2048),     # sparse: mostly fallback normals
    (1024, 1.0, 900),      # with padding points
])
def test_k2_plain_matches_pallas(n, r, n_valid):
    pts, sb, so = _sort_cloud(_sphere(n, r, 1), n_valid)
    pos = np.asarray([0.1, -0.2, 0.3], np.float32)
    j, t = _k2_pair(pts, sb, so, pos)
    dot, _ = _min_dot(j, t)
    assert dot > 1.0 - 1e-3, dot


def test_k2_plain_multi_tile_segment():
    """One segment of 16384 points with mm noise: the TPU kernel carried
    it across lane tiles; the port's plain version scans it relative to its
    first point.  All members share one normal."""
    n = 16384
    pts = np.tile(np.asarray([[1.012, 2.012, 3.012]], np.float32), (n, 1))
    pts += np.random.default_rng(0).normal(0, 1e-3, (n, 3)).astype(
        np.float32)
    pts, sb, so = _sort_cloud(pts, n)
    j, t = _k2_pair(pts, sb, so, np.zeros(3, np.float32))
    dot, b = _min_dot(j, t)
    assert dot > 1.0 - 1e-3, dot
    assert np.unique(b, axis=0).shape[0] <= 2


@pytest.mark.parametrize("r,n_valid", [(1.0, 2048), (5.0, 2048),
                                       (1.0, 1500)])
def test_segmented_scan_normals_match(r, n_valid):
    pts, sb, so = _sort_cloud(_sphere(2048, r, 2), n_valid)
    pos = np.asarray([0.1, -0.2, 0.3], np.float32)
    valid = sb != INT32_MAX
    j = normals.estimate_normals_soa(
        *(jnp.asarray(pts[:, i]) for i in range(3)), jnp.asarray(sb),
        jnp.asarray(so), jnp.asarray(valid), jnp.asarray(pos),
        CFG.normal_min_points, CFG.normal_max_depth)
    t = t_normals.estimate_normals_soa(
        *(_t(pts[:, i]) for i in range(3)), _t(sb), _t(so), _t(valid),
        _t(pos), CFG.normal_min_points, CFG.normal_max_depth)
    dot, _ = _min_dot(j, t)
    assert dot > 1.0 - 1e-3, dot
    # K2's wrapper on CPU tensors is this form, with validity from the keys
    k2 = normals_cuda.estimate_normals(
        *(_t(pts[:, i]) for i in range(3)), _t(sb), _t(so), _t(pos),
        CFG.normal_min_points, CFG.normal_max_depth)
    for a, b in zip(t, k2):
        assert torch.equal(a, b)


def test_k2_wrapper_rejects_non_cpu_non_cuda():
    """A tensor on neither the CPU nor a CUDA device never reaches the plain
    version: the wrapper raises."""
    x = torch.zeros(1024, device="meta")
    i = torch.zeros(1024, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        normals_cuda.estimate_normals(
            x, x, x, i, i, torch.zeros(3, device="meta"), 8, 3)
