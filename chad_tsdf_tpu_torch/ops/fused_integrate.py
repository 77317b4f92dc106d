"""K1: fused DDA + signed distance + tile accumulation — PyTorch port of
``chad_tsdf_tpu/ops/fused_integrate.py``.

For each tile of ``TILE`` Morton-sorted points the kernel
(``csrc/fused_integrate.cu``) walks every ray for K steps with the
Amanatides–Woo traversal of ops/dda.py (reference
include/chad/detail/octree.hpp:92-152), takes the projective signed
distance along the point's normal (octree.hpp:156-159) and the local
(block, offset) keys, and accumulates the samples into per-tile partial
block rows with K4's block list and ranks (``csrc/common.cuh``).  The
(K, N) sample grids never reach device memory.  Samples beyond a tile's
``nb`` distinct blocks are not accumulated; the caller recovers them through
K4 (core/integrate.py ``insert_step_fused``).

The plain version is that sequence in PyTorch: :func:`dda.local_sample_grids`
then :func:`tile_accum.tile_partials_plain`.  On the card the kernel equals
it bit for bit: the same voxels (see ops/dda.py on rounding), the same
block lists, and integer sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import dda, tile_accum

INT32_MAX = 2**31 - 1
TILE = tile_accum.TILE


def fused_tile_partials_plain(px, py, pz, nx, ny, nz, sb, position,
                              origin_voxel, *, nb: int, k: int, res: float,
                              trunc: float, extent: int):
    """Plain PyTorch K1: same outputs as :func:`fused_tile_partials`."""
    n = px.shape[0]
    t = n // TILE
    s_bkey, s_okey, sd, ok, samp_ovf = dda.local_sample_grids(
        px, py, pz, nx, ny, nz, sb != INT32_MAX, position, origin_voxel,
        res, trunc, k, extent)
    pkeys, psd, pw, ovfmask = tile_accum.tile_partials_plain(
        s_bkey, s_okey, sd, nb, trunc)

    def per_tile(m):
        return m.reshape(k, t, TILE).sum(dim=(0, 2), dtype=torch.int32)

    counts = torch.stack([per_tile(ok), per_tile(ovfmask),
                          per_tile(samp_ovf)], dim=1)
    return pkeys, psd, pw, counts


def fused_tile_partials(px, py, pz, nx, ny, nz, sb, position, origin_voxel,
                        *, nb: int, k: int, res: float, trunc: float,
                        extent: int):
    """K1 over Morton-sorted points.

    px..nz: f32[N] sorted coordinates and normals; sb: i32[N] sorted block
    key (INT32_MAX = padding); position: f32[3]; origin_voxel: i32[3].
    Returns (pkeys i32[T*nb, 1], psd f32[T*nb, 512], pw f32[T*nb, 512],
    counts i32[T, 3]) with T = N / TILE; ``counts[t]`` is tile t's
    [n_valid, n_not_covered, n_samp_ovf].  (The TPU kernel's (G*8, 128)
    counts layout served the TPU's tiling; only the column sums are read.)
    """
    n = px.shape[0]
    tile_accum.check_tile_shape(k, n)
    if px.device.type == "cpu":
        return fused_tile_partials_plain(
            px, py, pz, nx, ny, nz, sb, position, origin_voxel, nb=nb, k=k,
            res=res, trunc=trunc, extent=extent)
    dev = px.device
    for name, a in (("px", px), ("py", py), ("pz", pz), ("nx", nx),
                    ("ny", ny), ("nz", nz)):
        kernels.check(a, name, torch.float32, (n,), dev)
    kernels.check(sb, "sb", torch.int32, (n,), dev)
    kernels.check(position, "position", torch.float32, (3,), dev)
    kernels.check(origin_voxel, "origin_voxel", torch.int32, (3,), dev)
    t = n // TILE
    pkeys = torch.empty((t * nb, 1), dtype=torch.int32, device=dev)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=dev)
    pw = torch.empty_like(psd)
    counts = torch.empty((t, 3), dtype=torch.int32, device=dev)
    qscale, dscale = tile_accum.sd_scales(trunc)
    p = kernels.ptr
    kernels.launch(
        "fused_tile_partials", p(px), p(py), p(pz), p(nx), p(ny), p(nz),
        p(sb), p(position), p(origin_voxel), n, k, nb,
        float(np.float32(res)), dda.res_recip_f32(res),
        float(np.float32(trunc)), extent, qscale, dscale,
        p(pkeys), p(psd), p(pw), p(counts))
    return pkeys, psd, pw, counts
