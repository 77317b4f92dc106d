"""The ``seg`` insert's ray samples as int64 sort keys, in one launch.

For each of N Morton-sorted points and each of K DDA steps the kernel
(``csrc/seg_samples.cu``) walks the ray with K1's traversal
(``csrc/common.cuh``, bit-equal to ops/dda.py), takes the projective
signed distance along the point's normal and the local (block, offset)
keys, and writes ``bkey << 32 | payload`` (``payload = offset << 16 |
sd16``, core/integrate.py ``pack_payload``), ``INT32_MAX << 32 | 0`` for a
sample that is not valid.  The JAX package has no kernel here: its ``seg``
insert leaves this work to XLA (``chad_tsdf_tpu/core/integrate.py``
``sparse_seg_entry_stream`` through ``compute_samples``).

The plain version is that sequence in PyTorch: :func:`dda.local_sample_grids`,
the payload and the key.  CPU tensors go there.  On the card the kernel
equals it bit for bit, keys and counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import dda, tile_accum

INT32_MAX = 2**31 - 1


def seg_samples_plain(px, py, pz, nx, ny, nz, sb, position, origin_voxel,
                      *, k: int, res: float, trunc: float, extent: int):
    """Plain PyTorch :func:`seg_samples`: same outputs."""
    s_bkey, s_okey, sd, ok, samp_ovf = dda.local_sample_grids(
        px, py, pz, nx, ny, nz, sb != INT32_MAX, position, origin_voxel,
        res, trunc, k, extent)
    q = tile_accum.quantize_sd(sd, trunc)
    payload = torch.where(ok, (s_okey << 16) | (q & 0xFFFF), 0)
    key = (s_bkey.to(torch.int64) << 32) | payload.to(torch.int64)
    return (key, ok.sum(dtype=torch.int32),
            samp_ovf.sum(dtype=torch.int32))


def seg_samples(px, py, pz, nx, ny, nz, sb, position, origin_voxel, *,
                k: int, res: float, trunc: float, extent: int):
    """The sample keys of N Morton-sorted points.

    px..nz: f32[N] sorted coordinates and normals; sb: i32[N] sorted block
    key (INT32_MAX = padding); position: f32[3]; origin_voxel: i32[3].
    Returns (key i64[K, N], n_valid i32[], samp_overflow i32[]): the
    samples' keys, the count of valid samples and that of traversed
    samples outside the local extent.  No host read.
    """
    if px.device.type == "cpu":
        return seg_samples_plain(px, py, pz, nx, ny, nz, sb, position,
                                 origin_voxel, k=k, res=res, trunc=trunc,
                                 extent=extent)
    n = px.shape[0]
    dev = px.device
    for name, a in (("px", px), ("py", py), ("pz", pz), ("nx", nx),
                    ("ny", ny), ("nz", nz)):
        kernels.check(a, name, torch.float32, (n,), dev)
    kernels.check(sb, "sb", torch.int32, (n,), dev)
    kernels.check(position, "position", torch.float32, (3,), dev)
    kernels.check(origin_voxel, "origin_voxel", torch.int32, (3,), dev)
    if k < 1:
        raise ValueError(f"k = {k}: the walk takes at least one step")
    key = torch.empty((k, n), dtype=torch.int64, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    if n == 0:
        return key, counts[0], counts[1]
    qscale, _ = tile_accum.sd_scales(trunc)
    p = kernels.ptr
    kernels.launch(
        "seg_samples", p(px), p(py), p(pz), p(nx), p(ny), p(nz), p(sb),
        p(position), p(origin_voxel), n, k, float(np.float32(res)),
        dda.res_recip_f32(res), float(np.float32(trunc)), extent, qscale,
        p(key), p(counts))
    return key, counts[0], counts[1]
