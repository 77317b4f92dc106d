"""K2: normals from segmented moments in one CUDA pass — counterpart of
``chad_tsdf_tpu/ops/normals_pallas.py``.

Same result as :func:`ops.normals.estimate_normals_soa` up to float
reassociation: for depth d a segment is a run of equal (block key,
offset >> 3d) among the Morton-sorted points; each point fits its plane
from the moment totals of the smallest depth whose segment has
``min_points`` members; padding points (key INT32_MAX) and points without
such a depth get the point->scanner direction.  The kernel
(``csrc/normals.cu``) sums each segment once, in index order, in
coordinates relative to the segment's first point.  (The TPU kernel
anchored at the block corner and summed with a tree-shaped scan; a
sequential f32 sum needs the nearer anchor to keep mm-scale covariances.)

The plain version is :func:`ops.normals.estimate_normals_soa` (segmented
scans, anchored at the first point of the coarsest segment); CPU tensors go
there.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import normals

INT32_MAX = 2**31 - 1


def estimate_normals(px, py, pz, block_keys, offsets, position,
                     min_points: int, max_depth: int):
    """K2.  Inputs (N,) in Morton-sorted order; padding points carry
    ``block_keys == INT32_MAX``; position f32[3].  Returns (nx, ny, nz)
    f32[N] unit normals, flipped toward the scanner."""
    if px.device.type == "cpu":
        return normals.estimate_normals_soa(
            px, py, pz, block_keys, offsets, block_keys != INT32_MAX,
            position, min_points, max_depth)
    n = px.shape[0]
    dev = px.device
    for name, a in (("px", px), ("py", py), ("pz", pz)):
        kernels.check(a, name, torch.float32, (n,), dev)
    kernels.check(block_keys, "block_keys", torch.int32, (n,), dev)
    kernels.check(offsets, "offsets", torch.int32, (n,), dev)
    kernels.check(position, "position", torch.float32, (3,), dev)
    tot = torch.empty((10 * max_depth, n), dtype=torch.float32, device=dev)
    starts = torch.empty((max_depth, n), dtype=torch.int32, device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("estimate_normals", p(px), p(py), p(pz), p(block_keys),
                   p(offsets), p(position), n, max_depth, float(min_points),
                   p(tot), p(starts), p(out))
    return out[0], out[1], out[2]
