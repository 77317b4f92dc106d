"""K2: normals from segmented moments as a tile-parallel segmented reduction
on the card — counterpart of ``chad_tsdf_tpu/ops/normals_pallas.py``.

Same result as :func:`ops.normals.estimate_normals_soa` up to float
reassociation: for depth d a segment is a run of equal (block key,
offset >> 3d) among the Morton-sorted points; each point fits its plane
from the moment totals of the smallest depth whose segment has
``min_points`` members, in coordinates relative to the first point of its
coarsest segment; padding points (key INT32_MAX) and points without such a
depth get the point->scanner direction.  The kernel (``csrc/normals.cu``)
reduces each 1024-point tile's segment pieces in shared memory and
registers, adds the pieces of segments that cross tiles in tile order in a
small second pass, and fits in a third; every sum has one fixed order, so
the normals are the same bit for bit on every run.

The plain version is :func:`ops.normals.estimate_normals_soa` (segmented
scans, anchored at the first point of the coarsest segment); CPU tensors go
there.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import normals

INT32_MAX = 2**31 - 1
TILE = 1024          # points per CTA of the kernel's tile passes
MAX_DEPTH = 4        # offsets have 9 bits: depth 3 is already the block


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
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"max_depth {max_depth} outside 1..{MAX_DEPTH}")
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out[0], out[1], out[2]
    # per tile and depth: head / tail piece sums and segment totals (10
    # moments each), and [flag bits, anchor index] — a few hundred KB
    tiles = -(-n // TILE)
    part = torch.empty((tiles, max_depth, 2, 10), dtype=torch.float32,
                       device=dev)
    tot = torch.empty_like(part)
    meta = torch.empty((tiles, 2), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("estimate_normals", p(px), p(py), p(pz), p(block_keys),
                   p(offsets), p(position), n, max_depth, float(min_points),
                   p(part), p(tot), p(meta), p(out))
    return out[0], out[1], out[2]
