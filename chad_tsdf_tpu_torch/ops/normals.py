"""Normal estimation from Morton neighbourhoods — PyTorch port of
``chad_tsdf_tpu/ops/normals.py`` (its segmented-scan form).

The reference grows each point's neighbourhood by coarsening its Morton
prefix 3 bits at a time (up to 3 rounds) until it holds >= 8 points, fits a
plane with the weighted-determinant method, flips the normal toward the
scanner and falls back to the point->scanner direction (reference:
include/chad/detail/normals.hpp:10-148).  As in the JAX package, points are
sorted by local (block, offset) key; for depth d the points partition into
segments of equal ``offset >> 3d`` within a block; segment moments come from
segmented scans; each point uses the smallest depth whose full segment has
``min_points``.  Coordinates are taken relative to the first point of the
coarsest segment, so second moments do not cancel at world scale.

Kernel K2 (``ops/normals_cuda.py``) computes the same normals on the card
with a tile-parallel segmented reduction, anchored as here; this module is
K2's plain
version (the path of every CPU tensor) and the path under
``normals_impl="xla"``.
"""

from __future__ import annotations

import torch

from . import segops


def _plane_normal_from_moments(n, s, ss):
    """Weighted-determinant plane normal from segment moments
    (normals.hpp:10-80, in f32).

    ``n``: (N,) counts; ``s``: (3, N) coordinate sums; ``ss``: (6, N) sums
    of products (xx, xy, xz, yy, yz, zz), all relative to one shift per
    segment.  Returns unit normals (nx, ny, nz).
    """
    recip = 1.0 / torch.clamp(n, min=1.0)
    mx, my, mz = s[0] * recip, s[1] * recip, s[2] * recip
    xx = ss[0] * recip - mx * mx
    xy = ss[1] * recip - mx * my
    xz = ss[2] * recip - mx * mz
    yy = ss[3] * recip - my * my
    yz = ss[4] * recip - my * mz
    zz = ss[5] * recip - mz * mz

    # normalize the covariance scale: the reference computes in f64, and the
    # quartic weights below underflow f32 for mm-scale neighbourhoods
    m = torch.maximum(torch.abs(xx), torch.abs(xy))
    m = torch.maximum(m, torch.abs(xz))
    m = torch.maximum(m, torch.abs(yy))
    m = torch.maximum(m, torch.abs(yz))
    m = torch.maximum(m, torch.abs(zz))
    msc = 1.0 / torch.clamp(m, min=1e-30)
    xx, xy, xz = xx * msc, xy * msc, xz * msc
    yy, yz, zz = yy * msc, yz * msc, zz * msc

    det_x = yy * zz - yz * yz
    ax0, ax1, ax2 = det_x, xz * yz - xy * zz, xy * yz - xz * yy
    w = det_x * det_x
    wx, wy, wz = ax0 * w, ax1 * w, ax2 * w

    det_y = xx * zz - xz * xz
    ay0, ay1, ay2 = xz * yz - xy * zz, det_y, xy * xz - yz * xx
    w = det_y * det_y
    w = torch.where(wx * ay0 + wy * ay1 + wz * ay2 < 0.0, -w, w)
    wx, wy, wz = wx + ay0 * w, wy + ay1 * w, wz + ay2 * w

    det_z = xx * yy - xy * xy
    az0, az1, az2 = xy * yz - xz * yy, xy * xz - yz * xx, det_z
    w = det_z * det_z
    w = torch.where(wx * az0 + wy * az1 + wz * az2 < 0.0, -w, w)
    wx, wy, wz = wx + az0 * w, wy + az1 * w, wz + az2 * w

    norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    inv = 1.0 / torch.clamp(norm, min=1e-30)
    return wx * inv, wy * inv, wz * inv


def flip_and_fallback(nx, ny, nz, tx, ty, tz, use_fallback):
    """Flip plane normals toward the scanner (normals.hpp:117-118) and use
    the normalized point->scanner vector ``t`` where ``use_fallback``
    (normals.hpp:127-134)."""
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    tinv = 1.0 / torch.clamp(tn, min=1e-30)
    tx, ty, tz = tx * tinv, ty * tinv, tz * tinv
    flip = nx * tx + ny * ty + nz * tz < 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)
    return (torch.where(use_fallback, tx, nx),
            torch.where(use_fallback, ty, ny),
            torch.where(use_fallback, tz, nz))


def estimate_normals_soa(px, py, pz, block_keys, offsets, valid, position,
                         min_points: int = 8, max_depth: int = 3):
    """One unit normal per Morton-sorted point.

    px, py, pz: (N,) f32; block_keys / offsets: (N,) int32 local keys;
    valid: (N,) bool padding mask (invalid points get the fallback normal);
    position: (3,) scanner position.  Returns (nx, ny, nz), flipped toward
    the scanner.
    """
    n = px.shape[0]
    coarse_key = offsets >> (3 * (max_depth - 1))
    coarse_flags = segops.boundary_flags((block_keys, coarse_key)) | \
        segops.boundary_flags(valid)
    anchors = segops.segment_broadcast_first(
        coarse_flags, torch.stack([px, py, pz], dim=0))
    rx = px - anchors[0]
    ry = py - anchors[1]
    rz = pz - anchors[2]

    feats = torch.stack([
        torch.ones_like(rx), rx, ry, rz,
        rx * rx, rx * ry, rx * rz, ry * ry, ry * rz, rz * rz,
    ], dim=0)                                            # (10, N)

    best = torch.zeros((10, n), dtype=torch.float32, device=px.device)
    found = torch.zeros((n,), dtype=torch.bool, device=px.device)
    for depth in range(max_depth):
        key_d = offsets >> (3 * depth)
        flags = segops.boundary_flags((block_keys, key_d)) | \
            segops.boundary_flags(valid)
        run = segops.segmented_sum_scan(flags, feats)    # (10, N)
        seg = segops.segment_broadcast_last(flags, run)
        ok = (~found) & (seg[0] >= float(min_points))
        best = torch.where(ok[None, :], seg, best)
        found = found | ok

    nx, ny, nz = _plane_normal_from_moments(best[0], best[1:4], best[4:10])
    return flip_and_fallback(nx, ny, nz, position[0] - px, position[1] - py,
                             position[2] - pz, (~found) | (~valid))
