"""Fixed-budget Amanatides–Woo voxel traversal — PyTorch port of
``chad_tsdf_tpu/ops/dda.py``.

The reference walks each sensor ray through its truncation band with a
scalar loop of data-dependent length (reference:
include/chad/detail/octree.hpp:90-152).  Here every ray emits exactly K
(voxel, valid) slots, K chosen so no traversal is truncated
(``MapConfig.dda_steps``), as in the JAX package.

This module is also the plain twin of the DDA stage of kernel K1
(``csrc/fused_integrate.cu``), and the fused insert's fallback recomputes
K1's coverage through it.  On the card the two must give the same voxels
bit for bit, so every line below is one rounded PyTorch operation with no
fused multiply-add: ``p - d * trunc`` is a multiply, then a subtract, as
in the kernel, which is built with ``-fmad=false``.  ``res_recip`` is the
host-rounded f32 of ``1 / sdf_res``, the constant the kernel receives.

Semantics replicated exactly: the ray runs from ``point - dir*trunc`` to
``point + dir*trunc`` (octree.hpp:96-97); per-axis step =
sign(voxel_final - voxel_start) (:103); tMax from floor/ceil of the start
boundary, +inf (f32 max) on zero-step axes (:108-121); the axis with the
smallest tMax steps, with the nested-if tie-break of :128-148; a ray stops
(without emitting) once the stepped axis passes its final voxel; the start
voxel is always emitted (:124-125).
"""

from __future__ import annotations

import numpy as np
import torch

from . import morton

INT32_MAX = 2**31 - 1
_FMAX = float(np.float32(3.4028235e38))


def res_recip_f32(sdf_res: float) -> float:
    """The f32-rounded ``1 / sdf_res`` every DDA in the port multiplies by."""
    return float(np.float32(1.0 / sdf_res))


def _axis_setup(p, d, res: float, res_recip: float, trunc: float):
    start = p - d * trunc
    final = p + d * trunc
    vs = torch.floor(start * res_recip).to(torch.int32)
    vf = torch.floor(final * res_recip).to(torch.int32)
    sdir = torch.sign(vf - vs)
    d_recip = 1.0 / d
    delta = torch.abs(d_recip * res)
    bound = torch.where(sdir < 0, torch.floor(start * res_recip) * res,
                        torch.ceil(start * res_recip) * res)
    tmax = torch.abs((bound - start) * d_recip)
    tmax = torch.where(sdir == 0, _FMAX, tmax)
    delta = torch.where(sdir == 0, _FMAX, delta)
    return vs, vf, sdir, delta, tmax


def traverse(px, py, pz, position, sdf_res: float, sdf_trunc: float,
             num_steps: int):
    """Traverse rays through their truncation bands.

    px, py, pz: (N,) f32 world points (ray ends); position: (3,) f32 scanner
    position.  Returns (vx, vy, vz) (K, N) int32 world voxel coordinates and
    valid (K, N) bool.
    """
    res = float(np.float32(sdf_res))
    trunc = float(np.float32(sdf_trunc))
    res_recip = res_recip_f32(sdf_res)

    dx = px - position[0]
    dy = py - position[1]
    dz = pz - position[2]
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / norm
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    dir_ok = torch.isfinite(dx) & torch.isfinite(dy) & torch.isfinite(dz)

    vsx, vfx, sx, dlx, tx = _axis_setup(px, dx, res, res_recip, trunc)
    vsy, vfy, sy, dly, ty = _axis_setup(py, dy, res, res_recip, trunc)
    vsz, vfz, sz, dlz, tz = _axis_setup(pz, dz, res, res_recip, trunc)

    vx, vy, vz, alive = vsx, vsy, vsz, dir_ok
    out_x, out_y, out_z, out_v = [vx], [vy], [vz], [alive]
    for _ in range(num_steps - 1):
        # octree.hpp:128-148: if tx < ty: (tx < tz ? x : z)
        #                     else:        (ty < tz ? y : z)
        pick_x = (tx < ty) & (tx < tz)
        pick_y = (~(tx < ty)) & (ty < tz)
        pick_z = ~(pick_x | pick_y)
        vx = torch.where(pick_x, vx + sx, vx)
        vy = torch.where(pick_y, vy + sy, vy)
        vz = torch.where(pick_z, vz + sz, vz)
        tx = torch.where(pick_x, tx + dlx, tx)
        ty = torch.where(pick_y, ty + dly, ty)
        tz = torch.where(pick_z, tz + dlz, tz)
        passed = torch.where(
            pick_x, vx == vfx + sx,
            torch.where(pick_y, vy == vfy + sy, vz == vfz + sz))
        alive = alive & ~passed
        out_x.append(vx)
        out_y.append(vy)
        out_z.append(vz)
        out_v.append(alive)
    return (torch.stack(out_x), torch.stack(out_y), torch.stack(out_z),
            torch.stack(out_v))


def signed_distances(vx, vy, vz, px, py, pz, nx, ny, nz, sdf_res: float,
                     sdf_trunc: float):
    """Projective signed distance per traversed voxel (octree.hpp:156-159):
    ``clamp(dot(normal, voxel*res - point), -trunc, +trunc)``.
    vx/vy/vz: (K, N) int32; px...nz: (N,) -> (K, N) f32."""
    res = float(np.float32(sdf_res))
    trunc = float(np.float32(sdf_trunc))
    sd = (nx[None, :] * (vx.to(torch.float32) * res - px[None, :]) +
          ny[None, :] * (vy.to(torch.float32) * res - py[None, :]) +
          nz[None, :] * (vz.to(torch.float32) * res - pz[None, :]))
    return torch.clamp(sd, -trunc, trunc)


def local_sample_grids(px, py, pz, nx, ny, nz, valid_pt, position,
                       origin_voxel, sdf_res: float, sdf_trunc: float,
                       num_steps: int, extent: int):
    """DDA + signed distance + local (block, offset) keys: the sample
    grids of K1's first stage, in plain PyTorch.

    Returns ``(s_bkey, s_okey, sd, ok, samp_overflow_mask)``, all (K, N):
    keys INT32_MAX / offset 0 / sd 0 where the sample is not ``ok`` (not
    traversed, padding point, or outside the local extent); the last mask
    marks traversed samples that fell outside the extent.
    """
    vx, vy, vz, valid = traverse(px, py, pz, position, sdf_res, sdf_trunc,
                                 num_steps)
    sd = signed_distances(vx, vy, vz, px, py, pz, nx, ny, nz, sdf_res,
                          sdf_trunc)
    valid = valid & valid_pt[None, :]
    lx = vx - origin_voxel[0]
    ly = vy - origin_voxel[1]
    lz = vz - origin_voxel[2]
    in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                (lz >= 0) & (lz < extent))
    ok = valid & in_range
    lx = torch.clamp(lx, 0, extent - 1)
    ly = torch.clamp(ly, 0, extent - 1)
    lz = torch.clamp(lz, 0, extent - 1)
    s_bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    s_okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    s_bkey = torch.where(ok, s_bkey, INT32_MAX)
    s_okey = torch.where(ok, s_okey, 0)
    sd = torch.where(ok, sd, 0.0)
    return s_bkey, s_okey, sd, ok, valid & ~in_range
