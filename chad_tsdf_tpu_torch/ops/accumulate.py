"""Sample accumulation into the block pool — PyTorch port of
``chad_tsdf_tpu/ops/accumulate.py``.

* :func:`accumulate_xla`: the scatter form (the JAX package's portable
  path and the f32 twin that K5 is held to).
* :func:`group_touched_blocks`: the slot-sorted member tables and 8-row
  group tables of the JAX package, equal to it table for table.
* **K5** :func:`accumulate_segments`: the sort path's accumulate.  Each
  live member of the slot-sorted tables owns one pool row and one segment
  ``[start, start + len)`` of the block-sorted payload; the kernel adds
  ``onehot(offset)^T . [sd, 1]`` over that segment into the row.  CUDA
  kernel ``csrc/accumulate.cu``; plain version
  :func:`accumulate_segments_plain`.

K5 replaces the TPU kernel ``accumulate_pallas``.  Its 8-row DMA groups,
1024-sample aligned windows and per-member window re-scans are Mosaic's;
on CUDA member slots are distinct rows, so members run independently and
each reads only its own segment.  Signed distances are summed as int64 on
the SD_QUANT grid of the payload (``ops/tile_accum.py``): integer sums do
not depend on their order, so the kernel is deterministic and equals its
plain version bit for bit, and one voxel's segment may be any length.
The error against the f32 scatter is at most ``trunc / 65534`` per sample
(the payload's own rounding).  The TPU kernel's bf16 one-hot rounding is
not reproduced.

The wrappers take the plain version for CPU tensors only; for a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import kernels
from .segops import boundary_flags, compact_flag_positions
from .tile_accum import sd_scales

# pool rows per group: the last group of the pool is reserved, so a dummy
# slot never touches a live row (core/integrate.py _directory_update)
GROUP = 8


def accumulate_xla(pool_sd, pool_w, slots_per_sample, offsets, sd, valid):
    """Scatter-add samples into the pool IN PLACE; returns (pool_sd, pool_w).

    pool_sd/pool_w: f32[Cb, 512]; slots_per_sample/offsets: i32[S];
    sd: f32[S]; valid: bool[S].  Masked samples add zero to the last pool
    element, which belongs to the reserved row.  ``index_put_`` with
    ``accumulate=True`` sorts its indices on CUDA and sums duplicates in a
    fixed order, so the result is the same on every run.
    """
    cb = pool_sd.shape[0]
    idx = slots_per_sample.to(torch.int64) * 512 + offsets.to(torch.int64)
    idx = torch.where(valid, idx, cb * 512 - 1)
    pool_sd.view(-1).index_put_((idx,), torch.where(valid, sd, 0.0),
                                accumulate=True)
    pool_w.view(-1).index_put_((idx,), valid.to(torch.float32),
                               accumulate=True)
    return pool_sd, pool_w


def group_touched_blocks(starts, lens, slots, t_cap: int, cb: int):
    """Sort touched blocks by pool slot and bucket them into 8-row groups.

    Returns (n_groups i32[1], gstart, glen, grow, starts_s, lens_s,
    slots_s), all i32[T].  Dead entries carry the reserved slot ``cb - 1``
    (the maximum), so live members are a prefix of the slot-sorted tables;
    the last live group's ``glen`` stops at that prefix.  Dummy groups point
    at the reserved last group with zero length.
    """
    dev = slots.device
    reserved_group = cb // GROUP - 1
    slots_s, order = torch.sort(slots, stable=True)
    starts_s = starts[order]
    lens_s = lens[order]
    gkey = slots_s // GROUP
    live = gkey != reserved_group
    m_live = live.sum(dtype=torch.int32)
    flags = boundary_flags(gkey) & live
    pos, g_count, _ = compact_flag_positions(flags, t_cap)
    gvalid = torch.arange(t_cap, dtype=torch.int32, device=dev) < g_count
    pos_c = torch.clamp(pos, max=t_cap - 1)
    nxt = torch.cat([pos[1:], torch.full((1,), t_cap, dtype=torch.int32,
                                         device=dev)])
    gstart = torch.where(gvalid, pos_c, 0)
    glen = torch.where(gvalid,
                       torch.clamp(torch.minimum(nxt, m_live) - pos_c, min=0),
                       0)
    grow = torch.where(gvalid, torch.clamp(gkey[pos_c], max=reserved_group),
                       reserved_group)
    return (g_count.reshape(1).to(torch.int32), gstart.to(torch.int32),
            glen.to(torch.int32), grow.to(torch.int32),
            starts_s.to(torch.int32), lens_s.to(torch.int32),
            slots_s.to(torch.int32))


def accumulate_segments_plain(pool_sd, pool_w, starts, lens, slots, payload,
                              sdf_trunc: float):
    """Plain PyTorch K5: same result as :func:`accumulate_segments`, bit for
    bit (int64 sums per cell, scaled once, added once)."""
    dev = pool_sd.device
    cb = pool_sd.shape[0]
    live = (slots != cb - 1) & (lens > 0)
    ln = torch.where(live, lens, 0).to(torch.int64)
    first = torch.repeat_interleave(
        starts.to(torch.int64) - (torch.cumsum(ln, 0) - ln), ln)
    idx = torch.arange(first.shape[0], device=dev) + first
    slot = torch.repeat_interleave(slots.to(torch.int64), ln)
    p = payload[idx]
    cell = slot * 512 + ((p >> 16) & 0x1FF).to(torch.int64)
    ucell, inv = torch.unique(cell, return_inverse=True)
    accq = torch.zeros(ucell.shape[0], dtype=torch.int64, device=dev)
    accq.index_add_(0, inv, ((p << 16) >> 16).to(torch.int64))
    accw = torch.zeros_like(accq)
    accw.index_add_(0, inv, torch.ones_like(inv))
    _, dscale = sd_scales(sdf_trunc)
    flat_sd, flat_w = pool_sd.view(-1), pool_w.view(-1)
    flat_sd[ucell] = flat_sd[ucell] + accq.to(torch.float32) * dscale
    flat_w[ucell] = flat_w[ucell] + accw.to(torch.float32)
    return pool_sd, pool_w


def accumulate_segments(pool_sd, pool_w, starts, lens, slots, payload,
                        sdf_trunc: float):
    """K5.  Adds each member's samples into its pool row IN PLACE and
    returns (pool_sd, pool_w).

    pool_sd/pool_w: f32[Cb, 512]; starts/lens/slots: i32[T] members (the
    slot-sorted tables of :func:`group_touched_blocks`; live slots are
    distinct, dead ones are ``Cb - 1`` and are skipped on the device);
    payload: i32[S] block-sorted ``offset << 16 | sd_q16``.
    """
    if pool_sd.device.type == "cpu":
        return accumulate_segments_plain(pool_sd, pool_w, starts, lens,
                                         slots, payload, sdf_trunc)
    dev = pool_sd.device
    cb = pool_sd.shape[0]
    t = slots.shape[0]
    kernels.check(pool_sd, "pool_sd", torch.float32, (cb, 512))
    kernels.check(pool_w, "pool_w", torch.float32, (cb, 512), dev)
    for name, a in (("starts", starts), ("lens", lens), ("slots", slots)):
        kernels.check(a, name, torch.int32, (t,), dev)
    kernels.check(payload, "payload", torch.int32, None, dev)
    _, dscale = sd_scales(sdf_trunc)
    p = kernels.ptr
    kernels.launch("accumulate_segments", p(pool_sd), p(pool_w), p(starts),
                   p(lens), p(slots), p(payload), t, cb - 1, dscale)
    return pool_sd, pool_w
