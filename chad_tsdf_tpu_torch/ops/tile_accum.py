"""Tile-parallel sample accumulation — PyTorch port of
``chad_tsdf_tpu/ops/tile_accum.py``.

Points are Morton-sorted, so each tile of ``TILE`` consecutive points (and
all their ray samples) touches a handful of distinct blocks.

* **K4** :func:`tile_partials`: per tile, the ascending list of the ``nb``
  smallest distinct block keys, each sample's rank in it, and per-tile
  partial block rows ``(nb, 512)`` of signed-distance sums and weights.
  Samples beyond the list are left out and flagged in ``ovfmask`` (never
  silently).  CUDA kernel ``csrc/tile_accum.cu``; plain version
  :func:`tile_partials_plain`.
* **K3** :func:`merge_partials`: adds slot-sorted partial rows into the
  pool in place, one 8-row pool group per CTA, following the plan of
  :func:`plan_merge`.  CUDA kernel ``csrc/tile_accum.cu``; plain version
  :func:`merge_partials_plain`.

Signed distances are summed as integers on the ``SD_QUANT`` grid of the
sort path's payload (core/integrate.py ``pack_payload``): integer sums do
not depend on their order, so the kernel is deterministic and equals its
plain version bit for bit.  Against an f32 sum the error is at most
``trunc / 65534`` per sample.  (The TPU kernel summed f32 on the MXU with
bf16 inputs; that rounding is not reproduced.)

The wrappers take the plain version for CPU tensors only; for a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .segops import boundary_flags, compact_flag_positions

INT32_MAX = 2**31 - 1
TILE = 1024          # points per tile (one CTA)
SD_QUANT = 32767.0   # fixed-point grid of summed signed distances


def sd_scales(sdf_trunc: float) -> tuple[float, float]:
    """(quantize, dequantize) f32 scales of the SD_QUANT grid."""
    return (float(np.float32(SD_QUANT / sdf_trunc)),
            float(np.float32(sdf_trunc / SD_QUANT)))


def quantize_sd(sd: torch.Tensor, sdf_trunc: float) -> torch.Tensor:
    """f32 sd -> int32 on the SD_QUANT grid, round half to even."""
    qscale, _ = sd_scales(sdf_trunc)
    return torch.clamp(torch.round(sd * qscale), -32767, 32767).to(
        torch.int32)


def check_tile_shape(k: int, n: int) -> None:
    """Shapes the tile kernels take (a K beyond shared memory makes the
    launch fail, and :func:`kernels.launch` raises)."""
    if n % TILE != 0:
        raise ValueError(f"tile kernels need N % {TILE} == 0, got {n}")
    if not 1 <= k <= 32:
        raise ValueError(f"tile kernels need 1 <= K <= 32 samples per "
                         f"point, got {k}")


# --------------------------------------------------------------------------
# K4: per-tile partial block rows
# --------------------------------------------------------------------------

def tile_partials_plain(bkey, okey, sd, nb: int, sdf_trunc: float):
    """Plain PyTorch K4: same outputs as :func:`tile_partials`."""
    k, n = bkey.shape
    t = n // TILE
    dev = bkey.device

    def tile_major(a):                       # (K, N) -> (T, K * TILE)
        return a.reshape(k, t, TILE).permute(1, 0, 2).reshape(t, k * TILE)

    sk, order = torch.sort(tile_major(bkey), dim=1, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    drank = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
    valid = sk != INT32_MAX
    cov = valid & (drank < nb)

    # the list: the nb smallest distinct keys (column nb collects the rest)
    lst = torch.full((t, nb + 1), INT32_MAX, dtype=torch.int32, device=dev)
    lst.scatter_(1, torch.where(first & cov, drank, nb), sk)
    pkeys = lst[:, :nb].reshape(t * nb, 1).contiguous()

    ovf_sorted = (valid & ~cov).to(torch.int32)
    ovf = torch.empty_like(ovf_sorted).scatter_(1, order, ovf_sorted)
    ovfmask = ovf.reshape(t, k, TILE).permute(1, 0, 2).reshape(k, n)

    off_s = torch.gather(tile_major(okey), 1, order).to(torch.int64)
    q_s = torch.gather(tile_major(quantize_sd(sd, sdf_trunc)), 1, order)
    tile_idx = torch.arange(t, device=dev)[:, None]
    flat = torch.where(cov, (tile_idx * nb + drank) * 512 + off_s, 0)
    flat = flat.reshape(-1)
    accq = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
    accq.index_add_(0, flat, torch.where(cov, q_s, 0).to(torch.int64)
                    .reshape(-1))
    accw = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
    accw.index_add_(0, flat, cov.to(torch.int64).reshape(-1))
    _, dscale = sd_scales(sdf_trunc)
    psd = (accq.to(torch.float32) * dscale).reshape(t * nb, 512)
    pw = accw.to(torch.float32).reshape(t * nb, 512)
    return pkeys, psd, pw, ovfmask.contiguous()


def tile_partials(bkey, okey, sd, nb: int, sdf_trunc: float):
    """K4.  bkey/okey: i32[K, N]; sd: f32[K, N]; N % TILE == 0; invalid
    samples carry ``bkey == INT32_MAX``.

    Returns (pkeys i32[T*nb, 1], psd f32[T*nb, 512], pw f32[T*nb, 512],
    ovfmask i32[K, N]) with T = N // TILE: unused list slots have key
    INT32_MAX and zero rows; ovfmask is 1 where a valid sample lies beyond
    its tile's list (those samples are not accumulated here).
    """
    k, n = bkey.shape
    check_tile_shape(k, n)
    if bkey.device.type == "cpu":
        return tile_partials_plain(bkey, okey, sd, nb, sdf_trunc)
    kernels.check(bkey, "bkey", torch.int32)
    kernels.check(okey, "okey", torch.int32, (k, n), bkey.device)
    kernels.check(sd, "sd", torch.float32, (k, n), bkey.device)
    t = n // TILE
    pkeys = torch.empty((t * nb, 1), dtype=torch.int32, device=bkey.device)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=bkey.device)
    pw = torch.empty_like(psd)
    ovfmask = torch.empty((k, n), dtype=torch.int32, device=bkey.device)
    qscale, dscale = sd_scales(sdf_trunc)
    p = kernels.ptr
    kernels.launch("tile_partials", p(bkey), p(okey), p(sd), n, k, nb,
                   qscale, dscale, p(pkeys), p(psd), p(pw), p(ovfmask))
    return pkeys, psd, pw, ovfmask


# --------------------------------------------------------------------------
# K3: merge slot-sorted partial rows into the pool
# --------------------------------------------------------------------------

def plan_merge(slot_sorted, n_valid, cb: int, g_cap: int):
    """Group table for :func:`merge_partials` over a slot-sorted stream.

    slot_sorted: i32[P] pool slot per partial, ascending; entries beyond
    ``n_valid`` (and any in the reserved last 8-row group) are excluded.
    Returns (n_groups i32[1], gstart, glen, grow: i32[g_cap], prow i32[P]).
    Live groups are distinct and ascending (boundary flags over an
    ascending group key), so K3's CTAs own disjoint pool windows; every
    dead entry has glen = 0 and the reserved group.
    """
    p = slot_sorted.shape[0]
    dev = slot_sorted.device
    reserved_group = cb // 8 - 1
    gkey = slot_sorted // 8
    live = (torch.arange(p, dtype=torch.int32, device=dev) < n_valid) & \
        (gkey != reserved_group)
    flags = boundary_flags(gkey) & live
    pos, g_count, _ = compact_flag_positions(flags, g_cap)
    gvalid = torch.arange(g_cap, dtype=torch.int32, device=dev) < g_count
    pos_c = torch.clamp(pos, max=p - 1)
    nxt = torch.cat([pos[1:], torch.full((1,), p, dtype=torch.int32,
                                         device=dev)])
    gstart = torch.where(gvalid, pos_c, 0)
    gend = torch.minimum(torch.clamp(nxt, max=p), n_valid.to(torch.int32))
    glen = torch.where(gvalid, torch.clamp(gend - pos_c, min=0), 0)
    grow = torch.where(gvalid, torch.clamp(gkey[pos_c], max=reserved_group),
                       reserved_group)
    prow = (slot_sorted - gkey * 8).to(torch.int32)
    return (g_count.reshape(1).to(torch.int32), gstart.to(torch.int32),
            glen.to(torch.int32), grow.to(torch.int32), prow)


def merge_partials_plain(pool_sd, pool_w, n_groups, gstart, glen, grow,
                         prow, src, psd, pw):
    """Plain PyTorch K3 (a row scatter-add): each touched pool row gets the
    sum of its partial rows, taken in sorted order, added once."""
    dev = pool_sd.device
    ng = int(n_groups[0])
    lens = glen[:ng].to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(ng, device=dev), lens)
    first = torch.repeat_interleave(
        gstart[:ng].to(torch.int64) - (torch.cumsum(lens, 0) - lens), lens)
    idx = torch.arange(gid.shape[0], device=dev) + first
    slot = grow[gid].to(torch.int64) * 8 + prow[idx].to(torch.int64)
    rows = src[idx].to(torch.int64)
    uslot, inv = torch.unique(slot, return_inverse=True)
    for pool, part in ((pool_sd, psd), (pool_w, pw)):
        acc = torch.zeros((uslot.shape[0], part.shape[1]), dtype=part.dtype,
                          device=dev)
        acc.index_add_(0, inv, part[rows])
        pool.index_add_(0, uslot, acc)
    return pool_sd, pool_w


def merge_partials(pool_sd, pool_w, n_groups, gstart, glen, grow, prow, src,
                   psd, pw):
    """K3.  Adds partial rows into the pool IN PLACE and returns it.

    pool_sd/pool_w: f32[Cb, 512]; n_groups i32[1] (read on the device);
    gstart/glen/grow: i32[G] from :func:`plan_merge`; prow i32[P] row in
    group per sorted partial; src i32[P] row of ``psd``/``pw`` (f32[P', 512])
    holding sorted partial i.
    """
    if pool_sd.device.type == "cpu":
        return merge_partials_plain(pool_sd, pool_w, n_groups, gstart, glen,
                                    grow, prow, src, psd, pw)
    dev = pool_sd.device
    cb = pool_sd.shape[0]
    g = gstart.shape[0]
    p = prow.shape[0]
    kernels.check(pool_sd, "pool_sd", torch.float32, (cb, 512))
    kernels.check(pool_w, "pool_w", torch.float32, (cb, 512), dev)
    kernels.check(n_groups, "n_groups", torch.int32, (1,), dev)
    for name, t in (("gstart", gstart), ("glen", glen), ("grow", grow)):
        kernels.check(t, name, torch.int32, (g,), dev)
    kernels.check(prow, "prow", torch.int32, (p,), dev)
    kernels.check(src, "src", torch.int32, (p,), dev)
    kernels.check(psd, "psd", torch.float32, None, dev)
    kernels.check(pw, "pw", torch.float32, tuple(psd.shape), dev)
    if psd.dim() != 2 or psd.shape[1] != 512:
        raise ValueError(f"psd: shape {tuple(psd.shape)}, expected (P, 512)")
    p_ = kernels.ptr
    kernels.launch("merge_partials", p_(pool_sd), p_(pool_w), p_(n_groups),
                   p_(gstart), p_(glen), p_(grow), p_(prow), p_(src),
                   p_(psd), p_(pw), g)
    return pool_sd, pool_w
