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
on CUDA member slots are distinct rows, so members run independently.  The
work unit is a chunk of at most :data:`CHUNK` samples of one member's
segment (:func:`plan_chunks_plain`, built on the device inside the K5
call), so the kernel's time follows the number of samples, not the longest
segment.  Signed distances are summed as integers on the SD_QUANT grid of
the payload (``ops/tile_accum.py``), a multi-chunk member's chunks in an
int64 scratch row: integer sums do not depend on their order, so the
kernel is deterministic and equals its plain version bit for bit, and one
voxel's segment may be any length.
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
# K5's samples per chunk (kChunk of csrc/accumulate.cu)
CHUNK = 8192
# int32 words of K5's workspace before its chunk list: the chunk count and
# the overflow flag
_HEAD = 2

# per device: (int32 plan workspace, int64 and int32 scratch rows), grown
# when a call needs more and never shrunk; K5 leaves the scratch zero
_WORKSPACE: dict = {}


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


def plan_chunks_plain(lens, slots, cb: int, chunk: int):
    """K5's chunk list: each live member (slot not the reserved ``cb - 1``,
    ``len > 0``) split into ``ceil(len / chunk)`` chunks, in member order
    and in order within a member; dead members give none.

    Returns (member, index, scratch_row): i32[n] member and chunk index
    within it of each chunk, and i32[T] the scratch row of each member with
    more than one chunk (numbered in member order) or -1.  Chunk ``k`` of
    member ``m`` covers samples ``[k chunk, min((k + 1) chunk, len))`` of
    its segment.
    """
    dev = lens.device
    live = (slots != cb - 1) & (lens > 0)
    ln = lens.to(torch.int64)
    nch = torch.where(live, (ln + chunk - 1) // chunk, 0)
    member = torch.repeat_interleave(
        torch.arange(lens.shape[0], dtype=torch.int64, device=dev), nch)
    first = torch.repeat_interleave(torch.cumsum(nch, 0) - nch, nch)
    index = torch.arange(member.shape[0], device=dev) - first
    multi = nch > 1
    row = torch.where(multi, torch.cumsum(multi, 0) - 1, -1)
    return (member.to(torch.int32), index.to(torch.int32),
            row.to(torch.int32))


def _chunk_sizes(t: int, s: int, chunk: int):
    """(list capacity, scratch rows) for T members over a payload of S
    samples whose live segments are disjoint: sum(ceil(len / chunk)) <=
    T + S // chunk, and a multi-chunk member holds more than ``chunk``
    samples."""
    return t + s // chunk, max(1, min(t, s // (chunk + 1)))


def _check_tables(lens, slots, dev, t):
    for name, a in (("lens", lens), ("slots", slots)):
        kernels.check(a, name, torch.int32, (t,), dev)


def plan_chunks(lens, slots, cb: int, payload_len: int):
    """The device chunk list of K5 (the first phase of each K5 call, here
    alone), returned as :func:`plan_chunks_plain` returns it with
    :data:`CHUNK`; for checks, not the insert path (it reads the chunk
    count on the host).  Raises if the list outgrows its workspace.  Takes
    the plain version for CPU tensors."""
    if lens.device.type == "cpu":
        return plan_chunks_plain(lens, slots, cb, CHUNK)
    t = lens.shape[0]
    _check_tables(lens, slots, lens.device, t)
    cap, rows = _chunk_sizes(t, payload_len, CHUNK)
    ws = torch.empty(_HEAD + 2 * cap + t + rows, dtype=torch.int32,
                     device=lens.device)
    kernels.launch("plan_chunks", kernels.ptr(lens), kernels.ptr(slots), t,
                   cb - 1, cap, rows, kernels.ptr(ws))
    n, over = ws[:_HEAD].tolist()
    if over:
        raise RuntimeError("K5 chunk list outgrew its workspace: live "
                           "segments are not disjoint ranges of the payload")
    c0 = _HEAD + cap
    return ws[_HEAD:_HEAD + n], ws[c0:c0 + n], ws[c0 + cap:c0 + cap + t]


def _workspace(dev: torch.device, words: int, rows: int):
    """The device's cached K5 workspace, grown to ``words`` plan ints and
    ``rows`` zeroed scratch rows if it is smaller."""
    ws = _WORKSPACE.get(dev)
    if ws is None or ws[0].numel() < words or ws[1].shape[0] < rows:
        if torch.cuda.is_current_stream_capturing():
            # a capture would record the zeroing without running it, and
            # hand the graph's memory to later eager calls
            raise RuntimeError("K5's workspace must be allocated by an eager "
                               "call of the same shapes before a capture")
        if ws is not None:
            words = max(words, ws[0].numel())
            rows = max(rows, ws[1].shape[0])
        ws = (torch.empty(words, dtype=torch.int32, device=dev),
              torch.zeros((rows, 512), dtype=torch.int64, device=dev),
              torch.zeros((rows, 512), dtype=torch.int32, device=dev))
        _WORKSPACE[dev] = ws
    return ws


def overflowed(dev) -> bool:
    """Whether the device's last K5 call found a table whose chunk list
    outgrew its workspace (live segments that are not disjoint ranges of
    the payload) and so added nothing.  A host read, for checks; the insert
    path's tables always fit."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ws = _WORKSPACE.get(dev)
    return ws is not None and bool(ws[0][1])


def launch_segments(pool_sd, pool_w, starts, lens, slots, payload,
                    sdf_trunc: float):
    """Launch K5 on CUDA tensors; see :func:`accumulate_segments`.  The
    scratch is shared by the device's calls, so K5 runs on one stream at a
    time."""
    dev = pool_sd.device
    cb = pool_sd.shape[0]
    t = slots.shape[0]
    kernels.check(pool_sd, "pool_sd", torch.float32, (cb, 512))
    kernels.check(pool_w, "pool_w", torch.float32, (cb, 512), dev)
    kernels.check(starts, "starts", torch.int32, (t,), dev)
    _check_tables(lens, slots, dev, t)
    kernels.check(payload, "payload", torch.int32, None, dev)
    _, dscale = sd_scales(sdf_trunc)
    cap, rows = _chunk_sizes(t, payload.numel(), CHUNK)
    ws, scr_q, scr_w = _workspace(dev, _HEAD + 2 * cap + t + rows, rows)
    p = kernels.ptr
    kernels.launch("accumulate_segments", p(pool_sd), p(pool_w), p(starts),
                   p(lens), p(slots), p(payload), t, cb - 1, dscale, cap,
                   rows, p(ws), p(scr_q), p(scr_w))
    return pool_sd, pool_w


def accumulate_segments(pool_sd, pool_w, starts, lens, slots, payload,
                        sdf_trunc: float):
    """K5.  Adds each member's samples into its pool row IN PLACE and
    returns (pool_sd, pool_w).

    pool_sd/pool_w: f32[Cb, 512]; starts/lens/slots: i32[T] members (the
    slot-sorted tables of :func:`group_touched_blocks`; live slots are
    distinct, dead ones are ``Cb - 1`` and are skipped on the device);
    payload: i32[S] block-sorted ``offset << 16 | sd_q16``.

    Live segments must be disjoint ranges of the payload, as
    :func:`group_touched_blocks` gives them: the kernel's chunk list and
    scratch are sized by that, and a table that breaks it adds nothing on
    the device and sets :func:`overflowed`.
    """
    if pool_sd.device.type == "cpu":
        return accumulate_segments_plain(pool_sd, pool_w, starts, lens,
                                         slots, payload, sdf_trunc)
    return launch_segments(pool_sd, pool_w, starts, lens, slots, payload,
                           sdf_trunc)
