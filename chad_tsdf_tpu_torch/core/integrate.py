"""The insert pipeline — PyTorch port of ``chad_tsdf_tpu/core/integrate.py``.

Mirrors the reference hot path ``TSDFMap::insert`` (reference:
src/chad/tsdf.cpp:39-75):

  reference                                  this module
  ----------------------------------------  ------------------------------
  calc_morton_vector  morton.hpp:59-80    ->  local (block, offset) keys
  sort_morton_vector  morton.hpp:81-102   ->  one stable int64-key sort
  estimate_normals    normals.hpp:81-148  ->  K2 (or segmented scans)
  Octree::insert DDA  octree.hpp:92-152   ->  K1: DDA + sd + tile partials
  per-voxel upsert    octree.hpp:153-163  ->  directory update + K3 merge

Six backends, chosen by ``MapConfig.accumulate_impl``:

* ``fused`` (``auto`` on CUDA): :func:`insert_step_fused` — sort, normals,
  K1, then :func:`update_pool_tiled` (K3).  Samples beyond a tile's block
  list are recovered through K4 and the sort-based :func:`update_pool`.
* ``tile``: :func:`insert_step_tiled` — sort, normals, the plain DDA's
  sample grids, K4, K3, and the same fallback.
* ``sample_tile`` (a ``sparse_impl`` choice for sparse scans):
  :func:`insert_step_sample_tiled` — sample grids, one global sample sort,
  K4 over 1024-sample tiles of the sorted stream (list of
  ``sparse_tile_nb`` blocks; on the card the kernel made for a sorted
  stream, ``tile_accum.tile_partials_sorted``), K3; samples beyond a tile's list go through
  the sort-based :func:`update_pool`.
* ``pallas``: sample grids, one global sample sort, and :func:`update_pool`
  through K5.
* ``xla`` (``auto`` on CPU): as ``pallas``, with the scatter-form
  accumulate.
* ``seg`` (what ``TSDFMap`` dispatches sparse scans to on CUDA, under
  ``auto``): :func:`insert_step_sparse_seg` — the samples' sort keys
  (``ops/seg_samples.py``, one kernel on CUDA), one sort by (block,
  offset), per-voxel integer sums, and a scatter of one entry per unique
  voxel.  No tiles, no fallback, no kernel beyond K2 and ``seg_samples``,
  and no host read.

:func:`insert_step_packed` takes the int16 scanner-relative points of
``MapConfig.packed_ingest`` (:func:`pack_points`) and dequantizes them on
the device before any of the above.

:func:`update_pool` accumulates through K5 (``ops/accumulate.py``
``accumulate_segments``) under ``pallas`` and, for every backend but
``xla``, on CUDA — where the JAX package runs ``accumulate_pallas`` on the
TPU — and through the scatter form otherwise.

Counters and overflow semantics are those of the JAX package.  Where the
JAX package branches on a device value (``lax.cond`` / ``lax.switch``), the
port either computes both ways unconditionally (the directory rebuild is
one sort of <= block_capacity + touched_capacity keys), sizes the work
statically and masks (K3's and K5's grids), or, for the fallback of the
fused, tile and sample-tiled paths, leaves the branch to the caller
(:func:`insert_body`).
In a CUDA graph (``core/graph.py``, what ``TSDFMap.insert`` replays on the
card) the branch is an IF node decided on the device
(``ops/conditional.py``); the graph's eager step runs the fallback
unconditionally, which changes nothing when no sample needs it.
:func:`insert_step_deferred` returns the insert's :class:`FallbackTail`,
which copies the count of uncovered samples into pinned host memory
behind an event and runs the fallback only when the caller settles it
(the sharded map does at its next insert or read).  No backend reads the
device on the host during an insert; the settle's wait is the one host
wait (``utils/timing.py`` ``COUNTS["host_syncs"]``) that
:func:`insert_step`, which settles at once, adds.

:func:`insert_steps_scan` inserts one padded cloud ``reps`` times (the
JAX package's ``lax.scan`` over the insert, what bench.py times): on CUDA
as replays of one cached graph, one graph launch each, with no host read.

The state passed in is consumed: its pool planes are updated in place
(the JAX package donates them), and the returned state shares them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from ..utils import timing

from ..ops import (accumulate, dda, fused_integrate, morton, normals,
                   normals_cuda, seg_samples, segops, tile_accum)
from .state import INT32_MAX, ActiveMapState, clone_state, state_nbytes

SD_QUANT = tile_accum.SD_QUANT

# profile_insert.py sets this to a callable(name) that it calls where a
# stage of the sort-based and seg inserts ends; None costs one comparison
STAGE_HOOK = None


def _stage(name: str) -> None:
    if STAGE_HOOK is not None:
        STAGE_HOOK(name)


class SampleBatch(NamedTuple):
    """Flat ray samples: ``payload = offset << 16 | sd_q16``."""
    bkey: torch.Tensor           # i32[S] block key, INT32_MAX = invalid
    payload: torch.Tensor        # i32[S]
    pt_overflow: torch.Tensor    # i32[] points outside the local extent
    samp_overflow: torch.Tensor  # i32[] samples outside the local extent


def pack_payload(okey, sd, sdf_trunc: float):
    q = tile_accum.quantize_sd(sd, sdf_trunc)
    return (okey << 16) | (q & 0xFFFF)


def unpack_payload(payload, sdf_trunc: float):
    okey = (payload >> 16) & 0x1FF
    q = (payload << 16) >> 16          # arithmetic shift sign-extends
    _, dscale = tile_accum.sd_scales(sdf_trunc)
    return okey, q.to(torch.float32) * dscale


def _zero(device):
    return torch.zeros((), dtype=torch.int32, device=device)


def point_keys_soa(px, py, pz, n_points, origin_blocks,
                   config: MapConfig):
    """Local Morton keys per point; padding (rows from ``n_points``, an int
    or an i32[] tensor on the points' device) and out-of-extent points get
    INT32_MAX keys.  Returns (bkey, okey, pt_overflow)."""
    n = px.shape[0]
    extent = config.blocks_per_axis * 8
    idx = torch.arange(n, dtype=torch.int32, device=px.device)
    in_cloud = idx < n_points
    origin_voxel = origin_blocks * 8
    inv = dda.res_recip_f32(config.sdf_res)
    # floor(p / res) exactly as the reference (morton.hpp:71)
    lx = torch.floor(px * inv).to(torch.int32) - origin_voxel[0]
    ly = torch.floor(py * inv).to(torch.int32) - origin_voxel[1]
    lz = torch.floor(pz * inv).to(torch.int32) - origin_voxel[2]
    in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                (lz >= 0) & (lz < extent))
    valid_pt = in_cloud & in_range
    pt_overflow = (in_cloud & ~in_range).sum(dtype=torch.int32)
    lx = torch.clamp(lx, 0, extent - 1)
    ly = torch.clamp(ly, 0, extent - 1)
    lz = torch.clamp(lz, 0, extent - 1)
    bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    bkey = torch.where(valid_pt, bkey, INT32_MAX)
    okey = torch.where(valid_pt, okey, INT32_MAX)
    return bkey, okey, pt_overflow


def sort_points_soa(px, py, pz, bkey, okey):
    """Sort points by (block, offset) key (tsdf.cpp:64-65): one stable sort
    of the int64 key ``bkey << 32 | okey`` (INT32_MAX padding last), then a
    gather of the coordinates.  Returns (sb, so, px, py, pz)."""
    key = (bkey.to(torch.int64) << 32) | okey.to(torch.int64)
    _, order = torch.sort(key, stable=True)
    return bkey[order], okey[order], px[order], py[order], pz[order]


def _use_kernel_normals(config: MapConfig, device: torch.device) -> bool:
    if config.normals_impl == "pallas":
        return True
    if config.normals_impl == "xla":
        return False
    return device.type == "cuda"


def estimate_normals_dispatch(px, py, pz, sb, so, position, origin_blocks,
                              config: MapConfig):
    """Per-point normals over Morton-sorted points (tsdf.cpp:67): K2 under
    ``normals_impl="pallas"`` and, under ``auto``, on CUDA; the segmented-
    scan form otherwise."""
    if _use_kernel_normals(config, px.device):
        return normals_cuda.estimate_normals(
            px, py, pz, sb, so, position, config.normal_min_points,
            config.normal_max_depth)
    return normals.estimate_normals_soa(
        px, py, pz, sb, so, sb != INT32_MAX, position,
        config.normal_min_points, config.normal_max_depth)


def sample_grids(px, py, pz, nx, ny, nz, sb, position, origin_blocks,
                 config: MapConfig):
    """DDA + signed distances over sorted points with known normals.
    Returns (s_bkey, s_okey, sd, n_valid, samp_overflow) with (K, N)
    grids (INT32_MAX key = invalid slot)."""
    s_bkey, s_okey, sd, ok, samp_ovf = dda.local_sample_grids(
        px, py, pz, nx, ny, nz, sb != INT32_MAX, position,
        origin_blocks * 8, config.sdf_res, config.sdf_trunc,
        config.dda_steps, config.blocks_per_axis * 8)
    return (s_bkey, s_okey, sd, ok.sum(dtype=torch.int32),
            samp_ovf.sum(dtype=torch.int32))


def sorted_with_normals(points, n_points, position, origin_blocks,
                        config: MapConfig):
    """The front of every insert: local keys, one Morton sort and the
    normals of a padded cloud.  Returns (px, py, pz, nx, ny, nz, sb,
    pt_overflow): the points, their normals and block keys in sorted
    order, and the count of points outside the local extent."""
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    bkey, okey, pt_overflow = point_keys_soa(px, py, pz, n_points,
                                             origin_blocks, config)
    sb, so, px, py, pz = sort_points_soa(px, py, pz, bkey, okey)
    _stage("keys + sort")
    nx, ny, nz = estimate_normals_dispatch(px, py, pz, sb, so, position,
                                           origin_blocks, config)
    _stage("normals K2")
    return px, py, pz, nx, ny, nz, sb, pt_overflow


def compute_samples(points, n_points, position, origin_blocks,
                    config: MapConfig) -> SampleBatch:
    """Morton sort + normals + DDA: points -> flat packed samples."""
    px, py, pz, nx, ny, nz, sb, pt_overflow = sorted_with_normals(
        points, n_points, position, origin_blocks, config)
    s_bkey, s_okey, sd, _, samp_overflow = sample_grids(
        px, py, pz, nx, ny, nz, sb, position, origin_blocks, config)
    payload = pack_payload(s_okey, sd, config.sdf_trunc)
    payload = torch.where(s_bkey != INT32_MAX, payload, 0)
    _stage("DDA + payload")
    return SampleBatch(s_bkey.reshape(-1), payload.reshape(-1), pt_overflow,
                       samp_overflow)


def sort_samples(batch: SampleBatch) -> SampleBatch:
    b, order = torch.sort(batch.bkey, stable=True)
    return SampleBatch(b, batch.payload[order], batch.pt_overflow,
                       batch.samp_overflow)


def _directory_update(state: ActiveMapState, tb_keys, tvalid,
                      config: MapConfig):
    """Look up touched-block keys in the sorted directory, allocate pool
    slots for new blocks and rebuild the directory (reference
    octree.hpp:31-78, without the hashmap).

    Returns (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
    block_overflow); overflowed/invalid entries get the reserved slot
    ``cb - 1``.  The rebuild always runs: with no new block it returns the
    old directory unchanged, and it saves the host read a branch would
    need.
    """
    cb = config.block_capacity
    reserved_row = cb - 1
    # the last 8-row group is reserved so dead entries never touch a live row
    usable_blocks = cb - accumulate.GROUP

    pos = torch.searchsorted(state.dir_keys, tb_keys).to(torch.int32)
    pos_c = torch.clamp(pos, max=cb - 1)
    found = (state.dir_keys[pos_c] == tb_keys) & tvalid
    is_new = tvalid & ~found
    new_rank = torch.cumsum(is_new, 0, dtype=torch.int32)
    n_new = new_rank[-1]
    slot_if_new = state.n_blocks + new_rank - 1
    fits = slot_if_new < usable_blocks
    block_overflow = (is_new & ~fits).sum(dtype=torch.int32)
    tb_slots = torch.where(found, state.dir_slots[pos_c],
                           torch.where(fits, slot_if_new, reserved_row))
    tb_slots = torch.where(tvalid, tb_slots, reserved_row).to(torch.int32)

    append = is_new & fits
    mk = torch.cat([state.dir_keys, torch.where(append, tb_keys, INT32_MAX)])
    ms = torch.cat([state.dir_slots,
                    torch.where(append, slot_if_new, 0).to(torch.int32)])
    mk, order = torch.sort(mk, stable=True)
    dir_keys = mk[:cb].contiguous()
    dir_slots = ms[order[:cb]]
    n_blocks = torch.clamp(state.n_blocks + n_new, max=usable_blocks)
    return dir_keys, dir_slots, n_blocks, tb_slots, n_new, block_overflow


def _touched_blocks(sorted_keys, t_cap: int):
    """Touched-block segments of a key-sorted stream: (flags, starts_full,
    t_count, touched_overflow, tvalid, tb_keys).  ``starts_full`` holds
    t_cap + 1 segment starts, so the end of the last kept segment is
    known."""
    total = sorted_keys.shape[0]
    flags = segops.boundary_flags(sorted_keys) & (sorted_keys != INT32_MAX)
    starts_full, _, t_total = segops.compact_flag_positions(flags, t_cap + 1)
    t_count = torch.clamp(t_total, max=t_cap)
    touched_overflow = torch.clamp(t_total - t_cap, min=0)
    tvalid = torch.arange(t_cap, dtype=torch.int32,
                          device=sorted_keys.device) < t_count
    starts_c = torch.clamp(starts_full[:t_cap], max=total - 1)
    tb_keys = torch.where(tvalid, sorted_keys[starts_c], INT32_MAX)
    return flags, starts_full, t_count, touched_overflow, tvalid, tb_keys


def _slot_per_entry(flags, tb_slots, t_cap: int, reserved_row: int):
    """Pool slot of each entry of a key-sorted stream (dense segment fill)
    and whether the entry's block was kept."""
    t_idx = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    slot = tb_slots[torch.clamp(t_idx, 0, t_cap - 1)]
    return slot, (t_idx < t_cap) & (slot != reserved_row)


def _use_segment_kernel(config: MapConfig, device: torch.device) -> bool:
    """K5 route of :func:`update_pool` (the JAX package's ``_use_pallas``,
    with CUDA in the TPU's role)."""
    if config.accumulate_impl == "pallas":
        return True
    if config.accumulate_impl == "xla":
        return False
    return device.type == "cuda"


def plan_segments(state: ActiveMapState, sorted_keys, n_valid_samples,
                  config: MapConfig):
    """Directory update and K5's member tables for a block-sorted stream.

    Returns (directory, tables, t_count, touched_overflow): ``directory``
    is :func:`_directory_update`'s tuple and ``tables`` the slot-sorted
    (starts, lens, slots) of :func:`accumulate.group_touched_blocks`.  Each
    touched block's segment is [start, start + len) of the stream, as in
    the JAX package's update_pool; blocks that got the reserved slot have
    no samples.
    """
    cb = config.block_capacity
    t_cap = config.touched_capacity
    total = sorted_keys.shape[0]
    (_, starts_full, t_count, touched_overflow, tvalid,
     tb_keys) = _touched_blocks(sorted_keys, t_cap)
    directory = _directory_update(state, tb_keys, tvalid, config)
    tb_slots = directory[3]
    starts = starts_full[:t_cap]
    ends = torch.minimum(starts_full[1:], n_valid_samples)
    lens = torch.where(tvalid & (tb_slots != cb - 1),
                       torch.clamp(ends - starts, min=0), 0)
    tables = accumulate.group_touched_blocks(
        torch.clamp(starts, max=total - 1), lens, tb_slots, t_cap, cb)[4:]
    return directory, tables, t_count, touched_overflow


def update_pool(state: ActiveMapState, batch: SampleBatch,
                config: MapConfig):
    """Touched-block segmentation, directory merge and accumulate of a
    block-sorted sample batch (:func:`sort_samples`) into the pool: K5 on
    its route (:func:`_use_segment_kernel`), the scatter form otherwise.
    Returns (new_state, metrics)."""
    t_cap = config.touched_capacity
    reserved_row = config.block_capacity - 1
    s_bkey = batch.bkey
    valid = s_bkey != INT32_MAX
    n_valid_samples = valid.sum(dtype=torch.int32)
    if _use_segment_kernel(config, s_bkey.device):
        directory, tables, t_count, touched_overflow = plan_segments(
            state, s_bkey, n_valid_samples, config)
        pool_sd, pool_w = accumulate.accumulate_segments(
            state.pool_sd, state.pool_w, *tables, batch.payload,
            config.sdf_trunc)
    else:
        flags, _, t_count, touched_overflow, tvalid, tb_keys = \
            _touched_blocks(s_bkey, t_cap)
        directory = _directory_update(state, tb_keys, tvalid, config)
        s_okey, s_sd = unpack_payload(batch.payload, config.sdf_trunc)
        slot, kept = _slot_per_entry(flags, directory[3], t_cap,
                                     reserved_row)
        pool_sd, pool_w = accumulate.accumulate_xla(
            state.pool_sd, state.pool_w, slot, s_okey, s_sd, valid & kept)
    (dir_keys, dir_slots, n_blocks, _, n_new, block_overflow) = directory

    new_state = dataclasses.replace(
        state, dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w,
        point_overflow=state.point_overflow + batch.pt_overflow,
        sample_overflow=state.sample_overflow + batch.samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow)
    metrics = {"n_valid_samples": n_valid_samples,
               "n_touched_blocks": t_count, "n_new_blocks": n_new,
               "n_blocks": n_blocks}
    return new_state, metrics


def plan_tiled_merge(state: ActiveMapState, pkeys, config: MapConfig):
    """Directory update and K3 plan for a stream of per-tile partial rows.

    Returns (directory, plan, t_count, touched_overflow): ``directory`` is
    :func:`_directory_update`'s tuple and ``plan`` the arguments
    (n_groups, gstart, glen, grow, prow, src) of
    :func:`tile_accum.merge_partials`.
    """
    cb = config.block_capacity
    t_cap = config.touched_capacity
    reserved_row = cb - 1
    p = pkeys.shape[0]
    sk, order = torch.sort(pkeys.reshape(-1), stable=True)
    flags, _, t_count, touched_overflow, tvalid, tb_keys = _touched_blocks(
        sk, t_cap)
    directory = _directory_update(state, tb_keys, tvalid, config)
    tb_slots = directory[3]

    # per-partial pool slot, then sort by slot so each 8-row pool group
    # sees a contiguous range of partials (dead rows -> reserved, last)
    slot, kept = _slot_per_entry(flags, tb_slots, t_cap, reserved_row)
    slot = torch.where((sk != INT32_MAX) & kept, slot, reserved_row)
    slot_s, perm = torch.sort(slot, stable=True)
    src = order[perm].to(torch.int32)
    n_live = (slot_s != reserved_row).sum(dtype=torch.int32)
    # distinct live groups never exceed cb/8 - 1 nor the touched count
    g_cap = min(t_cap, cb // 8, p)
    plan = tile_accum.plan_merge(slot_s, n_live, cb, g_cap) + (src,)
    return directory, plan, t_count, touched_overflow


def update_pool_tiled(state: ActiveMapState, pkeys, psd, pw, tile_ovf,
                      n_valid_samples, samp_overflow, pt_overflow,
                      config: MapConfig):
    """Merge per-tile partial block rows into the pool.

    pkeys: i32[P, 1] per-tile sorted block lists (pad INT32_MAX); psd/pw:
    f32[P, 512] partial rows; tile_ovf: i32[] uncovered samples.  Every row
    count goes through K3: a CUDA row scatter with duplicate slots would
    sum in no fixed order.  (The JAX package scattered below 32768 rows,
    a TPU grid-overhead measurement that does not carry over.)
    """
    directory, plan, t_count, touched_overflow = plan_tiled_merge(
        state, pkeys, config)
    (dir_keys, dir_slots, n_blocks, _, n_new, block_overflow) = directory
    pool_sd, pool_w = tile_accum.merge_partials(
        state.pool_sd, state.pool_w, *plan, psd, pw)

    new_state = dataclasses.replace(
        state, dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w,
        point_overflow=state.point_overflow + pt_overflow,
        sample_overflow=state.sample_overflow + samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow,
        tile_overflow=state.tile_overflow + tile_ovf)
    metrics = {"n_valid_samples": n_valid_samples,
               "n_touched_blocks": t_count, "n_new_blocks": n_new,
               "n_blocks": n_blocks}
    return new_state, metrics


def insert_body(state: ActiveMapState, points, n_points, position,
                config: MapConfig):
    """Integrate one padded point cloud into the active map, leaving the
    fallback of the fused, tile and sample-tiled paths to the caller.

    points: f32[N, 3] world points on the state's device, padded;
    n_points: the number of valid rows, an int or an i32[] tensor on the
    state's device (a CUDA graph replays with a new count in the same
    tensor); position: f32[3] scanner position.  Returns (new_state,
    metrics dict of device scalars, tile_ovf, make_fallback): under
    ``fused``, ``tile`` and ``sample_tile`` the count of samples no tile's
    block list holds and the closure that makes the fallback's samples
    (:func:`_apply_fallback` runs it where the count is positive), under
    the other backends None and None.
    """
    impl = _accumulate_impl(config, state.device)
    if impl == "fused":
        return _fused_body(state, points, n_points, position, config)
    if impl == "tile":
        return _tiled_body(state, points, n_points, position, config)
    if impl == "sample_tile":
        return _sample_tiled_body(state, points, n_points, position, config)
    if impl in ("pallas", "xla"):
        # global sample sort; update_pool picks K5 or the scatter form
        batch = compute_samples(points, n_points, position,
                                state.origin_blocks, config)
        state, metrics = update_pool(state, sort_samples(batch), config)
        return state, metrics, None, None
    if impl == "seg":
        state, metrics = insert_step_sparse_seg(state, points, n_points,
                                                position, config)
        return state, metrics, None, None
    raise ValueError(f"unknown accumulate_impl {impl!r}")


def insert_step_deferred(state: ActiveMapState, points, n_points,
                         position, config: MapConfig):
    """:func:`insert_body` with the fallback of the fused, tile and
    sample-tiled paths deferred.  Returns (new_state, metrics dict of
    device scalars, tail): ``tail`` is None, or the :class:`FallbackTail`
    that must be settled (:func:`settle`) before anything else reads or
    updates the state.
    """
    state, metrics, tile_ovf, make_fallback = insert_body(
        state, points, n_points, position, config)
    tail = None if tile_ovf is None else \
        FallbackTail(tile_ovf, make_fallback, config)
    return state, metrics, tail


def insert_step(state: ActiveMapState, points, n_points, position,
                config: MapConfig):
    """:func:`insert_step_deferred`, settled at once: the fused, tile and
    sample-tiled paths wait here for their count of uncovered samples.
    Returns (new_state, metrics dict of device scalars)."""
    state, metrics, tail = insert_step_deferred(state, points, n_points,
                                                position, config)
    if tail is not None:
        state = settle(tail, state, metrics)
    return state, metrics


def pack_points(points: np.ndarray, position: np.ndarray,
                sdf_res: float) -> np.ndarray:
    """Host-side packing for :func:`insert_step_packed` (numpy, exact
    round-half-even): i16[N, 3] scanner-relative fixed point with step
    ``sdf_res / 8``.  Points beyond +-32767 steps of the scanner clamp —
    they lie outside the local map extent anyway."""
    step = sdf_res / 8.0
    q = points.astype(np.float64)       # the one f64 buffer, updated in place
    q -= np.asarray(position, np.float64)
    q /= step
    np.rint(q, out=q)
    np.clip(q, -32767, 32767, out=q)
    return q.astype(np.int16)


def pack_points_device(points, position, sdf_res: float):
    """:func:`pack_points` on the points' device, bit-equal to it: the same
    f64 subtraction and division, round-half-even and clip.  What the CUDA
    graph of a packed-ingest insert runs (``core/graph.py``), where the
    host's f64 numpy pass would cost more than the bytes it saves."""
    step = sdf_res / 8.0
    q = points.to(torch.float64) - position.to(torch.float64)
    q = torch.clamp(torch.round(q / step), -32767, 32767)
    return q.to(torch.int16)


def insert_step_packed(state: ActiveMapState, qpoints, n_points,
                       position, config: MapConfig):
    """Packed-ingest insert (``MapConfig.packed_ingest``): ``qpoints`` is
    i16[N, 3] from :func:`pack_points`, half the bytes of the f32 cloud on
    the way to the device; world points = q * step + position, computed
    here on the device (a multiply and an add, each rounded to f32)."""
    return insert_step(state, unpack_points(qpoints, position, config),
                       n_points, position, config)


def unpack_points(qpoints, position, config: MapConfig):
    """World points of a :func:`pack_points` cloud, on its device."""
    step = config.sdf_res / 8.0
    return qpoints.to(torch.float32) * step + position[None, :]


def sparse_seg_entry_stream(points, n_points, position, origin_blocks,
                            config: MapConfig):
    """Sparse-insert front half: one entry per UNIQUE VOXEL of one cloud.

    Sort, segmented sum, compact.  Returns ``(e_b, e_okey, e_sd_q, e_w,
    e_total, n_valid_samples, batch)``: the entry tensors are (S,) with
    the live entries an ascending-(block, offset) prefix ``[:e_total]`` and
    INT32_MAX block keys, zero sums and zero weights beyond.  ``e_sd_q``
    (int64) is the voxel's sum of 16-bit signed-distance quanta and
    ``e_w`` (int32) its sample count; :func:`seg_entries_update` scales
    the sum to metres.

    The samples come as the int64 keys ``bkey << 32 | payload`` of
    ``ops/seg_samples.py`` (one kernel launch on CUDA, its plain version on
    the CPU); ``batch`` holds its ``bkey`` and ``payload`` as views of the
    keys' two 32-bit halves, in (K, N) sample order.  The keys are sorted
    once: the payload (``offset << 16 | sd16``) is non-negative, so this is
    the JAX package's two-key sort, and invalid samples (INT32_MAX, 0) come
    last.  The sums are integer: an int64 running sum read at each voxel's
    last sample, less its value at the previous voxel's.  Integer sums have
    no order, so two runs are bit-equal, and they are exact for any number
    of samples in a voxel (the JAX package carries the sum in f32, exact up
    to 2^24 / 32767 = 512 samples a voxel).  Nothing here reads the device
    from the host: the entries are compacted at the fixed capacity S.

    A separate function so that a sharded map can route entry streams
    (one consolidated entry per voxel) between shards.
    """
    px, py, pz, nx, ny, nz, sb, pt_overflow = sorted_with_normals(
        points, n_points, position, origin_blocks, config)
    key, n_valid_samples, samp_overflow = seg_samples.seg_samples(
        px, py, pz, nx, ny, nz, sb, position, origin_blocks * 8,
        k=config.dda_steps, res=config.sdf_res, trunc=config.sdf_trunc,
        extent=config.blocks_per_axis * 8)
    key = key.reshape(-1)
    # the key's two 32-bit halves, low word first: (payload, bkey)
    halves = key.view(torch.int32).view(-1, 2)
    batch = SampleBatch(halves[:, 1], halves[:, 0], pt_overflow,
                        samp_overflow)
    _stage("DDA + payload")
    s = key.shape[0]
    dev = key.device
    key, _ = torch.sort(key)
    sb = (key >> 32).to(torch.int32)
    valid = sb != INT32_MAX
    okey = ((key >> 16) & 0x1FF).to(torch.int32)
    q = ((key << 48) >> 48)                      # sign-extended sd16, int64
    _stage("2-key sort")

    # a voxel ends where the next sample has another (block, offset) — the
    # step from the last valid sample to the first invalid one included
    vkey = key >> 16
    is_end = torch.ones(s, dtype=torch.bool, device=dev)
    is_end[:-1] = vkey[1:] != vkey[:-1]
    live_end = is_end & valid
    run = torch.cumsum(torch.where(valid, q, 0), 0)
    _stage("segmented sum")

    # valid samples are a prefix of the stream, so voxel j starts right
    # after voxel j - 1 ends: sums and counts are differences at the ends
    end_pos, _, e_total = segops.compact_flag_positions(live_end, s)
    ev = torch.arange(s, dtype=torch.int32, device=dev) < e_total
    at = torch.clamp(end_pos, max=s - 1)
    run_end = run[at]
    prev_run = torch.zeros_like(run_end)
    prev_run[1:] = run_end[:-1]
    prev_pos = torch.full_like(end_pos, -1)
    prev_pos[1:] = end_pos[:-1]
    e_b = torch.where(ev, sb[at], INT32_MAX)
    e_okey = torch.where(ev, okey[at], 0)
    e_sd_q = torch.where(ev, run_end - prev_run, 0)
    e_w = torch.where(ev, end_pos - prev_pos, 0)
    _stage("compaction")
    return e_b, e_okey, e_sd_q, e_w, e_total, n_valid_samples, batch


def seg_entries_update(state: ActiveMapState, pool_sd, pool_w, e_b, e_okey,
                       e_sd_q, e_w, config: MapConfig):
    """Sparse-insert back half: directory update and pool scatter over a
    block-sorted entry stream, IN PLACE on ``pool_sd`` / ``pool_w``.

    ``e_b`` must be ascending with INT32_MAX marking dead entries (a merged
    stream of several clouds works unchanged).  ``e_sd_q`` is in 16-bit
    quanta; the scaling to metres happens here.  Returns ``(pool_sd,
    pool_w, dir_keys, dir_slots, n_blocks, t_count, n_new, block_overflow,
    touched_overflow)``.

    The scatter is one ``index_add_`` per plane.  Dead entries (padding,
    blocks beyond a capacity) add zero into the reserved row, spread over
    its 512 elements so that they do not queue on one address; an index
    outside the pool would be a device-side assert on CUDA, not a dropped
    write.  The entries of one cloud are unique per (block, offset), so
    each live element gets one addend and the result does not depend on
    the order of the adds; duplicate entries are legal and sum.
    """
    cb = config.block_capacity
    e_cap = e_b.shape[0]
    # each entry opens at most one block, so touched capacity beyond the
    # stream's length is dead shape
    t_cap = min(config.touched_capacity, e_cap)
    reserved_row = cb - 1
    flags, _, t_count, touched_overflow, tvalid, tb_keys = _touched_blocks(
        e_b, t_cap)
    (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
     block_overflow) = _directory_update(state, tb_keys, tvalid, config)
    e_slot, kept = _slot_per_entry(flags, tb_slots, t_cap, reserved_row)
    _stage("directory")

    ok = (e_b != INT32_MAX) & kept
    lane = torch.arange(e_cap, dtype=torch.int64, device=e_b.device) & 511
    idx = torch.where(ok, e_slot.to(torch.int64) * 512 + e_okey,
                      reserved_row * 512 + lane)
    e_sd = e_sd_q.to(torch.float32) * (config.sdf_trunc / SD_QUANT)
    pool_sd.view(-1).index_add_(0, idx, torch.where(ok, e_sd, 0.0))
    pool_w.view(-1).index_add_(0, idx,
                               torch.where(ok, e_w, 0).to(torch.float32))
    _stage("scatter")
    return (pool_sd, pool_w, dir_keys, dir_slots, n_blocks, t_count, n_new,
            block_overflow, touched_overflow)


def insert_step_sparse_seg(state: ActiveMapState, points, n_points,
                           position, config: MapConfig):
    """Sparse-cloud insert: voxel-sorted segment sums, then a scatter of
    one entry per unique voxel — no tiles, no fallback, ``tile_overflow``
    untouched, and no host read.

    LiDAR-shaped clouds (a dozen points per block, a few samples per voxel)
    overflow every per-point tile's block list, so the tiled backends send
    them through their fallback.  This path reduces first and scatters
    last (:func:`sparse_seg_entry_stream`, :func:`seg_entries_update`): the
    samples in one kernel on CUDA, the rest in plain tensor operations.
    The JAX package picks an entry bucket of S/4 .. S by the live count to
    shorten its scatter; that choice reads the count on the host and does
    not change the result (the entries are a prefix), so the port runs the
    one capacity S.

    Replaces the reference's per-sample hashmap upsert (octree.hpp:153-163)
    at its outdoor-LiDAR operating point.
    """
    (e_b, e_okey, e_sd_q, e_w, _, n_valid_samples,
     batch) = sparse_seg_entry_stream(points, n_points, position,
                                      state.origin_blocks, config)
    (pool_sd, pool_w, dir_keys, dir_slots, n_blocks, t_count, n_new,
     block_overflow, touched_overflow) = seg_entries_update(
        state, state.pool_sd, state.pool_w, e_b, e_okey, e_sd_q, e_w, config)
    new_state = dataclasses.replace(
        state, dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w,
        point_overflow=state.point_overflow + batch.pt_overflow,
        sample_overflow=state.sample_overflow + batch.samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow)
    metrics = {"n_valid_samples": n_valid_samples,
               "n_touched_blocks": t_count, "n_new_blocks": n_new,
               "n_blocks": n_blocks}
    return new_state, metrics


def _masked_grids(s_bkey, s_okey, sd, ovfmask, config: MapConfig):
    """The fallback's samples of the fused and tile paths: the sample
    grids' samples that ``ovfmask`` marks as uncovered, as flat (bkey,
    payload) with INT32_MAX keys and zero payloads elsewhere."""
    fb_key = torch.where(ovfmask, s_bkey, INT32_MAX).reshape(-1)
    payload = torch.where(ovfmask, pack_payload(s_okey, sd, config.sdf_trunc),
                          0)
    return fb_key, payload.reshape(-1)


def _fallback(state: ActiveMapState, fb_key, payload, config: MapConfig):
    """The samples no tile's block list covered (``fb_key`` INT32_MAX
    elsewhere) go, sorted again, through the sort-based
    :func:`update_pool`; returns (state, n_new)."""
    zero = _zero(fb_key.device)
    batch = sort_samples(SampleBatch(fb_key, payload, zero, zero))
    state, m = update_pool(state, batch, config)
    return state, m["n_new_blocks"]


class FallbackTail:
    """The undecided end of a fused, tile or sample-tiled insert (the JAX
    package's ``lax.cond`` on ``tile_ovf``, integrate.py:652-675 and
    :730-735).

    Whether any sample fell outside its tile's block list is known only on
    the device.  Instead of reading that count on the host, the insert
    copies it into pinned host memory (``non_blocking``) and records an
    event behind the copy; the tail keeps what the fallback needs alive
    (``make_fallback``, a closure over the sorted points and normals, over
    the tile path's grids, or over the sample-tiled path's sorted
    samples and K4's mask).  :func:`settle` waits for the event, normally
    long done by then, and runs the fallback only when the count is
    non-zero.  The pool updates keep the JAX order as long as the tail is
    settled before anything else touches the state.
    """

    def __init__(self, tile_ovf, make_fallback, config: MapConfig):
        self.make_fallback = make_fallback
        self.config = config
        if tile_ovf.device.type == "cuda":
            self.flag = torch.empty((), dtype=torch.int32, pin_memory=True)
            self.flag.copy_(tile_ovf, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(tile_ovf.device))
        else:
            self.flag, self.copied = tile_ovf, None

    def needed(self) -> bool:
        """Whether the fallback must run: waits for the copy's event (one
        host wait in ``timing.COUNTS``, on the CPU too), then reads the
        host word (no tensor method, so the host-read counters of
        ``scripts/kitti_stream.py`` see no read of the device)."""
        timing.wait(self.copied)
        return ctypes.c_int32.from_address(self.flag.data_ptr()).value > 0


def settle(tail: FallbackTail, state: ActiveMapState, metrics) -> \
        ActiveMapState:
    """Run ``tail``'s fallback on ``state`` if it is needed and add what it
    allocated into ``metrics``' ``n_new_blocks`` and ``n_blocks`` (as
    differences, so metrics summed over several clouds stay sums)."""
    if not tail.needed():
        return state
    return _apply_fallback(tail.make_fallback, state, metrics, tail.config)


def _apply_fallback(make_fallback, state: ActiveMapState, metrics,
                    config: MapConfig) -> ActiveMapState:
    """:func:`settle`'s fallback, run unconditionally."""
    n_blocks0 = state.n_blocks
    state, extra_new = _fallback(state, *make_fallback(), config)
    metrics["n_new_blocks"] = metrics["n_new_blocks"] + extra_new
    metrics["n_blocks"] = metrics["n_blocks"] + (state.n_blocks - n_blocks0)
    return state


def insert_step_fused(state: ActiveMapState, points, n_points,
                      position, config: MapConfig):
    """Fused insert: Morton point sort -> normals -> K1 (DDA + signed
    distance + per-tile partial rows) -> K3 merge.

    The (K, N) sample grids never exist in device memory unless the
    returned :class:`FallbackTail` finds, when settled, that K1 could not
    fit some samples into their tile's block list: then the grids are
    recomputed, K4 marks exactly the samples K1 left out, and those go
    through the sort-based :func:`update_pool`.  Returns (state, metrics,
    tail).
    """
    state, metrics, tile_ovf, make_fallback = _fused_body(
        state, points, n_points, position, config)
    return state, metrics, FallbackTail(tile_ovf, make_fallback, config)


def _fused_body(state: ActiveMapState, points, n_points, position,
                config: MapConfig):
    """The fused insert without its tail: (state, metrics, tile_ovf,
    make_fallback), the count of uncovered samples and the closure that
    recomputes the grids and makes the fallback's samples."""
    origin_blocks = state.origin_blocks
    px, py, pz, nx, ny, nz, sb, pt_overflow = sorted_with_normals(
        points, n_points, position, origin_blocks, config)
    pkeys, psd, pw, counts = fused_integrate.fused_tile_partials(
        px, py, pz, nx, ny, nz, sb, position, origin_blocks * 8,
        nb=config.tile_nb, k=config.dda_steps, res=config.sdf_res,
        trunc=config.sdf_trunc, extent=config.blocks_per_axis * 8)
    totals = counts.sum(dim=0, dtype=torch.int32)
    n_valid, tile_ovf, samp_overflow = totals[0], totals[1], totals[2]
    state, metrics = update_pool_tiled(state, pkeys, psd, pw, tile_ovf,
                                       n_valid, samp_overflow, pt_overflow,
                                       config)

    def make_fallback():
        s_bkey, s_okey, sd, _, _ = sample_grids(
            px, py, pz, nx, ny, nz, sb, position, origin_blocks, config)
        ovfmask = tile_accum.tile_partials(s_bkey, s_okey, sd,
                                           config.tile_nb,
                                           config.sdf_trunc)[3] != 0
        return _masked_grids(s_bkey, s_okey, sd, ovfmask, config)

    return state, metrics, tile_ovf, make_fallback


def insert_step_tiled(state: ActiveMapState, points, n_points,
                      position, config: MapConfig):
    """Tiled insert: Morton point sort -> normals -> DDA sample grids -> K4
    per-tile partial rows -> K3 merge; no global sample sort.  Samples
    beyond a tile's block list go through the sort-based
    :func:`update_pool` when the returned :class:`FallbackTail` is settled,
    as in the fused path; the tail keeps the grids and K4's mask.  Returns
    (state, metrics, tail)."""
    state, metrics, tile_ovf, make_fallback = _tiled_body(
        state, points, n_points, position, config)
    return state, metrics, FallbackTail(tile_ovf, make_fallback, config)


def _tiled_body(state: ActiveMapState, points, n_points, position,
                config: MapConfig):
    """The tiled insert without its tail, as :func:`_fused_body`."""
    px, py, pz, nx, ny, nz, sb, pt_overflow = sorted_with_normals(
        points, n_points, position, state.origin_blocks, config)
    s_bkey, s_okey, sd, n_valid, samp_overflow = sample_grids(
        px, py, pz, nx, ny, nz, sb, position, state.origin_blocks, config)
    pkeys, psd, pw, ovfmask = tile_accum.tile_partials(
        s_bkey, s_okey, sd, config.tile_nb, config.sdf_trunc)
    ovfmask = ovfmask != 0
    tile_ovf = ovfmask.sum(dtype=torch.int32)
    state, metrics = update_pool_tiled(state, pkeys, psd, pw, tile_ovf,
                                       n_valid, samp_overflow, pt_overflow,
                                       config)
    return state, metrics, tile_ovf, lambda: _masked_grids(
        s_bkey, s_okey, sd, ovfmask, config)


def insert_step_sample_tiled(state: ActiveMapState, points, n_points,
                             position, config: MapConfig):
    """Sparse-cloud insert over tiles of SAMPLES (the JAX package's
    ``insert_step_sample_tiled``, integrate.py:681-739): sample grids ->
    one global sample sort -> K4 over 1024-sample tiles of the sorted
    stream -> K3 merge.

    Per-point tiles (``fused``, ``tile``) assume many samples per touched
    block; a LiDAR scan (a dozen points a block) overflows every tile's
    list.  Cut the block-sorted samples into tiles instead: consecutive
    samples touch at most 1024 / (samples per block) distinct blocks, so a
    list of ``sparse_tile_nb`` (128) covers any cloud with >= 8 samples per
    touched block.  Samples beyond a tile's list go through the sort-based
    :func:`update_pool` (K5 on the card) when the returned
    :class:`FallbackTail` is settled, counted in ``tile_overflow``.  The
    sample capacity S = N x ``dda_steps`` must be a multiple of 1024 (the
    JAX package asserts it; here K4's shape check raises).  Returns (state,
    metrics, tail).
    """
    state, metrics, tile_ovf, make_fallback = _sample_tiled_body(
        state, points, n_points, position, config)
    return state, metrics, FallbackTail(tile_ovf, make_fallback, config)


def _sample_tiled_body(state: ActiveMapState, points, n_points, position,
                       config: MapConfig):
    """The sample-tiled insert without its tail, as :func:`_fused_body`."""
    batch = sort_samples(compute_samples(points, n_points, position,
                                         state.origin_blocks, config))
    _stage("sample sort")
    return sample_tiled_update(state, batch, config)


def sample_tiled_update(state: ActiveMapState, batch: SampleBatch,
                        config: MapConfig):
    """K4 and K3 over a block-sorted sample batch (:func:`sort_samples`):
    K4 on the (1, S) grid of the batch's keys and payload words with a list
    of ``sparse_tile_nb`` blocks (``tile_partials_sorted``: the JAX
    package's K4 on the unpacked payloads, whose sds it re-quantizes to the
    same words), then :func:`update_pool_tiled`.  Returns (state, metrics,
    tile_ovf, make_fallback): the fallback's samples are the batch's own
    keys and payloads where K4's mask is set, INT32_MAX and 0 elsewhere
    (nothing is re-packed)."""
    n_valid = (batch.bkey != INT32_MAX).sum(dtype=torch.int32)
    # the batch is sorted by sort_samples: the unsorted word is not read
    pkeys, psd, pw, ovfmask, _ = tile_accum.tile_partials_sorted(
        batch.bkey, batch.payload, config.sparse_tile_nb, config.sdf_trunc)
    ovf = ovfmask.reshape(-1) != 0
    tile_ovf = ovf.sum(dtype=torch.int32)
    _stage("K4 partials")
    state, metrics = update_pool_tiled(state, pkeys, psd, pw, tile_ovf,
                                       n_valid, batch.samp_overflow,
                                       batch.pt_overflow, config)
    _stage("K3 merge")

    def make_fallback():
        # masking punches INT32_MAX holes into the key runs: _fallback sorts
        # again, so update_pool sees each block as one run
        return (torch.where(ovf, batch.bkey, INT32_MAX),
                torch.where(ovf, batch.payload, 0))

    return state, metrics, tile_ovf, make_fallback


def _accumulate_impl(config: MapConfig, device: torch.device) -> str:
    impl = config.accumulate_impl
    if impl != "auto":
        return impl
    if device.type == "cuda" and config.max_points % tile_accum.TILE == 0:
        return "fused"
    return "xla"


# --------------------------------------------------------------------------
# The same cloud ``reps`` times: the JAX package's ``insert_steps_scan``
# --------------------------------------------------------------------------

# the fields an insert carries from one insert to the next; the pools are
# updated in place and origin_blocks never changes
_CARRIED = ("dir_keys", "dir_slots", "n_blocks", "point_overflow",
            "sample_overflow", "block_overflow", "touched_overflow",
            "tile_overflow")
_FIELDS = tuple(f.name for f in dataclasses.fields(ActiveMapState))
# the device bytes the graphs of one cache may hold (insert_steps_scan's:
# a state copy and its private memory pools each; a TSDFMap's: the pools):
# the least recently used go once a new one takes them past this, the
# newest always stays.  A dense 2^20-point fused graph holds 1.56 GB of
# pools on the H100
MAX_GRAPH_BYTES = 4 << 30


def write_back(static: ActiveMapState, state: ActiveMapState) -> None:
    """Copy an insert's result into the state it started from, in place:
    the pools must have been updated in place (the JAX package donates
    them), the directory and the counters are copied.  A CUDA graph
    captured on ``static`` then carries one insert into the next."""
    if (state.pool_sd is not static.pool_sd or
            state.pool_w is not static.pool_w):
        raise RuntimeError("the insert did not update the pools in place")
    for f in _CARRIED:
        src, dst = getattr(state, f), getattr(static, f)
        if src is not dst:
            dst.copy_(src)


class GraphCache:
    """Captured graphs by key, bounded by the device bytes they hold (each
    graph's ``nbytes``): when a new graph takes the total past
    ``max_bytes``, the least recently used go, never the newest."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def put(self, key, g) -> None:
        self._graphs[key] = g
        self._graphs.move_to_end(key)
        while len(self._graphs) > 1 and self.nbytes() > self.max_bytes:
            self._graphs.popitem(last=False)

    def nbytes(self) -> int:
        return sum(g.nbytes for g in self._graphs.values())

    def values(self):
        return list(self._graphs.values())

    def clear(self) -> None:
        self._graphs.clear()

    def __len__(self) -> int:
        return len(self._graphs)


_GRAPHS = GraphCache(MAX_GRAPH_BYTES)


def clear_graphs() -> None:
    """Drop every graph :func:`insert_steps_scan` cached, with the state
    copies and memory pools they hold (the caching allocator keeps the
    freed memory until ``torch.cuda.empty_cache``)."""
    _GRAPHS.clear()


def insert_steps_scan(state: ActiveMapState, points, n_points, position,
                      config: MapConfig, reps: int) -> ActiveMapState:
    """Integrate the same padded cloud ``reps`` times (the JAX package's
    ``insert_steps_scan``, a ``lax.scan`` over the insert in one dispatch).

    ``state`` is consumed as :func:`insert_step` consumes it; returns the
    state after ``reps`` inserts, equal bit for bit to a loop of
    :func:`insert_step`.  On the CPU it is that loop.  On CUDA each insert
    is one replay of a ``core.graph.InsertGraph`` cached in ``_GRAPHS`` by
    (config, cloud shape, device), whose fused/tile fallback is an IF node
    decided on the device: no host read.  The graph owns a copy of the
    state, so a call copies ``state`` in and the pools out once; the first
    call of a key runs its first insert eagerly (which builds the kernels
    and allocates K5's workspace) and captures the graph after it.
    ``reps == 1`` without a cached graph is one :func:`insert_step`.
    """
    from . import graph
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if not graph.use_graph(state.device):
        for _ in range(reps):
            state, _ = insert_step(state, points, n_points, position, config)
        return state
    if reps == 0:
        return state
    key = (config, tuple(points.shape), state.device)
    g = _GRAPHS.get(key)
    if g is None:
        if reps == 1:
            return insert_step(state, points, n_points, position, config)[0]
        static = clone_state(state)
        g = graph.InsertGraph(static, config, points.shape[0],
                              owned_bytes=state_nbytes(static))
        g.load(points, position, n_points)
        g.warm()
        g.capture()
        _GRAPHS.put(key, g)
        reps -= 1
    else:
        for f in _FIELDS:
            getattr(g.state, f).copy_(getattr(state, f))
        g.load(points, position, n_points)
    for _ in range(reps):
        g.replay()
    state.pool_sd.copy_(g.state.pool_sd)
    state.pool_w.copy_(g.state.pool_w)
    return dataclasses.replace(
        state, **{f: getattr(g.state, f).clone() for f in _CARRIED})
