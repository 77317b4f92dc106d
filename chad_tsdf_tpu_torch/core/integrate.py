"""The insert pipeline — PyTorch port of ``chad_tsdf_tpu/core/integrate.py``
(all but the ``sample_tile`` backend).

Mirrors the reference hot path ``TSDFMap::insert`` (reference:
src/chad/tsdf.cpp:39-75):

  reference                                  this module
  ----------------------------------------  ------------------------------
  calc_morton_vector  morton.hpp:59-80    ->  local (block, offset) keys
  sort_morton_vector  morton.hpp:81-102   ->  one stable int64-key sort
  estimate_normals    normals.hpp:81-148  ->  K2 (or segmented scans)
  Octree::insert DDA  octree.hpp:92-152   ->  K1: DDA + sd + tile partials
  per-voxel upsert    octree.hpp:153-163  ->  directory update + K3 merge

Five backends, chosen by ``MapConfig.accumulate_impl``:

* ``fused`` (``auto`` on CUDA): :func:`insert_step_fused` — sort, normals,
  K1, then :func:`update_pool_tiled` (K3).  Samples beyond a tile's block
  list are recovered through K4 and the sort-based :func:`update_pool`.
* ``tile``: :func:`insert_step_tiled` — sort, normals, the plain DDA's
  sample grids, K4, K3, and the same fallback.
* ``pallas``: sample grids, one global sample sort, and :func:`update_pool`
  through K5.
* ``xla`` (``auto`` on CPU): as ``pallas``, with the scatter-form
  accumulate.
* ``seg`` (what ``TSDFMap`` dispatches sparse scans to on CUDA, under
  ``auto``): :func:`insert_step_sparse_seg` — sample grids, one sort by
  (block, offset), per-voxel integer sums, and a scatter of one entry per
  unique voxel.  No tiles, no fallback, no kernel of its own beyond K2,
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
one sort of <= block_capacity + touched_capacity keys) or sizes the work
statically and masks (K3's and K5's grids).  The single host read per
insert of the fused and tile paths is their total of uncovered samples,
which decides whether the fallback runs; it is counted in the metrics as
``host_reads`` (0 under ``pallas``, ``xla`` and ``seg``).

The state passed in is consumed: its pool planes are updated in place
(the JAX package donates them), and the returned state shares them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig

from ..ops import (accumulate, dda, fused_integrate, morton, normals,
                   normals_cuda, segops, tile_accum)
from .state import INT32_MAX, ActiveMapState

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


def point_keys_soa(px, py, pz, n_points: int, origin_blocks,
                   config: MapConfig):
    """Local Morton keys per point; padding and out-of-extent points get
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


def compute_sample_grids_soa(px, py, pz, sb, so, position, origin_blocks,
                             config: MapConfig):
    """Normals + DDA over Morton-sorted points -> (K, N) sample grids."""
    nx, ny, nz = estimate_normals_dispatch(px, py, pz, sb, so, position,
                                           origin_blocks, config)
    _stage("normals K2")
    return sample_grids(px, py, pz, nx, ny, nz, sb, position, origin_blocks,
                        config)


def compute_samples(points, n_points: int, position, origin_blocks,
                    config: MapConfig) -> SampleBatch:
    """Morton sort + normals + DDA: points -> flat packed samples."""
    bkey, okey, pt_overflow = point_keys_soa(
        points[:, 0], points[:, 1], points[:, 2], n_points, origin_blocks,
        config)
    sb, so, px, py, pz = sort_points_soa(points[:, 0], points[:, 1],
                                         points[:, 2], bkey, okey)
    _stage("keys + sort")
    s_bkey, s_okey, sd, _, samp_overflow = compute_sample_grids_soa(
        px, py, pz, sb, so, position, origin_blocks, config)
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


def insert_step(state: ActiveMapState, points, n_points: int, position,
                config: MapConfig):
    """Integrate one padded point cloud into the active map.

    points: f32[N, 3] world points on the state's device, padded;
    n_points: number of valid rows; position: f32[3] scanner position.
    Returns (new_state, metrics dict of device scalars).
    """
    _stage("host prep + upload")
    impl = _accumulate_impl(config, state.device)
    if impl == "fused":
        return insert_step_fused(state, points, n_points, position, config)
    if impl == "tile":
        return insert_step_tiled(state, points, n_points, position, config)
    if impl in ("pallas", "xla"):
        # global sample sort; update_pool picks K5 or the scatter form
        batch = compute_samples(points, n_points, position,
                                state.origin_blocks, config)
        state, metrics = update_pool(state, sort_samples(batch), config)
        metrics["host_reads"] = 0
        return state, metrics
    if impl == "seg":
        return insert_step_sparse_seg(state, points, n_points, position,
                                      config)
    raise NotImplementedError(
        f"accumulate_impl={impl!r} is not ported to PyTorch yet "
        "(see ROADMAP.md); use 'auto', 'fused', 'tile', 'pallas', 'xla' or "
        "'seg'")


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


def insert_step_packed(state: ActiveMapState, qpoints, n_points: int,
                       position, config: MapConfig):
    """Packed-ingest insert (``MapConfig.packed_ingest``): ``qpoints`` is
    i16[N, 3] from :func:`pack_points`, half the bytes of the f32 cloud on
    the way to the device; world points = q * step + position, computed
    here on the device (a multiply and an add, each rounded to f32)."""
    step = config.sdf_res / 8.0
    pts = qpoints.to(torch.float32) * step + position[None, :]
    return insert_step(state, pts, n_points, position, config)


def sparse_seg_entry_stream(points, n_points: int, position, origin_blocks,
                            config: MapConfig):
    """Sparse-insert front half: one entry per UNIQUE VOXEL of one cloud.

    Sort, segmented sum, compact.  Returns ``(e_b, e_okey, e_sd_q, e_w,
    e_total, n_valid_samples, batch)``: the entry tensors are (S,) with
    the live entries an ascending-(block, offset) prefix ``[:e_total]`` and
    INT32_MAX block keys, zero sums and zero weights beyond.  ``e_sd_q``
    (int64) is the voxel's sum of 16-bit signed-distance quanta and
    ``e_w`` (int32) its sample count; :func:`seg_entries_update` scales
    the sum to metres.

    The samples are sorted once by ``bkey << 32 | payload``: the payload
    (``offset << 16 | sd16``) is non-negative, so this is the JAX package's
    two-key sort, and invalid samples (INT32_MAX, 0) come last.  The sums
    are integer: an int64 running sum read at each voxel's last sample,
    less its value at the previous voxel's.  Integer sums have no order,
    so two runs are bit-equal, and they are exact for any number of
    samples in a voxel (the JAX package carries the sum in f32, exact up
    to 2^24 / 32767 = 512 samples a voxel).  Nothing here reads the device
    from the host: the entries are compacted at the fixed capacity S.

    A separate function so that a sharded map can route entry streams
    (one consolidated entry per voxel) between shards.
    """
    batch = compute_samples(points, n_points, position, origin_blocks,
                            config)
    s = batch.bkey.shape[0]
    dev = batch.bkey.device
    key, _ = torch.sort((batch.bkey.to(torch.int64) << 32) |
                        batch.payload.to(torch.int64))
    sb = (key >> 32).to(torch.int32)
    valid = sb != INT32_MAX
    n_valid_samples = valid.sum(dtype=torch.int32)
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


def insert_step_sparse_seg(state: ActiveMapState, points, n_points: int,
                           position, config: MapConfig):
    """Sparse-cloud insert: voxel-sorted segment sums, then a scatter of
    one entry per unique voxel — no tiles, no fallback, ``tile_overflow``
    untouched, and no host read.

    LiDAR-shaped clouds (a dozen points per block, a few samples per voxel)
    overflow every per-point tile's block list, so the tiled backends send
    them through their fallback.  This path reduces first and scatters
    last (:func:`sparse_seg_entry_stream`, :func:`seg_entries_update`), in
    plain tensor operations.  The JAX package picks an entry bucket of
    S/4 .. S by the live count to shorten its scatter; that choice reads
    the count on the host and does not change the result (the entries are
    a prefix), so the port runs the one capacity S.

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
               "n_blocks": n_blocks, "host_reads": 0}
    return new_state, metrics


def _fallback(state: ActiveMapState, s_bkey, s_okey, sd, ovfmask,
              config: MapConfig):
    """The samples a tile's block list could not cover (``ovfmask``) go
    through the sort-based :func:`update_pool`; returns (state, n_new)."""
    fb_key = torch.where(ovfmask, s_bkey, INT32_MAX).reshape(-1)
    payload = torch.where(ovfmask, pack_payload(s_okey, sd, config.sdf_trunc),
                          0)
    zero = _zero(s_bkey.device)
    batch = sort_samples(SampleBatch(fb_key, payload.reshape(-1), zero, zero))
    state, m = update_pool(state, batch, config)
    return state, m["n_new_blocks"]


def insert_step_fused(state: ActiveMapState, points, n_points: int,
                      position, config: MapConfig):
    """Fused insert: Morton point sort -> normals -> K1 (DDA + signed
    distance + per-tile partial rows) -> K3 merge.

    The (K, N) sample grids never exist in device memory.  When K1 could
    not fit some samples into their tile's block list (one host read of
    their count), the grids are recomputed, K4 marks exactly the samples
    K1 left out, and those go through the sort-based :func:`update_pool`.
    """
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    bkey, okey, pt_overflow = point_keys_soa(px, py, pz, n_points,
                                             state.origin_blocks, config)
    sb, so, px, py, pz = sort_points_soa(px, py, pz, bkey, okey)
    nx, ny, nz = estimate_normals_dispatch(px, py, pz, sb, so, position,
                                           state.origin_blocks, config)
    pkeys, psd, pw, counts = fused_integrate.fused_tile_partials(
        px, py, pz, nx, ny, nz, sb, position, state.origin_blocks * 8,
        nb=config.tile_nb, k=config.dda_steps, res=config.sdf_res,
        trunc=config.sdf_trunc, extent=config.blocks_per_axis * 8)
    totals = counts.sum(dim=0, dtype=torch.int32)
    n_valid, tile_ovf, samp_overflow = totals[0], totals[1], totals[2]
    state, metrics = update_pool_tiled(state, pkeys, psd, pw, tile_ovf,
                                       n_valid, samp_overflow, pt_overflow,
                                       config)
    del pkeys, psd, pw

    extra_new = 0
    if int(tile_ovf) > 0:                      # the one host read
        s_bkey, s_okey, sd, _, _ = sample_grids(
            px, py, pz, nx, ny, nz, sb, position, state.origin_blocks,
            config)
        ovfmask = tile_accum.tile_partials(s_bkey, s_okey, sd,
                                           config.tile_nb,
                                           config.sdf_trunc)[3] != 0
        state, extra_new = _fallback(state, s_bkey, s_okey, sd, ovfmask,
                                     config)
    metrics["n_new_blocks"] = metrics["n_new_blocks"] + extra_new
    metrics["n_blocks"] = state.n_blocks
    metrics["host_reads"] = 1
    return state, metrics


def insert_step_tiled(state: ActiveMapState, points, n_points: int,
                      position, config: MapConfig):
    """Tiled insert: Morton point sort -> normals -> DDA sample grids -> K4
    per-tile partial rows -> K3 merge; no global sample sort.  Samples
    beyond a tile's block list (one host read of their count) go through
    the sort-based :func:`update_pool`, as in the fused path."""
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    bkey, okey, pt_overflow = point_keys_soa(px, py, pz, n_points,
                                             state.origin_blocks, config)
    sb, so, px, py, pz = sort_points_soa(px, py, pz, bkey, okey)
    s_bkey, s_okey, sd, n_valid, samp_overflow = compute_sample_grids_soa(
        px, py, pz, sb, so, position, state.origin_blocks, config)
    pkeys, psd, pw, ovfmask = tile_accum.tile_partials(
        s_bkey, s_okey, sd, config.tile_nb, config.sdf_trunc)
    ovfmask = ovfmask != 0
    tile_ovf = ovfmask.sum(dtype=torch.int32)
    state, metrics = update_pool_tiled(state, pkeys, psd, pw, tile_ovf,
                                       n_valid, samp_overflow, pt_overflow,
                                       config)
    del pkeys, psd, pw

    extra_new = 0
    if int(tile_ovf) > 0:                      # the one host read
        state, extra_new = _fallback(state, s_bkey, s_okey, sd, ovfmask,
                                     config)
    metrics["n_new_blocks"] = metrics["n_new_blocks"] + extra_new
    metrics["n_blocks"] = state.n_blocks
    metrics["host_reads"] = 1
    return state, metrics


def _accumulate_impl(config: MapConfig, device: torch.device) -> str:
    impl = config.accumulate_impl
    if impl != "auto":
        return impl
    if device.type == "cuda" and config.max_points % tile_accum.TILE == 0:
        return "fused"
    return "xla"
