"""Space carving — PyTorch port of ``chad_tsdf_tpu/core/carve.py``.

Free-space evidence integrated along the observation rays (the reference's
unbuilt last roadmap item, reference README.md:60): a voxel between the
scanner and the truncation band of a return is an observation of
``sd = +trunc``, the value the reference integrator clamps to
(octree.hpp:156-159) but never visits.  As in the JAX package carving is

* strided: ``carve_stride`` voxels between the free-space samples of a ray
  and ``carve_subsample`` rows of the cloud between carved rays;
* erosion-only: a sample updates a voxel of an already allocated block and
  is dropped (counted in ``n_carve_dropped``) elsewhere, so the pool's
  pressure is the same with carving on or off;
* stopped ``sdf_trunc`` short of the return, so a ray never dilutes its own
  band;
* on the active map only: rotated-out submaps are immutable DAGs.

The JAX package leaves carving to XLA.  Here it runs in three stages, in
the shape of the ``seg`` insert (core/integrate.py):

1. :func:`carve_keys`: per carve ray, ``carve_steps`` strided sample
   positions from the scanner outward (valid while ``t < range - trunc``),
   voxelized with the insert path's ``floor(p * f32(1 / res))``, every f32
   step a separate operation, as the int64 key ``bkey << 32 | okey``;
2. one sort of the keys (the JAX package's two-key sort, INT32_MAX last);
   the payload is the constant ``+trunc``, so a voxel's evidence is its run
   length, an integer;
3. :func:`carve_apply`: one entry per voxel, each entry's block looked up
   in the sorted directory (a lookup, never an allocation), and each found
   voxel's ``(count * trunc * w_c, count * w_c)`` added to the pool.

On CUDA tensors all three steps are hand-written kernels
(``ops/carve_kernels.py``, ``csrc/carve.cu``, ``csrc/carve_sort.cu``: the
sort a keys-only radix sort over the valid keys' ``3 * block_bits + 9``
significant bits); on CPU tensors they are the plain torch ops of
:func:`carve_keys_plain`, ``torch.sort`` and :func:`carve_apply_plain`: a
fixed-capacity compaction (cumulative rank, no host read), a
``searchsorted`` per touched block and one ``index_add_`` per pool plane.
The two routes give the same sorted keys, pool and counters bit for bit.
The sharded carve (``parallel/sharded.py``) merges shards between the
plain stages (:func:`carve_entries`, :func:`lookup_blocks`,
:func:`apply_entries`).

The lookup covers the first ``touched_capacity`` blocks of the sorted
entries, as an insert touches at most that many.  The blocks past them are
lost data, not the erosion rule's drops: their lookup never ran.  They are
counted as an insert's are, in the state's lossy ``touched_overflow``
(which ``TSDFMap`` reads at its overflow check, at a rotation's drain and
in ``stats()``), and their samples are in none of the metrics:
``n_carve_dropped`` counts only the samples that the erosion rule drops by
design (their block is not allocated).

Every entry's index is unique, so each pool element gets at most one addend
and the result does not depend on the order of the adds (the kernel adds
without atomics for that reason).  The counters are
integers (the JAX package sums them in f32, inexact beyond 2^24 samples),
and the work runs at the full capacity ``carve_steps * ceil(N /
carve_subsample)``: the JAX package's entry-capacity buckets choose on the
device with ``lax.switch``, which torch could only do after a host read,
and the buckets do not change the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MapConfig
from ..ops import carve_kernels, dda, morton, segops
from . import integrate
from .state import INT32_MAX, ActiveMapState


def carve_sample_keys(px, py, pz, n_points, position, origin_blocks,
                      config: MapConfig):
    """Voxel keys of the free-space samples of one (padded) cloud.

    Returns flat ``(bkey, okey)`` i32[carve_steps * ceil(N / sub)], sample
    ``i`` of ray ``j`` at ``i * ceil(N / sub) + j``, with INT32_MAX marking
    invalid slots (padding: rows from ``n_points``, an int or an i32[]
    tensor on the points' device; samples beyond ``range - trunc``; samples
    outside the local extent).
    """
    sub = config.carve_subsample
    k = config.carve_steps
    dev = px.device
    pxs, pys, pzs = px[::sub], py[::sub], pz[::sub]
    ns = pxs.shape[0]
    valid_pt = torch.arange(ns, dtype=torch.int32, device=dev) * sub \
        < n_points

    dx = pxs - position[0]
    dy = pys - position[1]
    dz = pzs - position[2]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    safe = torch.clamp(r, min=1e-12)
    ux, uy, uz = dx / safe, dy / safe, dz / safe

    step_m = float(np.float32(config.carve_stride * config.sdf_res))
    # sample centres at (i + 0.5) strides: never on the scanner voxel's
    # corner, and the first sample clears the scanner's own voxel
    t = (torch.arange(k, dtype=torch.float32, device=dev)[:, None] + 0.5) \
        * step_m                                                  # (K, 1)
    limit = (r - float(np.float32(config.sdf_trunc)))[None, :]   # (1, Ns)
    valid_s = (t < limit) & valid_pt[None, :]                     # (K, Ns)

    qx = position[0] + ux[None, :] * t
    qy = position[1] + uy[None, :] * t
    qz = position[2] + uz[None, :] * t

    # the insert path's voxelization (morton.hpp:71, point_keys_soa)
    extent = config.blocks_per_axis * 8
    origin_voxel = origin_blocks * 8
    inv = dda.res_recip_f32(config.sdf_res)
    lx = torch.floor(qx * inv).to(torch.int32) - origin_voxel[0]
    ly = torch.floor(qy * inv).to(torch.int32) - origin_voxel[1]
    lz = torch.floor(qz * inv).to(torch.int32) - origin_voxel[2]
    in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                (lz >= 0) & (lz < extent))
    valid = valid_s & in_range
    lx = torch.clamp(lx, 0, extent - 1)
    ly = torch.clamp(ly, 0, extent - 1)
    lz = torch.clamp(lz, 0, extent - 1)
    bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    bkey = torch.where(valid, bkey, INT32_MAX)
    okey = torch.where(valid, okey, INT32_MAX)
    return bkey.reshape(-1), okey.reshape(-1)


def carve_keys_plain(points, n_points, position, origin_blocks,
                     config: MapConfig):
    """Plain :func:`carve_keys`: :func:`carve_sample_keys` as one int64
    key a slot, and the count of valid samples."""
    bkey, okey = carve_sample_keys(points[:, 0], points[:, 1], points[:, 2],
                                   n_points, position, origin_blocks, config)
    key = (bkey.to(torch.int64) << 32) | okey.to(torch.int64)
    return key, (bkey != INT32_MAX).sum(dtype=torch.int32)


def carve_keys(points, n_points, position, origin_blocks,
               config: MapConfig):
    """Step 1: the free-space sample keys of one padded cloud, ``(key
    i64[carve_steps * ceil(N / carve_subsample)], n_valid i32[], counts)``,
    laid out as :func:`carve_sample_keys`; the kernel on CUDA tensors,
    which also counts the keys' radix digits for the sort
    (:func:`digit_counts_plain`); ``counts`` is None on CPU tensors, whose
    sort needs none."""
    if points.device.type == "cpu":
        return (*carve_keys_plain(points, n_points, position, origin_blocks,
                                  config), None)
    if not isinstance(n_points, torch.Tensor):
        n_points = torch.full((), int(n_points), dtype=torch.int32,
                              device=points.device)
    return carve_kernels.carve_keys(
        points, n_points, position, origin_blocks, k=config.carve_steps,
        sub=config.carve_subsample,
        step_m=float(np.float32(config.carve_stride * config.sdf_res)),
        res_recip=dda.res_recip_f32(config.sdf_res),
        trunc=float(np.float32(config.sdf_trunc)),
        extent=config.blocks_per_axis * 8, key_bits=sort_key_bits(config))


def sort_key_bits(config: MapConfig) -> int:
    """The significant bits of a valid carve key ``bkey << 32 | okey``:
    ``bkey < 2**(3 * block_bits)`` and ``okey < 2**9``."""
    return 3 * config.block_bits + 9


def digit_counts_plain(key, config: MapConfig):
    """The radix digits of the valid keys that the card's sort takes from
    ``carve_keys``: i32[passes, 256], ``[q, v]`` the keys whose bits ``8q``
    to ``8q + 7`` of ``bkey << 9 | okey`` are ``v``."""
    v = key[key != (INT32_MAX << 32 | INT32_MAX)]
    v = (v >> 32) << 9 | (v & 511)
    passes = carve_kernels.sort_passes(sort_key_bits(config))
    return torch.stack([torch.bincount((v >> (8 * q)) & 255, minlength=256)
                        for q in range(passes)]).to(torch.int32)


def sort_keys_plain(key, n_valid, counts, config: MapConfig):
    """Plain :func:`sort_keys`: ``torch.sort`` (``counts`` unused)."""
    return torch.sort(key).values


def sort_keys(key, n_valid, counts, config: MapConfig):
    """Step 2: the keys of :func:`carve_keys` ascending, the ``n_valid``
    (i32[]) valid ones first; on CUDA tensors a keys-only radix sort over
    their ``3 * block_bits + 9`` significant bits, from the digit
    ``counts`` that :func:`carve_keys` returned."""
    if key.device.type == "cpu":
        return sort_keys_plain(key, n_valid, counts, config)
    return carve_kernels.carve_sort(key, n_valid, counts,
                                    key_bits=sort_key_bits(config))


def sorted_entries(key):
    """The sorted sample keys as one entry per voxel: ``(e_b, e_o, e_c,
    e_end)``, an ascending block-key prefix with INT32_MAX beyond, the
    voxels' offsets, their sample counts, and each entry's last sample in
    the sorted samples (so the entries before entry ``j`` hold ``e_end[j -
    1] + 1`` samples)."""
    s = key.shape[0]
    dev = key.device
    sb = (key >> 32).to(torch.int32)
    so = (key & 0x1FF).to(torch.int32)
    valid = sb != INT32_MAX

    # valid samples are a prefix: a voxel's count is the distance from the
    # previous voxel's last sample to its own
    is_end = torch.ones(s, dtype=torch.bool, device=dev)
    is_end[:-1] = key[1:] != key[:-1]
    end_pos, _, e_total = segops.compact_flag_positions(is_end & valid, s)
    ev = torch.arange(s, dtype=torch.int32, device=dev) < e_total
    at = torch.clamp(end_pos, max=s - 1)
    prev_pos = torch.full_like(end_pos, -1)
    prev_pos[1:] = end_pos[:-1]
    e_b = torch.where(ev, sb[at], INT32_MAX)
    e_o = torch.where(ev, so[at], 0)
    e_c = torch.where(ev, end_pos - prev_pos, 0)
    return e_b, e_o, e_c, end_pos


def carve_entries(points, n_points, position, origin_blocks,
                  config: MapConfig):
    """One cloud's free-space samples as one entry per voxel (steps 1-2
    of the module docstring, plain).  Returns ``(e_b, e_o, e_c, n_valid,
    e_end)``: :func:`sorted_entries` and the number of valid samples."""
    key, n_valid = carve_keys_plain(points, n_points, position,
                                    origin_blocks, config)
    e_b, e_o, e_c, e_end = sorted_entries(torch.sort(key).values)
    return e_b, e_o, e_c, n_valid, e_end


def lookup_blocks(state: ActiveMapState, e_b, config: MapConfig):
    """The entries' touched blocks looked up in the sorted directory
    (LOOKUP ONLY: the erosion-only rule allocates nothing), the first
    ``touched_capacity`` of them.  Returns ``(flags, tb_keys, found, slots,
    first_lost, overflow)``: per touched block, ``found`` is whether the
    state holds it and ``slots`` its pool row where found; ``first_lost``
    (i32[]) is the first entry of the blocks past the capacity, the
    stream's length where there are none, and ``overflow`` (i32[]) the
    number of those blocks."""
    cb = config.block_capacity
    t_cap = min(config.touched_capacity, e_b.shape[0])
    flags, starts, _, overflow, tvalid, tb_keys = integrate._touched_blocks(
        e_b, t_cap)
    pos = torch.searchsorted(state.dir_keys, tb_keys).to(torch.int32)
    pos_c = torch.clamp(pos, max=cb - 1)
    found = (state.dir_keys[pos_c] == tb_keys) & tvalid
    return (flags, tb_keys, found, state.dir_slots[pos_c], starts[t_cap],
            overflow)


def lost_samples(e_end, n_valid, first_lost):
    """The samples of the entries from ``first_lost`` on (the blocks past
    the touched capacity, which no lookup saw), as an i32[] on the device:
    read from the entries' last samples, with no pass over the stream."""
    s = e_end.shape[0]
    before = e_end[torch.clamp(first_lost - 1, 0, s - 1).reshape(1)] + 1
    return torch.where(first_lost < s, n_valid - before.reshape(()), 0)


def apply_entries(state: ActiveMapState, e_b, e_o, e_c, n_valid, flags,
                  apply, slots, config: MapConfig):
    """Add the entries of the touched blocks where ``apply`` holds into
    the pool, in place (step 3); the others are dropped and counted.
    Returns ``(state, metrics)`` as :func:`carve_step_impl`, but with the
    samples past the touched capacity in ``n_carve_dropped``."""
    reserved_row = config.block_capacity - 1
    t_cap = apply.shape[0]
    s = e_b.shape[0]
    tb_slots = torch.where(apply, slots, reserved_row)
    e_slot, kept = integrate._slot_per_entry(flags, tb_slots, t_cap,
                                             reserved_row)
    ok = (e_b != INT32_MAX) & kept

    # dead entries add zero into the reserved row, spread over its lanes
    lane = torch.arange(s, dtype=torch.int64, device=e_b.device) & 511
    idx = torch.where(ok, e_slot.to(torch.int64) * 512 + e_o,
                      reserved_row * 512 + lane)
    count = torch.where(ok, e_c, 0)
    cf = count.to(torch.float32)
    sd_per = float(np.float32(config.sdf_trunc * config.carve_weight))
    w_per = float(np.float32(config.carve_weight))
    state.pool_sd.view(-1).index_add_(0, idx, cf * sd_per)
    state.pool_w.view(-1).index_add_(0, idx, cf * w_per)

    n_hit = count.sum(dtype=torch.int32)
    metrics = {"n_carve_samples": n_hit,
               "n_carved_voxels": ok.sum(dtype=torch.int32),
               "n_carve_dropped": n_valid - n_hit}
    return state, metrics


def carve_apply_plain(state: ActiveMapState, key, n_valid,
                      config: MapConfig):
    """Plain :func:`carve_apply`: :func:`sorted_entries`,
    :func:`lookup_blocks`, :func:`apply_entries` and :func:`lost_samples`;
    the same ``(metrics, overflow)``."""
    e_b, e_o, e_c, e_end = sorted_entries(key)
    flags, _, found, slots, first_lost, overflow = lookup_blocks(state, e_b,
                                                                 config)
    _, metrics = apply_entries(state, e_b, e_o, e_c, n_valid, flags, found,
                               slots, config)
    metrics["n_carve_dropped"] = (metrics["n_carve_dropped"] -
                                  lost_samples(e_end, n_valid, first_lost))
    return metrics, overflow


def carve_apply(state: ActiveMapState, key, n_valid, config: MapConfig):
    """Step 3: add the sorted keys' evidence into ``state``'s pool, in
    place.  Returns ``(metrics, overflow)``: the three metrics of
    :func:`carve_step_impl` and the number of blocks past
    ``touched_capacity`` (i32[]); the kernels on CUDA tensors."""
    if key.device.type == "cpu":
        return carve_apply_plain(state, key, n_valid, config)
    c = carve_kernels.carve_apply(
        key, n_valid, state.dir_keys, state.dir_slots, state.pool_sd,
        state.pool_w,
        t_cap=min(config.touched_capacity, key.shape[0]),
        sd_per=float(np.float32(config.sdf_trunc * config.carve_weight)),
        w_per=float(np.float32(config.carve_weight)))
    return {"n_carve_samples": c[0], "n_carved_voxels": c[1],
            "n_carve_dropped": c[2]}, c[3]


def _carve_with(keys_fn, sort_fn, apply_fn, state, points, n_points,
                position, config):
    key, n_valid, counts = keys_fn(points, n_points, position,
                                   state.origin_blocks, config)
    metrics, overflow = apply_fn(state, sort_fn(key, n_valid, counts,
                                                config), n_valid, config)
    return dataclasses.replace(
        state, touched_overflow=state.touched_overflow + overflow), metrics


def carve_step_impl(state: ActiveMapState, points, n_points, position,
                    config: MapConfig):
    """Accumulate one cloud's free-space evidence into the pool, in place.

    ``points`` is the (padded) f32[N, 3] cloud the insert took; every
    ``carve_subsample``-th row spawns a carve ray.  Returns ``(new_state,
    metrics)`` with int32 ``n_carve_samples`` (samples that hit allocated
    blocks), ``n_carved_voxels`` (distinct voxels updated) and
    ``n_carve_dropped`` (samples in unallocated space: dropped by the
    erosion rule, by design, not data loss).  The blocks past
    ``touched_capacity`` are data loss: ``new_state.touched_overflow``
    counts them, on the device, and their samples are in none of the
    metrics.
    """
    return _carve_with(carve_keys, sort_keys, carve_apply, state, points,
                       n_points, position, config)


def carve_step_plain(state: ActiveMapState, points, n_points, position,
                     config: MapConfig):
    """:func:`carve_step_impl` through the plain stages on any device: what
    the kernels are held against on the card."""
    def keys_plain(*args):
        return (*carve_keys_plain(*args), None)

    return _carve_with(keys_plain, sort_keys_plain, carve_apply_plain,
                       state, points, n_points, position, config)


def carve_step(state: ActiveMapState, points, n_points, position,
               config: MapConfig):
    """:func:`carve_step_impl` (the pool is updated in place, as the JAX
    package's jitted step donates it)."""
    return carve_step_impl(state, points, n_points, position, config)


def carve_step_packed(state: ActiveMapState, qpoints, n_points,
                      position, config: MapConfig):
    """Packed-ingest carve: the same i16 fixed-point cloud as
    ``integrate.insert_step_packed``, decoded the same way."""
    return carve_step_impl(state,
                           integrate.unpack_points(qpoints, position, config),
                           n_points, position, config)
