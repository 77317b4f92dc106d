#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``chad_tsdf_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``chad_tsdf_tpu_torch/csrc`` and
runs, failing with a non-zero exit on the first error:

1. the card's name and power limit; the kernel build (one nvcc per
   source, all at once);
2. each kernel against its plain PyTorch version on the card, with both
   times: K1 fused integrate, K2 normals, K3 tile merge and K4 tile
   partials on the inputs the 1M-point sphere gives them (K1/K4 on their
   live partial rows: the kernels leave dead rows unwritten); K2 also on a
   dense-voxel cloud (64 voxels x 16,384 points) and a few small clouds with
   padding, ragged sizes and segments across tiles, and two K2 launches
   must give bit-equal normals; K5 segment accumulate on the ``pallas``
   backend's tables of the 1M-point sphere, the dense-voxel cloud and a
   single-voxel cloud (2^20 points in one voxel), and on a synthetic table
   with segments on chunk boundaries: its device chunk list against the
   plain one, both pool planes bit for bit against the plain version, and
   two launches bit-equal; the
   microbenchmark kernels M1 (every mode), M2 and M3 (both precisions) at a
   reduced size.  K3 and K5 are also timed against one PyTorch call that
   computes their function (``index_add_`` / ``index_put_(accumulate=
   True)``), a yardstick the port never calls;
3. the main path: ``TSDFMap(0.05, 0.1, device="cuda")`` at the default
   MapConfig inserts the 2^20-point r = 5 m sphere (seed 420, bench.py's
   cloud) and saves a PLY, whose vertices must sit on the sphere; then the
   ``pallas`` and ``tile`` backends insert the same cloud and must give the
   fused map's blocks, weights and signed distances;
4. a sparse 2048-point insert whose tiles overflow, so the fallback (K4,
   then K5) runs; its pool is held against the scatter backend, and the
   scatter form is not reached on the fallback;
5. determinism: two fresh maps, same insert, bit-equal pools (dense,
   sparse, and dense under ``pallas``);
6. the golden workload (tests/golden/sphere_r2_seed420.npz) through the
   fused path;
7. the microbenchmarks' own timing runs at their full sizes
   (``chad_tsdf_tpu_torch.scripts``), then each held once more against its
   plain version at that size;
8. the sparse streaming path at full width: bench.py's KITTI-shaped stream
   (``chad_tsdf_tpu_torch.scripts.kitti_stream``: 12 scans of ~120k points
   1.5 m apart, ``MapConfig(block_capacity=1 << 16, touched_capacity=
   1 << 15, packed_ingest=True)``), its scans/s, points/s and
   ``tile_overflow``; every scan must be dispatched to ``seg``, read
   nothing on the host, launch K2 once and no other kernel, overflow
   nothing and leave 2 deferred rotations behind; K2 against its plain
   version on one sorted scan; the same stream under ``sparse_impl`` =
   ``seg``, ``pallas`` and ``fused`` in turns (median scans/s of each), the
   three final maps equal to each other, rotated-out submaps included;
   ``seg`` against the scatter backend and packed against f32 ingest on one
   scan; two ``seg`` streams bit-equal in pools and DAG counters, and a
   stream drained after every insert equal to the deferred one.

Launch counts are reset just before the dense inserts of phase 3 and read
right after them: K1, K2 and K3 must have launched there and K4 not.  They
are reset again just before phase 4's sparse insert, where K4 and K5 must
launch, just before phase 7's timing runs, where M1-M3 must launch, and
just before phase 8's stream, where K2 must launch once per insert and K1,
K3, K4 and K5 not at all.
The ``kernels`` JSON line (before the card's name and the last line) gives
each kernel's launches in the run that drives it: phase 3 for K1-K3, phase 4
for K4-K5, phase 7 for M1-M3 (and, as ``launches_stream``, in the 12 inserts
of phase 8's ``seg`` stream), with its time, its plain version's time, the
library call's time (or null) and ``bound_ms``: the least time the H100
could take for the same work on this run's inputs, the larger of the bytes
the function must move (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak rate of their type
(``bound_by`` says which).  The last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX and nothing of
the JAX package ``chad_tsdf_tpu``, and checks that neither was loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_DENSE = 1 << 20
# per-unit-weight sd gate (tests/test_fused.py:58-59)
SD_TOL = 1e-4
KERNELS = {
    # name -> (source, the TPU kernel's pl.pallas_call it replaces)
    "fused_tile_partials": ("chad_tsdf_tpu_torch/csrc/fused_integrate.cu",
                            "chad_tsdf_tpu/ops/fused_integrate.py:389"),
    "estimate_normals": ("chad_tsdf_tpu_torch/csrc/normals.cu",
                         "chad_tsdf_tpu/ops/normals_pallas.py:241"),
    "merge_partials": ("chad_tsdf_tpu_torch/csrc/tile_accum.cu",
                       "chad_tsdf_tpu/ops/tile_accum.py:242"),
    "tile_partials": ("chad_tsdf_tpu_torch/csrc/tile_accum.cu",
                      "chad_tsdf_tpu/ops/tile_accum.py:134"),
    "accumulate_segments": ("chad_tsdf_tpu_torch/csrc/accumulate.cu",
                            "chad_tsdf_tpu/ops/accumulate.py:223"),
    "micro_stagea_phases": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                            "scripts/micro_stagea_phases.py:168"),
    "micro_tile_accum": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                         "scripts/micro_tile_accum.py:72"),
    "micro_mxu8": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                   "scripts/micro_mxu8.py:129"),
}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# f32 outside the tensor cores and bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# f32 operations per point, counted from the kernels' code: K2's three
# depths of 10 features (9 products, 10 sums each) and the plane fit and
# flip (~120); K1's ray setup (~60) and ~25 per DDA step
K2_OPS_PER_POINT = 3 * 19 + 120
K1_OPS_PER_POINT = 60
K1_OPS_PER_STEP = 25
# reduced sizes of phase 2's microbenchmark checks
MICRO_CHECK_N = 1 << 16        # M1 / M3 points (64 tiles)
MICRO_CHECK_TILES = 64         # M2 tiles


# The golden was written by the JAX package under jit on the CPU, whose
# compiled traversal rounds one ray's tie between two axes differently from
# the IEEE evaluation that the port (and eager JAX) performs: one band-edge
# voxel of 99804.  Same gate as tools/tpu_kernel_equality.py's cover_diff.
GOLDEN_MAX_CODE_DIFF = 2


def golden_diff(codes, sd, g_codes, g_sd):
    """(# codes in only one of the two sets, max |sd diff| on the rest)."""
    common, ia, ib = np.intersect1d(codes, g_codes, assume_unique=True,
                                    return_indices=True)
    n_diff = codes.shape[0] + g_codes.shape[0] - 2 * common.shape[0]
    return n_diff, float(np.abs(sd[ia] - g_sd[ib]).max())


def log(*args):
    print(*args, flush=True)


def sphere(n, r, seed):
    """bench.py's cloud: uniform cube directions, normalized, radius r."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn``'s device time: the port's own timer
    (``chad_tsdf_tpu_torch.scripts.cuda_ms``), imported once the port is on
    the path."""
    from chad_tsdf_tpu_torch.scripts import cuda_ms as timer
    return timer(fn, reps, warmup)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, ops=0.0, peak=F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def jax_package_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "chad_tsdf_tpu") or
                  m.startswith(("jax.", "chad_tsdf_tpu.")))


def check_k2(cfg, name, sb, so, px, py, pz, time_it=False):
    """K2 against its plain version (min dot > 1 - 1e-3) and against a
    second launch of itself (bit-equal); with ``time_it`` both times."""
    from chad_tsdf_tpu_torch.ops import normals, normals_cuda
    pos = torch.zeros(3, dtype=torch.float32, device=px.device)
    nargs = (px, py, pz, sb, so, pos, cfg.normal_min_points,
             cfg.normal_max_depth)

    def plain():
        return normals.estimate_normals_soa(
            px, py, pz, sb, so, sb != 2**31 - 1, pos, cfg.normal_min_points,
            cfg.normal_max_depth)

    nk = torch.stack(normals_cuda.estimate_normals(*nargs))
    nk2 = torch.stack(normals_cuda.estimate_normals(*nargs))
    npl = torch.stack(plain())
    min_dot = float((nk * npl).sum(0).min())
    require(min_dot > 1.0 - 1e-3, f"K2 min dot {min_dot} ({name})")
    require(torch.equal(nk, nk2), f"K2 not bit-equal across launches "
                                  f"({name})")
    _, seg = torch.unique_consecutive(
        (sb.to(torch.int64) << 32) | so.to(torch.int64), return_counts=True)
    r = {"points": int(px.shape[0]), "largest_segment": int(seg.max()),
         "min_dot": min_dot, "max_abs_err": float((nk - npl).abs().max())}
    if time_it:
        r["ms"] = cuda_ms(lambda: normals_cuda.estimate_normals(*nargs))
        r["plain_ms"] = cuda_ms(plain, reps=3)
    n = int(px.shape[0])
    r["bound_ms"], r["bound_by"] = bound(32 * n + 12, K2_OPS_PER_POINT * n)
    log(f"K2 estimate_normals ({name}): {r}; two launches bit-equal")
    return r, nk


def sd_err_per_weight(sd_a, sd_b, w):
    return float((torch.abs(sd_a - sd_b) / torch.clamp(w, min=1.0)).max())


def check_kernels(cfg, results):
    """Phase 2: K1-K4 against their plain versions on the sphere's inputs
    (K2 also on the dense-voxel cloud and small edge-case clouds)."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.core.state import (create_state,
                                                origin_blocks_for_position)
    from chad_tsdf_tpu_torch.ops import dda, fused_integrate, tile_accum
    from chad_tsdf_tpu_torch.profile_insert import sorted_cloud, voxel_clusters

    dev = torch.device("cuda")
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    origin = origin_blocks_for_position(np.zeros(3), cfg)
    origin_blocks = torch.from_numpy(origin).to(dev)
    origin_voxel = origin_blocks * 8
    sb, so, px, py, pz = sorted_cloud(sphere(N_DENSE, 5.0, 420), cfg, dev)

    # ---- K2 ----
    r2, nk = check_k2(cfg, "sphere", sb, so, px, py, pz, time_it=True)
    results["estimate_normals"] = r2
    dense = voxel_clusters(N_DENSE, 16384, cfg.sdf_res, 5)
    rd, _ = check_k2(cfg, "dense voxels", *sorted_cloud(dense, cfg, dev),
                     time_it=True)
    results["estimate_normals"]["dense_voxels"] = rd
    for name, pts_np, n_valid in (
            ("ragged 5001 points, 4000 valid", sphere(5001, 1.0, 3), 4000),
            ("3 segments of 3000 across tiles",
             voxel_clusters(9000, 3000, cfg.sdf_res, 6), 9000),
            ("one 40000-point voxel", voxel_clusters(40960, 40960,
                                                     cfg.sdf_res, 8), 40960)):
        check_k2(cfg, name, *sorted_cloud(pts_np, cfg, dev, n_valid))

    # ---- K1, on its live partial rows ----
    nx, ny, nz = nk[0].contiguous(), nk[1].contiguous(), nk[2].contiguous()
    kw = dict(nb=cfg.tile_nb, k=cfg.dda_steps, res=cfg.sdf_res,
              trunc=cfg.sdf_trunc, extent=cfg.blocks_per_axis * 8)
    fargs = (px, py, pz, nx, ny, nz, sb, pos, origin_voxel)
    k1 = fused_integrate.fused_tile_partials(*fargs, **kw)
    p1 = fused_integrate.fused_tile_partials_plain(*fargs, **kw)
    require(torch.equal(k1[0], p1[0]), "K1 block lists differ")
    require(torch.equal(k1[3], p1[3]), "K1 counters differ")
    live1 = tile_accum.live_rows(p1[0])
    n_live = int(live1.sum())
    require(torch.equal(k1[2][live1], p1[2][live1]), "K1 weights differ")
    err1 = sd_err_per_weight(k1[1][live1], p1[1][live1], p1[2][live1])
    require(err1 < SD_TOL, f"K1 sd error {err1}")
    tot = k1[3].sum(0).tolist()
    tiles = N_DENSE // 1024
    results["fused_tile_partials"] = {
        "max_abs_err": float((k1[1][live1] - p1[1][live1]).abs().max()),
        "ms": cuda_ms(lambda: fused_integrate.fused_tile_partials(
            *fargs, **kw)),
        "plain_ms": cuda_ms(lambda: fused_integrate.fused_tile_partials_plain(
            *fargs, **kw), reps=3), "live_rows": n_live}
    results["fused_tile_partials"]["bound_ms"], \
        results["fused_tile_partials"]["bound_by"] = bound(
            28 * N_DENSE + 24 + tiles * cfg.tile_nb * 4 + n_live * 4096 +
            tiles * 12,
            (K1_OPS_PER_POINT + K1_OPS_PER_STEP * cfg.dda_steps) * N_DENSE)
    log(f"K1 fused_tile_partials: [n_valid, n_not_covered, n_samp_ovf] = "
        f"{tot}, rows {k1[1].shape[0]}, live rows {n_live} "
        f"({n_live / tiles:.2f} per tile), {results['fused_tile_partials']}")
    del p1

    # ---- K4, on the sample grids K1 walked internally ----
    grids = dda.local_sample_grids(px, py, pz, nx, ny, nz, sb != 2**31 - 1,
                                   pos, origin_voxel, cfg.sdf_res,
                                   cfg.sdf_trunc, cfg.dda_steps,
                                   cfg.blocks_per_axis * 8)
    targs = (grids[0], grids[1], grids[2], cfg.tile_nb, cfg.sdf_trunc)
    k4 = tile_accum.tile_partials(*targs)
    p4 = tile_accum.tile_partials_plain(*targs)
    require(torch.equal(k4[0], p4[0]), "K4 block lists differ")
    require(torch.equal(k4[3], p4[3]), "K4 ovfmask differs")
    live4 = tile_accum.live_rows(p4[0])
    require(torch.equal(k4[2][live4], p4[2][live4]), "K4 weights differ")
    err4 = sd_err_per_weight(k4[1][live4], p4[1][live4], p4[2][live4])
    require(err4 < SD_TOL, f"K4 sd error {err4}")
    # one coverage rule: K4 on the grids reproduces K1 exactly
    require(torch.equal(k4[0], k1[0]), "K4 and K1 block lists differ")
    for i in (1, 2):
        require(torch.equal(k4[i][live4], k1[i][live4]),
                f"K4 and K1 output {i} differ")
    require(int(k4[3].sum()) == tot[1], "K4 and K1 coverage differ")
    k_steps = cfg.dda_steps
    results["tile_partials"] = {
        "max_abs_err": float((k4[1][live4] - p4[1][live4]).abs().max()),
        "ms": cuda_ms(lambda: tile_accum.tile_partials(*targs)),
        "plain_ms": cuda_ms(lambda: tile_accum.tile_partials_plain(*targs),
                            reps=3)}
    results["tile_partials"]["bound_ms"], \
        results["tile_partials"]["bound_by"] = bound(
            16 * k_steps * N_DENSE + tiles * cfg.tile_nb * 4 +
            int(live4.sum()) * 4096)
    log(f"K4 tile_partials: {results['tile_partials']}")
    del p4, k4, grids

    # ---- K3, merging K1's partials into a pool that already holds one
    # insert's sums (the second insert of a stream) ----
    state = create_state(cfg, origin, dev)
    state, _ = integrate.update_pool_tiled(
        state, k1[0], k1[1], k1[2], torch.zeros((), dtype=torch.int32,
                                                device=dev),
        0, 0, 0, cfg)
    directory, plan, _, _ = integrate.plan_tiled_merge(state, k1[0], cfg)
    pools_k = (state.pool_sd.clone(), state.pool_w.clone())
    pools_p = (state.pool_sd.clone(), state.pool_w.clone())
    tile_accum.merge_partials(*pools_k, *plan, k1[1], k1[2])
    tile_accum.merge_partials_plain(*pools_p, *plan, k1[1], k1[2])
    require(torch.equal(pools_k[1], pools_p[1]), "K3 weights differ")
    err3 = sd_err_per_weight(pools_k[0], pools_p[0], pools_p[1])
    require(err3 < SD_TOL, f"K3 sd error {err3}")
    require(torch.equal(pools_k[1], 2 * state.pool_w), "K3 lost weight")
    # the yardstick: one index_add_ of all P rows ([sd | w] side by side)
    # at their slots, dead rows at the reserved slot, as a scatter would
    n_groups, gstart, glen, grow, prow, src = plan
    ng = int(n_groups[0])
    lens = glen[:ng].to(torch.int64)
    slot_sorted = torch.full((k1[0].shape[0],), cfg.block_capacity - 1,
                             dtype=torch.int64, device=dev)
    n_live3 = int(lens.sum())
    slot_sorted[:n_live3] = (torch.repeat_interleave(grow[:ng].to(
        torch.int64), lens) * 8 + prow[:n_live3].to(torch.int64))
    row_slot = torch.empty_like(slot_sorted)
    row_slot[src.to(torch.int64)] = slot_sorted
    both_pool = torch.cat(pools_p, dim=1)
    both_rows = torch.cat((k1[1], k1[2]), dim=1)
    touched = int(torch.unique(slot_sorted[:n_live3]).shape[0])
    results["merge_partials"] = {
        "max_abs_err": float((pools_k[0] - pools_p[0]).abs().max()),
        "ms": cuda_ms(lambda: tile_accum.merge_partials(
            *pools_k, *plan, k1[1], k1[2])),
        "plain_ms": cuda_ms(lambda: tile_accum.merge_partials_plain(
            *pools_p, *plan, k1[1], k1[2]), reps=3),
        "library_ms": cuda_ms(lambda: both_pool.index_add_(0, row_slot,
                                                           both_rows)),
        "live_rows": n_live3, "touched_rows": touched}
    results["merge_partials"]["bound_ms"], \
        results["merge_partials"]["bound_by"] = bound(
            n_live3 * (4096 + 8) + touched * 8192 + ng * 12)
    log(f"K3 merge_partials: {ng} groups, {results['merge_partials']}")
    del state, pools_k, pools_p, k1, directory, plan, both_pool, both_rows


def check_k5(cfg, results):
    """Phase 2, K5 on the pallas backend's tables of the 1M-point sphere, a
    dense-voxel cloud (64 voxels x 16,384 points) and a single-voxel cloud
    (2^20 points in one voxel), and on a synthetic table whose segment
    lengths sit on chunk boundaries: the device chunk list equals
    plan_chunks_plain; two launches on equal pools give bit-equal pools;
    two passes (the second adds onto live rows) equal the plain version bit
    for bit on both planes; no launch overflows its chunk list, and a table
    of overlapping segments that outgrows it sets the flag and adds
    nothing."""
    from chad_tsdf_tpu_torch.ops import accumulate
    from chad_tsdf_tpu_torch.ops.tile_accum import sd_scales
    from chad_tsdf_tpu_torch.profile_insert import (boundary_inputs,
                                                    k5_clouds, k5_inputs)

    dev = torch.device("cuda")

    def k5(pools, args, name):
        accumulate.accumulate_segments(*pools, *args)
        require(not accumulate.overflowed(dev),
                f"K5 chunk list overflowed ({name})")

    # five live members over one 5C-sample range: more multi-chunk members
    # than the scratch rows sized for disjoint segments
    c, t = accumulate.CHUNK, cfg.touched_capacity
    cb = cfg.block_capacity
    over = [torch.zeros(t, dtype=torch.int32, device=dev) for _ in range(3)]
    over[1][:5] = 5 * c
    over[2][:] = cb - 1
    over[2][:5] = torch.arange(5, device=dev)
    pay = torch.zeros(5 * c, dtype=torch.int32, device=dev)
    pools = (torch.zeros((cb, 512), device=dev),
             torch.zeros((cb, 512), device=dev))
    accumulate.accumulate_segments(*pools, *over, pay, cfg.sdf_trunc)
    require(accumulate.overflowed(dev) and not pools[0].any() and
            not pools[1].any(), "K5 overlapping segments: no overflow flag")
    try:
        accumulate.plan_chunks(over[1], over[2], cb, pay.numel())
        require(False, "plan_chunks took overlapping segments")
    except RuntimeError:
        pass
    del over, pay, pools
    out = {}
    inputs = [(name, lambda pts=pts: k5_inputs(pts, cfg, dev))
              for name, pts in k5_clouds(cfg).items()]
    inputs.append(("chunk_boundaries", lambda: boundary_inputs(cfg, dev)))
    for name, make in inputs:
        pools_k, tables, payload, stats = make()
        args = (*tables, payload, cfg.sdf_trunc)
        starts, lens, slots = tables
        cb = pools_k[0].shape[0]
        plan = accumulate.plan_chunks(lens, slots, cb, payload.numel())
        plain_plan = accumulate.plan_chunks_plain(lens, slots, cb,
                                                  accumulate.CHUNK)
        require(all(torch.equal(a, b) for a, b in zip(plan, plain_plan)),
                f"K5 chunk list differs from plan_chunks_plain ({name})")
        stats["chunks"] = int(plan[0].shape[0])
        stats["multi_chunk_members"] = int((plan[2] >= 0).sum())
        twice = [(pools_k[0].clone(), pools_k[1].clone()) for _ in range(2)]
        for pools in twice:
            k5(pools, args, name)
        require(torch.equal(twice[0][0], twice[1][0]) and
                torch.equal(twice[0][1], twice[1][1]),
                f"K5 not bit-equal across launches ({name})")
        del twice
        pools_p = (pools_k[0].clone(), pools_k[1].clone())
        for _ in range(2):
            k5(pools_k, args, name)
            accumulate.accumulate_segments_plain(*pools_p, *args)
        require(torch.equal(pools_k[1], pools_p[1]),
                f"K5 weights differ ({name})")
        require(torch.equal(pools_k[0], pools_p[0]),
                f"K5 sd differs ({name})")
        require(int(pools_k[1].double().sum()) == 2 * stats["kept_samples"],
                f"K5 lost weight ({name})")
        err = sd_err_per_weight(pools_k[0], pools_p[0], pools_p[1])
        # the yardstick: one index_put_(accumulate=True) of every kept
        # sample's (sd, 1) into the flattened [sd, w] pool
        live = (slots != cb - 1) & (lens > 0)
        ln = torch.where(live, lens, 0).to(torch.int64)
        first = torch.repeat_interleave(
            starts.to(torch.int64) - (torch.cumsum(ln, 0) - ln), ln)
        p = payload[torch.arange(first.shape[0], device=dev) + first]
        cell = (torch.repeat_interleave(slots.to(torch.int64), ln) * 512 +
                ((p >> 16) & 0x1FF).to(torch.int64))
        _, dscale = sd_scales(cfg.sdf_trunc)
        vals = torch.stack([((p << 16) >> 16).to(torch.float32) * dscale,
                            torch.ones_like(cell, dtype=torch.float32)], 1)
        flat = torch.stack([pools_p[0].reshape(-1), pools_p[1].reshape(-1)],
                           1)
        members = int(live.sum())
        r = dict(stats, sd_err_per_weight=err,
                 max_abs_err=float((pools_k[0] - pools_p[0]).abs().max()),
                 ms=cuda_ms(lambda: accumulate.accumulate_segments(
                     *pools_k, *args)),
                 plain_ms=cuda_ms(lambda: accumulate.accumulate_segments_plain(
                     *pools_p, *args), reps=3),
                 library_ms=cuda_ms(lambda: flat.index_put_(
                     (cell,), vals, accumulate=True)))
        require(not accumulate.overflowed(dev),
                f"K5 chunk list overflowed ({name})")
        r["bound_ms"], r["bound_by"] = bound(
            4 * stats["kept_samples"] + members * (12 + 8192))
        log(f"K5 accumulate_segments ({name}): {r}")
        out[name] = r
        del pools_k, pools_p, tables, payload, flat, vals, cell, p
        torch.cuda.empty_cache()
    results["accumulate_segments"] = dict(
        out["sphere"], max_abs_err=max(r["max_abs_err"]
                                       for r in out.values()),
        **{k: out[k] for k in ("dense_voxels", "single_voxel",
                               "chunk_boundaries")})


def micro_inputs(mod, *size):
    return [torch.from_numpy(a).to("cuda") for a in mod.inputs(*size)]


def check_micro():
    """Phase 2, M1 (every mode), M2 and M3 (both precisions) against their
    plain versions at a reduced size; returns each one's largest sd
    error."""
    from chad_tsdf_tpu_torch.scripts import (micro_mxu8, micro_stagea_phases,
                                             micro_tile_accum)
    errs = {
        "micro_stagea_phases": micro_stagea_phases.check(
            *micro_inputs(micro_stagea_phases, MICRO_CHECK_N),
            48)["max_abs_err"],
        "micro_tile_accum": micro_tile_accum.check(
            *micro_inputs(micro_tile_accum, MICRO_CHECK_TILES))["max_abs_err"],
        "micro_mxu8": micro_mxu8.check(
            *micro_inputs(micro_mxu8, MICRO_CHECK_N))["max_abs_err"]}
    log(f"M1-M3 at a reduced size ({MICRO_CHECK_N} points, "
        f"{MICRO_CHECK_TILES} M2 tiles): every mode and precision equals its "
        f"plain version; max sd err {errs}")
    return errs


def run_micro(errs, results):
    """Phase 7: the microbenchmarks' timing runs at full size (launch counts
    read right after), then each held once more against its plain version
    at that size, with the plain version's time."""
    from chad_tsdf_tpu_torch import kernels
    from chad_tsdf_tpu_torch.scripts import (micro_mxu8, micro_stagea_phases,
                                             micro_tile_accum)
    kernels.reset_launches()
    b1 = micro_stagea_phases.benchmark(with_check=False)
    b2 = micro_tile_accum.benchmark(with_check=False)
    b3 = micro_mxu8.benchmark(with_check=False)
    launches = dict(kernels.LAUNCHES)
    c1 = micro_stagea_phases.check(*micro_inputs(micro_stagea_phases), 48,
                                   time_plain=True)
    c2 = micro_tile_accum.check(*micro_inputs(micro_tile_accum),
                                time_plain=True)
    c3 = micro_mxu8.check(*micro_inputs(micro_mxu8), time_plain=True)
    # bounds at the scripts' full sizes: M1 full mode at nb 48 (its live
    # rows from the plain list), M2 every row, M3 its 859 GFLOP of bf16
    m1 = micro_stagea_phases
    m1_key = torch.from_numpy(m1.inputs()[0]).to("cuda")
    m1_live = int((m1.tile_lists(m1_key, 48) != m1.INF).sum())
    m1_tiles = m1.N // m1.TILE
    m2 = micro_tile_accum
    m3 = micro_mxu8
    m3_flop = 2.0 * 512 * 2 * m3.NB * m3.K * m3.N
    bounds = {
        "micro_stagea_phases": bound(12 * m1.K * m1.N + m1_tiles * 48 * 4 +
                                     m1_live * 4096),
        "micro_tile_accum": bound(12 * m2.S * m2.NTILES + m2.NTILES * m2.NB *
                                  (4 + 4096)),
        "micro_mxu8": bound(16 * m3.K * m3.N + (m3.N // 1024) * m3.NB * 4096,
                            m3_flop, BF16_FLOPS)}
    for name, ms, plain_ms, err in (
            ("micro_stagea_phases", b1["ms"]["full_nb48"],
             c1["plain_ms"]["full"], c1["max_abs_err"]),
            ("micro_tile_accum", b2["ms"], c2["plain_ms"], c2["max_abs_err"]),
            ("micro_mxu8", b3["ms"]["bf16"], c3["plain_ms"],
             c3["max_abs_err"])):
        require(launches[name] > 0, f"{name} launched 0 times in its run")
        results[name] = {"max_abs_err": max(err, errs[name]), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1]}
    log(f"phase 7 microbenchmarks: M1 ms {b1['ms']}; M1 plain ms "
        f"{c1['plain_ms']}; M2 {b2}; M2 plain ms {c2['plain_ms']}; M3 ms "
        f"{b3['ms']}; M3 plain ms {c3['plain_ms']}; launches {launches}")
    return launches


def pool_of(m):
    """(dir_keys, pool_sd, pool_w) of a map's active state."""
    s = m.state
    return s.dir_keys, s.pool_sd, s.pool_w


def same_state(sa, sb, what):
    """Require equal directories and, through each state's slots, equal
    weights and sd within SD_TOL per weight; returns the sd error."""
    require(torch.equal(sa.dir_keys, sb.dir_keys), f"{what}: dir_keys differ")
    nb = int(sb.n_blocks)
    require(int(sa.n_blocks) == nb, f"{what}: n_blocks differ")
    sl_a = sa.dir_slots[:nb].long()
    sl_b = sb.dir_slots[:nb].long()
    require(torch.equal(sa.pool_w[sl_a], sb.pool_w[sl_b]),
            f"{what}: weights differ")
    err = sd_err_per_weight(sa.pool_sd[sl_a], sb.pool_sd[sl_b],
                            sb.pool_w[sl_b])
    require(err < SD_TOL, f"{what}: sd error {err}")
    return err


def same_map(a, b, what):
    """:func:`same_state` on two maps' active states and, pairwise, on the
    rotated-out states their pending submaps still hold; returns the
    largest sd error."""
    require(len(a._pending) == len(b._pending),
            f"{what}: pending submaps differ")
    pairs = [(a.state, b.state, "active")] + [
        (p.raw_state, q.raw_state, f"rotated-out {i}")
        for i, (p, q) in enumerate(zip(a._pending, b._pending))]
    return max(same_state(x, y, f"{what} ({name})") for x, y, name in pairs)


def bit_equal_maps(a, b, what):
    """Require bit-equal directories and pools, active and rotated-out."""
    states = lambda m: [m.state] + [p.raw_state for p in m._pending]
    require(len(a._pending) == len(b._pending),
            f"{what}: pending submaps differ")
    for x, y in zip(states(a), states(b)):
        for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w"):
            require(torch.equal(getattr(x, f), getattr(y, f)),
                    f"{what}: {f} not bit-equal")


def run_stream(cfg):
    """Phase 8: the KITTI-shaped stream and its checks; returns the launch
    counts of the ``seg`` stream and K2's result on one scan."""
    from chad_tsdf_tpu_torch import MapConfig, TSDFMap, kernels
    from chad_tsdf_tpu_torch.ops import accumulate
    from chad_tsdf_tpu_torch.profile_insert import sorted_cloud
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks

    dev = torch.device("cuda")
    scans = ks.make_scans()
    scfg = ks.stream_config()
    rotations = ks.expected_rotations(scans, scfg)
    require(rotations == 2, f"the stream's policy gives {rotations} rotations")
    sizes = [int(p.shape[0]) for p, _ in scans]
    bucket = next(b for b in scfg.buckets if b >= max(sizes))

    # K2 on one sorted KITTI-shaped scan, padded to its bucket (with points
    # of the scan, marked as padding: a padding point at the scanner's own
    # position has no view direction to orient a normal by)
    pad = np.resize(scans[0][0], (bucket, 3))
    rk2, _ = check_k2(cfg, f"KITTI-shaped scan, {sizes[0]} of {bucket} points",
                      *sorted_cloud(pad, cfg, dev, sizes[0]), time_it=True)

    # bench.py's run: warm pass + stats(), then the timed region
    out = ks.kitti_shaped_stream(device="cuda", config=scfg)
    log(f"phase 8 stream (sparse_impl seg): {json.dumps(out)}; scans of "
        f"{min(sizes)}-{max(sizes)} points in the {bucket} bucket, "
        f"S = {bucket * scfg.dda_steps}")
    require(out["kitti_tile_overflow"] == 0,
            f"kitti_tile_overflow {out['kitti_tile_overflow']}")

    # the three sparse backends in turns; the first round warms each
    rates = {"seg": [], "pallas": [], "fused": []}
    maps, stream_launches = {}, None
    for rnd in range(4):
        for impl in rates:
            c = ks.stream_config(sparse_impl=impl)
            kernels.reset_launches()
            m, dt, n_pts, metrics, reads = ks.timed_stream(scans, c, "cuda")
            launches = dict(kernels.LAUNCHES)
            require(not accumulate.overflowed("cuda"),
                    f"K5 chunk list overflowed on the {impl} stream")
            backends = {m._dispatch_config(p).accumulate_impl
                        for p, _ in scans}
            require(backends == {impl},
                    f"scans dispatched to {backends}, not {impl}")
            require(m.n_submaps == rotations and
                    len(m._pending) == rotations and not m.submaps,
                    f"{impl}: {m.n_submaps} submaps, {len(m._pending)} "
                    f"pending; the policy gives {rotations} deferred")
            host_reads = {int(x["host_reads"]) for x in metrics}
            if impl == "seg":
                require(reads == {} and host_reads == {0},
                        f"seg inserts read the host: {reads}, {host_reads}")
                require(launches["estimate_normals"] == len(scans),
                        f"K2 launched {launches['estimate_normals']} times "
                        f"in {len(scans)} seg inserts")
                for name in ("fused_tile_partials", "merge_partials",
                             "tile_partials", "accumulate_segments"):
                    require(launches[name] == 0,
                            f"{name} launched on the seg stream")
                stream_launches = launches
            if rnd > 0:
                rates[impl].append((len(scans) - 1) / dt)
            if impl in maps and impl == "seg":
                bit_equal_maps(m, maps[impl], "two seg streams")
            maps[impl] = m
            if rnd == 3:
                log(f"phase 8 {impl}: {statistics.median(rates[impl]):.2f} "
                    f"scans/s median of "
                    f"{[round(r, 2) for r in rates[impl]]}, "
                    f"{n_pts / dt:.0f} points/s in the last round; host "
                    f"reads/insert {sorted(host_reads)} (counted calls "
                    f"{reads}); launches in 12 inserts {launches}")
        torch.cuda.empty_cache()
    for impl in ("pallas", "fused"):
        err = same_map(maps[impl], maps["seg"], f"stream {impl} vs seg")
        log(f"phase 8 {impl} vs seg: directories and weights equal on the "
            f"active and {rotations} rotated-out states, sd err/weight "
            f"{err:.3e}")
    require(int(maps["fused"].state.tile_overflow) > 0,
            "the fused stream did not fall back")

    # the seg map's drain: overflow counters, submaps, DAG counters; then a
    # stream drained after every insert must give the same DAG
    deferred = maps["seg"]
    sample_blocks = int(deferred.state.n_blocks)
    stats = deferred.stats()
    require(stats["n_submaps"] == rotations and not deferred._pending,
            f"stats(): {stats['n_submaps']} submaps")
    require(not any(stats["overflow"].values()),
            f"seg stream overflow {stats['overflow']}")
    drained = TSDFMap(config=scfg, device="cuda")
    for pts, pos in scans:
        drained.insert(pts, pos)
        drained._drain_pending()
    require(drained.stats() == stats, "drain after every insert: stats differ")
    for f in ("dir_keys", "pool_sd", "pool_w"):
        require(torch.equal(getattr(drained.state, f),
                            getattr(deferred.state, f)),
                f"drain after every insert: {f} differs")
    log(f"phase 8 determinism: two seg streams bit-equal (pools and "
        f"directories, active and rotated-out); deferred rotation equals a "
        f"drain after every insert; stats(): n_submaps "
        f"{stats['n_submaps']}, leaf clusters {stats['leaf_clusters']}, "
        f"active blocks {sample_blocks}, overflow {stats['overflow']}")
    del maps, drained, deferred
    torch.cuda.empty_cache()

    # one scan: seg against the scatter backend, packed against f32 ingest
    pts, pos = scans[0]
    one = {}
    for name, kw in (("seg", dict(accumulate_impl="seg")),
                     ("xla", dict(accumulate_impl="xla")),
                     ("f32", dict(accumulate_impl="seg",
                                  packed_ingest=False))):
        one[name] = TSDFMap(config=ks.stream_config(**kw), device="cuda")
        met = one[name].insert(pts, pos)
    err = same_map(one["seg"], one["xla"], "one scan, seg vs scatter")
    abs_err = float((one["seg"].state.pool_sd -
                     one["xla"].state.pool_sd).abs().max())
    require(abs_err <= 1e-5, f"seg vs scatter pool_sd differs by {abs_err}")
    c1, s1 = one["f32"].voxel_samples()
    c2, s2 = one["seg"].voxel_samples()
    common, i1, i2 = np.intersect1d(c1, c2, return_indices=True)
    share = common.shape[0] / max(c1.shape[0], c2.shape[0])
    diff = np.abs(s1[i1] - s2[i2])
    require(share >= 0.95 and float(np.median(diff)) < 0.004 and
            float(np.mean(diff)) < 0.01,
            f"packed vs f32 ingest: share {share}, median {np.median(diff)}, "
            f"mean {np.mean(diff)}")
    log(f"phase 8 one scan ({sizes[0]} points): n_valid_samples "
        f"{met['n_valid_samples']}, touched blocks "
        f"{met['n_touched_blocks']}, unique voxels "
        f"{int((one['seg'].state.pool_w > 0).sum())}; seg vs scatter "
        f"backend weights equal, sd err/weight {err:.3e}, max abs "
        f"{abs_err:.3e}; packed vs f32 ingest share {share:.4f} of "
        f"{c1.shape[0]} / {c2.shape[0]} voxels, sd diff median "
        f"{np.median(diff):.2e} mean {np.mean(diff):.2e}")
    return stream_launches, rk2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    sys.path.insert(0, ROOT)
    from chad_tsdf_tpu_torch import MapConfig, TSDFMap, kernels
    from chad_tsdf_tpu_torch.mesh import read_ply
    require(not jax_package_modules(),
            f"the port imported {jax_package_modules()}")

    # ---- phase 1: build ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "Used" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # ---- phase 2: kernels vs plain versions ----
    cfg = MapConfig()
    results = {}
    check_kernels(cfg, results)
    torch.cuda.empty_cache()
    check_k5(cfg, results)
    micro_errs = check_micro()
    torch.cuda.empty_cache()

    # ---- phase 3: the main path ----
    dense = sphere(N_DENSE, 5.0, 420)
    origin0 = np.zeros(3, np.float32)
    kernels.reset_launches()
    m = TSDFMap(0.05, 0.1, device="cuda")
    met = m.insert(dense, origin0)
    torch.cuda.synchronize()
    insert_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        met = m.insert(dense, origin0)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
    dense_launches = dict(kernels.LAUNCHES)
    for name in ("fused_tile_partials", "estimate_normals", "merge_partials"):
        require(dense_launches[name] > 0,
                f"{name} launched 0 times on the dense sphere")
    require(dense_launches["tile_partials"] == 0,
            "the dense sphere fell back through K4")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        t0 = time.perf_counter()
        m.save(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        mesh = read_ply(path)
    n_blocks = int(m.state.n_blocks)
    tile_ovf = int(m.state.tile_overflow)
    require(tile_ovf == 0, f"dense sphere tile_overflow {tile_ovf}")
    require(n_blocks > 0, "no blocks allocated")
    require(met["host_reads"] == 1, "host reads per insert != 1")
    lossy = {k: int(getattr(m.state, k)) for k in
             ("point_overflow", "sample_overflow", "block_overflow",
              "touched_overflow")}
    require(not any(lossy.values()), f"overflow {lossy}")
    require(mesh.n_vertices > 0 and mesh.n_faces > 0, "empty mesh")
    radius = np.linalg.norm(mesh.vertices.astype(np.float64), axis=1)
    rmse = float(np.sqrt(np.mean((radius - 5.0) ** 2)))
    require(rmse < 0.1 * cfg.sdf_res, f"sphere RMSE {rmse}")
    ins = statistics.median(insert_ms)
    log(f"phase 3 dense insert: {ins:.3f} ms median of "
        f"{[round(x, 3) for x in insert_ms]} -> {N_DENSE / ins * 1e3:.0f} "
        f"points/s; n_blocks {n_blocks}, tile_overflow {tile_ovf}, "
        f"host reads/insert {met['host_reads']}, n_valid_samples "
        f"{met['n_valid_samples']}; launches {dense_launches}")
    log(f"phase 3 save: {save_ms:.1f} ms (sub fin "
        f"{m.last_metrics['sub_fin_ms']:.1f} ms, mesh "
        f"{m.last_metrics['mesh_ms']:.1f} ms); {mesh.n_vertices} vertices, "
        f"{mesh.n_faces} faces, RMSE to the r=5 sphere {rmse:.6f} m")

    # the pallas and tile backends: same cloud, same number of inserts
    from chad_tsdf_tpu_torch.ops import accumulate
    for impl in ("pallas", "tile"):
        kernels.reset_launches()
        mb = TSDFMap(0.05, 0.1, config=dataclasses.replace(
            cfg, accumulate_impl=impl), device="cuda")
        mb.insert(dense, origin0)
        torch.cuda.synchronize()
        impl_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            mb.insert(dense, origin0)
            torch.cuda.synchronize()
            impl_ms.append((time.perf_counter() - t0) * 1e3)
        impl_launches = dict(kernels.LAUNCHES)
        needed = (("accumulate_segments",) if impl == "pallas" else
                  ("tile_partials", "merge_partials"))
        for name in needed:
            require(impl_launches[name] > 0,
                    f"{name} launched 0 times on the {impl} backend")
        require(not accumulate.overflowed("cuda"),
                f"K5 chunk list overflowed on the {impl} backend")
        err = same_map(mb, m, f"dense {impl} vs fused")
        log(f"phase 3 {impl} insert: {statistics.median(impl_ms):.3f} ms "
            f"median of {[round(x, 3) for x in impl_ms]} (fused "
            f"{ins:.3f} ms); dir_keys and weights equal to the fused map's, "
            f"sd err/weight {err:.3e}; tile_overflow "
            f"{int(mb.state.tile_overflow)}; launches {impl_launches}")
        del mb
        torch.cuda.empty_cache()
    del m
    torch.cuda.empty_cache()

    # ---- phase 4: sparse insert -> fallback through K4 and K5 ----
    # fused by name: under auto this cloud would be dispatched to seg
    sparse_cfg = MapConfig(max_points=2048, accumulate_impl="fused")
    sparse = sphere(2048, 5.0, 7)
    ms_ = TSDFMap(0.05, 0.1, config=sparse_cfg, device="cuda")
    scatter = accumulate.accumulate_xla

    def no_scatter(*args, **kw):
        raise AssertionError("the fallback reached the scatter form")

    kernels.reset_launches()
    accumulate.accumulate_xla = no_scatter
    try:
        ms_.insert(sparse, origin0)
    finally:
        accumulate.accumulate_xla = scatter
    sparse_launches = dict(kernels.LAUNCHES)
    for name in ("tile_partials", "accumulate_segments"):
        require(sparse_launches[name] > 0,
                f"{name} launched 0 times on the sparse insert")
    require(int(ms_.state.tile_overflow) > 0, "sparse insert did not fall back")
    require(not accumulate.overflowed("cuda"),
            "K5 chunk list overflowed on the sparse insert")
    mx = TSDFMap(0.05, 0.1, config=dataclasses.replace(
        sparse_cfg, accumulate_impl="xla"), device="cuda")
    mx.insert(sparse, origin0)
    err = same_map(ms_, mx, "sparse fused vs the scatter backend")
    log(f"phase 4 sparse insert: tile_overflow "
        f"{int(ms_.state.tile_overflow)}, n_blocks {int(mx.state.n_blocks)}, "
        f"sd err/weight vs scatter backend {err:.3e}; launches "
        f"{sparse_launches}")

    # ---- phase 5: determinism ----
    for name, pts, c in (("dense", dense, cfg), ("sparse", sparse,
                                                  sparse_cfg),
                         ("dense pallas", dense, dataclasses.replace(
                             cfg, accumulate_impl="pallas"))):
        a = TSDFMap(0.05, 0.1, config=c, device="cuda")
        b = TSDFMap(0.05, 0.1, config=c, device="cuda")
        a.insert(pts, origin0)
        b.insert(pts, origin0)
        for x, y in zip(pool_of(a), pool_of(b)):
            require(torch.equal(x, y), f"{name} insert not deterministic")
        log(f"phase 5 determinism ({name}): pools bit-equal")
        del a, b
        torch.cuda.empty_cache()

    # ---- phase 6: golden workload through the fused path ----
    g = np.load(os.path.join(ROOT, "tests", "golden",
                             "sphere_r2_seed420.npz"))
    rng = np.random.default_rng(420)
    d = rng.uniform(-1.0, 1.0, (65536, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    gm = TSDFMap(config=MapConfig(max_points=65536, block_capacity=16384,
                                  touched_capacity=8192,
                                  accumulate_impl="fused"), device="cuda")
    gm.insert((d * 2.0).astype(np.float32), origin0)
    codes, sd = gm.voxel_samples()
    n_diff, sd_diff = golden_diff(codes, sd, g["codes"], g["sd"])
    step = 0.1 / 127
    require(n_diff <= GOLDEN_MAX_CODE_DIFF,
            f"{n_diff} voxel codes differ from the golden")
    require(sd_diff <= step + 1e-7, f"golden sd differs by {sd_diff}")
    log(f"phase 6 golden: {codes.shape[0]} voxel codes vs "
        f"{g['codes'].shape[0]}, {n_diff} differ; max sd diff on the common "
        f"codes {sd_diff:.3e} (one step {step:.3e})")

    # ---- phase 7: microbenchmarks at full size ----
    micro_launches = run_micro(micro_errs, results)

    # ---- phase 8: the sparse streaming path ----
    stream_launches, rk2 = run_stream(cfg)
    results["estimate_normals"]["kitti_scan"] = rk2

    # ---- result ----
    launches = dict(dense_launches,
                    tile_partials=sparse_launches["tile_partials"],
                    accumulate_segments=sparse_launches[
                        "accumulate_segments"],
                    **{k: micro_launches[k] for k in (
                        "micro_stagea_phases", "micro_tile_accum",
                        "micro_mxu8")})
    require(not jax_package_modules(),
            f"the run loaded {jax_package_modules()}")
    out = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r.get("library_ms"),
                    "launches_stream": stream_launches[name]})
    log(f"phase 2 details: {json.dumps(results)}")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
