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
   must give bit-equal normals; K1 and K4 with block lists of 128 and 256
   (the wide form: 16-bit ranks beside the sample words) on one sorted
   KITTI-shaped scan at K = 10, against their plain versions and each
   other; the general K4 at (K = 1, nb = 128) on that scan's block-sorted
   sample stream and K3 merging its 163,840 partial-row slots, each against
   its plain version, timed, with its bound (K3 also against
   ``index_add_``); the sorted K4 (``tile_partials_sorted``, the
   ``sample_tile`` path's K4) on the same stream's keys and payload words:
   equal to its plain version and bit-equal to the general K4 on the
   unpacked stream at nb 128 and 8, equal to its plain version at nb 4,096
   (past the general kernel's limit) on the 64 tiles with the most runs,
   its unsorted word clear and set on a copy with one tile's keys
   shuffled; timed beside its plain version and the parent path
   (``unpack_payload`` and the general K4 in one call); K5 segment
   accumulate on the ``pallas``
   backend's tables of the 1M-point sphere, the dense-voxel cloud and a
   single-voxel cloud (2^20 points in one voxel), and on a synthetic table
   with segments on chunk boundaries: its device chunk list against the
   plain one, both pool planes bit for bit against the plain version, and
   two launches bit-equal; the
   microbenchmark kernels M1 (every mode, nb 48 and 128), M2 and M3 (both
   precisions) at a
   reduced size, M3 at every nb it takes on the script's inputs and on four
   edge cases (one offset group, ``use`` all zero, sdq = +-127, lrow outside
   [0, nb)), its wgmmas per tile equal to the padded group lists.  K3 and
   K5 are also timed against one PyTorch call that computes their function
   (``index_add_`` / ``index_put_(accumulate=True)``), a yardstick the port
   never calls; the one-thread kernel that sets a CUDA graph's IF node
   (``ops/conditional.py``) in a captured graph whose IF body allocates,
   replayed for counts of both signs and zero after the allocator emptied
   its cache and gave memory away, against its plain version; the ``seg``
   insert's sample kernel (``ops/seg_samples.py``) on ``kitti_parked``'s 8
   street sweeps (``tsdf_bench/``), each padded to its 131,072-point
   bucket, and on a ragged cloud with a point outside the local extent, a
   ray leaving it and a zero-length ray: keys (in order and sorted),
   ``n_valid`` and the sample overflow bit-equal to its plain version, a
   second launch bit-equal, timed beside the plain version with its bound;
   the carve's three kernels (``ops/carve_kernels.py``) on a parked
   sweep's carve into the map of another sweep from the same spot
   (``scripts/carve_stages.py``, at ``kitti_parked_carve``'s map
   configuration): keys, ``n_valid``, the digit counts, the sorted keys
   (``carve_sort`` against ``torch.sort``), both pool planes,
   ``touched_overflow`` and the three metrics bit-equal to the plain route,
   under the cell's touched cap and one that loses blocks, each kernel timed
   beside the plain stages it replaces, with its bound (the sort beside
   ``torch.sort``, its library yardstick);
3. the main path: ``TSDFMap(0.05, 0.1, device="cuda")`` at the default
   MapConfig inserts the 2^20-point r = 5 m sphere (seed 420, bench.py's
   cloud) six times (the first runs eagerly and captures the map's CUDA
   graph, the other five replay it; the eager insert is timed beside them)
   and saves a PLY through device marching cubes (``mesh_impl``
   ``auto`` on CUDA; its calls are counted), whose vertices must sit on the
   sphere; then the ``pallas`` and ``tile`` backends insert the same cloud
   and must give the fused map's blocks, weights and signed distances;
4. a sparse 2048-point eager insert whose tiles overflow, so the
   fallback (K4, then K5) that the eager step runs is needed; its pool is
   held against the scatter backend, and the scatter form is not reached
   on the fallback;
5. determinism: two fresh maps, same insert, bit-equal pools (dense,
   sparse, and dense under ``pallas``);
6. the golden workload (tests/golden/sphere_r2_seed420.npz) through the
   fused path;
7. the microbenchmarks' own timing runs at their full sizes
   (``chad_tsdf_tpu_torch.scripts``), then each held once more against its
   plain version at that size; M3's yardstick, one ``torch.bmm`` of the
   dense bf16 one-hot and value operands with f32 sums (equal to the plain
   version), and beside it one ``index_add_`` of the kept samples onto
   precomputed flat cells;
8. the sparse streaming path at full width: bench.py's KITTI-shaped stream
   (``chad_tsdf_tpu_torch.scripts.kitti_stream``: 12 scans of ~120k points
   1.5 m apart, ``MapConfig(block_capacity=1 << 16, touched_capacity=
   1 << 15, packed_ingest=True)``), its scans/s, points/s and
   ``tile_overflow``; every scan must be dispatched to ``seg``, read
   nothing on the host, replay the map's graph (captured after the eager
   first scan) that launches K2 and no other kernel, overflow nothing and
   leave 2 deferred rotations behind; K2 against its plain version on one
   sorted scan; the same stream under ``sparse_impl`` = ``seg``,
   ``sample_tile``, ``pallas`` and ``fused`` through the graphs and under
   ``seg`` eagerly, in turns (median scans/s of each), the final maps'
   directories and weights equal to each other (the two ``seg`` ones bit
   for bit), rotated-out submaps included, the ``sample_tile`` graph
   launching K2, the sorted K4, K3 and the IF node's kernel a replay and K5
   in the IF node, whose body runs (``tile_overflow`` > 0), and the general
   K4 not at all;
   ``seg`` against the scatter backend and packed against f32 ingest on one
   scan; two ``seg`` streams bit-equal in pools and DAG counters, and a
   stream drained after every insert equal to the deferred one; and
   ``kitti_parked``'s 8 sweeps twice through the map's graph, eagerly,
   and eagerly with ``seg_samples``' plain version: directories and pools
   bit-equal, the graph launching K2 and ``seg_samples`` once a replay;
9. ``save`` on the card: the phase-3 sphere map and a ``seg`` stream map
   of phase 8 (2 pending rotations, drained by the save) each saved under
   ``auto``, which must run device marching cubes once, and then with
   ``mesh_impl="host"``: both ``save`` times, ``last_metrics``' split
   (``sub_fin_ms``, ``voxel_samples_ms``, ``mc_ms``, ``normals_ms``,
   ``ply_ms``) and the peak device memory; the device mesh of each map's
   voxel samples against the host mesh of the same samples (vertex sets
   within 1e-6 m, face sets and counts equal); and the sphere's ``.grid``
   dump, whose header counts must equal ``mesh/grid.py`` ``build_cells``';
10. carving on phase 8's stream (``carve_steps=128, carve_stride=2.0,
   carve_subsample=2``: 12.8 m of free space per ray, 65,536 rays a
   scan): every scan dispatched to ``seg`` and then carved with no host
   read; scans/s with carving off and on in turns; carve ms per insert
   (CUDA events); one scan's carve on the card against the port's CPU run
   on the same state and points (differing voxels must be 0, counters
   equal); and ``examples/demo_carve.py``'s parked-car scene at its sizes,
   whose car must leave the mesh while the wall stays;
11. checkpoints: the 12-scan stream map with its 2 pending rotations saved
   (``io/checkpoint.py``), loaded into a new map on the card, and 2 more
   scans (one more rotation) inserted into both: pools, directories
   (active and rotated-out), ``voxel_samples`` and ``stats()`` bit-equal;
   save ms, load ms, file MB;
12. loop closure: two passes over the 2^20-point r = 5 m sphere, the second
   shifted by a 0.35 m odometry drift, each finalized;
   ``optimize_loop_closures`` with the true loop edge (called twice: the
   first call pays one-time set-up) must correct submap 1 by -drift
   (within 0.01 m) with poses equal to the port's CPU solve (within 1e-4),
   and the saved mesh's RMSE to the sphere must drop;
13. the sharded map (``parallel/``) on the one card: ``ShardedTSDFMap`` on
   ``make_mesh(1)`` bit-equal to ``TSDFMap`` on the sphere with no host
   read; the N = 1 generic path (scratch pool, routing, K3 merge) with K1,
   K2 and K3 launched and no row routed, equal to ``TSDFMap``; four shards
   on the card (``make_mesh(4)``) on the sphere at the default MapConfig
   (no row deferred, some rows routed, merged keys and weights equal to
   ``TSDFMap``'s, sd within tests/test_sharding.py's rule; K2, K1 and K3
   held against their plain versions on the inputs that insert gave them:
   each shard's point bucket, each shard's scratch merge and each shard's
   merge of its own and the received halo rows, K3 bit-equal on both pool
   planes, the received live rows adding up to ``route_sent``; insert ms
   in turns, and by stage; ``save`` through device MC against
   ``TSDFMap``'s mesh) and on the phase-8
   stream (scans/s in turns, two streams bit-equal, no host read but where
   the stubs' byte bound drains one, keys and weights equal to the
   single-device stream's, voxel samples under tests/test_sharded_map.py's
   rule, ``save``); the carved stream (counters equal to ``TSDFMap``'s,
   none dropped below 0); an N = 4 checkpoint resumed on 2 shards with 2
   more scans into both; ``optimize_poses(mesh=...)`` against the N = 1
   solve; and a world-size-1 NCCL group running the generic insert through
   the collectives, bit-equal to the in-process exchange;
14. ``core.integrate.insert_steps_scan`` replaying a captured CUDA graph:
   at reps 3 bit-equal to 3 eager ``insert_step``s (pools, directory, slot
   order and the five counters) on the 2^20-point sphere (K1, K2, K3 in
   the graph, K4 and K5 in its IF node, not run) and on phase 4's
   2048-point sparse sphere under ``fused`` (the IF node runs K4 and K5)
   and on one KITTI-shaped scan under ``sample_tile`` (K2, the sorted K4,
   K3 in the graph, K5 in its IF node, which runs); the launches per replay as
   captured, and as the profiler names the kernels of 4 replays; no
   synchronising call from ``core/integrate.py``
   while replaying; ms per insert through the graph, the eager loop and a
   synced single, and the device's busy share under replay; the memory
   reserved before, during and after; ``utils.timing.profile_insert``'s
   report and a ``trace`` file on the card; ``examples/demo_sphere`` at
   full size in its own process, its PLY on the r = 5 sphere;
15. in a process of its own, ``TSDFMap.insert`` through its CUDA graphs
   (``core/graph.py``), every insert bit-equal to the eager insert of a
   twin map (states active and rotated-out, every metric) and reading
   nothing on the host: the dense
   sphere under ``fused``, ``tile``, ``pallas`` and ``sample_tile``
   (clouds of 2^20,
   2^20 - 12,345 and 900,000 points in one bucket), the 2048-point sparse
   sphere under ``fused`` (three clouds, the IF node runs K4 and K5) and
   ``sample_tile`` (the IF node runs K5), and phase 8's stream with its two
   rotations, carving off and on, and under ``sparse_impl="sample_tile"``
   (the IF node runs K5; then the drain's ``stats()`` equal); the launches
   per replay outside and inside
   the IF node (under ``sample_tile`` the sorted K4 once outside it and the
   general K4 nowhere), and for the sphere clouds the kernels the profiler sees in
   one more replay; the graphs' bytes and the memory reserved before,
   during and after; the cost of the rotation design (the stub's copy of
   the graph's state and its reset in place, against an eager insert and
   a capture on new tensors).

The fused, tile and pallas inserts must not wait for the card
(``utils/timing.py`` ``COUNTS["host_syncs"]`` does not grow over a
replay, nor over an eager insert, whose fallback runs unconditionally),
and the fused
inserts run once more under ``torch.cuda.set_sync_debug_mode("warn")``:
no synchronising call may come from ``core/integrate.py``.

A graph's kernels are counted where they are captured, never where the
graph replays, so a map's counts are those of its eager first insert (its
fallback runs unconditionally there, adding nothing where no sample needs
it) and of the capture; the graphs report what one replay launches.
Launch counts are reset just before the dense inserts of phase 3 and read
right after them: K1, K2, K3 and ``set_conditional`` must have launched
there, and the map's graph must hold one of each outside its IF node.
They are reset again just before phase 4's sparse insert, where K4 and K5
must launch, just before phase 7's timing runs, where M1-M3 must launch,
and just before phase 8's stream, where K2 and ``seg_samples`` must
launch twice each (the eager scan and the capture), the graph one of each
a replay, and K1, K3, K4 and K5 not at all; and before each of phase 8's
``sample_tile`` streams, where K2, the sorted K4, K3 and
``set_conditional`` must launch and K1, the general K4 and
``seg_samples`` not at all.
Phases 10-12 reset them just before their own inserts and read them right
after (K2, ``seg_samples``, ``carve_keys``, ``carve_sort`` and
``carve_apply`` twice each on the carved stream, the eager scan and the
capture, and its graphs once each a replay; K2 on the checkpoint's 2
scans, K1-K3 on the loop closure's sphere passes); phase 13 just before
one N = 4 dense insert (K1-K3) and the N = 4 stream (K2, K3).
The ``kernels`` JSON line (before the card's name and the last line) gives
each kernel's launches in the run that drives it: phase 3 for K1-K3, phase 4
for K4-K5, phase 8's ``sample_tile`` stream for the sorted K4, phase 8's
``seg`` stream for ``seg_samples``, phase 10's carved stream for the
carve's kernels, phase 7 for M1-M3 (and, as ``launches_stream``,
``launches_carve``, ``launches_checkpoint`` and ``launches_loop_closure``,
in the inserts of phases 8, 10, 11 and 12, and as
``launches_sharded_dense`` and ``launches_sharded_stream`` in phase 13's,
and as ``launches_per_replay_dense``, ``launches_per_replay_fallback`` and
``launches_per_replay_sample_tile`` each replay of phase 14's three graphs,
as ``launches_sample_tile_stream`` phase 8's ``sample_tile`` stream, and as
``launches_per_insert_map``
each insert through phase 15's map graphs, by cloud: what the graph
launches outside its IF node, plus its body where the cloud falls back),
with its time, its plain
version's time, the library call's time (or null) and ``bound_ms``: the
least time the H100 could take for the same work on this run's inputs, the
larger of the bytes the function must move (each input read once, each
output written once)
over 3.35 TB/s and its operations over the peak rate of their type
(``bound_by`` says which); M3's entry also has its int8 time,
``ms_int8`` (``ms`` is bf16's), K4's and K3's entries their numbers
at the ``sample_tile`` path's shapes under ``sample_tile``, and the sorted
K4's entry the parent path's time, ``parent_path_ms``.  The last line is
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
    # K4 on the sample_tile path's block-sorted sample stream
    "tile_partials_sorted": ("chad_tsdf_tpu_torch/csrc/tile_sorted.cu",
                             "chad_tsdf_tpu/ops/tile_accum.py:134"),
    "accumulate_segments": ("chad_tsdf_tpu_torch/csrc/accumulate.cu",
                            "chad_tsdf_tpu/ops/accumulate.py:223"),
    "micro_stagea_phases": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                            "scripts/micro_stagea_phases.py:168"),
    "micro_tile_accum": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                         "scripts/micro_tile_accum.py:72"),
    "micro_mxu8": ("chad_tsdf_tpu_torch/csrc/micro.cu",
                   "scripts/micro_mxu8.py:129"),
    # no TPU kernel: it sets the IF node that stands for the lax.cond
    "set_conditional": ("chad_tsdf_tpu_torch/csrc/conditional.cu",
                        "chad_tsdf_tpu/core/integrate.py:674"),
    # no TPU kernel: the seg insert's samples, which XLA computes there
    "seg_samples": ("chad_tsdf_tpu_torch/csrc/seg_samples.cu",
                    "chad_tsdf_tpu/core/integrate.py:759"),
    # no TPU kernel: the carve's keys, their sort (lax.sort) and the pool
    # update, which XLA computes there
    "carve_keys": ("chad_tsdf_tpu_torch/csrc/carve.cu",
                   "chad_tsdf_tpu/core/carve.py:121"),
    "carve_sort": ("chad_tsdf_tpu_torch/csrc/carve_sort.cu",
                   "chad_tsdf_tpu/core/carve.py:139"),
    "carve_apply": ("chad_tsdf_tpu_torch/csrc/carve.cu",
                    "chad_tsdf_tpu/core/carve.py:121"),
}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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


def integrate_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: (the
    synchronising calls made from ``core/integrate.py`` as file:line, all
    synchronising calls by file:line)."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    mine = {k: v for k, v in where.items()
            if k.startswith(os.path.join("chad_tsdf_tpu_torch", "core",
                                         "integrate.py"))}
    return mine, dict(where)


def sd_err_per_weight(sd_a, sd_b, w):
    return float((torch.abs(sd_a - sd_b) / torch.clamp(w, min=1.0)).max())


def hold_k1(k1, fargs, kw, what):
    """K1's outputs ``k1`` against its plain version on the same inputs:
    block lists and counters equal, weights equal on the live rows, sd
    within SD_TOL per unit weight.  Returns (the live-row mask, max |sd
    difference| on the live rows)."""
    from chad_tsdf_tpu_torch.ops import fused_integrate, tile_accum
    p1 = fused_integrate.fused_tile_partials_plain(*fargs, **kw)
    require(torch.equal(k1[0], p1[0]), f"K1 block lists differ ({what})")
    require(torch.equal(k1[3], p1[3]), f"K1 counters differ ({what})")
    live = tile_accum.live_rows(p1[0])
    require(torch.equal(k1[2][live], p1[2][live]),
            f"K1 weights differ ({what})")
    err = sd_err_per_weight(k1[1][live], p1[1][live], p1[2][live])
    require(err < SD_TOL, f"K1 sd error {err} ({what})")
    return live, float((k1[1][live] - p1[1][live]).abs().max())


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
    live1, err_abs = hold_k1(k1, fargs, kw, "sphere")
    n_live = int(live1.sum())
    tot = k1[3].sum(0).tolist()
    tiles = N_DENSE // 1024
    results["fused_tile_partials"] = {
        "max_abs_err": err_abs,
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
    results["merge_partials"], merged_w = check_k3(state, k1, cfg, "sphere")
    require(torch.equal(merged_w, 2 * state.pool_w), "K3 lost weight")
    log(f"K3 merge_partials: {results['merge_partials']}")
    del state, k1, merged_w


def check_k3(state, partials, cfg, what):
    """K3 merging the partial rows ``partials`` (a tile kernel's pkeys, psd,
    pw) into copies of ``state``'s pools against its plain version: weights
    equal, sd within SD_TOL per unit weight; timed, with its bound and the
    yardstick, one ``index_add_`` of all P rows ([sd | w] side by side) at
    their slots, dead rows at the reserved slot, as a scatter would.
    Returns (the result, the weight plane after one merge)."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.ops import tile_accum
    pkeys, psd, pw = partials[:3]
    _, plan, _, _ = integrate.plan_tiled_merge(state, pkeys, cfg)
    pools_k = (state.pool_sd.clone(), state.pool_w.clone())
    pools_p = (state.pool_sd.clone(), state.pool_w.clone())
    tile_accum.merge_partials(*pools_k, *plan, psd, pw)
    tile_accum.merge_partials_plain(*pools_p, *plan, psd, pw)
    require(torch.equal(pools_k[1], pools_p[1]), f"K3 weights differ ({what})")
    err3 = sd_err_per_weight(pools_k[0], pools_p[0], pools_p[1])
    require(err3 < SD_TOL, f"K3 sd error {err3} ({what})")
    merged_w = pools_k[1].clone()      # the timing below merges again
    n_groups, gstart, glen, grow, prow, src = plan
    ng = int(n_groups[0])
    lens = glen[:ng].to(torch.int64)
    slot_sorted = torch.full((pkeys.shape[0],), cfg.block_capacity - 1,
                             dtype=torch.int64, device=pkeys.device)
    n_live = int(lens.sum())
    slot_sorted[:n_live] = (torch.repeat_interleave(grow[:ng].to(
        torch.int64), lens) * 8 + prow[:n_live].to(torch.int64))
    row_slot = torch.empty_like(slot_sorted)
    row_slot[src.to(torch.int64)] = slot_sorted
    both_pool = torch.cat(pools_p, dim=1)
    both_rows = torch.cat((psd, pw), dim=1)
    touched = int(torch.unique(slot_sorted[:n_live]).shape[0])
    r = {"max_abs_err": float((pools_k[0] - pools_p[0]).abs().max()),
         "ms": cuda_ms(lambda: tile_accum.merge_partials(
             *pools_k, *plan, psd, pw)),
         "plain_ms": cuda_ms(lambda: tile_accum.merge_partials_plain(
             *pools_p, *plan, psd, pw), reps=3),
         "library_ms": cuda_ms(lambda: both_pool.index_add_(0, row_slot,
                                                            both_rows)),
         "slots": int(pkeys.shape[0]), "live_rows": n_live,
         "touched_rows": touched, "groups": ng}
    # each live partial row read once (and its plan entry), each touched
    # pool row read and written once
    r["bound_ms"], r["bound_by"] = bound(
        n_live * (4096 + 8) + touched * 8192 + ng * 12)
    return r, merged_w


def hold_k4(k4, targs, what):
    """K4's outputs ``k4`` against its plain version on ``targs``: block
    lists and overflow masks equal, weights equal on the live rows, sd
    within SD_TOL per unit weight.  Returns (the live-row mask, max |sd
    difference| on the live rows)."""
    from chad_tsdf_tpu_torch.ops import tile_accum
    p4 = tile_accum.tile_partials_plain(*targs)
    require(torch.equal(k4[0], p4[0]), f"K4 block lists differ ({what})")
    require(torch.equal(k4[3], p4[3]), f"K4 ovfmask differs ({what})")
    live = tile_accum.live_rows(p4[0])
    require(torch.equal(k4[2][live], p4[2][live]),
            f"K4 weights differ ({what})")
    err = sd_err_per_weight(k4[1][live], p4[1][live], p4[2][live])
    require(err < SD_TOL, f"K4 sd error {err} ({what})")
    return live, float((k4[1][live] - p4[1][live]).abs().max())


def hold_k4_sorted(k4s, bkey, payload, nb, trunc, what, general=True):
    """The sorted K4's outputs ``k4s`` on the stream (``bkey``, ``payload``)
    against its plain version (block lists and overflow masks equal,
    weights equal on the live rows, sd within SD_TOL per unit weight) and,
    with ``general``, bit-equal to the general K4 on the unpacked stream
    (lists, masks, both planes' live rows); its unsorted word clear.
    Returns (the live-row mask, max |sd difference| to the plain version
    on the live rows)."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.ops import tile_accum
    require(int(k4s[4][0]) == 0,
            f"sorted K4 set its unsorted word on a sorted stream ({what})")
    p = tile_accum.tile_partials_sorted_plain(bkey, payload, nb, trunc)
    require(torch.equal(k4s[0], p[0]), f"sorted K4 block lists differ ({what})")
    require(torch.equal(k4s[3], p[3]), f"sorted K4 ovfmask differs ({what})")
    live = tile_accum.live_rows(p[0])
    require(torch.equal(k4s[2][live], p[2][live]),
            f"sorted K4 weights differ ({what})")
    err = sd_err_per_weight(k4s[1][live], p[1][live], p[2][live])
    require(err < SD_TOL, f"sorted K4 sd error {err} ({what})")
    max_abs = float((k4s[1][live] - p[1][live]).abs().max())
    del p
    if general:
        s = bkey.shape[0]
        okey, sd = integrate.unpack_payload(payload, trunc)
        g = tile_accum.tile_partials(bkey.reshape(1, s), okey.reshape(1, s),
                                     sd.reshape(1, s), nb, trunc)
        require(torch.equal(k4s[0], g[0]) and torch.equal(k4s[3], g[3]) and
                torch.equal(k4s[1][live], g[1][live]) and
                torch.equal(k4s[2][live], g[2][live]),
                f"sorted K4 is not bit-equal to the general K4 ({what})")
    return live, max_abs


def kitti_scan_inputs(cfg, dev):
    """Scan 0 of phase 8's stream padded to its 131,072-point bucket (with
    points of the scan marked as padding), Morton-sorted, with K2's
    normals: (scan points, scan position, bucket, sb, so, px, py, pz, nx,
    ny, nz)."""
    from chad_tsdf_tpu_torch.ops import normals_cuda
    from chad_tsdf_tpu_torch.profile_insert import sorted_cloud
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks
    (pts, pos), = ks.make_scans(1)
    bucket = next(b for b in ks.stream_config().buckets if b >= len(pts))
    sb, so, px, py, pz = sorted_cloud(np.resize(pts, (bucket, 3)), cfg, dev,
                                      len(pts))
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    nk = normals_cuda.estimate_normals(px, py, pz, sb, so, zero,
                                       cfg.normal_min_points,
                                       cfg.normal_max_depth)
    return (pts, pos, bucket, sb, so, px, py, pz,
            *(n.contiguous() for n in nk))


def parked_street(seed=20261018):
    """The ``kitti_parked`` cell's traffic (``tsdf_bench/``): its map
    configuration and its 8 street sweeps cast from the parked car, each
    with the range noise ``seed`` draws: (MapConfig, [(points, position)]
    * 8)."""
    from chad_tsdf_tpu_torch import MapConfig
    from tsdf_bench.traffic import lidar
    with open(os.path.join(ROOT, "tsdf_bench", "configs",
                           "kitti_hdl64.json")) as fh:
        conf = json.load(fh)
    with open(os.path.join(ROOT, "tsdf_bench", "workloads",
                           "kitti_parked.json")) as fh:
        params = json.load(fh)["params"]
    traffic = lidar.Traffic(conf, params, seed)
    sweeps = [traffic.points(i) for i in range(params["templates"])]
    return (MapConfig(**conf["map_config"]),
            [(p, traffic.position(i)) for i, p in enumerate(sweeps)])


def seg_kernel_inputs(pts, n_valid, pos, cfg, dev):
    """What ``sparse_seg_entry_stream`` hands ``seg_samples`` for the cloud
    ``pts`` (rows from ``n_valid`` on are padding) cast from ``pos``: the
    Morton-sorted points, their K2 normals, block keys, the position and
    the origin voxel."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.core.state import origin_blocks_for_position
    p = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
    position = torch.from_numpy(np.float32(pos)).to(dev)
    ob = torch.from_numpy(origin_blocks_for_position(pos, cfg)).to(dev)
    px, py, pz, nx, ny, nz, sb, _ = integrate.sorted_with_normals(
        p, n_valid, position, ob, cfg)
    return (px, py, pz, nx, ny, nz, sb, position, ob * 8)


def check_seg_samples(results):
    """Phase 2, the seg insert's sample kernel (``ops/seg_samples.py``)
    against its plain version: the 8 street sweeps of ``kitti_parked``,
    each padded to its 131,072-point bucket, and a ragged cloud (5,003 rows
    of which 4,000 are points, with one far outside the local extent, one
    whose ray leaves it and one at the scanner): keys bit-equal in (K, N)
    order and sorted, ``n_valid`` and the sample overflow equal, and a
    second launch bit-equal to the first; timed on sweep 0 beside its
    plain version (the sequence the seg insert ran before), with its
    bound."""
    from chad_tsdf_tpu_torch.ops import seg_samples

    dev = torch.device("cuda")
    cfg, sweeps = parked_street()
    bucket = 1 << 17
    kw = dict(k=cfg.dda_steps, res=cfg.sdf_res, trunc=cfg.sdf_trunc,
              extent=cfg.blocks_per_axis * 8)
    ragged = sphere(4000, 3.0, 3)
    face = (cfg.blocks_per_axis // 2) * 8 * cfg.sdf_res
    ragged[:3] = [[300.0, 1.0, 2.0], [face - 0.02, 0.0, 0.0], [0.0, 0.0, 0.0]]
    clouds = [(f"street sweep {i}", np.resize(p, (bucket, 3)), len(p), pos)
              for i, (p, pos) in enumerate(sweeps)]
    clouds.append(("ragged 5003 rows, 4000 points",
                   np.resize(ragged, (5003, 3)), 4000, np.zeros(3)))
    seen = []
    for name, pts, n_valid, pos in clouds:
        args = seg_kernel_inputs(pts, n_valid, pos, cfg, dev)
        got = seg_samples.seg_samples(*args, **kw)
        want = seg_samples.seg_samples_plain(*args, **kw)
        again = seg_samples.seg_samples(*args, **kw)
        require(torch.equal(got[0], want[0]) and
                torch.equal(torch.sort(got[0].reshape(-1))[0],
                            torch.sort(want[0].reshape(-1))[0]),
                f"seg_samples keys differ from the plain version ({name})")
        require(int(got[1]) == int(want[1]) and int(got[2]) == int(want[2]),
                f"seg_samples counts [{int(got[1])}, {int(got[2])}] against "
                f"the plain [{int(want[1])}, {int(want[2])}] ({name})")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"two seg_samples launches differ ({name})")
        seen.append([name, int(got[1]), int(got[2])])
    require(seen[-1][2] > 0, "the ragged cloud overflowed no sample")
    args = seg_kernel_inputs(clouds[0][1], clouds[0][2], clouds[0][3], cfg,
                             dev)
    k = cfg.dda_steps
    results["seg_samples"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: seg_samples.seg_samples(*args, **kw)),
        "plain_ms": cuda_ms(lambda: seg_samples.seg_samples_plain(
            *args, **kw), reps=3), "points": bucket}
    results["seg_samples"]["bound_ms"], results["seg_samples"]["bound_by"] = \
        bound(28 * bucket + 24 + 8 * k * bucket + 8,
              (K1_OPS_PER_POINT + K1_OPS_PER_STEP * k) * bucket)
    log(f"seg_samples: keys bit-equal to the plain version, [name, n_valid, "
        f"n_samp_ovf] {seen}; {results['seg_samples']}")


def check_carve_kernels(results):
    """Phase 2, the carve's kernels (``ops/carve_kernels.py``) against the
    plain route on ``scripts/carve_stages.py``'s scene (a parked sweep
    carved into the map of another from the same spot, at
    ``kitti_parked_carve``'s map configuration): keys, their count and
    digit counts, the sorted keys (``carve_sort`` against ``torch.sort``),
    both pool planes, ``touched_overflow`` and the metrics bit for bit,
    under the cell's touched cap and one that loses blocks; then each
    kernel timed beside its plain stages, with its bound."""
    from chad_tsdf_tpu_torch.scripts import carve_stages

    dev = torch.device("cuda")
    cfg, state, pts, n, pos = carve_stages.scene(dev)
    held = {}
    for cap in (cfg.touched_capacity, carve_stages.SMALL_CAP):
        c = dataclasses.replace(cfg, touched_capacity=cap)
        held[cap] = carve_stages.hold(state, pts, n, pos, c)
        require((held[cap]["touched_overflow"] > 0) ==
                (cap == carve_stages.SMALL_CAP),
                f"carve at touched cap {cap}: {held[cap]}")
    counts = held[cfg.touched_capacity]
    rays = -(-pts.shape[0] // cfg.carve_subsample)
    b = carve_stages.bounds_ms(counts, cfg, rays)
    ms = carve_stages.stage_times(state, pts, n, pos, cfg, 10)
    plain = ms["plain"]
    results["carve_keys"] = {
        "max_abs_err": 0.0, "ms": ms["kernel"]["keys"],
        "plain_ms": plain["keys"], "bound_ms": b["carve_keys"],
        "bound_by": "bytes", "slots": counts["slots"]}
    results["carve_sort"] = {
        "max_abs_err": 0.0, "ms": ms["kernel"]["sort"],
        "plain_ms": plain["sort"], "library_ms": plain["sort"],
        "bound_ms": b["carve_sort"], "bound_by": "bytes",
        "slots": counts["slots"], "n_valid": counts["n_valid"]}
    results["carve_apply"] = {
        "max_abs_err": 0.0, "ms": ms["kernel"]["apply"],
        "plain_ms": plain["entries"] + plain["lookup"] + plain["apply"],
        "bound_ms": b["carve_apply"], "bound_by": "bytes",
        "n_valid": counts["n_valid"],
        "n_carved_voxels": counts["n_carved_voxels"]}
    log(f"carve kernels: bit-equal to the plain route under touched caps "
        f"{sorted(held)}: {held}; stages (ms) {ms}; bounds {b}")
    del state, pts
    torch.cuda.empty_cache()


def check_sample_tile(cfg, results):
    """Phase 2, the sample_tile path's kernels and the wide block lists:
    K4 and K1 at (K = 10, nb = 128) and (K = 10, nb = 256) on one sorted
    KITTI-shaped scan (whose tiles hold more than 128 blocks) against their
    plain versions and each other; K4 at (K = 1, nb = 128) on that scan's
    block-sorted sample stream, as ``insert_step_sample_tiled`` runs it,
    and K3 merging its partial rows (T x nb = 163,840 slots), each against
    its plain version, timed, with its bound; K3 also against
    ``index_add_``."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.core.state import (create_state,
                                                origin_blocks_for_position)
    from chad_tsdf_tpu_torch.ops import dda, fused_integrate, tile_accum
    from chad_tsdf_tpu_torch.scripts import k4_stream_bytes
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks

    dev = torch.device("cuda")
    (pts, pos_np, bucket, sb, so, px, py, pz, nx, ny, nz) = \
        kitti_scan_inputs(cfg, dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    origin_voxel = torch.from_numpy(origin_blocks_for_position(
        np.zeros(3), cfg)).to(dev) * 8
    grids = dda.local_sample_grids(px, py, pz, nx, ny, nz, sb != 2**31 - 1,
                                   zero, origin_voxel, cfg.sdf_res,
                                   cfg.sdf_trunc, cfg.dda_steps,
                                   cfg.blocks_per_axis * 8)
    wide = {}
    for nb in (128, 256):
        kw = dict(nb=nb, k=cfg.dda_steps, res=cfg.sdf_res,
                  trunc=cfg.sdf_trunc, extent=cfg.blocks_per_axis * 8)
        fargs = (px, py, pz, nx, ny, nz, sb, zero, origin_voxel)
        k1 = fused_integrate.fused_tile_partials(*fargs, **kw)
        live1, err1 = hold_k1(k1, fargs, kw, f"KITTI scan, nb {nb}")
        targs = (grids[0], grids[1], grids[2], nb, cfg.sdf_trunc)
        k4 = tile_accum.tile_partials(*targs)
        _, err4 = hold_k4(k4, targs, f"KITTI scan, K = 10, nb {nb}")
        require(torch.equal(k4[0], k1[0]) and
                int(k4[3].sum()) == int(k1[3][:, 1].sum()),
                f"K4 and K1 coverage differ at nb {nb}")
        for i in (1, 2):
            require(torch.equal(k4[i][live1], k1[i][live1]),
                    f"K4 and K1 output {i} differ at nb {nb}")
        wide[f"nb{nb}"] = {
            "live_rows": int(live1.sum()),
            "not_covered": int(k1[3][:, 1].sum()),
            "k1_max_abs_err": err1, "k4_max_abs_err": err4,
            "k1_ms": cuda_ms(lambda: fused_integrate.fused_tile_partials(
                *fargs, **kw)),
            "k4_ms": cuda_ms(lambda: tile_accum.tile_partials(*targs))}
        del k1, k4
    results["fused_tile_partials"]["kitti_wide"] = wide
    log(f"K1 and K4 at K = {cfg.dda_steps}, nb 128 / 256 on one KITTI-shaped "
        f"scan ({len(pts)} of {bucket} points): equal to their plain "
        f"versions and to each other; {wide}")
    del grids

    # ---- K4 at (1, 128) on the block-sorted sample stream ----
    scfg = ks.stream_config(accumulate_impl="sample_tile")
    pos = torch.from_numpy(pos_np).to(dev)
    origin = torch.from_numpy(origin_blocks_for_position(pos_np, scfg)).to(
        dev)
    padded = torch.from_numpy(np.resize(pts, (bucket, 3))).to(dev)
    batch = integrate.sort_samples(integrate.compute_samples(
        padded, len(pts), pos, origin, scfg))
    s = batch.bkey.shape[0]
    okey, sd = integrate.unpack_payload(batch.payload, scfg.sdf_trunc)
    targs = (batch.bkey.reshape(1, s), okey.reshape(1, s).contiguous(),
             sd.reshape(1, s).contiguous(), scfg.sparse_tile_nb,
             scfg.sdf_trunc)
    k4 = tile_accum.tile_partials(*targs)
    live4, err4 = hold_k4(k4, targs, "sample stream, K = 1, nb 128")
    n_live = int(live4.sum())
    tiles = s // 1024
    n_valid = int((batch.bkey != 2**31 - 1).sum())
    r4 = {"samples": s, "valid_samples": n_valid, "tiles": tiles,
          "nb": scfg.sparse_tile_nb, "live_rows": n_live,
          "not_covered": int(k4[3].sum()), "max_abs_err": err4,
          "ms": cuda_ms(lambda: tile_accum.tile_partials(*targs)),
          "plain_ms": cuda_ms(lambda: tile_accum.tile_partials_plain(
              *targs), reps=3)}
    # keys read and mask written; offset and sd (8 B) read for each covered
    # sample; the list and the live rows written
    r4["bound_ms"], r4["bound_by"] = bound(k4_stream_bytes(
        batch.bkey, k4[3], scfg.sparse_tile_nb, n_live, 8))
    results["tile_partials"]["sample_tile"] = r4
    log(f"K4 tile_partials on the sample stream (K = 1, nb "
        f"{scfg.sparse_tile_nb}): {r4}")

    # ---- the sorted K4 on the same stream, as sample_tiled_update runs
    # it: the batch's keys and payload words ----
    nb, trunc = scfg.sparse_tile_nb, scfg.sdf_trunc
    bkey, payload = batch.bkey, batch.payload
    k4s = tile_accum.tile_partials_sorted(bkey, payload, nb, trunc)
    live_s, err_s = hold_k4_sorted(k4s, bkey, payload, nb, trunc,
                                   f"sample stream, nb {nb}")
    require(torch.equal(live_s, live4), "sorted and general K4 live rows")
    n_live = int(live_s.sum())

    def parent_path():
        ok, sd_ = integrate.unpack_payload(payload, trunc)
        return tile_accum.tile_partials(bkey.reshape(1, s), ok.reshape(1, s),
                                        sd_.reshape(1, s), nb, trunc)

    rs = {"samples": s, "valid_samples": n_valid, "tiles": tiles, "nb": nb,
          "live_rows": n_live, "not_covered": int(k4s[3].sum()),
          "max_abs_err": err_s, "unsorted_word": int(k4s[4][0]),
          "ms": cuda_ms(lambda: tile_accum.tile_partials_sorted(
              bkey, payload, nb, trunc)),
          "plain_ms": cuda_ms(lambda: tile_accum.tile_partials_sorted_plain(
              bkey, payload, nb, trunc), reps=3),
          "parent_path_ms": cuda_ms(parent_path),
          "general_k4_ms": r4["ms"], "library_ms": None}
    # keys read and mask written; the payload word (4 B) read for each
    # covered sample; the list and the live rows written
    rs["bound_ms"], rs["bound_by"] = bound(
        k4_stream_bytes(bkey, k4s[3], nb, n_live, 4))
    del k4s

    # a copy with one tile's keys shuffled: the word must be set
    key_t = bkey.reshape(tiles, 1024)
    prev = torch.cat([torch.full((tiles, 1), -1, dtype=torch.int32,
                                 device=dev), key_t[:, :-1]], dim=1)
    valid_t = key_t != 2**31 - 1
    runs = (valid_t & (key_t != prev)).sum(1)
    worst = int(runs.argmax())
    gen = torch.Generator().manual_seed(16)
    shuffled = bkey.clone().reshape(tiles, 1024)
    shuffled[worst] = shuffled[worst][torch.randperm(1024, generator=gen)
                                      .to(dev)]
    sh = shuffled.reshape(-1)
    require(bool((sh[1:] < sh[:-1]).any()), "the shuffle left the keys sorted")
    word = int(tile_accum.tile_partials_sorted(sh, payload, nb, trunc)[4][0])
    require(word == 1, f"sorted K4's unsorted word is {word} on a stream "
                       f"with tile {worst} shuffled")
    rs["shuffled"] = {"tile": worst, "runs": int(runs[worst]),
                      "unsorted_word": word}
    del shuffled, sh

    # nb 8 on the whole stream; nb 4,096 (past the general kernel's
    # max_nb(1)) on the 64 tiles with the most runs, against the plain
    # version alone
    k8 = tile_accum.tile_partials_sorted(bkey, payload, 8, trunc)
    _, err8 = hold_k4_sorted(k8, bkey, payload, 8, trunc,
                             "sample stream, nb 8")
    rs["nb8"] = {"not_covered": int(k8[3].sum()), "max_abs_err": err8,
                 "ms": cuda_ms(lambda: tile_accum.tile_partials_sorted(
                     bkey, payload, 8, trunc))}
    del k8
    pick = torch.sort(torch.topk(runs, 64).indices).values
    sub_key = key_t[pick].reshape(-1).contiguous()
    sub_pay = payload.reshape(tiles, 1024)[pick].reshape(-1).contiguous()
    require(4096 > tile_accum.max_nb(1), "nb 4,096 is within max_nb(1)")
    kbig = tile_accum.tile_partials_sorted(sub_key, sub_pay, 4096, trunc)
    _, errb = hold_k4_sorted(kbig, sub_key, sub_pay, 4096, trunc,
                             "64 tiles of the sample stream, nb 4096",
                             general=False)
    require(int(kbig[3].sum()) == 0, "a list of 4,096 blocks overflowed")
    rs["nb4096"] = {"tiles": 64, "max_runs": int(runs.max()),
                    "live_rows": int(tile_accum.live_rows(kbig[0]).sum()),
                    "max_abs_err": errb,
                    "ms": cuda_ms(lambda: tile_accum.tile_partials_sorted(
                        sub_key, sub_pay, 4096, trunc))}
    del kbig
    results["tile_partials_sorted"] = rs
    log(f"sorted K4 tile_partials_sorted on the sample stream: equal to its "
        f"plain version and bit-equal to the general K4 at nb {nb} and 8, "
        f"equal to its plain version at nb 4096 on 64 tiles, its word clear "
        f"on sorted input and set with tile {worst} shuffled: {rs}")

    # ---- K3 at this path's shapes: T x nb slots into a fresh pool ----
    state = create_state(scfg, origin_blocks_for_position(pos_np, scfg), dev)
    r3, _ = check_k3(state, k4, scfg, "sample stream")
    results["merge_partials"]["sample_tile"] = r3
    log(f"K3 merge_partials of the sample stream's partial rows: {r3}")
    del state, k4, batch


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
    m1_in = micro_inputs(micro_stagea_phases, MICRO_CHECK_N)
    errs = {
        # nb 128: the shared stage's wide lists (16-bit ranks)
        "micro_stagea_phases": max(
            micro_stagea_phases.check(*m1_in, nb)["max_abs_err"]
            for nb in (48, 128)),
        "micro_tile_accum": micro_tile_accum.check(
            *micro_inputs(micro_tile_accum, MICRO_CHECK_TILES))["max_abs_err"],
        "micro_mxu8": check_m3(micro_mxu8)}
    log(f"M1-M3 at a reduced size ({MICRO_CHECK_N} points, nb 48 and 128 "
        f"for M1, {MICRO_CHECK_TILES} M2 tiles): every mode and precision "
        f"equals its plain version; max sd err {errs}")
    return errs


def check_m3(m3):
    """M3 in both precisions against its plain version, and its wgmmas per
    tile against the padded lists, at MICRO_CHECK_N: the script's inputs
    and each edge case (one offset group, use all zero, sdq = +-127, lrow
    outside [0, nb)) at every nb it takes."""
    wgmmas, err = {}, 0.0
    for case in (None, *m3.EDGE_CASES):
        for nb in m3.NB_SUPPORTED:
            npy = (m3.inputs(MICRO_CHECK_N) if case is None else
                   m3.edge_inputs(case, MICRO_CHECK_N, nb))
            r = m3.check(*(torch.from_numpy(a).to("cuda") for a in npy), nb)
            err = max(err, r["max_abs_err"])
            if nb == m3.NB:
                wgmmas[case or "inputs"] = r["wgmmas"]
    log(f"M3 at {MICRO_CHECK_N} points: inputs and edge cases "
        f"{m3.EDGE_CASES} at nb {m3.NB_SUPPORTED}, bf16 and int8 equal to "
        f"the plain version, wgmmas per tile equal to the padded lists "
        f"(all tiles, nb {m3.NB}: {wgmmas})")
    return err


def m3_yardsticks(m3, args):
    """M3's library call, timed: one ``torch.bmm`` of the dense bf16
    operands (built before the timing, freed after) with f32 sums, whose
    output must equal the plain version's; and, logged beside it, the
    scatter form: one ``index_add_`` of the kept samples' (sdq, 1) onto
    precomputed flat cells."""
    ref = m3.contract_plain(*args)
    onehot, vals = m3.onehot_operands(*args)
    out = torch.bmm(onehot, vals, out_dtype=torch.float32)
    for name, a, b in zip(("psd", "pw"), m3.from_bmm(out), ref):
        require(torch.equal(a, b), f"M3 yardstick bmm: {name} differs from "
                                   f"the plain version")
    del out
    bmm_ms = cuda_ms(lambda: torch.bmm(onehot, vals,
                                       out_dtype=torch.float32),
                     reps=5, warmup=1)
    op_gb = (onehot.numel() + vals.numel()) * 2 / 1e9
    del onehot, vals
    torch.cuda.empty_cache()
    okey, sdq, lrow, use = args
    t = okey.shape[1] // m3.TILE
    sel = (use != 0) & (lrow >= 0) & (lrow < m3.NB)
    tile = torch.arange(okey.shape[1], device="cuda")[None, :] // m3.TILE
    cell = ((tile * m3.NB + lrow) * m3.OFFSETS + okey)[sel]
    src = torch.stack([sdq[sel], torch.ones_like(sdq[sel])], 1).float()
    acc = torch.zeros((t * m3.NB * m3.OFFSETS, 2), device="cuda")
    acc.index_add_(0, cell, src)
    require(torch.equal(acc[:, 0].reshape(ref[0].shape), ref[0]) and
            torch.equal(acc[:, 1].reshape(ref[1].shape), ref[1]),
            "M3 yardstick index_add_ differs from the plain version")
    add_ms = cuda_ms(lambda: acc.index_add_(0, cell, src), reps=5)
    log(f"M3 yardsticks: torch.bmm of the dense operands ({op_gb:.2f} GB "
        f"of bf16) {bmm_ms:.3f} ms, equal to the plain version; "
        f"index_add_ of {cell.numel()} kept samples onto flat cells "
        f"{add_ms:.3f} ms, equal")
    return bmm_ms, add_ms


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
    m3_args = micro_inputs(micro_mxu8)
    c3 = micro_mxu8.check(*m3_args, time_plain=True)
    bmm_ms, add_ms = m3_yardsticks(micro_mxu8, m3_args)
    del m3_args
    torch.cuda.empty_cache()
    # bounds at the scripts' full sizes: M1 full mode at nb 48 (its live
    # rows from the plain list), M2 every row, M3 its bytes (what the
    # inputs need, whatever product computes it)
    m1 = micro_stagea_phases
    m1_key = torch.from_numpy(m1.inputs()[0]).to("cuda")
    m1_live = int((m1.tile_lists(m1_key, 48) != m1.INF).sum())
    m1_tiles = m1.N // m1.TILE
    m2 = micro_tile_accum
    m3 = micro_mxu8
    bounds = {
        "micro_stagea_phases": bound(12 * m1.K * m1.N + m1_tiles * 48 * 4 +
                                     m1_live * 4096),
        "micro_tile_accum": bound(12 * m2.S * m2.NTILES + m2.NTILES * m2.NB *
                                  (4 + 4096)),
        "micro_mxu8": bound(16 * m3.K * m3.N +
                            2 * (m3.N // 1024) * m3.NB * 512 * 4)}
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
    results["micro_mxu8"].update(
        ms_int8=b3["ms"]["int8"], library_ms=bmm_ms, index_add_ms=add_ms,
        wgmmas=c3["wgmmas"], gflop=c3["gflop"])
    log(f"phase 7 microbenchmarks: M1 ms {b1['ms']}; M1 plain ms "
        f"{c1['plain_ms']}; M2 {b2}; M2 plain ms {c2['plain_ms']}; M3 ms "
        f"{b3['ms']} (bound {bounds['micro_mxu8'][0]:.4f} ms, bytes; "
        f"bucketed product {c3['wgmmas']} wgmmas, {c3['gflop']} GFLOP); "
        f"M3 plain ms {c3['plain_ms']}; M3 torch.bmm {bmm_ms:.3f} ms, "
        f"index_add_ {add_ms:.3f} ms; launches {launches}")
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
    counts of the ``seg`` stream and of the ``sample_tile`` stream, K2's
    result on one scan, and one ``seg`` stream map whose rotations are
    still pending (for phase 9)."""
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

    # the four sparse backends in turns, and seg's eager insert; the first
    # round warms each
    turns = {"seg": ("seg", True), "seg eager": ("seg", False),
             "sample_tile": ("sample_tile", True),
             "pallas": ("pallas", True), "fused": ("fused", True)}
    rates = {name: [] for name in turns}
    maps, stream_launches, undrained = {}, None, None
    sample_tile_launches = None
    for rnd in range(4):
        for name, (impl, graphs) in turns.items():
            c = ks.stream_config(sparse_impl=impl)
            kernels.reset_launches()
            m, dt, n_pts, metrics, reads = ks.timed_stream(scans, c, "cuda",
                                                           graphs)
            launches = dict(kernels.LAUNCHES)
            require(not accumulate.overflowed("cuda"),
                    f"K5 chunk list overflowed on the {name} stream")
            backends = {m._dispatch_config(p).accumulate_impl
                        for p, _ in scans}
            require(backends == {impl},
                    f"scans dispatched to {backends}, not {impl}")
            require(m.n_submaps == rotations and
                    len(m._pending) == rotations and not m.submaps,
                    f"{name}: {m.n_submaps} submaps, {len(m._pending)} "
                    f"pending; the policy gives {rotations} deferred")
            require(reads == {}, f"{name} inserts read the host: {reads}")
            if name == "seg":
                # scan 0 ran eagerly and captured the map's graph; scans
                # 1.. replayed it, each launching K2 and seg_samples and
                # nothing else
                (sg,) = m._graphs.values()
                require(launches["estimate_normals"] == 2 and
                        launches["seg_samples"] == 2 and
                        sg.replays == len(scans) - 1 and
                        sg.launches == {"estimate_normals": 1,
                                        "seg_samples": 1} and
                        not sg.body_launches,
                        f"K2 launched {launches['estimate_normals']} and "
                        f"seg_samples {launches['seg_samples']} times "
                        f"for {len(scans)} seg inserts; the graph: "
                        f"{sg.replays} replays, launches {sg.launches}, in "
                        f"its IF node {sg.body_launches}")
                for k in ("fused_tile_partials", "merge_partials",
                          "tile_partials", "tile_partials_sorted",
                          "accumulate_segments"):
                    require(launches[k] == 0, f"{k} launched on the seg "
                                              f"stream")
                stream_launches = launches
            if name == "sample_tile":
                # K2, the sorted K4, K3 and the IF node's kernel a replay;
                # K5 in the IF node's body, which runs where a tile's list
                # overflowed; the general K4 nowhere
                (sg,) = m._graphs.values()
                outer = ("estimate_normals", "tile_partials_sorted",
                         "merge_partials", "set_conditional")
                require(sg.replays == len(scans) - 1 and
                        sg.launches == dict.fromkeys(outer, 1) and
                        sg.body_launches == {"accumulate_segments": 1},
                        f"the sample_tile graph: {sg.replays} replays, "
                        f"launches {sg.launches}, in its IF node "
                        f"{sg.body_launches}")
                require(all(launches[k] > 0 for k in outer) and
                        launches["fused_tile_partials"] == 0 and
                        launches["tile_partials"] == 0 and
                        launches["seg_samples"] == 0,
                        f"sample_tile stream launches {launches}")
                sample_tile_launches = launches
            if name == "seg eager":
                require(launches["estimate_normals"] == len(scans) and
                        launches["seg_samples"] == len(scans),
                        f"K2 launched {launches['estimate_normals']} and "
                        f"seg_samples {launches['seg_samples']} times in "
                        f"{len(scans)} eager seg inserts")
            if rnd > 0:
                rates[name].append((len(scans) - 1) / dt)
            if name.startswith("seg") and "seg" in maps:
                bit_equal_maps(m, maps["seg"], f"{name} and seg streams")
                if undrained is None:
                    undrained = maps["seg"]
            if name != "seg eager":
                maps[impl] = m
            if rnd == 3:
                log(f"phase 8 {name}: {statistics.median(rates[name]):.2f} "
                    f"scans/s median of "
                    f"{[round(r, 2) for r in rates[name]]}, "
                    f"{n_pts / dt:.0f} points/s in the last round; host "
                    f"reads (counted calls) {reads}; launches in 12 "
                    f"inserts {launches}")
            del m
        torch.cuda.empty_cache()
    for impl in ("sample_tile", "pallas", "fused"):
        err = same_map(maps[impl], maps["seg"], f"stream {impl} vs seg")
        log(f"phase 8 {impl} vs seg: directories and weights equal on the "
            f"active and {rotations} rotated-out states, sd err/weight "
            f"{err:.3e}; tile_overflow "
            f"{int(maps[impl].state.tile_overflow)}")
    for impl in ("sample_tile", "fused"):
        require(int(maps[impl].state.tile_overflow) > 0,
                f"the {impl} stream did not fall back")

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
    return stream_launches, sample_tile_launches, rk2, undrained


def check_parked_seg():
    """Phase 8, ``kitti_parked``'s parked car: its 8 sweeps twice into
    three maps, through the map's graph (K2 and ``seg_samples`` once a
    replay), eagerly, and eagerly with the plain version in the kernel's
    place (the sequence the seg insert ran before): directories and pools
    bit-equal."""
    from chad_tsdf_tpu_torch import TSDFMap, kernels
    from chad_tsdf_tpu_torch.ops import seg_samples

    cfg, sweeps = parked_street()
    scans = sweeps * 2
    kernel = seg_samples.seg_samples
    maps, counts = {}, {}
    for name in ("graph", "eager", "eager plain"):
        m = TSDFMap(config=cfg, device="cuda")
        m.graphs_enabled = name == "graph"
        kernels.reset_launches()
        if name == "eager plain":
            seg_samples.seg_samples = seg_samples.seg_samples_plain
        try:
            for pts, pos in scans:
                m.insert(pts, pos)
        finally:
            seg_samples.seg_samples = kernel
        counts[name] = kernels.LAUNCHES["seg_samples"]
        backends = {m._dispatch_config(p).accumulate_impl for p, _ in sweeps}
        require(backends == {"seg"}, f"parked sweeps dispatched to {backends}")
        want = {"graph": 2, "eager": len(scans), "eager plain": 0}[name]
        require(counts[name] == want, f"parked {name}: seg_samples launched "
                                      f"{counts[name]} times, not {want}")
        if name == "graph":
            (g,) = m._graphs.values()
            require(g.replays == len(scans) - 1 and
                    g.launches == {"estimate_normals": 1, "seg_samples": 1},
                    f"the parked graph: {g.replays} replays, launches "
                    f"{g.launches}")
        maps[name] = m
    for name in ("eager", "eager plain"):
        bit_equal_maps(maps[name], maps["graph"],
                       f"parked seg {name} against the graph")
    st = maps["graph"].state
    lossy = {k: int(getattr(st, k)) for k in
             ("point_overflow", "sample_overflow", "block_overflow",
              "touched_overflow")}
    require(not any(lossy.values()), f"parked overflow {lossy}")
    log(f"phase 8 parked car ({len(scans)} inserts of kitti_parked's 8 "
        f"sweeps): the graph's, the eager and the plain version's eager "
        f"maps bit-equal (dir_keys, dir_slots, n_blocks, pool_sd, pool_w); "
        f"n_blocks {int(st.n_blocks)}; seg_samples launches {counts}")
    del maps, st
    torch.cuda.empty_cache()


def timed_save(m, impl, path):
    """``m.save(path)`` with ``mesh_impl=impl``: (ms, ``last_metrics``'
    split, peak device bytes, device bytes before the save).  Under
    ``auto`` and ``device`` it must run device marching cubes once."""
    from chad_tsdf_tpu_torch.mesh import device_mc
    m.config = dataclasses.replace(m.config, mesh_impl=impl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    calls = device_mc.CALLS["marching_cubes_device"]
    t0 = time.perf_counter()
    m.save(path)
    ms = (time.perf_counter() - t0) * 1e3
    ran = device_mc.CALLS["marching_cubes_device"] - calls
    require(ran == (impl != "host"),
            f"save under mesh_impl={impl} ran device MC {ran} times")
    split = {k: m.last_metrics[k] for k in (
        "sub_fin_ms", "voxel_samples_ms", "mc_ms", "normals_ms", "ply_ms")}
    return ms, split, torch.cuda.max_memory_allocated(), base


def device_vs_host_mesh(m, what):
    """Device marching cubes against the host's on ``m``'s voxel samples
    (vertex sets within 1e-6 m, equal face sets and counts); returns the
    comparison, both meshes' sizes and both MC times (ms)."""
    from chad_tsdf_tpu_torch.mesh import device_mc, mc
    from chad_tsdf_tpu_torch.scripts.mesh_scale import mesh_difference
    codes, sd = m.voxel_samples()
    t0 = time.perf_counter()
    dev = device_mc.marching_cubes_device(codes, sd, m.sdf_res)
    dev_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = mc.marching_cubes(codes, sd, m.sdf_res)
    host_ms = (time.perf_counter() - t0) * 1e3
    diff = mesh_difference(dev, host)
    require(diff["same_face_set"] and diff["same_face_count"] and
            diff["max_vertex_diff_m"] is not None and
            diff["max_vertex_diff_m"] <= 1e-6,
            f"{what}: device and host meshes differ: {diff}")
    return dict(diff, voxels=int(codes.shape[0]), vertices=dev.n_vertices,
                faces=dev.n_faces, device_mc_ms=dev_ms, host_mc_ms=host_ms)


def run_save(sphere_map, stream_map, tmp):
    """Phase 9: ``save`` on the card, device against host."""
    from chad_tsdf_tpu_torch.mesh import grid
    out = {}
    for name, m in (("sphere", sphere_map), ("stream", stream_map)):
        if name == "stream":
            require(len(m._pending) == 2,
                    f"the stream map has {len(m._pending)} pending stubs")
        r = {}
        for impl in ("auto", "host"):
            ms, split, peak, base = timed_save(
                m, impl, os.path.join(tmp, f"{name}_{impl}.ply"))
            r[impl] = {"save_ms": ms, "split_ms": split,
                       "peak_device_bytes": peak, "device_bytes_before": base}
        require(not m._pending and m.n_submaps == len(m.submaps),
                f"{name}: save left pending stubs")
        r["meshes"] = device_vs_host_mesh(m, name)
        log(f"phase 9 save ({name}): device {r['auto']['save_ms']:.1f} ms "
            f"(split {json.dumps(r['auto']['split_ms'])}, peak device "
            f"memory {r['auto']['peak_device_bytes']} B of which "
            f"{r['auto']['device_bytes_before']} B held before), host "
            f"{r['host']['save_ms']:.1f} ms (split "
            f"{json.dumps(r['host']['split_ms'])}); device vs host MC on "
            f"the same samples: {json.dumps(r['meshes'])}")
        out[name] = r
    path = os.path.join(tmp, "sphere.grid")
    sphere_map.save_grid(path)
    codes, sd = sphere_map.voxel_samples()
    _, cells, n_complete = grid.build_cells(codes, sd)
    with open(path, "rb") as fh:
        res = float(np.frombuffer(fh.read(4), np.float32)[0])
        n_pts, n_cells = (int(x) for x in np.frombuffer(fh.read(16),
                                                        np.uint64))
    require((res, n_pts, n_cells) == (np.float32(sphere_map.sdf_res),
                                       codes.shape[0], int(n_complete)) and
            n_cells == cells.shape[0],
            f".grid header {res, n_pts, n_cells}, build_cells "
            f"{codes.shape[0], int(n_complete)}")
    log(f"phase 9 .grid dump of the sphere: {n_pts} points, {n_cells} "
        f"complete cells, {os.path.getsize(path)} bytes; equal to "
        f"build_cells")
    return out


CARVE = dict(carve_steps=128, carve_stride=2.0, carve_subsample=2,
             carve_weight=1.0)


def padded(pts, config):
    """``pts`` zero-padded to the smallest of ``config``'s buckets."""
    bucket = next(b for b in config.buckets if b >= len(pts))
    out = np.zeros((bucket, 3), np.float32)
    out[:len(pts)] = pts
    return out


def carve_scene():
    """``examples/demo_carve.py``'s parked car at its sizes: (mesh vertices
    on the car after scan 1, on the car after 17 scans, on the wall)."""
    from chad_tsdf_tpu_torch import MapConfig, TSDFMap
    rng = np.random.default_rng(42)

    def car(n=1500):
        face = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
        return np.column_stack([np.full(n, 2.0, np.float32), face[:, 0],
                                0.75 * np.abs(face[:, 1])])

    def wall(n=2000):
        yz = rng.uniform(-2.5, 2.5, (n, 2)).astype(np.float32)
        return np.column_stack([np.full(n, 5.0, np.float32), yz[:, 0],
                                yz[:, 1]])

    cfg = MapConfig(max_points=1 << 12, carve_steps=128, carve_stride=1.0,
                    carve_subsample=1)
    pos = np.float32([0.0, 0.0, 0.5])
    m = TSDFMap(config=cfg, device="cuda")
    m.insert(car(), pos)
    near = lambda v, x: int(np.sum(np.abs(v[:, 0] - x) < 0.2))
    n_car0 = near(m.extract_mesh().vertices, 2.0)
    for _ in range(16):
        m.insert(wall(), pos)
    after = m.extract_mesh().vertices
    return n_car0, near(after, 2.0), near(after, 5.0)


# what a carving map's graphs launch a replay: the seg insert's K2 and
# sample kernel, then the carve's three kernels
CARVE_GRAPH_LAUNCHES = {"estimate_normals": 1, "seg_samples": 1,
                        "carve_keys": 1, "carve_sort": 1, "carve_apply": 1}


def run_carve():
    """Phase 10: carving on the KITTI-shaped stream, then the parked-car
    scene; returns the carved stream's launch counts."""
    from chad_tsdf_tpu_torch import TSDFMap, kernels
    from chad_tsdf_tpu_torch.core import carve
    from chad_tsdf_tpu_torch.core.state import (state_from_numpy,
                                                state_to_numpy)
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks

    scans = ks.make_scans()
    plain = ks.stream_config()
    carving = ks.stream_config(**CARVE)
    for c in (plain, carving):                      # warm both
        w = TSDFMap(config=c, device="cuda")
        for pts, pos in scans:
            w.insert(pts, pos)
        w.stats()
    del w
    rates = {"off": [], "on": []}
    launches = None
    for name in ("off", "on", "on", "off"):
        c = carving if name == "on" else plain
        kernels.reset_launches()
        m, dt, _, metrics, reads = ks.timed_stream(scans, c, "cuda")
        rates[name].append((len(scans) - 1) / dt)
        if name == "off":
            continue
        launches = dict(kernels.LAUNCHES)
        require(reads == {}, f"the carved stream read the host: {reads}")
        backends = {m._dispatch_config(p).accumulate_impl for p, _ in scans}
        require(backends == {"seg"}, f"carved scans dispatched to {backends}")
        # scan 0 ran eagerly and captured the graph (insert and carve);
        # the other scans replayed it
        (cg,) = m._graphs.values()
        require(all(launches[k] == 2 for k in CARVE_GRAPH_LAUNCHES) and
                cg.replays == len(scans) - 1 and
                cg.launches == CARVE_GRAPH_LAUNCHES,
                f"{len(scans)} carved inserts launched "
                f"{ {k: launches[k] for k in CARVE_GRAPH_LAUNCHES} }; the "
                f"graph: {cg.replays} replays, launches {cg.launches}")
        for k in ("fused_tile_partials", "merge_partials", "tile_partials",
                  "accumulate_segments"):
            require(launches[k] == 0, f"{k} launched on the carved stream")
        samples = [int(x["n_carve_samples"]) for x in metrics]
        dropped = [int(x["n_carve_dropped"]) for x in metrics]
        voxels = [int(x["n_carved_voxels"]) for x in metrics]
        require(min(samples) > 0 and min(dropped) >= 0,
                f"carve counters {samples} {dropped}")
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"phase 10 carved stream ({json.dumps(CARVE)}): "
        f"{med['on']:.2f} scans/s with carving, {med['off']:.2f} without "
        f"(turns off/on/on/off: {[round(r, 2) for r in rates['off']]} / "
        f"{[round(r, 2) for r in rates['on']]}); per scan n_carve_samples "
        f"{samples}, n_carve_dropped {dropped}, n_carved_voxels {voxels}; "
        f"host reads {reads}; launches {launches}")
    del m

    # one scan carved on the card and on the CPU from the same state
    base = TSDFMap(config=plain, device="cuda")
    base.insert(*scans[0])
    st = state_to_numpy(base.state)
    del base
    pts, pos = scans[1]
    pad = padded(pts, carving)
    out = {}
    for dev in ("cuda", "cpu"):
        state = state_from_numpy(st, dev)
        args = (torch.from_numpy(pad).to(dev), len(pts),
                torch.from_numpy(pos).to(dev))
        state, met = carve.carve_step(state, *args, carving)
        out[dev] = (state.pool_sd.cpu(), state.pool_w.cpu(),
                    {k: int(v) for k, v in met.items()})
        if dev == "cuda":
            carve_ms = cuda_ms(lambda: carve.carve_step(state, *args,
                                                        carving))
        del state
    (sd_g, w_g, met_g), (sd_c, w_c, met_c) = out["cuda"], out["cpu"]
    differ = int(((sd_g != sd_c) | (w_g != w_c)).any(1).sum())
    differ_voxels = int(((sd_g != sd_c) | (w_g != w_c)).sum())
    require(differ_voxels == 0 and met_g == met_c,
            f"carve on the card vs the CPU: {differ_voxels} voxels in "
            f"{differ} blocks differ; counters {met_g} vs {met_c}")
    log(f"phase 10 one scan ({len(pts)} points, "
        f"{carving.carve_steps * pad.shape[0] // carving.carve_subsample} "
        f"carve samples at capacity): card vs CPU differing voxels "
        f"{differ_voxels}, counters {met_g}; carve {carve_ms:.3f} ms per "
        f"insert (CUDA events, median of 10)")
    n_car0, n_car1, n_wall = carve_scene()
    require(n_car0 > 0 and n_car1 == 0 and n_wall > 0,
            f"parked car: {n_car0} -> {n_car1} car vertices, {n_wall} wall")
    log(f"phase 10 parked car (examples/demo_carve.py): car vertices "
        f"{n_car0} after scan 1, {n_car1} after 17 scans; wall vertices "
        f"{n_wall}")
    return launches


def run_checkpoint(tmp):
    """Phase 11: checkpoint a stream map with pending rotations, load it on
    the card and keep inserting into both; returns the launch counts of
    the 2 scans."""
    from chad_tsdf_tpu_torch import TSDFMap, kernels
    from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks

    scans = ks.make_scans(14)
    scfg = ks.stream_config()
    a = TSDFMap(config=scfg, device="cuda")
    for pts, pos in scans[:12]:
        a.insert(pts, pos)
    require(len(a._pending) == 2, f"{len(a._pending)} pending before save")
    path = os.path.join(tmp, "stream.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, a)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b = load_checkpoint(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(b.device.type == "cuda", f"loaded onto {b.device}")
    kernels.reset_launches()
    for pts, pos in scans[12:]:
        a.insert(pts, pos)
        b.insert(pts, pos)
    launches = dict(kernels.LAUNCHES)
    # the loaded map's first insert ran eagerly and captured its graph;
    # the other three inserts replayed a graph
    require(launches["estimate_normals"] == 2 and
            [g.replays for g in b._graphs.values()] == [1],
            f"K2 launched {launches['estimate_normals']} times in 4 inserts")
    bit_equal_maps(a, b, "checkpoint reloaded")
    ca, sa = a.voxel_samples()
    cb, sb = b.voxel_samples()
    require(np.array_equal(ca, cb) and np.array_equal(sa, sb),
            "checkpoint reloaded: voxel_samples differ")
    require(a.stats() == b.stats(), "checkpoint reloaded: stats differ")
    mb = os.path.getsize(path) / 1e6
    log(f"phase 11 checkpoint of the stream map (2 pending rotations, "
        f"{len(a.submaps)} submaps after 2 more scans): save {save_ms:.1f} "
        f"ms, load {load_ms:.1f} ms, file {mb:.2f} MB; pools, directories "
        f"and {ca.shape[0]} voxel samples bit-equal after 2 more scans; "
        f"launches {launches}")
    return launches


def run_loop_closure(tmp):
    """Phase 12: a drifted second pass over the sphere corrected by loop
    closure; returns the launch counts of the two passes."""
    from chad_tsdf_tpu_torch import TSDFMap, kernels
    from chad_tsdf_tpu_torch.mesh import read_ply
    from chad_tsdf_tpu_torch.mesh.rmse import analytic_sphere_rmse
    from chad_tsdf_tpu_torch.slam import posegraph as pg

    drift = np.float32([0.35, 0.0, 0.0])
    pos2 = np.float32([0.6, 0.0, 0.0])
    loop = np.eye(4)
    loop[:3, 3] = pos2
    pts = sphere(N_DENSE, 5.0, 420)
    kernels.reset_launches()
    m = TSDFMap(0.05, 0.1, device="cuda")
    m.insert(pts, np.zeros(3, np.float32))
    m.finalize_active()
    m.insert(pts + drift, pos2 + drift)
    m.finalize_active()
    launches = dict(kernels.LAUNCHES)
    for k in ("fused_tile_partials", "estimate_normals", "merge_partials"):
        require(launches[k] > 0, f"{k} launched 0 times in the two passes")

    def rmse(name):
        path = os.path.join(tmp, name)
        m.save(path)
        return analytic_sphere_rmse(read_ply(path).vertices, 5.0)

    before = rmse("drifted.ply")
    anchors = np.stack([sm.anchor for sm in m.submaps]).astype(np.float32)
    opt_ms = []
    for _ in range(2):          # the first call pays one-time set-up
        t0 = time.perf_counter()
        stats = m.optimize_loop_closures(loop_edges=[(0, 1, loop, 1000.0)])
        opt_ms.append((time.perf_counter() - t0) * 1e3)
    corr = m.submaps[1].corrected
    require(corr is not None and m.submaps[0].corrected is None,
            "loop closure: corrections not where expected")
    t_err = float(np.abs(corr[:3, 3] + drift).max())
    require(t_err < 0.01, f"correction {corr[:3, 3]}, expected {-drift}")
    graph = pg.add_edge(pg.make_odometry_edges(anchors), 0, 1,
                        loop.astype(np.float32), 1000.0)
    cpu, cpu_stats = pg.optimize_poses(graph, anchors, iterations=20,
                                       damping=1e-6, huber_delta=1.0,
                                       device="cpu")
    card = np.stack([(sm.corrected if sm.corrected is not None
                      else np.eye(4)) @ a for sm, a in zip(m.submaps,
                                                            anchors)])
    pose_err = float(np.abs(card - cpu).max())
    require(pose_err < 1e-4 and cpu_stats["gated_edges"] ==
            stats["gated_edges"] and cpu_stats["iterations"] ==
            stats["iterations"],
            f"card vs CPU solve: {pose_err}, {stats} vs {cpu_stats}")
    after = rmse("corrected.ply")
    require(after < 0.1 * 0.05 and before > 10 * after,
            f"sphere RMSE {before} -> {after}")
    log(f"phase 12 loop closure (2^20-point r = 5 m sphere, 0.35 m drift): "
        f"optimize_loop_closures {opt_ms[0]:.1f} ms (first call), "
        f"{opt_ms[1]:.1f} ms (second), {stats}; correction "
        f"{corr[:3, 3].tolist()} (error {t_err:.2e} m); poses vs the CPU "
        f"solve {pose_err:.2e}; mesh RMSE to the sphere {before:.6f} -> "
        f"{after:.6f} m; launches in the two passes {launches}")
    return launches


SHARDS = 4          # phase 13's mesh: four shards on the one card


def merged_vs_single(stack, state, cfg, what):
    """A sharded map's states merged exactly (``merge_states_host``)
    against a single-device state: directory keys and weights equal.
    Returns the per-voxel mean signed distance differences (median,
    max)."""
    from chad_tsdf_tpu_torch.parallel import sharded
    merged = sharded.merge_states_host(stack, cfg, device="cuda")
    require(torch.equal(merged.dir_keys, state.dir_keys),
            f"{what}: dir_keys differ")
    nb = int(state.n_blocks)
    require(int(merged.n_blocks) == nb, f"{what}: n_blocks differ")
    sa, sb = merged.dir_slots[:nb].long(), state.dir_slots[:nb].long()
    wa, wb = merged.pool_w[sa], state.pool_w[sb]
    require(torch.equal(wa, wb), f"{what}: weights differ")
    occ = wb > 0
    d = (merged.pool_sd[sa][occ] / wa[occ] -
         state.pool_sd[sb][occ] / wb[occ]).abs()
    return float(d.median()), float(d.max())


def samples_close(a, b, what):
    """tests/test_sharded_map.py's rule on two maps' voxel samples (both
    drained): equal codes, over 98% of the signed distances within two
    8-bit codec steps.  Returns (that share, the number of voxels)."""
    ca, sa = a.voxel_samples()
    cb, sb = b.voxel_samples()
    require(np.array_equal(ca, cb),
            f"{what}: voxel codes differ ({ca.shape[0]} vs {cb.shape[0]})")
    share = float((np.abs(sa - sb) <= 2 * a.config.sdf_trunc / 127).mean())
    require(share > 0.98, f"{what}: {share} of the voxels within 2 steps")
    return share, int(ca.shape[0])


def sharded_stream(scans, cfg, mesh):
    """``kitti_stream.timed_stream`` for a ``ShardedTSDFMap``: scan 0,
    synchronise, scans 1.. timed to a second synchronisation.  Returns
    (map, seconds, per-insert metrics, host reads of each timed insert,
    the submaps drained in each timed insert)."""
    from chad_tsdf_tpu_torch.parallel import ShardedTSDFMap
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks
    m = ShardedTSDFMap(config=cfg, mesh=mesh)
    m.insert(*scans[0])
    torch.cuda.synchronize()
    metrics, reads, drained = [], [], []
    t0 = time.perf_counter()
    for pts, pos in scans[1:]:
        n_sub = len(m.submaps)
        with ks.count_host_reads() as r:
            metrics.append(m.insert(pts, pos))
        reads.append(r)
        drained.append(len(m.submaps) - n_sub)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0, metrics, reads, drained


def sharded_states(m):
    """Every state a sharded map holds on the device: active, then each
    pending stub's."""
    return [m.state_stack] + [p.state_stack for p in m._pending]


def check_reads(reads, drained, what):
    """No insert reads the host, but one that had to drain a rotated-out
    stub beyond the byte bound (``core/map.py`` ``_MAX_PENDING_BYTES``;
    a 4-shard stub at this pool size pins 1 GiB on the one card)."""
    for i, (r, d) in enumerate(zip(reads, drained)):
        require(r == {} or d > 0,
                f"{what}: insert {i + 1} read the host ({r}) and drained "
                "nothing")
    return sum(1 for r in reads if r), sum(drained)


class KernelCalls:
    """While entered, records every call of the K1, K2 and K3 wrappers
    (the insert reaches them through their modules' attributes) with its
    arguments and result; K3 adds into its pools in place, so its pools
    are copied just before and just after the launch.  The wrappers still
    launch once per call, so the launch counts are the main path's."""

    def __init__(self):
        from chad_tsdf_tpu_torch.ops import (fused_integrate, normals_cuda,
                                             tile_accum)
        self.targets = {"estimate_normals": (normals_cuda,
                                             "estimate_normals"),
                        "fused_tile_partials": (fused_integrate,
                                                "fused_tile_partials"),
                        "merge_partials": (tile_accum, "merge_partials")}
        self.calls = {k: [] for k in self.targets}
        self.saved = {}

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn

            def run(*a, _name=name, _fn=fn, **kw):
                if _name == "merge_partials":
                    before = (a[0].clone(), a[1].clone())
                    out = _fn(*a, **kw)
                    self.calls[_name].append(
                        (a, kw, before, (a[0].clone(), a[1].clone())))
                    return out
                out = _fn(*a, **kw)
                self.calls[_name].append((a, kw, out))
                return out
            setattr(mod, attr, run)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])


def hold_k3_call(call, what):
    """K3 on one main-path call's inputs against its plain version, run
    under torch's deterministic algorithms so that its ``index_add_`` sums
    each pool row's partial rows in the plan's order, as K3 does: both pool
    planes must be bit-equal to the main path's output, and a second
    launch on a copy of the input pools must equal it too.  Returns (max
    |difference| over both planes, live partial rows)."""
    from chad_tsdf_tpu_torch.ops import tile_accum
    args, _, before, after = call
    plan, psd, pw = args[2:8], args[8], args[9]
    plain = (before[0].clone(), before[1].clone())
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tile_accum.merge_partials_plain(*plain, *plan, psd, pw)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    again = (before[0].clone(), before[1].clone())
    tile_accum.merge_partials(*again, *plan, psd, pw)
    err = max(float((a - b).abs().max()) for a, b in zip(after, plain))
    for i, plane in enumerate(("sd", "w")):
        require(torch.equal(after[i], plain[i]),
                f"K3 {plane} plane differs from its plain version ({what}): "
                f"max |diff| {err}, sd err/weight "
                f"{sd_err_per_weight(after[0], plain[0], plain[1]):.3e}")
        require(torch.equal(after[i], again[i]),
                f"K3 {plane} plane not bit-equal across launches ({what})")
    return err, int(args[4].sum())


def hold_sharded_kernels(calls, cfg, scratch_rows, route_sent):
    """Phase 13: K2, K1 and K3 held against their plain versions on the
    inputs the N = 4 dense insert gave them (``KernelCalls``): each shard's
    point bucket (K2, K1), each shard's merge into its scratch pool and
    each shard's merge of its own and the received halo rows into its
    persistent pool (K3).  The received rows are the rows of the merge's
    input beyond the ``scratch_rows`` local ones; the live ones must add
    up to ``route_sent``.  Returns a summary for the log."""
    from chad_tsdf_tpu_torch.ops import normals, normals_cuda
    k2, k1, k3 = (calls.calls[k] for k in ("estimate_normals",
                                           "fused_tile_partials",
                                           "merge_partials"))
    require(len(k2) == len(k1) == SHARDS and len(k3) == 2 * SHARDS,
            f"N = 4 dense insert: {len(k2)} K2, {len(k1)} K1, {len(k3)} K3 "
            "calls")
    out = {"K2": [], "K1": [], "K3 scratch": [], "K3 halo": []}
    for i, (args, _, nk) in enumerate(k2):
        px, py, pz, sb, so, pos, min_pts, depth = args
        nk = torch.stack(nk)
        npl = torch.stack(normals.estimate_normals_soa(
            px, py, pz, sb, so, sb != 2**31 - 1, pos, min_pts, depth))
        # K2's rule of phase 2 on the bucket's points; its padding (zero
        # points at the scanner, whose normals are 0) exactly equal
        valid = sb != 2**31 - 1
        min_dot = float((nk * npl).sum(0)[valid].min())
        require(min_dot > 1.0 - 1e-3, f"K2 min dot {min_dot} (N = 4 shard "
                                      f"{i} bucket)")
        require(torch.equal(nk[:, ~valid], npl[:, ~valid]),
                f"K2 padding normals differ (N = 4 shard {i} bucket)")
        require(torch.equal(nk, torch.stack(
            normals_cuda.estimate_normals(*args))),
                f"K2 shard {i}: the main path's normals differ from a "
                "second launch")
        out["K2"].append({"points": int(px.shape[0]),
                          "valid": int(valid.sum()), "min_dot": min_dot,
                          "max_abs_err": float((nk - npl).abs().max())})
    for i, (args, kw, k1_out) in enumerate(k1):
        live, err = hold_k1(k1_out, args, kw, f"N = 4 shard {i} bucket")
        out["K1"].append({"points": int(args[0].shape[0]),
                          "rows": int(k1_out[0].shape[0]),
                          "live_rows": int(live.sum()), "max_abs_err": err})
    received = 0
    for i, call in enumerate(k3):
        kind = "K3 scratch" if i < SHARDS else "K3 halo"
        err, n_live = hold_k3_call(call, f"{kind} merge of shard "
                                         f"{i % SHARDS}")
        args = call[0]
        rec = {"pool_rows": int(args[0].shape[0]),
               "input_rows": int(args[8].shape[0]), "live_rows": n_live,
               "max_abs_err": err}
        if kind == "K3 halo":
            require(args[8].shape[0] > scratch_rows,
                    f"K3 halo merge of shard {i % SHARDS}: "
                    f"{args[8].shape[0]} input rows")
            src_live = args[7][:n_live].to(torch.int64)
            rec["received_live_rows"] = int((src_live >= scratch_rows).sum())
            received += rec["received_live_rows"]
        out[kind].append(rec)
    require(received == route_sent,
            f"K3 halo merges took {received} received rows, route_sent "
            f"{route_sent}")
    return out


def stage_times(m, pts, pos, reps=3):
    """``reps`` inserts of ``pts`` into the sharded map ``m``, each timed
    whole and by stage with ``time.perf_counter``, the card synchronised
    around every stage (which takes away their overlap): the density
    dispatch, the host split (``owner_split`` + ``rebalance_chunks``), the
    fresh scratch pools, the shards' scratch inserts (K2, K1 and the
    scratch K3 merge), the routing of the scratch rows, the halo exchange,
    the K3 merges of local and received rows, the metrics' psum and the
    settling of the fused fallbacks; ``other`` is the rest of the insert
    (the padded copy, the uploads, the row gathers).  Returns the median
    ms of each."""
    from chad_tsdf_tpu_torch import TSDFMap
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.parallel import sharded
    stages = {"dispatch": ((TSDFMap, "_dispatch_config"),),
              "split": ((sharded, "owner_split"),
                        (sharded, "rebalance_chunks")),
              "scratch_pools": ((sharded, "create_state"),),
              "scratch_inserts": ((integrate, "insert_step_deferred"),),
              "route": ((sharded, "_route_block_rows"),),
              "exchange": ((sharded.ShardMesh, "exchange"),),
              "halo_merge": ((integrate, "update_pool_tiled"),),
              "psum": ((sharded, "_psum_metrics"),),
              "settle": ((sharded, "settle_stack"),)}
    acc = dict.fromkeys(stages, 0.0)
    depth = [0]
    saved = []

    def timed(name, fn):
        def run(*a, **kw):
            if depth[0]:          # a stage inside a timed stage
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                acc[name] += (time.perf_counter() - t0) * 1e3
                depth[0] -= 1
        return run

    for name, targets in stages.items():
        for owner, attr in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, timed(name, fn))
    runs = []
    try:
        for _ in range(reps):
            for k in acc:
                acc[k] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.insert(pts, pos)
            m._settle()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            runs.append(dict(acc, other=total - sum(acc.values()),
                             total=total))
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return {k: round(statistics.median(r[k] for r in runs), 3)
            for k in runs[0]}


def run_sharded(tmp):
    """Phase 13: the sharded map (``parallel/``) on the one card; returns
    the launch counts of one dense N = 4 insert and of the N = 4 stream's
    12 inserts."""
    from chad_tsdf_tpu_torch import MapConfig, TSDFMap, kernels
    from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
    from chad_tsdf_tpu_torch.mesh import read_ply
    from chad_tsdf_tpu_torch.parallel import (ShardedTSDFMap, distributed,
                                              make_mesh, sharded)
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks
    from chad_tsdf_tpu_torch.slam import posegraph as pg

    t_phase = time.perf_counter()
    cfg = MapConfig()
    dense = sphere(N_DENSE, 5.0, 420)
    origin0 = np.zeros(3, np.float32)
    k123 = ("fused_tile_partials", "estimate_normals", "merge_partials")

    # 1. N = 1: the single-device insert itself
    ref = TSDFMap(0.05, 0.1, device="cuda")
    ref.insert(dense, origin0)
    s1 = ShardedTSDFMap(0.05, 0.1, mesh=make_mesh(1))
    with ks.count_host_reads() as reads:
        met = s1.insert(dense, origin0)
    for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
              "tile_overflow"):
        require(torch.equal(getattr(s1.state_stack[0], f),
                            getattr(ref.state, f)),
                f"N = 1: {f} not bit-equal to TSDFMap")
    require(reads == {}, f"the N = 1 insert read the host: {reads}")
    log(f"phase 13 N = 1 (2^20-point r = 5 m sphere): pools, directory "
        f"and slot order bit-equal to TSDFMap; host reads {reads}")

    # 2. N = 1 through the generic path: scratch, routing, K3 merge
    mesh1 = make_mesh(1)
    origin = ref.state.origin_blocks.cpu().numpy()

    def generic(mesh):
        step, _ = sharded.make_sharded_insert(cfg, mesh, force_generic=True)
        stack = sharded.create_sharded_state(cfg, mesh, origin)
        stack, m, tails = step(stack, dense, np.int32([N_DENSE]), origin0,
                               sharded.key_bounds(1, cfg))
        stack, _ = sharded.settle_stack(stack, tails, mesh)
        return stack, {k: int(v) for k, v in m.items()}

    kernels.reset_launches()
    g_stack, g_met = generic(mesh1)
    g_launches = dict(kernels.LAUNCHES)
    g_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generic(mesh1)
        torch.cuda.synchronize()
        g_ms.append((time.perf_counter() - t0) * 1e3)
    for k in k123:
        require(g_launches[k] > 0, f"{k} launched 0 times in the N = 1 "
                                   "generic insert")
    require(g_met["route_sent"] == 0 and g_met["route_overflow"] == 0,
            f"N = 1 generic routed rows: {g_met}")
    g_err = same_state(g_stack[0], ref.state, "N = 1 generic vs TSDFMap")
    log(f"phase 13 N = 1 generic (force_generic): dir_keys and weights "
        f"equal to TSDFMap's, sd err/weight {g_err:.3e}; route_sent "
        f"{g_met['route_sent']}; one insert into a fresh pool "
        f"{[round(x, 3) for x in g_ms]} ms; launches {g_launches}")

    # 3. N = 4 on the one card, the dense sphere at full width
    mesh4 = make_mesh(SHARDS)
    require(mesh4.devices == (torch.device("cuda", 0),) * SHARDS,
            f"mesh devices {mesh4.devices}")
    s4 = ShardedTSDFMap(0.05, 0.1, mesh=mesh4)
    kernels.reset_launches()
    with KernelCalls() as calls, ks.count_host_reads() as reads:
        met4 = s4.insert(dense, origin0)
    torch.cuda.synchronize()
    dense_launches = dict(kernels.LAUNCHES)
    for k in k123:
        require(dense_launches[k] > 0, f"{k} launched 0 times in the N = 4 "
                                       "dense insert")
    require(reads == {}, f"the N = 4 dense insert read the host: {reads}")
    met4 = {k: met4[k] for k in ("route_overflow", "route_sent",
                                 "n_valid_samples", "n_blocks")}
    require(met4["route_overflow"] == 0 and met4["route_sent"] > 0,
            f"N = 4 dense: {met4}")
    held = hold_sharded_kernels(calls, cfg,
                                sharded.scratch_config(cfg).block_capacity,
                                met4["route_sent"])
    del calls
    log(f"phase 13 N = 4 dense insert, its kernels against their plain "
        f"versions on its own inputs (K2 min dot > 1 - 1e-3; K1 as phase 2; "
        f"K3 both planes bit-equal to the deterministic plain version): "
        f"{json.dumps(held)}")
    med, mx = merged_vs_single(s4.state_stack, ref.state, cfg,
                               "N = 4 dense")
    require(med < 2e-3 and mx < 5e-2,
            f"N = 4 dense sd differs from TSDFMap: median {med}, max {mx}")
    ins = {"single": [], "N = 1": [], "N = 4": []}
    for name in ("single", "N = 1", "N = 4", "N = 4", "N = 1", "single"):
        m = {"single": ref, "N = 1": s1, "N = 4": s4}[name]
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.insert(dense, origin0)
            torch.cuda.synchronize()
            ins[name].append((time.perf_counter() - t0) * 1e3)
    save = {}
    for name, m in (("single", ref), ("sharded", s4)):
        path = os.path.join(tmp, f"{name}.ply")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.save(path)
        save[name] = ((time.perf_counter() - t0) * 1e3, read_ply(path))
    v_s, v_r = save["sharded"][1].vertices, save["single"][1].vertices
    rmse = float(np.sqrt(np.mean(
        (np.linalg.norm(v_s.astype(np.float64), axis=1) - 5.0) ** 2)))
    require(abs(len(v_s) - len(v_r)) <= 0.02 * len(v_r) and
            rmse < 0.1 * cfg.sdf_res,
            f"N = 4 mesh: {len(v_s)} vs {len(v_r)} vertices, RMSE {rmse}")
    log(f"phase 13 N = 4 dense insert (one card, {SHARDS} shards): {met4}; "
        f"merged keys and weights equal to TSDFMap's, per-voxel sd diff "
        f"median {med:.3e} max {mx:.3e}; insert ms in turns (single, "
        f"N = 1, N = 4, N = 4, N = 1, single; 3 each): "
        f"{ {k: [round(x, 3) for x in v] for k, v in ins.items()} } "
        f"(medians { {k: round(statistics.median(v), 3) for k, v in ins.items()} }); save "
        f"{save['sharded'][0]:.1f} ms ({len(v_s)} vertices, RMSE to r = 5 "
        f"{rmse:.6f} m) vs TSDFMap {save['single'][0]:.1f} ms ({len(v_r)} "
        f"vertices); launches in one insert {dense_launches}")
    stages = stage_times(s4, dense, origin0)
    log(f"phase 13 N = 4 dense insert by stage (ms, median of 3, card "
        f"synchronised around each stage): {stages}")
    del s1, s4, ref, g_stack
    torch.cuda.empty_cache()

    # 4. N = 4, the KITTI-shaped stream (sharded_kitti_bench.py's config)
    scans = ks.make_scans()
    scfg = ks.stream_config()
    rotations = ks.expected_rotations(scans, scfg)
    rates = {"single": [], "N = 1": [], "sharded": []}
    maps, stream_launches, sh_metrics = {}, None, None
    for rnd, name in enumerate(("single", "N = 1", "sharded", "single",
                                "N = 1", "sharded", "sharded", "N = 1",
                                "single")):
        if name == "N = 1":
            m, dt, metrics, reads, drained = sharded_stream(scans, scfg,
                                                            mesh1)
            check_reads(reads, drained, "N = 1 stream")
        elif name == "single":
            m, dt, _, metrics, reads = ks.timed_stream(scans, scfg, "cuda")
            require(reads == {}, f"the single-device stream read {reads}")
        else:
            kernels.reset_launches()
            m, dt, metrics, reads, drained = sharded_stream(scans, scfg,
                                                            mesh4)
            stream_launches, sh_metrics = dict(kernels.LAUNCHES), metrics
            n_read, n_drained = check_reads(reads, drained, "N = 4 stream")
            require(max(int(x["route_overflow"]) for x in metrics) == 0,
                    "N = 4 stream metrics")
            for k in ("estimate_normals", "merge_partials"):
                require(stream_launches[k] > 0,
                        f"{k} launched 0 times on the N = 4 stream")
            require(m.n_submaps == rotations,
                    f"N = 4 stream: {m.n_submaps} submaps")
            if name in maps:
                for a, b in zip(sharded_states(m), sharded_states(maps[name])):
                    for x, y in zip(a, b):
                        for f in ("dir_keys", "dir_slots", "n_blocks",
                                  "pool_sd", "pool_w"):
                            require(torch.equal(getattr(x, f),
                                                getattr(y, f)),
                                    f"two N = 4 streams: {f} differs")
                require(m.levels.stats() == maps[name].levels.stats(),
                        "two N = 4 streams: drained DAGs differ")
        if rnd >= 3:
            rates[name].append((len(scans) - 1) / dt)
        maps[name] = m
    sh, single = maps["sharded"], maps["single"]
    require(len(sh._pending) + len(sh.submaps) ==
            len(single._pending) == rotations, "rotations differ")
    pairs = [(sh.state_stack, single.state)] + [
        (p.state_stack, q.raw_state) for p, q in
        zip(sh._pending, single._pending[len(sh.submaps):])]
    for stack, state in pairs:
        merged_vs_single(stack, state, scfg, "N = 4 stream")
    share, n_vox = samples_close(sh, single, "N = 4 stream")
    path = os.path.join(tmp, "stream.ply")
    t0 = time.perf_counter()
    sh.save(path)
    st_save_ms = (time.perf_counter() - t0) * 1e3
    require(read_ply(path).n_vertices > 0, "N = 4 stream: empty mesh")
    log(f"phase 13 N = 4 stream ({len(scans)} scans, {rotations} "
        f"rotations): scans/s medians "
        f"{ {k: round(statistics.median(v), 2) for k, v in rates.items()} } "
        f"(turns: { {k: [round(r, 2) for r in v] for k, v in rates.items()} }"
        f"); route_sent per scan "
        f"{[int(x['route_sent']) for x in sh_metrics]}; two streams "
        f"bit-equal; "
        f"inserts reading the host {n_read} (each drained a stub: "
        f"{n_drained} drained); merged keys and weights equal to the "
        f"single-device stream's (active and rotated-out); {share:.4f} of "
        f"{n_vox} voxels within 2 steps; save {st_save_ms:.1f} ms; "
        f"launches in {len(scans)} inserts {stream_launches}")
    del maps, sh, single, m
    torch.cuda.empty_cache()

    # 5a. carving on the N = 4 stream
    ccfg = ks.stream_config(**CARVE)
    c_ref, _, _, c_single, _ = ks.timed_stream(scans, ccfg, "cuda")
    cm, c_dt, c_met, c_reads, c_drained = sharded_stream(scans, ccfg, mesh4)
    check_reads(c_reads, c_drained, "carved N = 4 stream")
    dropped = [int(x["n_carve_dropped"]) for x in c_met]
    hits = [int(x["n_carve_samples"]) for x in c_met]
    require(min(dropped) >= 0 and min(hits) > 0,
            f"carve counters {hits} {dropped}")
    require(hits == [int(x["n_carve_samples"]) for x in c_single],
            "carved N = 4 stream: n_carve_samples differ from TSDFMap's")
    merged_vs_single(cm.state_stack, c_ref.state, ccfg, "carved N = 4")
    c_share, _ = samples_close(cm, c_ref, "carved N = 4 stream")
    log(f"phase 13 carved N = 4 stream ({json.dumps(CARVE)}): "
        f"{(len(scans) - 1) / c_dt:.2f} scans/s; n_carve_samples per scan "
        f"{hits} (equal to TSDFMap's), n_carve_dropped {dropped}; merged "
        f"keys and weights equal to TSDFMap's; {c_share:.4f} within 2 steps")
    del cm, c_ref, c_single
    torch.cuda.empty_cache()

    # 5b. an N = 4 checkpoint resumed on 2 shards; 2 more scans into both
    more = ks.make_scans(14)[12:]
    a = ShardedTSDFMap(config=scfg, mesh=mesh4)
    for pts, pos in scans:
        a.insert(pts, pos)
    ck = os.path.join(tmp, "sharded.npz")
    t0 = time.perf_counter()
    save_checkpoint(ck, a)
    ck_save = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b = load_checkpoint(ck, mesh=make_mesh(2))
    torch.cuda.synchronize()
    ck_load = (time.perf_counter() - t0) * 1e3
    require(b.n_shards == 2 and b.state_stack[0].device.type == "cuda",
            "checkpoint: not resumed on 2 shards on the card")
    for pts, pos in more:
        a.insert(pts, pos)
        b.insert(pts, pos)
    ck_share, ck_vox = samples_close(a, b, "N = 4 checkpoint on 2 shards")
    require(a.stats()["n_submaps"] == b.stats()["n_submaps"],
            "checkpoint: submaps differ")
    log(f"phase 13 checkpoint: N = 4 stream map saved in {ck_save:.1f} ms "
        f"({os.path.getsize(ck) / 1e6:.2f} MB), loaded on 2 shards in "
        f"{ck_load:.1f} ms; after 2 more scans into both {ck_vox} voxel "
        f"codes equal, {ck_share:.4f} within 2 steps")
    del a, b
    torch.cuda.empty_cache()

    # 5c. the pose graph's normal equations summed over the mesh
    gt = []
    for i in range(16):
        ang = 2 * np.pi * i / 16
        t = np.eye(4)
        t[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        t[:2, 3] = [10 * np.cos(ang), 10 * np.sin(ang)]
        gt.append(t)
    gt = np.asarray(gt)
    graph = pg.add_edge(pg.make_odometry_edges(gt, noise=0.02, seed=1), 15,
                        0, np.linalg.inv(gt[-1]) @ gt[0], weight=10.0)
    init = [gt[0]]
    for k in range(15):
        init.append(init[-1] @ graph.measurements[k].astype(np.float64))
    init = np.asarray(init, np.float32)
    p1, st1 = pg.optimize_poses(graph, init, iterations=8, device="cuda")
    p4, st4 = pg.optimize_poses(graph, init, iterations=8, mesh=mesh4,
                                device="cuda")
    pg_err = float(np.abs(p4 - p1).max())
    require(np.allclose(p4, p1, rtol=1e-3, atol=1e-4) and
            st1["gated_edges"] == st4["gated_edges"],
            f"mesh solve vs single: {pg_err}, {st1} vs {st4}")
    log(f"phase 13 pose graph (16 nodes, 17 edges, 8 iterations): "
        f"optimize_poses(mesh=make_mesh({SHARDS})) vs N = 1, max |dpose| "
        f"{pg_err:.2e}; {st4}")

    # 6. a world-size-1 NCCL group: the N = 1 generic insert through the
    # collective path, equal to the in-process exchange's
    import socket
    import torch.distributed as dist
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    distributed.initialize(f"tcp://localhost:{port}", 1, 0, device="cuda",
                           timeout_s=120)
    try:
        mesh_c = make_mesh(1)
        require(mesh_c.group is not None and dist.get_backend() == "nccl",
                "no NCCL group")
        n_stack, n_met = generic(mesh_c)
        ref_stack, _ = generic(mesh1)
        for f in ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w"):
            require(torch.equal(getattr(n_stack[0], f),
                                getattr(ref_stack[0], f)),
                    f"NCCL generic insert: {f} differs")
    finally:
        dist.destroy_process_group()
    log(f"phase 13 NCCL (world size 1, backend nccl): the N = 1 generic "
        f"insert through all_to_all_single / all_reduce / all_gather "
        f"equals the in-process exchange bit for bit; {n_met}")
    log(f"phase 13 time: {time.perf_counter() - t_phase:.1f} s")
    return dense_launches, stream_launches


# the CUDA symbol each kernel's wrapper launches once a call (the profiler's
# names; carve_sort's pass kernel runs once a digit, five times a call at
# block_bits 10)
KERNEL_SYMBOLS = {
    "fused_tile_partials": ("fused_tile_kernel",),
    "estimate_normals": ("normals_combine_kernel",),
    "merge_partials": ("merge_partials_kernel",),
    "tile_partials": ("tile_partials_kernel",),
    "tile_partials_sorted": ("tile_heads_kernel",),
    "accumulate_segments": ("accumulate_chunks_kernel",),
    "set_conditional": ("set_conditional_kernel",),
    "seg_samples": ("seg_samples_kernel",),
    "carve_keys": ("carve_keys_kernel",),
    "carve_sort": ("carve_sort_pass_kernel",),
    "carve_apply": ("carve_apply_kernel",),
}
GRAPH_FIELDS = ("dir_keys", "dir_slots", "n_blocks", "pool_sd", "pool_w",
                "point_overflow", "sample_overflow", "block_overflow",
                "touched_overflow", "tile_overflow")


def profiled(fn):
    """Run ``fn`` under ``torch.profiler`` with CUDA activity; returns (the
    device's kernels by name with their counts, device busy ms, window
    ms).  Only device activity that starts after a marker kernel launched
    at the start of the region counts: the profiler can hand over a
    record of a kernel that ended before it started."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    marks = [e.time_range.start for e in evs if "spin" in e.name]
    if marks:
        evs = [e for e in evs if e.time_range.start > min(marks) and
               "spin" not in e.name]
    names = collections.Counter(e.name for e in evs)
    if not evs:
        return names, None, None
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    t0 = min(e.time_range.start for e in evs)
    t1 = max(e.time_range.end for e in evs)
    return names, busy, (t1 - t0) / 1e3


def run_graph(tmp):
    """Phase 14: ``insert_steps_scan`` replaying a captured CUDA graph,
    held bit for bit against eager inserts, on the dense sphere, on the
    2048-point sparse sphere (whose graph's IF node runs K4 and K5) and on
    one KITTI-shaped scan under ``sample_tile`` (K4 and K3 in the graph, K5
    in its IF node, which runs); its
    timing and busy share; the memory reserved before, during and after;
    ``utils.timing`` and ``demo_sphere`` on the card.  Returns (the
    launches per replay of each graph, the memory reserved by moment)."""
    from chad_tsdf_tpu_torch import MapConfig, kernels
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.core.state import (create_state,
                                                origin_blocks_for_position)
    from chad_tsdf_tpu_torch.mesh import read_ply
    from chad_tsdf_tpu_torch.ops import accumulate
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks
    from chad_tsdf_tpu_torch.utils import timing
    t_phase = time.perf_counter()
    mem = {"before": reserved_mb()}
    dev = torch.device("cuda", torch.cuda.current_device())
    per_replay = {}
    reps = 3
    fused_outer = ("fused_tile_partials", "estimate_normals",
                   "merge_partials", "set_conditional")
    tile_body = ("tile_partials", "accumulate_segments")
    (kitti, kitti_pos), = ks.make_scans(1)
    kitti_cfg = ks.stream_config(accumulate_impl="sample_tile",
                                 packed_ingest=False, max_points=1 << 17)
    kitti_pts = np.zeros((kitti_cfg.max_points, 3), np.float32)
    kitti_pts[:len(kitti)] = kitti
    cases = (
        # name, config, padded cloud, valid points, position, kernels a
        # replay launches outside the IF node and in its body, fallback
        ("dense", MapConfig(), sphere(N_DENSE, 5.0, 420), N_DENSE,
         np.zeros(3, np.float32), fused_outer, tile_body, False),
        ("fallback", MapConfig(max_points=2048, accumulate_impl="fused"),
         sphere(2048, 5.0, 7), 2048, np.zeros(3, np.float32), fused_outer,
         tile_body, True),
        ("sample_tile", kitti_cfg, kitti_pts, len(kitti), kitti_pos,
         ("estimate_normals", "tile_partials_sorted", "merge_partials",
          "set_conditional"), ("accumulate_segments",), True))
    for name, cfg, pts_np, n, pos_np, outer, body, fallback in cases:
        pts = torch.from_numpy(pts_np).to(dev)
        pos = torch.from_numpy(pos_np).to(dev)
        origin = origin_blocks_for_position(pos_np, cfg)
        eager = create_state(cfg, origin, dev)
        for _ in range(reps):
            eager, _ = integrate.insert_step(eager, pts, n, pos, cfg)
        integrate.clear_graphs()
        kernels.reset_launches()
        scan = integrate.insert_steps_scan(create_state(cfg, origin, dev),
                                           pts, n, pos, cfg, reps)
        torch.cuda.synchronize()
        captured = dict(kernels.LAUNCHES)
        require(len(integrate._GRAPHS) == 1,
                f"{name}: {len(integrate._GRAPHS)} graphs captured")
        (g,) = integrate._GRAPHS.values()
        require(g.replays == reps - 1, f"{name}: {g.replays} replays")
        for f in GRAPH_FIELDS:
            require(torch.equal(getattr(scan, f), getattr(eager, f)),
                    f"{name}: insert_steps_scan's {f} is not bit-equal to "
                    f"{reps} eager inserts")
        require(not accumulate.overflowed(dev),
                f"{name}: K5 chunk list overflowed")
        falls_back = int(scan.tile_overflow) > 0
        require(falls_back == fallback,
                f"{name}: tile_overflow {int(scan.tile_overflow)}")
        require(g.launches == dict.fromkeys(outer, 1) and
                g.body_launches == dict.fromkeys(body, 1),
                f"{name}: launches per replay {g.launches}, in the IF node "
                f"{g.body_launches}")
        want = dict.fromkeys(outer + (body if falls_back else ()), 1)
        # the replays alone: kernels by name (one replay each), no
        # synchronising call from core/integrate.py
        names, busy, window = profiled(
            lambda: integrate.insert_steps_scan(scan, pts, n, pos, cfg, 4))
        seen = {k: sum(c for nm, c in names.items()
                       if any(sy in nm for sy in sym)) / 4
                for k, sym in KERNEL_SYMBOLS.items()}
        if any(seen.values()):
            require(all(seen[k] == want.get(k, 0) for k in seen),
                    f"{name}: the profiler's kernels per replay {seen} "
                    f"against {want}")
        mine, _ = integrate_syncs(
            lambda: integrate.insert_steps_scan(scan, pts, n, pos, cfg, 2))
        require(not mine, f"{name}: replays synchronised in "
                          f"core/integrate.py: {mine}")
        per_replay[name] = want
        log(f"phase 14 {name} ({n} points, {cfg.accumulate_impl}): "
            f"insert_steps_scan at reps {reps} bit-equal to {reps} eager "
            f"inserts (pools, directory, slot order, the five counters: "
            f"tile_overflow {int(scan.tile_overflow)}); launches per replay "
            f"outside the IF node {g.launches}, in it {g.body_launches}, "
            f"run {want} (the profiler's kernels per replay: "
            f"{seen if any(seen.values()) else 'none seen'}); launch counts "
            f"of the eager insert + capture {captured}; graph bytes "
            f"{g.nbytes}")
        if name == "dense":
            mem["during"] = reserved_mb()
            # timing: the graph against the eager loop and a synced single
            st = scan
            t_reps = 10
            rows = {"graph": [], "eager": [], "single": []}
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = integrate.insert_steps_scan(st, pts, n, pos, cfg,
                                                 t_reps)
                torch.cuda.synchronize()
                rows["graph"].append((time.perf_counter() - t0) * 1e3 /
                                     t_reps)
                t0 = time.perf_counter()
                for _ in range(t_reps):
                    st, _ = integrate.insert_step(st, pts, n, pos, cfg)
                torch.cuda.synchronize()
                rows["eager"].append((time.perf_counter() - t0) * 1e3 /
                                     t_reps)
            for _ in range(5):
                t0 = time.perf_counter()
                st, _ = integrate.insert_step(st, pts, n, pos, cfg)
                torch.cuda.synchronize()
                rows["single"].append((time.perf_counter() - t0) * 1e3)
            med = {k: statistics.median(v) for k, v in rows.items()}
            busy_txt = ("not measured" if busy is None else
                        f"{busy / 4:.3f} ms of device time per replay in "
                        f"{window / 4:.3f} ms, busy {busy / window:.1%} "
                        f"(the state's copies in and out included)")
            log(f"phase 14 timing (dense, ms per insert, median of 3 "
                f"rounds of {t_reps}): insert_steps_scan {med['graph']:.3f} "
                f"{[round(x, 3) for x in rows['graph']]}, eager loop "
                f"{med['eager']:.3f} {[round(x, 3) for x in rows['eager']]}"
                f", synced single {med['single']:.3f} (median of 5) -> "
                f"{N_DENSE / med['graph'] * 1e3:.0f} points/s through the "
                f"graph; under replay {busy_txt}")
            del st
        del eager, scan, g
        integrate.clear_graphs()
        torch.cuda.empty_cache()
    mem["after"] = reserved_mb()
    log(f"phase 14 memory reserved (MiB): {mem}")

    # utils.timing on the card
    cfg = MapConfig()
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    pts = torch.from_numpy(sphere(N_DENSE, 5.0, 420)).to(dev)
    st = create_state(cfg, origin_blocks_for_position(np.zeros(3), cfg), dev)
    st, met, report = timing.profile_insert(st, pts, N_DENSE, pos, cfg)
    stages = [line.split()[0] for line in report.splitlines()]
    require(stages == ["mc+norm", "smp", "pool", "total"],
            f"profile_insert's report {report!r}")
    require(int(met["n_valid_samples"]) > 0, "profile_insert: no samples")
    trace_dir = os.path.join(tmp, "trace")
    with timing.trace(trace_dir, device=dev):
        st, _ = integrate.insert_step(st, pts, N_DENSE, pos, cfg)
        torch.cuda.synchronize()
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    require(len(traces) == 1 and os.path.getsize(
        os.path.join(trace_dir, traces[0])) > 0, f"trace wrote {traces}")
    log(f"phase 14 utils.timing.profile_insert (2^20-point sphere, ms of "
        f"device time): {' | '.join(report.splitlines())}; trace wrote "
        f"{traces[0]} ({os.path.getsize(os.path.join(trace_dir, traces[0]))}"
        f" bytes)")
    del st, pts
    torch.cuda.empty_cache()

    # demo_sphere at full size, in its own process
    ply = os.path.join(tmp, "demo_sphere.ply")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "chad_tsdf_tpu_torch.examples.demo_sphere",
         "--out", ply], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    require(proc.returncode == 0,
            f"demo_sphere exited {proc.returncode}: {proc.stderr[-2000:]}")
    mesh = read_ply(ply)
    r = np.linalg.norm(mesh.vertices.astype(np.float64), axis=1)
    require(mesh.n_vertices > 0 and abs(r.mean() - 5.0) < 0.05 and
            r.std() < 0.05, f"demo_sphere's mesh |v| {r.mean()} +- {r.std()}")
    lines = [x for x in proc.stdout.splitlines()
             if x.startswith(("insert:", "save:", "mesh:"))]
    log(f"phase 14 demo_sphere (1,000,000 points, subprocess "
        f"{time.perf_counter() - t0:.1f} s): {' | '.join(lines)}")
    log(f"phase 14 time: {time.perf_counter() - t_phase:.1f} s")
    return per_replay, mem


def check_conditional(results):
    """Phase 2: the one-thread kernel that sets a CUDA graph's IF node
    (``ops/conditional.py``) against its plain version: a captured graph
    whose IF body allocates and adds into a marker, replayed for counts of
    both signs and zero after the allocator emptied its cache and handed
    memory to another tensor (the body's memory must stay the graph's);
    its time in a graph with an empty body, against the plain version's
    comparison as one torch op."""
    from chad_tsdf_tpu_torch.ops import conditional
    dev = torch.device("cuda", torch.cuda.current_device())
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    marker = torch.zeros(4, dtype=torch.int32, device=dev)
    pool = torch.cuda.MemPool()

    def body():
        step = torch.arange(1, 5, dtype=torch.int32, device=dev) * 3
        marker.add_(step + torch.ones_like(step) - 1)

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        marker.zero_()
        conditional.if_positive(flag, body, pool)
    torch.cuda.empty_cache()
    junk = torch.full((1 << 22,), -7, dtype=torch.int32, device=dev)
    err = 0
    for v in (2**31 - 1, 7, 1, 0, -1, -2**31):
        flag.fill_(v)
        g.replay()
        torch.cuda.synchronize()
        want = torch.arange(1, 5, dtype=torch.int32, device=dev) * 3 \
            if conditional.set_conditional_plain(flag.cpu()) else \
            torch.zeros(4, dtype=torch.int32, device=dev)
        err = max(err, int((marker - want).abs().max()))
    require(err == 0, f"set_conditional: the IF body disagrees with the "
                      f"plain version by {err}")
    # a MemPool must outlive the capture (its destructor empties the cache)
    empty, empty_pool = torch.cuda.CUDAGraph(), torch.cuda.MemPool()
    with torch.cuda.graph(empty):
        conditional.if_positive(flag, lambda: None, empty_pool)
    flag.fill_(0)
    ms = cuda_ms(empty.replay)
    plain_ms = cuda_ms(lambda: torch.gt(flag, 0))
    del junk, g, empty, pool, empty_pool
    results["set_conditional"] = {"max_abs_err": float(err), "ms": ms,
                                  "plain_ms": plain_ms, "library_ms": None}
    results["set_conditional"]["bound_ms"], \
        results["set_conditional"]["bound_by"] = bound(4)
    log(f"phase 2 set_conditional: IF body bit-equal to the plain version "
        f"for counts of both signs and 0; {ms:.4f} ms a replay of its graph "
        f"(empty body), plain {plain_ms:.4f} ms")


def reserved_mb():
    torch.cuda.synchronize()
    return round(torch.cuda.memory_reserved() / 2**20, 1)


def same_insert(ga, ea, ma, mb, what):
    """Two maps' active and rotated-out states bit-equal in every field,
    and one insert's metrics equal."""
    require(dict(ma) == dict(mb), f"{what}: metrics {dict(ma)} against "
                                  f"{dict(mb)}")
    states = lambda m: [m.state] + [p.raw_state for p in m._pending]
    require(len(ga._pending) == len(ea._pending),
            f"{what}: pending submaps differ")
    for x, y in zip(states(ga), states(ea)):
        for f in GRAPH_FIELDS + ("origin_blocks",):
            require(torch.equal(getattr(x, f), getattr(y, f)),
                    f"{what}: {f} not bit-equal to the eager insert")


def graph_pair(cfg):
    """(a map that replays graphs, a map that inserts eagerly) on the
    card."""
    from chad_tsdf_tpu_torch import TSDFMap
    eager = TSDFMap(config=cfg, device="cuda")
    eager.graphs_enabled = False
    return TSDFMap(config=cfg, device="cuda"), eager


def run_map_graph():
    """Phase 15: ``TSDFMap.insert`` through its CUDA graphs, bit-equal to
    the eager insert: the dense sphere under fused, tile, pallas and
    sample_tile (three clouds of different n in the 2^20 bucket), the
    2048-point sparse sphere under fused (the IF body runs K4 and K5) and
    under sample_tile (the IF body runs K5), the phase-8 stream with two
    rotations, carving off and on, and under ``sparse_impl="sample_tile"``
    (its IF body runs K5); no host read; launches per insert; memory
    reserved.  Returns (launches per insert by cloud, memory reserved by
    moment)."""
    from chad_tsdf_tpu_torch import MapConfig
    from chad_tsdf_tpu_torch.core import graph
    from chad_tsdf_tpu_torch.core.state import clone_state, reset_state_
    from chad_tsdf_tpu_torch.ops import accumulate
    from chad_tsdf_tpu_torch.scripts import kitti_stream as ks
    from chad_tsdf_tpu_torch.utils import timing
    t_phase = time.perf_counter()
    mem = {"before": reserved_mb()}
    per_insert = {}
    pos0 = np.zeros(3, np.float32)
    dense = sphere(N_DENSE, 5.0, 420)
    # sample_tile's graph holds K4's partial rows of the 2^20 bucket
    # (T x nb x 4 KiB, twice: 5.4 GB), past the cache's byte bound: the
    # newest graph stays
    cases = [(f"dense {impl}", MapConfig(accumulate_impl=impl),
              [(dense[:n], pos0) for n in (N_DENSE, N_DENSE - 12345,
                                           900_000)])
             for impl in ("fused", "tile", "pallas", "sample_tile")]
    for impl in ("fused", "sample_tile"):
        cases.append((f"sparse {impl}", MapConfig(max_points=2048,
                                                  accumulate_impl=impl),
                      [(sphere(2048, 5.0, 7 + i)[:2048 - 50 * i], pos0)
                       for i in range(3)]))
    scans = ks.make_scans()
    for carving in (False, True):
        kw = dict(carve_steps=128, carve_stride=2.0, carve_subsample=2) \
            if carving else {}
        cases.append((f"stream carve {'on' if carving else 'off'}",
                      ks.stream_config(**kw), scans))
    cases.append(("stream sample_tile",
                  ks.stream_config(sparse_impl="sample_tile"), scans))
    for name, cfg, clouds in cases:
        gm, em = graph_pair(cfg)
        reads_all = {}
        for i, (pts, pos) in enumerate(clouds):
            c0 = timing.counts()
            with ks.count_host_reads() as reads:
                mg = gm.insert(pts, pos)
            c1 = timing.counts()
            reads_all.update(reads)
            me = em.insert(pts, pos)
            same_insert(gm, em, mg, me, f"phase 15 {name}, insert {i}")
            # a capture waits for the card once; a replay never does
            require(c1["host_syncs"] - c0["host_syncs"] ==
                    c1["graph_captures"] - c0["graph_captures"] and
                    not reads, f"{name}: insert {i} read the host: "
                    f"{reads}, {c1['host_syncs'] - c0['host_syncs']} waits")
        require(not accumulate.overflowed("cuda"),
                f"{name}: K5 chunk list overflowed")
        graphs = gm._graphs.values()
        require(len(graphs) >= 1 and all(g.replays > 0 for g in graphs),
                f"{name}: graphs {[(g.replays) for g in graphs]}")
        tile_ovf = int(gm.state.tile_overflow)
        if name.startswith("sparse") or name == "stream sample_tile":
            # the IF node's body ran
            require(tile_ovf > 0, f"{name} did not fall back")
        elif name.startswith("dense"):
            require(tile_ovf == 0, f"{name}: tile_overflow {tile_ovf}")
        if name == "stream carve off":
            # the rotation design: the stub's copy of the graph's state and
            # the state's reset in place, against a capture on new tensors
            st = gm.state
            origin = st.origin_blocks.cpu().numpy()
            rotate_ms = cuda_ms(lambda: reset_state_(clone_state(st), origin))
            g0 = gm._graphs.values()[0]
            fresh = graph.InsertGraph(clone_state(st), g0.config,
                                      g0.points.shape[0], g0.packed)
            fresh.load(clouds[0][0], clouds[0][1], len(clouds[0][0]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.warm()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fresh.capture()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rotation = {"clone_and_reset_ms": rotate_ms,
                        "eager_insert_ms": (t1 - t0) * 1e3,
                        "capture_ms": (t2 - t1) * 1e3,
                        "capture_bytes": fresh.nbytes}
            log(f"phase 15 rotation: the stub's copy and the reset in place "
                f"{rotate_ms:.4f} ms of device time (CUDA events, median of "
                f"10) against recapturing on new tensors: an eager insert "
                f"{rotation['eager_insert_ms']:.3f} ms, then the capture "
                f"{rotation['capture_ms']:.3f} ms and {fresh.nbytes} bytes "
                f"(host clock)")
            del fresh, st, g0
        if name.startswith("stream"):
            require(len(gm._pending) == 2, f"{name}: "
                    f"{len(gm._pending)} pending rotations")
            gs, es = gm.stats(), em.stats()
            require(gs == es, f"{name}: stats after the drain differ")
        (g,) = graphs[:1]
        if name.startswith("stream carve"):
            carving = {k: g.launches.get(k, 0)
                       for k in ("carve_keys", "carve_sort", "carve_apply")}
            want = 1 if name.endswith("on") else 0
            require(set(carving.values()) == {want},
                    f"{name}: the carve's kernels a replay {carving}")
        fell = tile_ovf > 0
        if "sample_tile" in name:
            # the sorted K4 once a replay outside the IF node, the general
            # K4 nowhere in the graph
            require(g.launches.get("tile_partials_sorted") == 1 and
                    "tile_partials" not in g.launches and
                    "tile_partials" not in g.body_launches,
                    f"{name}: launches per replay {g.launches}, in the IF "
                    f"node {g.body_launches}")
        per_insert[name] = {k: g.launches.get(k, 0) + (
            g.body_launches.get(k, 0) if fell else 0)
            for k in set(g.launches) | set(g.body_launches)}
        busy_txt = ""
        if not name.startswith("stream"):
            # one more replay under the profiler, held to the eager insert
            # after it: the kernels the device ran, K4 and K5 only where
            # the IF node took its body.  This phase runs in a process of
            # its own (phase15_apart): CUPTI's names for the records of an
            # IF body go wrong as the process's history grows (PERF.md §7).
            # A second K5 run would double the pools, which the eager
            # insert after it rules out, so the check on the profiler is
            # the set
            pts, pos = clouds[-1]
            names, busy, window = profiled(lambda: gm.insert(pts, pos))
            same_insert(gm, em, gm.last_metrics, em.insert(pts, pos),
                        f"phase 15 {name}, the profiled insert")
            seen = {k: sum(c for nm, c in names.items()
                           if any(sy in nm for sy in sym))
                    for k, sym in KERNEL_SYMBOLS.items()}
            if any(seen.values()):
                require({k for k, v in seen.items() if v} ==
                        {k for k, v in per_insert[name].items() if v},
                        f"{name}: the profiler's kernels in one replay "
                        f"{seen} against {per_insert[name]}")
            busy_txt = (f"; one replay under the profiler (then bit-equal "
                        f"to the eager insert): kernels {seen}, "
                        + ("device time not measured" if busy is None else
                           f"{busy:.3f} ms of device time in {window:.3f} "
                           f"ms, busy {busy / window:.1%}"))
        log(f"phase 15 {name}: {len(clouds)} inserts through "
            f"{len(graphs)} graph(s), each bit-equal to the eager insert "
            f"(states active and rotated-out, metrics); tile_overflow "
            f"{tile_ovf}; launches per replay outside the IF node "
            f"{g.launches}, in its body {g.body_launches}; graph bytes "
            f"{gm._graphs.nbytes()}; host reads {reads_all}{busy_txt}")
        if name == "dense fused":
            mem["during"] = reserved_mb()
        del gm, em, graphs, g
        torch.cuda.empty_cache()
    mem["after"] = reserved_mb()
    log(f"phase 15 memory reserved (MiB): {mem}; time "
        f"{time.perf_counter() - t_phase:.1f} s")
    return per_insert, mem


def phase15_apart():
    """Phase 15 in a process of its own, this script run with
    ``--phase15 <json>``: in a process that ran phases 1-14, the profiler
    paired the records of an IF body's kernels with other kernels' names
    and attributes in some sessions (their times stayed right), also where
    no carve kernel was ever loaded (PERF.md §7).  Returns what
    :func:`run_map_graph` returns."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase15.json")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--phase15", path], cwd=ROOT, timeout=900)
        require(proc.returncode == 0, f"phase 15 exited {proc.returncode}")
        with open(path) as fh:
            got = json.load(fh)
    return got["per_insert"], got["mem"]


def phase15_main(path: str) -> int:
    """The process of :func:`phase15_apart`: phase 15, its result written
    to ``path``."""
    sys.path.insert(0, ROOT)
    from chad_tsdf_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    per_insert, mem = run_map_graph()
    require(not jax_package_modules(),
            f"the port imported {jax_package_modules()}")
    with open(path, "w") as fh:
        json.dump({"per_insert": per_insert, "mem": mem}, fh)
    return 0


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
    from chad_tsdf_tpu_torch.mesh import device_mc, read_ply
    from chad_tsdf_tpu_torch.utils import timing
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
    check_sample_tile(cfg, results)
    torch.cuda.empty_cache()
    check_seg_samples(results)
    torch.cuda.empty_cache()
    check_carve_kernels(results)
    check_k5(cfg, results)
    check_conditional(results)
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
    syncs0 = timing.COUNTS["host_syncs"]
    for _ in range(5):
        t0 = time.perf_counter()
        met = m.insert(dense, origin0)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
    waits = timing.COUNTS["host_syncs"] - syncs0
    dense_launches = dict(kernels.LAUNCHES)
    # the first insert ran eagerly (its fallback unconditionally: K4 and
    # K5 add nothing there) and captured the map's graph; the other five
    # replayed it, which no count sees (phase 15 reads the replays)
    for name in ("fused_tile_partials", "estimate_normals", "merge_partials",
                 "set_conditional"):
        require(dense_launches[name] > 0,
                f"{name} launched 0 times on the dense sphere")
    (dense_graph,) = m._graphs.values()
    require(dense_graph.replays == 5 and dense_graph.launches == dict.fromkeys(
        ("fused_tile_partials", "estimate_normals", "merge_partials",
         "set_conditional"), 1), f"the dense sphere's graph: "
        f"{dense_graph.replays} replays, launches {dense_graph.launches}")
    eager_ms = []
    me = TSDFMap(0.05, 0.1, device="cuda")
    me.graphs_enabled = False
    me.insert(dense, origin0)
    torch.cuda.synchronize()
    for _ in range(5):
        t0 = time.perf_counter()
        me.insert(dense, origin0)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    del me
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        device_mc.CALLS["marching_cubes_device"] = 0
        t0 = time.perf_counter()
        m.save(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        mesh = read_ply(path)
    require(device_mc.CALLS["marching_cubes_device"] == 1,
            "the sphere's save did not run device marching cubes")
    n_blocks = int(m.state.n_blocks)
    tile_ovf = int(m.state.tile_overflow)
    require(tile_ovf == 0, f"dense sphere tile_overflow {tile_ovf}")
    require(n_blocks > 0, "no blocks allocated")
    require(waits == 0, f"the fused replays waited for the card {waits} "
                        f"times")
    msync = TSDFMap(0.05, 0.1, device="cuda")
    msync.insert(dense, origin0)
    mine, syncs = integrate_syncs(lambda: [msync.insert(dense, origin0)
                                           for _ in range(3)])
    del msync
    require(not mine, f"fused inserts synchronised in core/integrate.py: "
                      f"{mine}")
    lossy = {k: int(getattr(m.state, k)) for k in
             ("point_overflow", "sample_overflow", "block_overflow",
              "touched_overflow")}
    require(not any(lossy.values()), f"overflow {lossy}")
    require(mesh.n_vertices > 0 and mesh.n_faces > 0, "empty mesh")
    radius = np.linalg.norm(mesh.vertices.astype(np.float64), axis=1)
    rmse = float(np.sqrt(np.mean((radius - 5.0) ** 2)))
    require(rmse < 0.1 * cfg.sdf_res, f"sphere RMSE {rmse}")
    ins = statistics.median(insert_ms)
    log(f"phase 3 dense insert (TSDFMap.insert, one graph replay): "
        f"{ins:.3f} ms median of {[round(x, 3) for x in insert_ms]} -> "
        f"{N_DENSE / ins * 1e3:.0f} points/s; eager insert "
        f"{statistics.median(eager_ms):.3f} ms median of "
        f"{[round(x, 3) for x in eager_ms]}; n_blocks {n_blocks}, "
        f"tile_overflow {tile_ovf}, host waits in 5 inserts {waits}, "
        f"n_valid_samples {met['n_valid_samples']}; launches (eager first "
        f"insert + capture) {dense_launches}")
    log(f"phase 3 sync debug mode over 3 fused inserts: synchronising "
        f"calls from core/integrate.py {mine}; from anywhere {syncs}")
    log(f"phase 3 save (device marching cubes): {save_ms:.1f} ms (sub fin "
        f"{m.last_metrics['sub_fin_ms']:.1f} ms, mesh "
        f"{m.last_metrics['mesh_ms']:.1f} ms: voxel samples "
        f"{m.last_metrics['voxel_samples_ms']:.1f}, MC "
        f"{m.last_metrics['mc_ms']:.1f}, normals "
        f"{m.last_metrics['normals_ms']:.1f}; PLY "
        f"{m.last_metrics['ply_ms']:.1f} ms); {mesh.n_vertices} vertices, "
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
        syncs0 = timing.COUNTS["host_syncs"]
        for _ in range(5):
            t0 = time.perf_counter()
            mb.insert(dense, origin0)
            torch.cuda.synchronize()
            impl_ms.append((time.perf_counter() - t0) * 1e3)
        impl_launches = dict(kernels.LAUNCHES)
        require(timing.COUNTS["host_syncs"] == syncs0,
                f"the {impl} replays waited for the card")
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

    # ---- phase 4: sparse insert -> fallback through K4 and K5 ----
    # fused by name: under auto this cloud would be dispatched to seg
    sparse_cfg = MapConfig(max_points=2048, accumulate_impl="fused")
    sparse = sphere(2048, 5.0, 7)
    # the graph's step run eagerly, its fallback unconditionally; phase 15
    # holds the graph's IF node to it
    ms_ = TSDFMap(0.05, 0.1, config=sparse_cfg, device="cuda")
    ms_.graphs_enabled = False
    scatter = accumulate.accumulate_xla

    def no_scatter(*args, **kw):
        raise AssertionError("the fallback reached the scatter form")

    kernels.reset_launches()
    accumulate.accumulate_xla = no_scatter
    try:
        syncs0 = timing.COUNTS["host_syncs"]
        ms_.insert(sparse, origin0)
        require(timing.COUNTS["host_syncs"] == syncs0,
                "the sparse fused insert waited for the card")
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
    stream_launches, sample_tile_launches, rk2, stream_map = run_stream(cfg)
    results["estimate_normals"]["kitti_scan"] = rk2
    check_parked_seg()

    # ---- phase 9: save on the card, device against host ----
    with tempfile.TemporaryDirectory() as tmp:
        run_save(m, stream_map, tmp)
    del m, stream_map
    torch.cuda.empty_cache()

    # ---- phases 10-12: carving, checkpoints, loop closure ----
    carve_launches = run_carve()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_launches = run_checkpoint(tmp)
        torch.cuda.empty_cache()
        loop_launches = run_loop_closure(tmp)
    torch.cuda.empty_cache()

    # ---- phase 13: the sharded map on the one card ----
    with tempfile.TemporaryDirectory() as tmp:
        shard_dense, shard_stream = run_sharded(tmp)
    torch.cuda.empty_cache()

    # ---- phase 14: insert_steps_scan as a CUDA graph; utils, examples ----
    with tempfile.TemporaryDirectory() as tmp:
        graph_launches, graph_mem = run_graph(tmp)
    torch.cuda.empty_cache()

    # ---- phase 15: TSDFMap.insert through its CUDA graphs ----
    map_graph_launches, map_graph_mem = phase15_apart()
    torch.cuda.empty_cache()

    # ---- result ----
    launches = dict(dense_launches,
                    tile_partials=sparse_launches["tile_partials"],
                    # the main path of the sorted K4: phase 8's sample_tile
                    # stream
                    tile_partials_sorted=sample_tile_launches[
                        "tile_partials_sorted"],
                    accumulate_segments=sparse_launches[
                        "accumulate_segments"],
                    # the seg stream of phase 8
                    seg_samples=stream_launches["seg_samples"],
                    # the carved stream of phase 10
                    carve_keys=carve_launches["carve_keys"],
                    carve_sort=carve_launches["carve_sort"],
                    carve_apply=carve_launches["carve_apply"],
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
                    **({"ms_int8": r["ms_int8"]} if "ms_int8" in r else {}),
                    # K4 and K3 at the sample_tile path's shapes (phase 2)
                    **({"sample_tile": r["sample_tile"]}
                       if "sample_tile" in r else {}),
                    # the sorted K4: the general K4 and the unpack it
                    # replaces on the same stream, in one timed call
                    **({"parent_path_ms": r["parent_path_ms"]}
                       if "parent_path_ms" in r else {}),
                    "launches_stream": stream_launches[name],
                    "launches_carve": carve_launches[name],
                    "launches_checkpoint": ckpt_launches[name],
                    "launches_loop_closure": loop_launches[name],
                    "launches_sharded_dense": shard_dense[name],
                    "launches_sharded_stream": shard_stream[name],
                    "launches_per_replay_dense":
                        graph_launches["dense"].get(name, 0),
                    "launches_per_replay_fallback":
                        graph_launches["fallback"].get(name, 0),
                    "launches_per_replay_sample_tile":
                        graph_launches["sample_tile"].get(name, 0),
                    "launches_sample_tile_stream":
                        sample_tile_launches[name],
                    "launches_per_insert_map": {
                        cloud: got.get(name, 0)
                        for cloud, got in map_graph_launches.items()}})
    log(f"phase 2 details: {json.dumps(results)}")
    log(f"memory reserved (MiB) around phase 14: {json.dumps(graph_mem)}, "
        f"around phase 15: {json.dumps(map_graph_mem)}")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase15"]:
        sys.exit(phase15_main(sys.argv[2]))
    sys.exit(main())
