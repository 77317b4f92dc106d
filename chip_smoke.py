#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``chad_tsdf_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``chad_tsdf_tpu_torch/csrc`` and
runs, failing with a non-zero exit on the first error:

1. the card's name and power limit; the kernel build;
2. each kernel (K1 fused integrate, K2 normals, K3 tile merge, K4 tile
   partials) against its plain PyTorch version on the card, on the inputs
   the 1M-point sphere gives it, with both times;
3. the main path: ``TSDFMap(0.05, 0.1, device="cuda")`` at the default
   MapConfig inserts the 2^20-point r = 5 m sphere (seed 420, bench.py's
   cloud) and saves a PLY, whose vertices must sit on the sphere;
4. a sparse 2048-point insert whose tiles overflow, so the fallback (K4)
   runs; its pool is held against the scatter backend;
5. determinism: two fresh maps, same insert, bit-equal pools (dense and
   sparse);
6. the golden workload (tests/golden/sphere_r2_seed420.npz) through the
   fused path.

Launch counts are reset just before the dense inserts of phase 3 and read
right after them: K1, K2 and K3 must have launched there and K4 not.  They
are reset again just before phase 4's sparse insert, where K4 must launch.
The ``kernels`` JSON line (before the card's name and the last line) gives
each kernel's launches in the run that drives it: phase 3 for K1-K3, phase 4
for K4.  The last line is ``{"ok": true, "device": {...}}``.  The script
imports no JAX.
"""

from __future__ import annotations

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
    # name -> (source, TPU kernel it replaces)
    "fused_tile_partials": ("chad_tsdf_tpu_torch/csrc/fused_integrate.cu",
                            "chad_tsdf_tpu/ops/fused_integrate.py:343"),
    "estimate_normals": ("chad_tsdf_tpu_torch/csrc/normals.cu",
                         "chad_tsdf_tpu/ops/normals_pallas.py:209"),
    "merge_partials": ("chad_tsdf_tpu_torch/csrc/tile_accum.cu",
                       "chad_tsdf_tpu/ops/tile_accum.py:204"),
    "tile_partials": ("chad_tsdf_tpu_torch/csrc/tile_accum.cu",
                      "chad_tsdf_tpu/ops/tile_accum.py:116"),
}


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
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def sd_err_per_weight(sd_a, sd_b, w):
    return float((torch.abs(sd_a - sd_b) / torch.clamp(w, min=1.0)).max())


def check_kernels(cfg, results):
    """Phase 2: K1-K4 against their plain versions on the sphere's inputs."""
    from chad_tsdf_tpu_torch.core import integrate
    from chad_tsdf_tpu_torch.core.state import (create_state,
                                                origin_blocks_for_position)
    from chad_tsdf_tpu_torch.ops import (dda, fused_integrate, normals,
                                         normals_cuda, tile_accum)

    dev = torch.device("cuda")
    pts = torch.from_numpy(sphere(N_DENSE, 5.0, 420)).to(dev)
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    origin = origin_blocks_for_position(np.zeros(3), cfg)
    origin_blocks = torch.from_numpy(origin).to(dev)
    origin_voxel = origin_blocks * 8
    bkey, okey, _ = integrate.point_keys_soa(pts[:, 0], pts[:, 1], pts[:, 2],
                                             N_DENSE, origin_blocks, cfg)
    sb, so, px, py, pz = integrate.sort_points_soa(pts[:, 0], pts[:, 1],
                                                   pts[:, 2], bkey, okey)

    # ---- K2 ----
    nargs = (px, py, pz, sb, so, pos, cfg.normal_min_points,
             cfg.normal_max_depth)

    def k2_plain():
        return normals.estimate_normals_soa(
            px, py, pz, sb, so, sb != 2**31 - 1, pos, cfg.normal_min_points,
            cfg.normal_max_depth)

    nk = torch.stack(normals_cuda.estimate_normals(*nargs))
    npl = torch.stack(k2_plain())
    dots = (nk * npl).sum(0)
    min_dot = float(dots.min())
    require(min_dot > 1.0 - 1e-3, f"K2 min dot {min_dot}")
    results["estimate_normals"] = {
        "max_abs_err": float((nk - npl).abs().max()),
        "ms": cuda_ms(lambda: normals_cuda.estimate_normals(*nargs)),
        "plain_ms": cuda_ms(k2_plain, reps=3)}
    log(f"K2 estimate_normals: min dot {min_dot:.7f} "
        f"{results['estimate_normals']}")

    # ---- K1 ----
    nx, ny, nz = nk[0].contiguous(), nk[1].contiguous(), nk[2].contiguous()
    kw = dict(nb=cfg.tile_nb, k=cfg.dda_steps, res=cfg.sdf_res,
              trunc=cfg.sdf_trunc, extent=cfg.blocks_per_axis * 8)
    fargs = (px, py, pz, nx, ny, nz, sb, pos, origin_voxel)
    k1 = fused_integrate.fused_tile_partials(*fargs, **kw)
    p1 = fused_integrate.fused_tile_partials_plain(*fargs, **kw)
    require(torch.equal(k1[0], p1[0]), "K1 block lists differ")
    require(torch.equal(k1[3], p1[3]), "K1 counters differ")
    require(torch.equal(k1[2], p1[2]), "K1 weights differ")
    err1 = sd_err_per_weight(k1[1], p1[1], p1[2])
    require(err1 < SD_TOL, f"K1 sd error {err1}")
    tot = k1[3].sum(0).tolist()
    results["fused_tile_partials"] = {
        "max_abs_err": float((k1[1] - p1[1]).abs().max()),
        "ms": cuda_ms(lambda: fused_integrate.fused_tile_partials(
            *fargs, **kw)),
        "plain_ms": cuda_ms(lambda: fused_integrate.fused_tile_partials_plain(
            *fargs, **kw), reps=3)}
    log(f"K1 fused_tile_partials: [n_valid, n_not_covered, n_samp_ovf] = "
        f"{tot}, rows {k1[1].shape[0]}, {results['fused_tile_partials']}")
    del p1

    # ---- K4, on the sample grids K1 walked internally ----
    grids = dda.local_sample_grids(px, py, pz, nx, ny, nz, sb != 2**31 - 1,
                                   pos, origin_voxel, cfg.sdf_res,
                                   cfg.sdf_trunc, cfg.dda_steps,
                                   cfg.blocks_per_axis * 8)
    targs = (grids[0], grids[1], grids[2], cfg.tile_nb, cfg.sdf_trunc)
    k4 = tile_accum.tile_partials(*targs)
    p4 = tile_accum.tile_partials_plain(*targs)
    for i, what in ((0, "block lists"), (2, "weights"), (3, "ovfmask")):
        require(torch.equal(k4[i], p4[i]), f"K4 {what} differ")
    err4 = sd_err_per_weight(k4[1], p4[1], p4[2])
    require(err4 < SD_TOL, f"K4 sd error {err4}")
    # one coverage rule: K4 on the grids reproduces K1 exactly
    for i in range(3):
        require(torch.equal(k4[i], k1[i]), f"K4 and K1 output {i} differ")
    require(int(k4[3].sum()) == tot[1], "K4 and K1 coverage differ")
    results["tile_partials"] = {
        "max_abs_err": float((k4[1] - p4[1]).abs().max()),
        "ms": cuda_ms(lambda: tile_accum.tile_partials(*targs)),
        "plain_ms": cuda_ms(lambda: tile_accum.tile_partials_plain(*targs),
                            reps=3)}
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
    results["merge_partials"] = {
        "max_abs_err": float((pools_k[0] - pools_p[0]).abs().max()),
        "ms": cuda_ms(lambda: tile_accum.merge_partials(
            *pools_k, *plan, k1[1], k1[2])),
        "plain_ms": cuda_ms(lambda: tile_accum.merge_partials_plain(
            *pools_p, *plan, k1[1], k1[2]), reps=3)}
    log(f"K3 merge_partials: {int(plan[0][0])} groups, "
        f"{results['merge_partials']}")
    del state, pools_k, pools_p, k1, directory, plan


def pool_of(m):
    """(dir_keys, pool_sd, pool_w) of a map's active state."""
    s = m.state
    return s.dir_keys, s.pool_sd, s.pool_w


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
    require("jax" not in sys.modules, "the port imported jax")

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
    del m
    torch.cuda.empty_cache()

    # ---- phase 4: sparse insert -> fallback through K4 ----
    sparse_cfg = MapConfig(max_points=2048)
    sparse = sphere(2048, 5.0, 7)
    ms_ = TSDFMap(0.05, 0.1, config=sparse_cfg, device="cuda")
    kernels.reset_launches()
    ms_.insert(sparse, origin0)
    sparse_launches = dict(kernels.LAUNCHES)
    require(sparse_launches["tile_partials"] > 0,
            "tile_partials launched 0 times on the sparse insert")
    require(int(ms_.state.tile_overflow) > 0, "sparse insert did not fall back")
    import dataclasses
    mx = TSDFMap(0.05, 0.1, config=dataclasses.replace(
        sparse_cfg, accumulate_impl="xla"), device="cuda")
    mx.insert(sparse, origin0)
    require(torch.equal(ms_.state.dir_keys, mx.state.dir_keys),
            "sparse dir_keys differ from the scatter backend")
    nb = int(mx.state.n_blocks)
    sl_f = ms_.state.dir_slots[:nb].long()
    sl_x = mx.state.dir_slots[:nb].long()
    require(torch.equal(ms_.state.pool_w[sl_f], mx.state.pool_w[sl_x]),
            "sparse weights differ from the scatter backend")
    err = sd_err_per_weight(ms_.state.pool_sd[sl_f], mx.state.pool_sd[sl_x],
                            mx.state.pool_w[sl_x])
    require(err < SD_TOL, f"sparse sd error {err}")
    log(f"phase 4 sparse insert: tile_overflow "
        f"{int(ms_.state.tile_overflow)}, n_blocks {nb}, sd err/weight vs "
        f"scatter backend {err:.3e}; launches {sparse_launches}")

    # ---- phase 5: determinism ----
    for name, pts, c in (("dense", dense, cfg), ("sparse", sparse,
                                                  sparse_cfg)):
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

    # ---- result ----
    launches = dict(dense_launches,
                    tile_partials=sparse_launches["tile_partials"])
    out = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
