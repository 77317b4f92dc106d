"""K1's device time split by phase and K2's by pass, on one card.

    python3 -m chad_tsdf_tpu_torch.scripts.kernel_phases

K1: builds three copies of ``csrc/`` in which K1 (``fused_tile_kernel``)
stops early: after the DDA has written the tile's samples to shared memory
(phase 0), after the block list (phase 1), after the ranks (phase 2); the
checkout's own K1 is the whole kernel (phase 3).  Each copy keeps a
dependency on what it computed, so the compiler cannot drop the work.
Times with ``cuda_ms`` (median of ``--reps`` calls, device time) on the
2^20-point r = 5 m sphere (bench.py's cloud) at the default MapConfig,
normals from K2.

K2: ``torch.profiler``'s device time of each of its three kernels, mean
over ``--reps`` calls, on the sphere and on the dense-voxel cloud (64
voxels x 16,384 points), beside ``cuda_ms`` of the whole call.

Prints the card's name and power limit, then a JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import kernels
from ..config import MapConfig
from ..ops import dda, fused_integrate, normals_cuda, tile_accum
from ..profile_insert import sorted_cloud, sphere, voxel_clusters
from . import cuda_ms, require_cuda
from .k1_k2_turns import origin_voxel

_CALL = ("  const ColMask ovf = tile_accumulate(s, k, nb, tile, dscale, "
         "pkeys, psd, pw);\n")
_STOPS = {
    0: "  if (tid == 0) counts[tile * 3] = s.key[0] + s.pay[5];\n  return;\n",
    1: ("  tile_block_list(s, k, nb);\n"
        "  if (tid < nb) pkeys[(size_t)tile * nb + tid] = s.list[tid];\n"
        "  return;\n"),
    2: ("  tile_block_list(s, k, nb);\n"
        "  if (tid < nb) pkeys[(size_t)tile * nb + tid] = s.list[tid];\n"
        "  const ColMask ranked = tile_ranks(s, k, nb);\n"
        "  if (tid == 0) counts[tile * 3] = s.pay[3] + ranked.m[0];\n"
        "  return;\n"),
}
# K2's kernels by the name the profiler gives them
_K2_PASSES = {"pass1": "normals_tile_kernel<false>",
              "pass2": "normals_combine_kernel",
              "pass3": "normals_tile_kernel<true>"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def stopped_library(phase: int) -> ctypes.CDLL:
    """A build of csrc/ whose K1 returns after ``phase``."""
    d = os.path.join(kernels.BUILD_DIR, f"k1_phase{phase}")
    src = os.path.join(d, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    path = os.path.join(src, "fused_integrate.cu")
    with open(path) as fh:
        text = fh.read()
    if text.count(_CALL) != 1:
        raise RuntimeError("fused_integrate.cu no longer has the single "
                           "tile_accumulate() call this script cuts at")
    with open(path, "w") as fh:       # the rest stays, unreachable
        fh.write(text.replace(_CALL, _STOPS[phase] + _CALL))
    lib = ctypes.CDLL(kernels.build_library(src, d)[0])
    fn = lib.chad_fused_tile_partials
    fn.argtypes = [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] + [_F] * 2 + [_P] * 5
    fn.restype = _I
    return lib


def k1_phases(cfg, dev, reps: int) -> dict:
    with concurrent.futures.ThreadPoolExecutor(len(_STOPS)) as ex:
        libs = dict(zip(_STOPS, ex.map(stopped_library, _STOPS)))
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    sb, so, px, py, pz = sorted_cloud(sphere(1 << 20, 5.0, 420), cfg, dev)
    nx, ny, nz = (a.contiguous() for a in normals_cuda.estimate_normals(
        px, py, pz, sb, so, pos, cfg.normal_min_points,
        cfg.normal_max_depth))
    n, nb, k = px.shape[0], cfg.tile_nb, cfg.dda_steps
    t = n // 1024
    qscale, dscale = tile_accum.sd_scales(cfg.sdf_trunc)
    extent = cfg.blocks_per_axis * 8
    fargs = (px, py, pz, nx, ny, nz, sb, pos, origin_voxel(cfg, dev))
    keys = torch.empty((t * nb, 1), dtype=torch.int32, device=dev)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=dev)
    pw = torch.empty_like(psd)
    cnt = torch.empty((t, 3), dtype=torch.int32, device=dev)
    p = kernels.ptr

    def stopped(lib):
        def call():
            err = lib.chad_fused_tile_partials(
                *(p(a) for a in fargs), n, k, nb,
                float(np.float32(cfg.sdf_res)),
                dda.res_recip_f32(cfg.sdf_res),
                float(np.float32(cfg.sdf_trunc)), extent, qscale, dscale,
                p(keys), p(psd), p(pw), p(cnt),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"K1 phase build failed: CUDA error {err}")
        return call

    calls = {f"phase{ph}": stopped(lib) for ph, lib in libs.items()}
    calls["phase3"] = lambda: fused_integrate.fused_tile_partials(
        *fargs, nb=nb, k=k, res=cfg.sdf_res, trunc=cfg.sdf_trunc,
        extent=extent)
    return {name: cuda_ms(fn, reps) for name, fn in calls.items()}


def k2_passes(cfg, dev, reps: int) -> dict:
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    clouds = {"sphere": sphere(1 << 20, 5.0, 420),
              "dense_voxels": voxel_clusters(1 << 20, 16384, cfg.sdf_res, 5)}
    out = {}
    for name, pts in clouds.items():
        sb, so, px, py, pz = sorted_cloud(pts, cfg, dev)

        def call():
            normals_cuda.estimate_normals(px, py, pz, sb, so, pos,
                                          cfg.normal_min_points,
                                          cfg.normal_max_depth)

        r = {"ms": cuda_ms(call, reps)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(2_000_000)
                call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        for key, kernel in _K2_PASSES.items():
            hit = [e for e in events if kernel in e.key]
            if len(hit) != 1:
                raise RuntimeError(f"profiler shows {len(hit)} kernels "
                                   f"named like {kernel!r}")
            r[f"{key}_ms"] = hit[0].device_time_total / hit[0].count / 1e3
        out[name] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    cfg = MapConfig()
    out = {"k1_ms_up_to": k1_phases(cfg, dev, args.reps),
           "k2_passes": k2_passes(cfg, dev, args.reps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
