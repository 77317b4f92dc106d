"""K1 and K2 of an older ``csrc/`` against this checkout's, in turns, on
one card.

    mkdir -p _unpacked/old
    git archive <commit> chad_tsdf_tpu_torch/csrc | tar -x -C _unpacked/old
    python3 -m chad_tsdf_tpu_torch.scripts.k1_k2_turns \\
        --old-csrc _unpacked/old/chad_tsdf_tpu_torch/csrc

The older sources are built with this checkout's nvcc flags into their own
directory and called through their C entries, whose interfaces are this
checkout's: K1 ``chad_fused_tile_partials``, K4 ``chad_tile_partials`` and
K2 ``chad_estimate_normals`` (the per-tile scratch of
``ops/normals_cuda.py``; sources older than K2's redesign took other
scratch).  Inputs:
the 2^20-point r = 5 m sphere (bench.py's cloud) and, for K2, the
dense-voxel cloud (64 voxels x 16,384 points) at the default MapConfig; K4
on the sample grids K1 walks.  Each kernel is timed old, new, new, old
(``cuda_ms``: median of 20 calls, device time only); the two versions are
held against each other first (K2 normals within a dot of 1e-3, K1 and K4
lists, counters or masks and live partial rows equal).

``K4_sample_stream``: the ``sample_tile`` insert's K4 on one KITTI-shaped
scan (``kitti_stream.make_scans(1)``, padded to its bucket, walked into
samples and sorted as ``insert_step_sample_tiled`` does: 1,310,720
samples, nb = ``sparse_tile_nb``).  ``old`` is the path before the sorted
K4, ``unpack_payload`` and the older general K4 in one timed call; ``new``
is this checkout's ``tile_partials_sorted``; held equal first; with the
sorted K4's bound (``k4_stream_bytes`` over 3.35 TB/s).  Prints the
card's name and power limit, then a JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import kernels
from ..config import MapConfig
from ..core import integrate
from ..ops import dda, fused_integrate, normals_cuda, tile_accum
from ..core.state import origin_blocks_for_position
from ..profile_insert import sorted_cloud, sphere, voxel_clusters
from . import cuda_ms, k4_stream_bytes, kitti_stream, require_cuda

INT32_MAX = 2**31 - 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_library(csrc: str) -> ctypes.CDLL:
    path, _ = kernels.build_library(
        csrc, os.path.join(kernels.BUILD_DIR, "old"))
    lib = ctypes.CDLL(path)
    lib.chad_estimate_normals.argtypes = [_P] * 6 + [_I] * 2 + [_F] + \
        [_P] * 5
    lib.chad_fused_tile_partials.argtypes = \
        [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] + [_F] * 2 + [_P] * 5
    lib.chad_tile_partials.argtypes = [_P] * 3 + [_I] * 3 + [_F] * 2 + \
        [_P] * 5
    for fn in (lib.chad_estimate_normals, lib.chad_fused_tile_partials,
               lib.chad_tile_partials):
        fn.restype = _I
    return lib


def _call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old kernel failed with CUDA error {err}")


def origin_voxel(cfg, dev) -> torch.Tensor:
    """The voxel of local block (0, 0, 0) for a scanner at the origin."""
    return torch.from_numpy(
        origin_blocks_for_position(np.zeros(3), cfg) * 8).to(dev)


def turns(old, new, reps):
    """old, new, new, old; returns both medians of each."""
    t = [cuda_ms(old, reps), cuda_ms(new, reps), cuda_ms(new, reps),
         cuda_ms(old, reps)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def sample_stream_turns(lib, dev, reps):
    """The older unpack + general K4 against the sorted K4 on one
    KITTI-shaped scan's block-sorted sample stream (``K4_sample_stream``)."""
    cfg = kitti_stream.stream_config(accumulate_impl="sample_tile")
    (pts, pos), = kitti_stream.make_scans(1)
    bucket = next(b for b in cfg.buckets if b >= len(pts))
    padded = torch.from_numpy(np.resize(pts, (bucket, 3))).to(dev)
    origin = torch.from_numpy(origin_blocks_for_position(pos, cfg)).to(dev)
    batch = integrate.sort_samples(integrate.compute_samples(
        padded, len(pts), torch.from_numpy(pos).to(dev), origin, cfg))
    bkey, payload = batch.bkey, batch.payload
    s, nb, trunc = bkey.shape[0], cfg.sparse_tile_nb, cfg.sdf_trunc
    qscale, dscale = tile_accum.sd_scales(trunc)
    p = kernels.ptr
    o_keys = torch.empty((s // 1024 * nb, 1), dtype=torch.int32, device=dev)
    o_sd = torch.empty((s // 1024 * nb, 512), dtype=torch.float32,
                       device=dev)
    o_w = torch.empty_like(o_sd)
    o_mask = torch.empty((1, s), dtype=torch.int32, device=dev)

    def k4_old():
        okey, sd = integrate.unpack_payload(payload, trunc)
        _call(lib.chad_tile_partials, p(bkey), p(okey), p(sd), s, 1, nb,
              qscale, dscale, p(o_keys), p(o_sd), p(o_w), p(o_mask))

    def k4_new():
        return tile_accum.tile_partials_sorted(bkey, payload, nb, trunc)

    k4_old()
    new = k4_new()
    live = tile_accum.live_rows(new[0])
    if not (torch.equal(new[0], o_keys) and torch.equal(new[3], o_mask) and
            torch.equal(new[1][live], o_sd[live]) and
            torch.equal(new[2][live], o_w[live]) and int(new[4][0]) == 0):
        raise AssertionError("the older unpack + K4 and the sorted K4 differ")
    n_live = int(live.sum())
    nbytes = k4_stream_bytes(bkey, new[3], nb, n_live, 4)
    res = dict(turns(k4_old, k4_new, reps), samples=s,
               valid_samples=int((bkey != INT32_MAX).sum()),
               not_covered=int(new[3].sum()), nb=nb, live_rows=n_live,
               bound_bytes=nbytes, bound_ms=nbytes / 3.35e12 * 1e3)
    print(f"K4 sample stream: {res}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    lib = old_library(args.old_csrc)
    cfg = MapConfig()
    nd, mp = cfg.normal_max_depth, float(cfg.normal_min_points)
    p = kernels.ptr
    pos = torch.zeros(3, dtype=torch.float32, device=dev)
    out = {}

    clouds = {"sphere": sphere(1 << 20, 5.0, 420),
              "dense_voxels": voxel_clusters(1 << 20, 16384, cfg.sdf_res, 5)}
    for name, pts_np in clouds.items():
        sb, so, px, py, pz = sorted_cloud(pts_np, cfg, dev)
        n = px.shape[0]
        tiles = -(-n // normals_cuda.TILE)
        part = torch.empty((tiles, nd, 2, 10), dtype=torch.float32,
                           device=dev)
        tot = torch.empty_like(part)
        meta = torch.empty((tiles, 2), dtype=torch.int32, device=dev)
        res_old = torch.empty((3, n), dtype=torch.float32, device=dev)

        def k2_old():
            _call(lib.chad_estimate_normals, p(px), p(py), p(pz), p(sb),
                  p(so), p(pos), n, nd, mp, p(part), p(tot), p(meta),
                  p(res_old))

        def k2_new():
            return normals_cuda.estimate_normals(
                px, py, pz, sb, so, pos, cfg.normal_min_points, nd)

        k2_old()
        nk = torch.stack(k2_new())
        min_dot = float((nk * res_old).sum(0).min())
        if not min_dot > 1.0 - 1e-3:
            raise AssertionError(f"K2 old and new differ: min dot {min_dot}")
        out[f"K2_{name}"] = dict(turns(k2_old, k2_new, args.reps),
                                 min_dot_old_new=min_dot)
        print(f"K2 {name}: {out[f'K2_{name}']}", flush=True)
        if name != "sphere":
            continue

        nx, ny, nz = (nk[i].contiguous() for i in range(3))
        nb, k = cfg.tile_nb, cfg.dda_steps
        t = n // 1024
        qscale, dscale = tile_accum.sd_scales(cfg.sdf_trunc)
        o_keys = torch.empty((t * nb, 1), dtype=torch.int32, device=dev)
        o_sd = torch.empty((t * nb, 512), dtype=torch.float32, device=dev)
        o_w = torch.empty_like(o_sd)
        o_cnt = torch.empty((t, 3), dtype=torch.int32, device=dev)
        kw = dict(nb=nb, k=k, res=cfg.sdf_res, trunc=cfg.sdf_trunc,
                  extent=cfg.blocks_per_axis * 8)
        fargs = (px, py, pz, nx, ny, nz, sb, pos, origin_voxel(cfg, dev))

        def k1_old():
            _call(lib.chad_fused_tile_partials, *(p(a) for a in fargs), n, k,
                  nb, float(np.float32(cfg.sdf_res)),
                  dda.res_recip_f32(cfg.sdf_res),
                  float(np.float32(cfg.sdf_trunc)), kw["extent"], qscale,
                  dscale, p(o_keys), p(o_sd), p(o_w), p(o_cnt))

        def k1_new():
            return fused_integrate.fused_tile_partials(*fargs, **kw)

        k1_old()
        new = k1_new()
        live = tile_accum.live_rows(new[0])
        same = (torch.equal(new[0], o_keys) and torch.equal(new[3], o_cnt)
                and torch.equal(new[1][live], o_sd[live])
                and torch.equal(new[2][live], o_w[live]))
        if not same:
            raise AssertionError("K1 old and new differ")
        out["K1_sphere"] = dict(turns(k1_old, k1_new, args.reps),
                                live_rows=int(live.sum()), rows=t * nb)
        print(f"K1 sphere: {out['K1_sphere']}", flush=True)

        grids = dda.local_sample_grids(
            px, py, pz, nx, ny, nz, sb != INT32_MAX, pos,
            origin_voxel(cfg, dev), cfg.sdf_res, cfg.sdf_trunc, k,
            kw["extent"])
        o_mask = torch.empty((k, n), dtype=torch.int32, device=dev)

        def k4_old():
            _call(lib.chad_tile_partials, p(grids[0]), p(grids[1]),
                  p(grids[2]), n, k, nb, qscale, dscale, p(o_keys), p(o_sd),
                  p(o_w), p(o_mask))

        def k4_new():
            return tile_accum.tile_partials(grids[0], grids[1], grids[2], nb,
                                            cfg.sdf_trunc)

        k4_old()
        new = k4_new()
        same = (torch.equal(new[0], o_keys) and torch.equal(new[3], o_mask)
                and torch.equal(new[1][live], o_sd[live])
                and torch.equal(new[2][live], o_w[live]))
        if not same:
            raise AssertionError("K4 old and new differ")
        out["K4_sphere"] = turns(k4_old, k4_new, args.reps)
        print(f"K4 sphere: {out['K4_sphere']}", flush=True)

    out["K4_sample_stream"] = sample_stream_turns(lib, dev, args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
