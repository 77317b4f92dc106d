"""Kernel equality on the card: ``tools/tpu_kernel_equality.py`` for the
port.  Every accumulate backend against the port's ``xla`` oracle (the
scatter form, no kernel of its own), on the same device.

    python3 -m chad_tsdf_tpu_torch.scripts.gpu_equality            # on a card
    python3 -m chad_tsdf_tpu_torch.scripts.gpu_equality --device cpu \\
        --points 4096 --out /tmp/eq.json

Three workloads, each inserted twice into a fresh map per backend through
``core.integrate.insert_step`` (bench.py's sphere and KITTI-shaped scan,
tools/tpu_kernel_equality.py's configurations):

* ``dense_sphere_1m``: the 2^20-point r = 5 m sphere (seed 420) at
  ``MapConfig(max_points=2^20)``: ``fused`` (K2, K1, K3), ``tile`` (K2, K4,
  K3), ``pallas`` (K2, K5), ``seg`` (K2 and ``seg_samples``) and ``sample_tile``
  (K2, K4 over tiles of the sorted samples at ``sparse_tile_nb`` 128, K3,
  and K5 for what the lists leave);
* ``sparse_lidar_131k``: ``io.kitti.synthetic_lidar_scan`` (seed 0, from
  (0, 0, 1.7)) at ``MapConfig(block_capacity=2^17, touched_capacity=2^15,
  max_points=2^17)``, where ``fused`` and ``tile`` fall back through K4 and
  K5 on every tile (``sample_tile``: on a few);
* ``fallback_sphere_2048``: ``chip_smoke.py`` phase 4's 2048-point r = 5 m
  sphere (seed 7) at ``MapConfig(max_points=2048)``: one point per block,
  so the fused and tile inserts fall back.

Per backend, as in the TPU tool: ``dir_keys_equal``; the voxels whose
weight differs (``voxels_with_weight_diff``, at most max(2, 1e-5 of the
voxels), and ``max_weight_diff`` at most 4); ``max_mean_sd_diff_in_quanta``,
the largest difference of per-voxel mean signed distance over the voxels
of equal weight in 8-bit codec quanta (trunc / 127), below 1; ``pass``.
The TPU tool ran ``sample_tile`` on the sparse scan only; here it runs on
all three.  Its ``pallas_smem_switch`` row tests the SMEM table bucketing
of the TPU kernel, which the port does not have.  ``--points`` cuts the
sphere to that many points and the scan to at most that many (every k-th
point), for a dry run.

Writes ``chad_tsdf_tpu_torch/GPU_EQUALITY.json`` on a card (``--out``
elsewhere; on the CPU only with ``--out``) with the card's name and power
limit; the last line is ``{"all_pass": ...}``.  Exits 1 if any fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..config import MapConfig
from ..core import integrate
from ..core.state import create_state, origin_blocks_for_position
from ..io.kitti import synthetic_lidar_scan
from ..profile_insert import sphere

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "GPU_EQUALITY.json")
BACKENDS = ("fused", "tile", "pallas", "seg", "sample_tile")


def run_impl(cfg: MapConfig, pts: np.ndarray, pos: np.ndarray, device,
             inserts: int = 2):
    """``inserts`` inserts of ``pts`` into a fresh map on ``device``: the
    live blocks' keys, sd and weight rows in directory order, and the
    overflow counters."""
    n = len(pts)
    pad = np.zeros((cfg.max_points, 3), np.float32)
    pad[:n] = pts
    points = torch.from_numpy(pad).to(device)
    position = torch.from_numpy(pos).to(device)
    state = create_state(cfg, origin_blocks_for_position(pos, cfg), device)
    for _ in range(inserts):
        state, _ = integrate.insert_step(state, points, n, position, cfg)
    nb = int(state.n_blocks)
    keys = state.dir_keys[:nb].cpu().numpy()
    slots = state.dir_slots[:nb].to(torch.int64)
    sd = state.pool_sd[slots].cpu().numpy()
    w = state.pool_w[slots].cpu().numpy()
    return keys, sd, w, {
        "n_blocks": nb,
        "tile_overflow": int(state.tile_overflow),
        "touched_overflow": int(state.touched_overflow),
        "block_overflow": int(state.block_overflow),
    }


def compare(base_cfg: MapConfig, pts, pos, quantum: float, device) -> dict:
    """Each backend of :data:`BACKENDS` against ``xla``; the TPU tool's
    ``compare`` keys and gate."""
    rk, rsd, rw, rmeta = run_impl(
        dataclasses.replace(base_cfg, accumulate_impl="xla"), pts, pos,
        device)
    out = {"xla": {**rmeta, "role": "oracle"}}
    for name in BACKENDS:
        k, sd, w, meta = run_impl(
            dataclasses.replace(base_cfg, accumulate_impl=name), pts, pos,
            device)
        keys_equal = (len(k) == len(rk)) and bool(np.array_equal(k, rk))
        if keys_equal:
            wd = np.abs(w - rw)
            cover_diff = int((wd > 0).sum())
            w_diff = float(wd.max()) if wd.size else 0.0
            same = wd == 0
            mean_r = rsd / np.maximum(rw, 1)
            mean_i = sd / np.maximum(w, 1)
            sd_diff = float(np.abs(mean_i - mean_r)[same].max()) \
                if same.any() else 0.0
            cover_ok = (cover_diff <= max(2, 1e-5 * w.size)
                        and w_diff <= 4.0)
        else:
            sd_diff = w_diff = float("nan")
            cover_diff = -1
            cover_ok = False
        out[name] = {
            **meta,
            "dir_keys_equal": keys_equal,
            "voxels_with_weight_diff": cover_diff,
            "total_voxels": int(w.size),
            "max_weight_diff": w_diff,
            "max_mean_sd_diff_same_cover": sd_diff,
            "max_mean_sd_diff_in_quanta": sd_diff / quantum,
            "pass": bool(keys_equal and cover_ok
                         and sd_diff < 1.0 * quantum),
        }
        print(f"  {name:8s} keys_equal={keys_equal} "
              f"cover_diff={cover_diff} w_diff={w_diff} "
              f"sd_diff={sd_diff:.3e} ({sd_diff / quantum:.3f} quanta) "
              f"tile_ovf={meta['tile_overflow']}", flush=True)
    return out


def _max_points(n: int) -> int:
    """The power of two that holds ``n`` points (at least 4096)."""
    return max(4096, 1 << (int(n) - 1).bit_length())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = {"torch": torch.__version__}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but torch.cuda.is_available() "
                             "is false; pass --device cpu")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        results.update(device=torch.cuda.get_device_name(device),
                       nvidia_smi=smi, cuda=torch.version.cuda)
        out_path = args.out or OUT
    else:
        results["device"] = "cpu"
        out_path = args.out
    results["workloads"] = {}
    quantum = 0.1 / 127

    n_dense = args.points or 1 << 20
    print(f"dense sphere ({n_dense} points):", flush=True)
    results["workloads"]["dense_sphere_1m"] = compare(
        MapConfig(max_points=_max_points(n_dense)),
        sphere(n_dense, 5.0, 420), np.zeros(3, np.float32), quantum, device)

    scan = synthetic_lidar_scan([0.0, 0.0, 0.0], seed=0)
    if args.points:
        scan = scan[::max(1, -(-len(scan) // args.points))]
    print(f"sparse lidar ({len(scan)} points):", flush=True)
    results["workloads"]["sparse_lidar_131k"] = compare(
        MapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
                  max_points=_max_points(len(scan))), scan,
        np.float32([0.0, 0.0, 1.7]), quantum, device)

    print("fallback sphere (2048 points):", flush=True)
    results["workloads"]["fallback_sphere_2048"] = compare(
        MapConfig(max_points=2048), sphere(2048, 5.0, 7),
        np.zeros(3, np.float32), quantum, device)

    ok = all(v.get("pass", True)
             for wl in results["workloads"].values() for v in wl.values())
    results["all_pass"] = bool(ok)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(results, fh, indent=1)
        print(f"wrote {out_path}", flush=True)
    print(json.dumps({"all_pass": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
