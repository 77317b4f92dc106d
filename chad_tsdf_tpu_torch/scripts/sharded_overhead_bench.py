"""The sharded step's fixed cost at one shard, and the KITTI-shaped
stream's halo traffic — the port of the JAX package's
``scripts/sharded_overhead_bench.py``.

    python3 -m chad_tsdf_tpu_torch.scripts.sharded_overhead_bench    # card
    python3 -m chad_tsdf_tpu_torch.scripts.sharded_overhead_bench \\
        --device cpu --scans 2 --bucket 4096 --block-capacity 8192 \\
        --touched-capacity 4096

Three measurements on the packed ``seg`` stream of stationary scans
(``synthetic_lidar_scan`` from x = 0.15 i, seed i, all scanned from
(0, 0, 1.7), so no rotation; padded to ``--bucket`` and packed on the
host, as the JAX script feeds its step):

1. ``direct_ms``: the one-shard step of ``parallel.make_sharded_insert``,
   which is the single-device insert;
2. ``generic_ms``: the same scans through the many-shard code path forced
   at one shard (``force_generic``: scratch pool, row extract, routing,
   K3 merge); ``fixed_overhead_ms`` = generic - direct is F, the fixed
   cost each shard's step pays on top of the insert.  ``route_sent_n1``
   is the halo rows that step sent, 0 at one shard;
3. ``halo``: for N = 2..32 shards, the host-side count of each scan's
   touched blocks that land outside the shard that integrates them (the
   rows the exchange sends), under static (``key_bounds`` and
   ``morton_split``) and adaptive (``adaptive_bounds`` and
   ``owner_split``) ownership.

Times are the median over ``--rounds`` rounds of the mean ms a step, one
synchronisation a round, after a warm pass over the scans.  With
``--json`` the result goes to a file with the JAX script's keys, plus
``device`` (the card's ``nvidia-smi`` name and power limit, or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import MapConfig
from ..core import integrate
from ..core.state import origin_blocks_for_position
from ..io.kitti import synthetic_lidar_scan
from ..parallel.sharded import (adaptive_bounds, create_sharded_state,
                                key_bounds, make_mesh, make_sharded_insert,
                                morton_split, owner_split, point_block_keys)

POSITION = np.float32([0.0, 0.0, 1.7])
HALO_SHARDS = (2, 4, 8, 16, 32)


def device_name(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--bucket", type=int, default=1 << 17)
    ap.add_argument("--block-capacity", type=int, default=1 << 17)
    ap.add_argument("--touched-capacity", type=int, default=1 << 15)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=None)


def stream_config(args) -> MapConfig:
    """The JAX script's configuration: packed ``seg`` at one bucket."""
    return MapConfig(block_capacity=args.block_capacity,
                     touched_capacity=args.touched_capacity,
                     max_points=args.bucket, packed_ingest=True,
                     accumulate_impl="seg", point_buckets=())


def raw_scans(n_scans: int, bucket: int) -> list:
    """The stationary stream's scans, every k-th point where a scan
    outgrows ``bucket`` (the dry run's small bucket).  Scan 8 has no
    point, in the JAX script's stream too."""
    out = []
    for i in range(n_scans):
        pts = synthetic_lidar_scan([0.15 * i, 0.0, 0.0], seed=i)
        out.append(pts[::max(1, -(-len(pts) // bucket))][:bucket])
    return out


def packed_scans(raw: list, config: MapConfig) -> list:
    """[(i16[bucket, 3] packed scan, its point count)]."""
    out = []
    for pts in raw:
        padded = np.zeros((config.max_points, 3), np.float32)
        padded[:len(pts)] = pts
        out.append((integrate.pack_points(padded, POSITION, config.sdf_res),
                    len(pts)))
    return out


def timed_rounds(run_once, device: torch.device, rounds: int,
                 n_steps: int) -> float:
    """Median over ``rounds`` of the mean ms a step of ``run_once()`` (one
    pass over the scans), one synchronisation a round, after a warm
    pass."""
    run_once()
    sync(device)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_once()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3 / n_steps)
    return statistics.median(times)


def step_ms(config: MapConfig, device: torch.device, scans: list,
            force_generic: bool, rounds: int):
    """(ms a step, halo rows sent in the last step) of the one-shard
    sharded step over ``scans``."""
    mesh = make_mesh(1, device=device)
    step, _ = make_sharded_insert(config, mesh, force_generic=force_generic)
    origin = origin_blocks_for_position(POSITION, config)
    bounds = key_bounds(1, config)
    box = {"stack": create_sharded_state(config, mesh, origin)}

    def run_once():
        for q, n in scans:
            box["stack"], box["metrics"], tails = step(
                box["stack"], q, np.asarray([n], np.int32), POSITION, bounds)
            if any(t is not None for t in tails):
                raise RuntimeError("the seg step left a fallback")

    ms = timed_rounds(run_once, device, rounds, len(scans))
    return ms, int(box["metrics"]["route_sent"])


def halo_rows(raw: list, config: MapConfig) -> dict:
    """Remote and touched block rows per scan for N = 2..32, static and
    adaptive ownership (host numpy, the step's own mapping)."""
    origin = origin_blocks_for_position(POSITION, config)
    halo = {}
    for n_sh in HALO_SHARDS:
        row_sets = {}
        for scheme in ("static", "adaptive"):
            if scheme == "static":
                bounds = key_bounds(n_sh, config)
                chunks = [morton_split(pts, n_sh, config.sdf_res)
                          for pts in raw]
            else:
                bounds = adaptive_bounds(raw[0], origin, n_sh, config)
                chunks = [owner_split(pts, bounds, origin, config)
                          for pts in raw]
            rows = []
            for split in chunks:
                remote = touched = 0
                for me, c in enumerate(split):
                    if not len(c):
                        continue
                    uk = np.unique(point_block_keys(c, origin, config))
                    touched += len(uk)
                    owner = np.searchsorted(bounds, uk, side="right") - 1
                    remote += int((owner != me).sum())
                rows.append((remote, touched))
            r = np.asarray(rows, np.float64)
            row_sets[scheme] = {
                "remote_rows_per_scan": float(r[:, 0].mean()),
                "touched_rows_per_scan": float(r[:, 1].mean()),
                "remote_fraction": float(r[:, 0].sum() /
                                         max(r[:, 1].sum(), 1.0)),
            }
        halo[str(n_sh)] = row_sets
    return halo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = device_name(device)
    print(card, flush=True)
    config = stream_config(args)
    raw = raw_scans(args.scans, args.bucket)
    scans = packed_scans(raw, config)
    out = {"backend": device.type, "device": card,
           "n_points_per_scan": len(raw[0])}
    for name, force in (("direct_ms", False), ("generic_ms", True)):
        ms, sent = step_ms(config, device, scans, force, args.rounds)
        out[name] = ms
        if force:
            out["route_sent_n1"] = sent
        print(f"{name}: {ms:.3f} ms/step ({card})", flush=True)
    out["fixed_overhead_ms"] = out["generic_ms"] - out["direct_ms"]
    out["halo"] = halo_rows(raw, config)
    for n_sh, row_sets in out["halo"].items():
        print(f"N={n_sh}: {json.dumps(row_sets)}", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
