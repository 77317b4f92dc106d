"""``ShardedTSDFMap``'s KITTI-shaped stream at one shard — the port of the
JAX package's ``scripts/sharded_kitti_bench.py``.

    python3 -m chad_tsdf_tpu_torch.scripts.sharded_kitti_bench       # card
    python3 -m chad_tsdf_tpu_torch.scripts.sharded_kitti_bench \\
        --device cpu --scans 2 --bucket 4096 --block-capacity 8192

``--shards`` shards (one by default: ``make_mesh(1)``, the sharded path's
overhead on one card) take bench.py's stream (``scripts/kitti_stream``:
scans 1.5 m apart, seed i; every k-th point where a scan outgrows
``--bucket``) at the JAX script's ``MapConfig(block_capacity=1 << 16,
touched_capacity=1 << 15, max_points=1 << 17, packed_ingest=True)``.  A
warm pass over the stream and ``stats()`` come first; then a fresh map
takes scan 0, the device is synchronised, and scans 1.. are timed to a
second synchronisation.  The JSON line has the JAX script's keys, plus
``device`` (the card's name and power limit, or ``cpu``); ``--json``
writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import MapConfig
from ..io.kitti import synthetic_lidar_scan
from ..parallel import ShardedTSDFMap, make_mesh
from .sharded_overhead_bench import device_name, sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--bucket", type=int, default=1 << 17)
    ap.add_argument("--block-capacity", type=int, default=1 << 16)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = device_name(device)
    print(card, flush=True)
    config = MapConfig(block_capacity=args.block_capacity,
                       touched_capacity=1 << 15, max_points=args.bucket,
                       packed_ingest=True)
    scans = []
    for i in range(args.scans):
        pts = synthetic_lidar_scan([1.5 * i, 0.0, 0.0], seed=i)
        step = max(1, -(-len(pts) // args.bucket))
        scans.append((pts[::step][:args.bucket],
                      np.float32([1.5 * i, 0.0, 1.7])))

    def new_map():
        return ShardedTSDFMap(config=config,
                              mesh=make_mesh(args.shards, device=device))

    m = new_map()                       # warm pass: builds and allocates
    for pts, pos in scans:
        m.insert(pts, pos)
    m.stats()
    del m

    m = new_map()
    m.insert(*scans[0])
    sync(device)
    t0 = time.perf_counter()
    total = 0
    for pts, pos in scans[1:]:
        m.insert(pts, pos)
        total += len(pts)
    sync(device)
    dt = time.perf_counter() - t0
    out = {"backend": device.type, "device": card,
           "n_devices": args.shards,
           "scans_per_sec": (len(scans) - 1) / dt,
           "points_per_sec": total / dt,
           "route_overflow": int(m.last_metrics.get("route_overflow", 0)),
           "n_submaps": m.n_submaps}
    print(f"{out['scans_per_sec']:.3f} scans/s at {args.shards} shard(s) "
          f"({card})", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
