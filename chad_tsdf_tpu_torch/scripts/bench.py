"""bench.py on the port: TSDF integrate throughput on the canonical
workload, and the KITTI-shaped stream.

    python3 -m chad_tsdf_tpu_torch.scripts.bench               # on a card
    python3 -m chad_tsdf_tpu_torch.scripts.bench --device cpu --points 4096 \\
        --reps 2 --rounds 1 --scans 2

The dense metric follows bench.py:37-118: bench.py's 2^20-point r = 5 m
sphere (seed 420) at ``MapConfig(max_points=2^20)``; one insert to warm
up, three more as a re-warm, a synchronisation (a read of one pool
element, as bench.py's ``sync``); then ``core.integrate.insert_steps_scan``
once untimed (it captures its CUDA graph) and ``--rounds`` rounds of
``--reps`` inserts through it, one synchronisation per round; the median
round over ``reps`` is the amortized insert.  Then the median of 5 single
inserts, each synchronised.  For comparison in the same process, the same
rounds through a Python loop of ``insert_step`` (the eager loop) are timed
too and printed on a line before the JSON.  The second metric is
``scripts/kitti_stream.kitti_shaped_stream`` (``--scans`` scans).

The last line is bench.py's JSON object: ``metric``, ``value``, ``unit``,
``vs_baseline`` (against 50e6 points/s, bench.py's north star),
``kitti_scans_per_sec``, ``kitti_points_per_sec`` and
``kitti_tile_overflow``, plus ``device``: the card's name, or ``cpu``,
whose figures are not device numbers.  On a card the line before the
first prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import MapConfig
from ..core import integrate
from ..core.state import create_state, origin_blocks_for_position
from ..profile_insert import sphere
from .kitti_stream import kitti_shaped_stream

BASELINE_POINTS_PER_SEC = 50e6


def dense_metric(n_points: int, device: torch.device, reps: int,
                 rounds: int) -> dict:
    """Seconds per insert: ``amortized`` (the median round through
    ``insert_steps_scan``), ``eager`` (the same rounds as a loop of
    ``insert_step``) and ``single`` (median of 5 synchronised inserts), each
    with its rounds."""
    config = MapConfig(max_points=n_points)
    points = torch.from_numpy(sphere(n_points, 5.0, 420)).to(device)
    position = torch.zeros(3, dtype=torch.float32, device=device)
    state = create_state(config, origin_blocks_for_position(
        np.zeros(3, np.float32), config), device)

    def sync():
        float(state.pool_sd[0, 0])

    state, metrics = integrate.insert_step(state, points, n_points,
                                           position, config)
    print("warmup:", {k: int(v) for k, v in metrics.items()},
          file=sys.stderr)
    for _ in range(3):
        state, metrics = integrate.insert_step(state, points, n_points,
                                               position, config)
    sync()

    state = integrate.insert_steps_scan(state, points, n_points, position,
                                        config, reps)   # capture + warm
    sync()
    out = {"amortized_rounds": [], "eager_rounds": [], "single_runs": []}
    for _ in range(rounds):
        t0 = time.perf_counter()
        state = integrate.insert_steps_scan(state, points, n_points,
                                            position, config, reps)
        sync()
        out["amortized_rounds"].append((time.perf_counter() - t0) / reps)
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = integrate.insert_step(state, points, n_points,
                                             position, config)
        sync()
        out["eager_rounds"].append((time.perf_counter() - t0) / reps)
    for _ in range(5):
        t0 = time.perf_counter()
        state, _ = integrate.insert_step(state, points, n_points, position,
                                         config)
        sync()
        out["single_runs"].append(time.perf_counter() - t0)
    for k in ("amortized", "eager", "single"):
        out[k] = statistics.median(out[k + ("_runs" if k == "single"
                                            else "_rounds")])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--scans", type=int, default=12)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but torch.cuda.is_available() "
                             "is false; pass --device cpu")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu"

    d = dense_metric(args.points, device, args.reps, args.rounds)
    pts_per_sec = args.points / d["amortized"]
    ms = {k: [round(x * 1e3, 3) for x in d[k]]
          for k in ("amortized_rounds", "eager_rounds", "single_runs")}
    print(f"amortized: {d['amortized'] * 1e3:.3f} ms/insert over "
          f"{args.rounds}x{args.reps} through insert_steps_scan -> "
          f"{pts_per_sec / 1e6:.2f} M points/s (rounds: "
          f"{ms['amortized_rounds']})", file=sys.stderr)
    print(f"per-insert-synced: {d['single'] * 1e3:.3f} ms "
          f"(runs: {ms['single_runs']})", file=sys.stderr)
    print(f"eager loop: {d['eager'] * 1e3:.3f} ms/insert over "
          f"{args.rounds}x{args.reps} insert_step calls -> "
          f"{args.points / d['eager'] / 1e6:.2f} M points/s (rounds: "
          f"{ms['eager_rounds']}); insert_steps_scan "
          f"{d['amortized'] * 1e3:.3f}, synced single "
          f"{d['single'] * 1e3:.3f} ms", flush=True)

    # ---- secondary metric: bench.py's KITTI-shaped stream ----
    extra = {}
    try:
        extra = kitti_shaped_stream(args.scans, device)
    except Exception as e:  # bench.py: never jeopardize the primary metric
        print(f"kitti-shaped bench failed: {e!r}", file=sys.stderr)

    print(json.dumps({
        "metric": "tsdf_integrate_points_per_sec",
        "value": round(pts_per_sec),
        "unit": "points/s",
        "vs_baseline": round(pts_per_sec / BASELINE_POINTS_PER_SEC, 4),
        **extra,
        "device": name,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
