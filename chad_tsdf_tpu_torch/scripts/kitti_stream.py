"""KITTI-shaped streaming benchmark of the port — bench.py's
``_kitti_shaped_stream`` on ``chad_tsdf_tpu_torch``.

    python3 -m chad_tsdf_tpu_torch.scripts.kitti_stream            # on a card
    python3 -m chad_tsdf_tpu_torch.scripts.kitti_stream \\
        --sparse-impl sample_tile
    python3 -m chad_tsdf_tpu_torch.scripts.kitti_stream --sweep    # on a card
    python3 -m chad_tsdf_tpu_torch.scripts.kitti_stream --device cpu --scans 3

Twelve synthetic ~120k-point LiDAR scans (``io/kitti.py``
``synthetic_lidar_scan``, seed = scan index) 1.5 m apart go through
``TSDFMap.insert`` at ``MapConfig(block_capacity=1 << 16,
touched_capacity=1 << 15, packed_ingest=True)``: bucketed insert, density
dispatch (``seg`` on CUDA), packed ingest, and a submap rotation after every
5 m of travel.  A warm pass over the whole stream and ``stats()`` come
first; then a fresh map takes scan 0, the stream is synchronised, and scans
1..11 are timed up to a second synchronisation.  The last line is a JSON
object with bench.py's three keys: ``kitti_scans_per_sec``,
``kitti_points_per_sec`` and ``kitti_tile_overflow``.

On the card each scan is one replay of the map's CUDA graph
(``core/graph.py``); the first scan of a map runs eagerly and captures it.
``--sparse-impl`` picks what sparse scans are dispatched to (``seg``,
``sample_tile``, ``pallas``, ``fused``, ...).  On the CPU no dispatch
happens (as in the JAX package off the TPU), so ``--device cpu`` times the
``xla`` backend unless ``--accumulate-impl`` says otherwise; its rates are
not device numbers.

``--sweep`` measures the timed region (no warm pass) at every
``sparse_impl`` of :data:`SPARSE_IMPLS` and every density threshold
``sparse_points_per_block`` of :data:`THRESHOLDS`, in turns: ``--rounds``
rounds, each running every setting once in the same order, after a first
round that warms each.  It prints one JSON line per setting (median
scans/s, every round's, and which backend each scan was dispatched to),
then one JSON object of the medians.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import MapConfig
from ..core.map import TSDFMap
from ..io.kitti import synthetic_lidar_scan

N_SCANS = 12
SPACING_M = 1.5
SPARSE_IMPLS = ("seg", "sample_tile", "pallas", "fused")
THRESHOLDS = (16.0, 32.0, 64.0, 128.0, 256.0)


def stream_config(**overrides) -> MapConfig:
    """bench.py's streaming configuration: a block pool sized for one 5 m
    KITTI-shaped submap, a touched capacity sized for one scan's block set,
    and packed ingest."""
    return dataclasses.replace(
        MapConfig(block_capacity=1 << 16, touched_capacity=1 << 15,
                  packed_ingest=True), **overrides)


def make_scans(n_scans: int = N_SCANS):
    """[(points f32[N, 3], scanner position f32[3])]: scan i from x = 1.5 i
    metres, seed i."""
    return [(synthetic_lidar_scan([SPACING_M * i, 0.0, 0.0], seed=i),
             np.float32([SPACING_M * i, 0.0, 1.7])) for i in range(n_scans)]


def expected_rotations(scans, config: MapConfig) -> int:
    """Rotations the policy of ``TSDFMap.insert`` makes over ``scans``: a
    new submap whenever a scan lies more than ``submap_distance`` from the
    first scan of the active one."""
    first, n = None, 0
    for _, pos in scans:
        if first is not None and \
                np.linalg.norm(pos - first) > config.submap_distance:
            first, n = None, n + 1
        if first is None:
            first = pos
    return n


def wait(m: TSDFMap) -> None:
    """Block until every insert queued on the map's device is done (a read
    of one pool element, as bench.py does)."""
    float(m.state.pool_sd[0, 0])


@contextlib.contextmanager
def count_host_reads():
    """Count the calls that read a tensor on the host (``item``, ``cpu``,
    ``tolist``, ``numpy``, ``nonzero``, ``bool()``, ``int()``, ``float()``,
    ``operator.index``) while the context is open; yields the dict of
    counts by name."""
    counts: dict = {}
    names = ("item", "cpu", "tolist", "numpy", "nonzero", "__bool__",
             "__int__", "__float__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    saved_nonzero = torch.nonzero

    def counting(name, fn):
        def wrapper(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for n, fn in saved.items():
        setattr(torch.Tensor, n, counting(n, fn))
    torch.nonzero = counting("torch.nonzero", saved_nonzero)
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        torch.nonzero = saved_nonzero


def timed_stream(scans, config: MapConfig, device="cuda", graphs=True):
    """The timed region of bench.py: scan 0 into a fresh map, synchronise,
    scans 1.. timed to a second synchronisation (``graphs=False``: the
    eager insert on the card too).  Returns (map, seconds, points,
    per-insert metrics, host reads counted in the timed inserts)."""
    m = TSDFMap(config=config, device=device)
    m.graphs_enabled = graphs
    m.insert(*scans[0])
    wait(m)
    metrics = []
    total_pts = 0
    with count_host_reads() as reads:
        t0 = time.perf_counter()
        for pts, pos in scans[1:]:
            metrics.append(m.insert(pts, pos))
            total_pts += len(pts)
    wait(m)
    dt = time.perf_counter() - t0
    return m, dt, total_pts, metrics, reads


def sweep(scans, device="cuda", rounds: int = 3, impls=SPARSE_IMPLS,
          thresholds=THRESHOLDS, log=print) -> dict:
    """The timed region at every (``sparse_impl``, ``sparse_points_per_
    block``) setting, in turns (module docstring).  Returns {setting:
    {"scans_per_s": median, "rounds": [...], "dispatched": {backend:
    scans}}} with settings named ``"<impl>@<threshold>"``."""
    settings = {f"{impl}@{thr:g}": stream_config(
        sparse_impl=impl, sparse_points_per_block=thr)
        for thr in thresholds for impl in impls}
    out = {name: {"rounds": []} for name in settings}
    for rnd in range(rounds + 1):
        for name, cfg in settings.items():
            m, dt, _, _, _ = timed_stream(scans, cfg, device)
            if rnd == 0:
                disp: dict = {}
                for pts, _ in scans:
                    impl = m._dispatch_config(pts).accumulate_impl
                    disp[impl] = disp.get(impl, 0) + 1
                out[name]["dispatched"] = disp
            else:
                out[name]["rounds"].append(round((len(scans) - 1) / dt, 2))
            del m
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    for name, r in out.items():
        r["scans_per_s"] = float(np.median(r["rounds"]))
        log(json.dumps({"setting": name, **r}))
    return out


def kitti_shaped_stream(n_scans: int = N_SCANS, device="cuda",
                        config: MapConfig | None = None) -> dict:
    """bench.py's ``_kitti_shaped_stream`` on the port; returns its three
    keys."""
    config = stream_config() if config is None else config
    scans = make_scans(n_scans)

    # warm pass over the whole stream, rotations and drain included: the
    # first calls allocate and build what the timed region reuses
    m = TSDFMap(config=config, device=device)
    for pts, pos in scans:
        m.insert(pts, pos)
    m.stats()                       # drain pending finalizes + sync
    del m

    m, dt, total_pts, _, _ = timed_stream(scans, config, device)
    scans_per_s = (len(scans) - 1) / dt
    tile_ovf = int(m.state.tile_overflow)
    print(f"kitti-shaped: {scans_per_s:.1f} scans/s, "
          f"{total_pts / dt / 1e6:.2f} M pts/s, "
          f"tile_overflow={tile_ovf}, submaps={m.n_submaps}",
          file=sys.stderr)
    return {"kitti_scans_per_sec": round(scans_per_s, 2),
            "kitti_points_per_sec": round(total_pts / dt),
            "kitti_tile_overflow": tile_ovf}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=N_SCANS)
    impls = ("seg", "sample_tile", "pallas", "fused", "tile", "xla")
    ap.add_argument("--sparse-impl", default=None, choices=impls)
    ap.add_argument("--accumulate-impl", default=None,
                    choices=("auto",) + impls)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("sparse_impl", args.sparse_impl),
                                   ("accumulate_impl", args.accumulate_impl))
                 if v is not None}
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    if args.sweep:
        res = sweep(make_scans(args.scans), args.device, args.rounds)
        print(json.dumps({k: v["scans_per_s"] for k, v in res.items()}))
        return 0
    print(json.dumps(kitti_shaped_stream(
        args.scans, args.device, stream_config(**overrides))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
