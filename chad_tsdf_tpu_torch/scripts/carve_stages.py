"""One sweep's carve by stage on the card, on the kernel route and on the
plain route.

    python3 -m chad_tsdf_tpu_torch.scripts.carve_stages \\
        [--reps 20] [--json carve_stages.json]

The scene is a parked HDL-64E's street, as the ``kitti_parked_carve`` cell
carves it, built from the port's own ``io/kitti.synthetic_lidar_scan`` (a
ground plane and box obstacles) with the cell's map configuration written
out here (``PARKED``: every 2nd ray carved 128 steps of 0.1 m out, a
32,768-block touched cap).  The map holds one sweep of the street of seed
0 from the kerb; the carved sweep is seed 3's from the same spot (119,631
points in the 131,072-point bucket, ~14,000 blocks carved), whose rays
cross the surfaces that seed 0's obstacles left, as a passing car's rays
do.  It is padded to its bucket and put through packed ingest's round
trip on the card, as the map's graph does.  The two routes are first held
bit for bit (keys and their count, both pool planes, the touched overflow
and the three metrics), under the configuration's touched cap and under
one too small for the carve, and the sorted keys and the digit counts
on their own.  Then the stages are timed (``cuda_ms``: CUDA events, median
of ``--reps`` calls, each queued behind a spin):

* kernel route: ``keys`` (``carve_keys``, with the sort's digit counts),
  ``sort`` (``carve_sort``), ``apply`` (``carve_apply``: count, scan,
  apply), ``whole`` (``carve_step``);
* plain route (the sequence every carve ran before the kernels):
  ``keys`` (``carve_keys_plain``), ``sort`` (``torch.sort`` of the int64
  keys), ``entries`` (``sorted_entries``), ``lookup`` (``lookup_blocks``),
  ``apply`` (``apply_entries`` and ``lost_samples``), ``whole``
  (``carve_step_plain``).

Each kernel's bound is bytes over 3.35 TB/s: ``carve_keys`` reads 12 B a
carve ray and writes 8 B a sample slot; ``carve_sort`` reads and writes 8
B a slot (the least any sort of the slots moves); ``carve_apply`` reads 8
B a valid sample (the sorted keys, once), 8 B a looked-up block (its
directory key and slot) and reads and writes the two pool words of each
carved voxel (16 B).  Prints the card's name and power limit, then a
JSON line.  No host read inside a timed call; the stage functions are
called directly, so nothing here adds to the code the map runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess

import numpy as np
import torch

from ..config import MapConfig
from ..core import carve, integrate
from ..core.state import clone_state
from ..io.kitti import synthetic_lidar_scan
from . import cuda_ms, require_cuda

HBM_BYTES_PER_S = 3.35e12
# the kitti_parked_carve cell's map configuration
PARKED = MapConfig(block_capacity=131072, touched_capacity=32768,
                   packed_ingest=True, carve_steps=128, carve_stride=2.0,
                   carve_subsample=2, carve_weight=1.0)
KERB = [0.0, -2.0, 0.0]   # the sensor's car parked at the kerb
MAP_SEED, CARVED_SEED = 0, 3
SMALL_CAP = 2048      # under a sweep's ~12,000-15,000 carved blocks


def sweep(seed: int):
    """(points f32[N, 3], scanner position f32[3]) of one sweep of the
    street ``seed`` from the kerb."""
    # the scan's sensor is 1.7 m above the ground
    return (synthetic_lidar_scan(KERB, seed=seed),
            np.float32(KERB) + np.float32([0.0, 0.0, 1.7]))


def device_cloud(pts: np.ndarray, pos: np.ndarray, config: MapConfig, dev):
    """What the map's graph hands the carve for ``pts``: the cloud padded
    to its bucket (zero rows), through packed ingest's round trip on the
    device where the configuration packs.  Returns (points, n, position),
    ``n`` an i32[] on the device, as the map's graph holds it."""
    n = len(pts)
    bucket = next(b for b in config.buckets if b >= n)
    pad = np.zeros((bucket, 3), np.float32)
    pad[:n] = pts
    p = torch.from_numpy(pad).to(dev)
    position = torch.from_numpy(np.float32(pos)).to(dev)
    if config.packed_ingest:
        p = integrate.unpack_points(integrate.pack_points_device(
            p, position, config.sdf_res), position, config)
    return p, torch.full((), n, dtype=torch.int32, device=dev), position


def scene(dev, config: MapConfig = PARKED):
    """(config, state, points, n, position): the map of sweep
    ``MAP_SEED`` and sweep ``CARVED_SEED`` to carve (module docstring)."""
    from ..core.map import TSDFMap
    m = TSDFMap(config=config, device=dev)
    m.insert(*sweep(MAP_SEED))
    return (config, m.state, *device_cloud(*sweep(CARVED_SEED), config,
                                           dev))


def hold(state, points, n, position, config: MapConfig) -> dict:
    """Carve on the kernel route and on the plain route, each on a copy of
    ``state``, and raise unless they agree bit for bit: the keys and their
    count (and on the card the digit counts), the sorted keys, both pool
    planes, ``touched_overflow`` and the metrics.  Returns the counts of
    the carve (ints)."""
    ob = state.origin_blocks
    key, nv, counts = carve.carve_keys(points, n, position, ob, config)
    pkey, pnv = carve.carve_keys_plain(points, n, position, ob, config)
    if not (torch.equal(key, pkey) and int(nv) == int(pnv)):
        bad = int((key != pkey).sum())
        raise AssertionError(f"carve_keys: {bad} keys differ, n_valid "
                             f"{int(nv)} against {int(pnv)}")
    if counts is not None and not torch.equal(
            counts, carve.digit_counts_plain(pkey, config)):
        raise AssertionError("carve_keys: digit counts differ from the "
                             "plain counts")
    skey = torch.sort(pkey).values
    got_sorted = carve.sort_keys(key, nv, counts, config)
    if not torch.equal(got_sorted, skey):
        bad = int((got_sorted != skey).sum())
        raise AssertionError(f"sort_keys: {bad} of {skey.numel()} slots "
                             f"differ from torch.sort")
    got, gm = carve.carve_step(clone_state(state), points, n, position,
                               config)
    want, wm = carve.carve_step_plain(clone_state(state), points, n,
                                      position, config)
    for f in ("pool_sd", "pool_w", "touched_overflow"):
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"carve: {f} differs in {bad} elements "
                                 f"from the plain route")
    gm = {k: int(v) for k, v in gm.items()}
    wm = {k: int(v) for k, v in wm.items()}
    if gm != wm:
        raise AssertionError(f"carve metrics {gm} against the plain "
                             f"route's {wm}")
    bkeys = skey[:int(pnv)] >> 32
    blocks = int(torch.unique_consecutive(bkeys).numel())
    return dict(gm, n_valid=int(nv), slots=key.numel(), blocks=blocks,
                touched_overflow=int(got.touched_overflow) -
                int(state.touched_overflow))


def bounds_ms(counts: dict, config: MapConfig, rays: int) -> dict:
    """Each kernel's least time on the H100 (module docstring)."""
    looked = min(counts["blocks"], config.touched_capacity)
    keys_b = 12 * rays + 8 * counts["slots"]
    sort_b = 16 * counts["slots"]
    apply_b = 8 * counts["n_valid"] + 8 * looked + \
        16 * counts["n_carved_voxels"]
    return {"carve_keys": keys_b / HBM_BYTES_PER_S * 1e3,
            "carve_sort": sort_b / HBM_BYTES_PER_S * 1e3,
            "carve_apply": apply_b / HBM_BYTES_PER_S * 1e3,
            "carve_keys_bytes": keys_b, "carve_sort_bytes": sort_b,
            "carve_apply_bytes": apply_b}


def stage_times(state, points, n, position, config: MapConfig,
                reps: int) -> dict:
    """Device ms of each stage on both routes (module docstring); the pool
    of ``state`` gains the carves the timing runs."""
    ob = state.origin_blocks
    key, nv, counts = carve.carve_keys(points, n, position, ob, config)
    skey = carve.sort_keys(key, nv, counts, config)
    e_b, e_o, e_c, e_end = carve.sorted_entries(skey)
    looked = carve.lookup_blocks(state, e_b, config)
    flags, _, found, slots, first_lost, _ = looked

    def plain_apply():
        carve.apply_entries(state, e_b, e_o, e_c, nv, flags, found, slots,
                            config)
        carve.lost_samples(e_end, nv, first_lost)

    kernel = {
        "keys": cuda_ms(lambda: carve.carve_keys(points, n, position, ob,
                                                 config), reps),
        "sort": cuda_ms(lambda: carve.sort_keys(key, nv, counts, config),
                        reps),
        "apply": cuda_ms(lambda: carve.carve_apply(state, skey, nv, config),
                         reps),
        "whole": cuda_ms(lambda: carve.carve_step(state, points, n,
                                                  position, config), reps),
    }
    plain = {
        "keys": cuda_ms(lambda: carve.carve_keys_plain(
            points, n, position, ob, config), reps),
        "sort": cuda_ms(lambda: torch.sort(key), reps),
        "entries": cuda_ms(lambda: carve.sorted_entries(skey), reps),
        "lookup": cuda_ms(lambda: carve.lookup_blocks(state, e_b, config),
                          reps),
        "apply": cuda_ms(plain_apply, reps),
        "whole": cuda_ms(lambda: carve.carve_step_plain(
            state, points, n, position, config), reps),
    }
    return {"kernel": kernel, "plain": plain}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    dev = require_cuda("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    cfg, state, points, n, position = scene(dev)
    out = {"seeds": [MAP_SEED, CARVED_SEED], "points": int(n),
           "bucket": points.shape[0]}
    for cap in (cfg.touched_capacity, SMALL_CAP):
        c = dataclasses.replace(cfg, touched_capacity=cap)
        counts = hold(state, points, n, position, c)
        if (counts["touched_overflow"] > 0) != (cap == SMALL_CAP):
            raise AssertionError(f"touched cap {cap}: overflow "
                                 f"{counts['touched_overflow']}")
        out[f"cap_{cap}"] = counts
        print(f"touched cap {cap}: kernel route bit-equal to the plain "
              f"route; {counts}", flush=True)
    counts = out[f"cap_{cfg.touched_capacity}"]
    out["bound_ms"] = bounds_ms(counts, cfg, -(-points.shape[0] //
                                               cfg.carve_subsample))
    out["ms"] = stage_times(state, points, n, position, cfg, args.reps)
    out["device"] = torch.cuda.get_device_name(dev)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
