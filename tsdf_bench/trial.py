"""Runs of a cell of ``BENCHMARK.json`` under overrides from a file: a
configuration or traffic that no cell holds yet, judged by the cell's own
check.  Several seeds run in one process, one after another.

    python3 -m tsdf_bench.trial --workload kitti_parked \\
        --overrides tsdf_bench/trials/kitti_parked_carve.json \\
        --seeds 11 12 13 --seconds 30 --trace 0

The overrides file holds what ``run.cell_spec`` takes: keys of the
configuration file (``map_config``, ``sensor``, ``world``, ...) and of the
workload file (``generator``, ``params``, ...).  Per seed one JSON line:
the run's result (``run.run_cell``'s object; its ``setup_s`` counts from
the process's start, so only the first seed's is a set-up), the seconds
from the window's close to the result (reading the outputs back, freeing
the map, the reference), and, in a carving map, the distinct blocks of one
insert's carve samples per template: what ``touched_capacity`` has to hold
for the carve to drop nothing.  Where JAX or the JAX package is loaded
after a run, the process prints nothing more and exits with 3.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run
from .reference import tsdf_ref as R


def carve_blocks(name: str, seed: int, overrides: dict,
                 device: str = "cuda") -> dict:
    """Per template of the cell's traffic: the distinct blocks of one
    insert's carve samples, with the stream's first position as the
    submap's (a parked stream has one submap); empty without carving."""
    _, _, cell, conf = run.cell_spec(name, overrides)
    sem = R.Semantics.from_map_config(conf["map_config"])
    if sem.carve_steps == 0:
        return {}
    traffic = run.traffic_of(cell, conf, seed)
    first = traffic.position(0)
    out = {}
    for k in range(len(traffic.templates)):
        keys, _ = R.carve_samples(traffic.points(k), traffic.position(k),
                                  first, sem, device)
        out[str(k)] = int(torch.unique(R.block_keys(keys)).shape[0])
    return out


def trial(name: str, seed: int, seconds: float, trace: bool,
          overrides: dict, device: str = "cuda") -> dict:
    """One run of cell ``name`` under ``overrides``."""
    out, rec = run.run_record(name, seed, seconds, trace, device, overrides)
    check_s = time.perf_counter() - run.T_START - rec.setup_s - rec.window_s
    return {"workload": name, "seed": seed, "result": out,
            "check_s": check_s,
            "carve_blocks": carve_blocks(name, seed, overrides, device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--overrides", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None,
                    help="also append each line to this file")
    args = ap.parse_args(argv)
    overrides = run.load_json(args.overrides)
    for seed in args.seeds:
        line = json.dumps(trial(args.workload, seed, args.seconds,
                                bool(args.trace), overrides))
        bad = run.loaded_forbidden()
        if bad:
            print(f"loaded in this process: {bad}", file=sys.stderr)
            return 3
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
