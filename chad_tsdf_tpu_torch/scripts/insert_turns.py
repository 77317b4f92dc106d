"""Dense-insert times of several checkouts of the port, in turns, on one
card.

    mkdir -p _unpacked/parent
    git archive <commit> chad_tsdf_tpu_torch | tar -x -C _unpacked/parent
    python3 -m chad_tsdf_tpu_torch.scripts.insert_turns \\
        --roots _unpacked/parent . . _unpacked/parent

Each root is a directory that holds a ``chad_tsdf_tpu_torch`` package.  For
each root, in the order given, one process imports the package from there
(building its kernels into that package's ``_build/``), makes a
``TSDFMap(0.05, 0.1)`` per backend and inserts bench.py's 2^20-point
r = 5 m sphere (seed 420) from the origin: two warm-up inserts, then
``--reps`` inserts each followed by ``torch.cuda.synchronize()`` (the host
clock around each, as ``chip_smoke.py`` phase 3 times them), then a read of
``m.state`` that settles what an insert may have left.  It uses only the
API every slice of the port has.  Prints the card's name and power limit,
one JSON line per process, then a JSON line of the medians by root.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from . import require_cuda

# run in a fresh process with the root first on sys.path
_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
import chad_tsdf_tpu_torch
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
reps, impls = int(sys.argv[1]), sys.argv[2].split(",")
rng = np.random.default_rng(420)
d = rng.uniform(-1.0, 1.0, (1 << 20, 3))
d /= np.linalg.norm(d, axis=1, keepdims=True)
pts = (d * 5.0).astype(np.float32)
origin = np.zeros(3, np.float32)
out = {"package": chad_tsdf_tpu_torch.__file__}
for impl in impls:
    m = TSDFMap(0.05, 0.1, config=MapConfig(accumulate_impl=impl),
                device="cuda")
    for _ in range(2):
        m.insert(pts, origin)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m.insert(pts, origin)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    m.state
    out[impl] = {"median_ms": statistics.median(ms), "ms": ms}
    del m
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def run_root(root: str, reps: int, impls: str) -> dict:
    # from the root itself: ``-c`` puts the working directory first on
    # sys.path, ahead of PYTHONPATH
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(reps), impls],
                          env=env, cwd=root, capture_output=True, text=True,
                          timeout=900, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--impls", default="fused,tile,pallas")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    medians: dict = {}
    for root in args.roots:
        r = run_root(root, args.reps, args.impls)
        r["root"] = root
        print(json.dumps(r), flush=True)
        for impl in args.impls.split(","):
            medians.setdefault(root, {}).setdefault(impl, []).append(
                round(r[impl]["median_ms"], 3))
    print(json.dumps({"medians_ms_by_root": medians,
                      "median_of_medians_ms": {
                          root: {k: statistics.median(v)
                                 for k, v in by.items()}
                          for root, by in medians.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
