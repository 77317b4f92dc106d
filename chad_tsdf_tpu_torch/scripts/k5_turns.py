"""K5 (segment accumulate) of an older ``csrc/`` against this checkout's,
in turns, on one card.

    mkdir -p _unpacked/old
    git archive 51ee14f chad_tsdf_tpu_torch/csrc | tar -x -C _unpacked/old
    python3 -m chad_tsdf_tpu_torch.scripts.k5_turns \\
        --old-csrc _unpacked/old/chad_tsdf_tpu_torch/csrc

The older sources are built with this checkout's nvcc flags into their own
directory and called through the first design's C entry
``chad_accumulate_segments`` (one CTA per member).  Inputs: K5's tables on
the ``pallas`` backend at the default MapConfig for one insert, from the
origin into a fresh map, of the 2^20-point r = 5 m sphere (bench.py's
cloud), of the dense-voxel cloud (64 voxels x 16,384 points) and of the
single-voxel cloud (2^20 points in one voxel).  Old and new are first held
against each other and the plain version (both planes bit for bit), then
timed old, new, new, old (``cuda_ms``: median of 20 calls, device time
only); then the chunk list alone (``plan_ms``, K5's first phase).
Prints the card's name and power limit, then a JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from .. import kernels
from ..config import MapConfig
from ..ops import accumulate
from ..profile_insert import k5_clouds, k5_inputs
from . import cuda_ms, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_library(csrc: str) -> ctypes.CDLL:
    path, _ = kernels.build_library(
        csrc, os.path.join(kernels.BUILD_DIR, "old"))
    lib = ctypes.CDLL(path)
    lib.chad_accumulate_segments.argtypes = [_P] * 6 + [_I] * 2 + [_F, _P]
    lib.chad_accumulate_segments.restype = _I
    return lib


def turns(old, new, reps):
    """old, new, new, old; returns both medians of each."""
    t = [cuda_ms(old, reps), cuda_ms(new, reps), cuda_ms(new, reps),
         cuda_ms(old, reps)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


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
    _, dscale = accumulate.sd_scales(cfg.sdf_trunc)
    p = kernels.ptr
    out = {}
    for name, pts_np in k5_clouds(cfg).items():
        pools, tables, payload, stats = k5_inputs(pts_np, cfg, dev)
        cb, t = pools[0].shape[0], tables[0].shape[0]
        targs = (*tables, payload, cfg.sdf_trunc)
        a = (pools[0].clone(), pools[1].clone())

        def old():
            err = lib.chad_accumulate_segments(
                p(a[0]), p(a[1]), *(p(x) for x in tables), p(payload), t,
                cb - 1, dscale, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"old K5 failed with CUDA error {err}")

        def new():
            accumulate.accumulate_segments(*pools, *targs)

        ref = (pools[0].clone(), pools[1].clone())
        accumulate.accumulate_segments_plain(*ref, *targs)
        old()
        new()
        if accumulate.overflowed(dev):
            raise AssertionError(f"K5 {name}: chunk list overflowed")
        for x, y in ((a, ref), (pools, ref)):
            if not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])):
                raise AssertionError(f"K5 {name}: old or new differs from "
                                     f"the plain version")
        r = dict(stats, **turns(old, new, args.reps))
        if accumulate.overflowed(dev):
            raise AssertionError(f"K5 {name}: chunk list overflowed")
        # the chunk list alone: the first phase of every K5 call
        cap, rows = accumulate._chunk_sizes(t, payload.numel(),
                                            accumulate.CHUNK)
        ws = torch.empty(accumulate._HEAD + 2 * cap + t + rows,
                         dtype=torch.int32, device=dev)
        r["plan_ms"] = cuda_ms(lambda: kernels.launch(
            "plan_chunks", p(tables[1]), p(tables[2]), t, cb - 1, cap, rows,
            p(ws)), args.reps)
        out[name] = r
        print(f"K5 {name}: {r}", flush=True)
        del pools, tables, payload, a, ref, ws
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
