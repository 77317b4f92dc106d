"""M3 (the one-hot contraction) of an older ``csrc/`` against this
checkout's, in turns, and this checkout's M3 split by phase, on one card.

    mkdir -p _unpacked/old
    git archive d8af7df chad_tsdf_tpu_torch/csrc | tar -x -C _unpacked/old
    python3 -m chad_tsdf_tpu_torch.scripts.m3_turns \\
        --old-csrc _unpacked/old/chad_tsdf_tpu_torch/csrc

The older sources are built with this checkout's nvcc flags into their
own directory and called through the C entry of that design,
``chad_micro_mxu8`` without the wgmma count (at d8af7df: the dense 512-row
one-hot on ``mma.sync``).  Inputs: the script's (K = 10, N = 2^20,
NB = 40).  Per precision, old and new are first held against the plain
version (equal), then timed old, new, new, old, old, new (``cuda_ms``:
median of ``--reps`` calls, device time only).  Without ``--old-csrc``
only the phases run.  Prints the card's name and power limit, then a JSON
line.

Phases: three copies of ``csrc/`` in which M3 (``micro_mxu8_kernel``)
leaves one part out: ``sort`` returns once the tile is staged and
bucketed; ``no_stores`` runs every wgmma but writes no sum (a compare
keeps the sums live); ``no_mma`` writes and clears every chunk and stores
the sums, but issues no wgmma.  Each is timed beside the whole kernel, in
both precisions, at the script's inputs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess

import torch

from .. import kernels
from . import cuda_ms, micro_mxu8, require_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int


def old_library(csrc: str) -> ctypes.CDLL:
    path, _ = kernels.build_library(
        csrc, os.path.join(kernels.BUILD_DIR, "old"))
    lib = ctypes.CDLL(path)
    lib.chad_micro_mxu8.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 3
    lib.chad_micro_mxu8.restype = _I
    return lib


# micro.cu's text at each cut -> what replaces it
_WGMMA = ("          wgmma_ss(acc, da + ((2 * st * kM3GroupRows * 16) >> 4),\n"
          "                   db + ((2 * st * N * 16) >> 4));\n")
_CUTS = {
    "sort": [("  // the chunk buffers (over the staged words) start zero; a "
              "chunk's\n",
              "  if (tid == 0 && steps_out != nullptr)\n"
              "    steps_out[tile] = (int)sorted[gstart[7]] + gkept[7];\n"
              "  return;\n")],
    "no_stores": [("        out[((size_t)tile * nb + b) * kRowLen + "
                   "g * kM3GroupRows + row +\n"
                   "            8 * (e >> 1)] = (float)acc[4 * j + e];\n",
                   "        if (acc[4 * j + e] == (Acc)-7) out[b] = 1.0f;\n")],
    "no_mma": [(_WGMMA, "          acc[0] += (Acc)(da == db);\n")],
}


def cut_source(text: str, phase: str) -> str:
    """micro.cu with ``phase``'s cut: the text at each cut is replaced (the
    ``sort`` cut is inserted before it, leaving the rest unreachable)."""
    for anchor, repl in _CUTS[phase]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"micro.cu no longer has the one place the "
                               f"{phase!r} cut expects: {anchor!r}")
        text = text.replace(anchor, repl + anchor if phase == "sort"
                            else repl)
    return text


def cut_library(phase: str) -> ctypes.CDLL:
    d = os.path.join(kernels.BUILD_DIR, f"m3_{phase}")
    src = os.path.join(d, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    path = os.path.join(src, "micro.cu")
    with open(path) as fh:
        text = cut_source(fh.read(), phase)
    with open(path, "w") as fh:
        fh.write(text)
    lib = ctypes.CDLL(kernels.build_library(src, d)[0])
    lib.chad_micro_mxu8.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 3
    lib.chad_micro_mxu8.restype = _I
    return lib


def phases(a, reps: int) -> dict:
    m3 = micro_mxu8
    with concurrent.futures.ThreadPoolExecutor(len(_CUTS)) as ex:
        libs = dict(zip(_CUTS, ex.map(cut_library, _CUTS)))
    k, n = a[0].shape
    t = n // m3.TILE
    o_sd = torch.empty((t * m3.NB, m3.OFFSETS), dtype=torch.float32,
                       device=a[0].device)
    o_w = torch.empty_like(o_sd)
    steps = torch.empty(t, dtype=torch.int32, device=a[0].device)
    p = kernels.ptr
    out = {}
    for prec in m3.PRECISIONS:
        def cut(lib):
            def call():
                err = lib.chad_micro_mxu8(
                    *(p(x) for x in a), n, k, m3.NB, int(prec == "int8"),
                    p(o_sd), p(o_w), p(steps),
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"M3 cut failed: CUDA error {err}")
            return call

        r = {ph: cuda_ms(cut(lib), reps) for ph, lib in libs.items()}
        r["whole"] = cuda_ms(lambda: m3.contract(*a, m3.NB, prec), reps)
        out[prec] = r
        print(f"M3 {prec} by phase: {r}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = require_cuda("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    m3 = micro_mxu8
    a = [torch.from_numpy(x).to(dev) for x in m3.inputs()]
    k, n = a[0].shape
    t = n // m3.TILE
    out = {"phases": phases(a, args.reps)}
    if args.old_csrc is None:
        print(json.dumps(out))
        return 0
    lib = old_library(args.old_csrc)
    ref = m3.contract_plain(*a, m3.NB)
    p = kernels.ptr
    for prec in m3.PRECISIONS:
        o_sd = torch.empty((t * m3.NB, m3.OFFSETS), dtype=torch.float32,
                           device=dev)
        o_w = torch.empty_like(o_sd)

        def old():
            err = lib.chad_micro_mxu8(
                *(p(x) for x in a), n, k, m3.NB, int(prec == "int8"),
                p(o_sd), p(o_w), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"old M3 failed with CUDA error {err}")

        def new():
            return m3.contract(*a, m3.NB, prec)

        old()
        got = new()
        for name, x, y in (("old psd", o_sd, ref[0]), ("old pw", o_w, ref[1]),
                           ("new psd", got[0], ref[0]),
                           ("new pw", got[1], ref[1])):
            if not torch.equal(x, y):
                raise AssertionError(f"M3 {prec}: {name} differs from the "
                                     f"plain version")
        order = ("old", "new", "new", "old", "old", "new")
        fns = {"old": old, "new": new}
        times = {"old_ms": [], "new_ms": []}
        for who in order:
            times[f"{who}_ms"].append(cuda_ms(fns[who], args.reps))
        out[prec] = times
        print(f"M3 {prec}: {times}", flush=True)
        del o_sd, o_w, got
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
