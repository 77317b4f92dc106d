"""Microbenchmark M2: per-tile block list + stacked accumulate — PyTorch /
CUDA port of ``scripts/micro_tile_accum.py``.

For each tile of S = 8192 samples laid out as (ROWS, C) = (8, 1024): the
list of the NB = 32 smallest distinct block keys (K1/K4's list phase), each
sample's rank in it (count form: # list[1:] <= key; a sample beyond the
list lands in row NB - 1, as in the TPU kernel), and the (NB, 512) partial
rows of sd sums and counts, every row written.  One CTA of 512 threads per
tile (kernel ``csrc/micro.cu``, launch name ``micro_tile_accum``); sd is
summed on the SD_QUANT grid over [-SD_RANGE, SD_RANGE] as K1/K4 sum it (the
TPU script summed bf16 on the MXU).

Run on the card::

    python3 -m chad_tsdf_tpu_torch.scripts.micro_tile_accum
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import kernels
from ..ops import tile_accum
from . import cuda_ms, max_abs_err, require_cuda

S = 8192          # samples per tile
ROWS = 8          # rows per tile
C = S // ROWS     # columns per row (two per thread of the CTA)
NB = 32           # block-list capacity per tile
NTILES = 1024     # ~1M points at K = 8 -> 8M samples
INF = 2**31 - 1
SD_RANGE = 8.0


def inputs(ntiles: int = NTILES, seed: int = 0):
    """The script's data: ~16 distinct blocks per tile, uniform offsets,
    N(0, 1) sd; each (ntiles, ROWS, C)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 20, (ntiles, 1, 1))
    bkeys = (base + rng.integers(0, 16, (ntiles, ROWS, C))).astype(np.int32)
    offs = rng.integers(0, 512, (ntiles, ROWS, C)).astype(np.int32)
    sds = rng.normal(size=(ntiles, ROWS, C)).astype(np.float32)
    return bkeys, offs, sds


def run_plain(bkeys, offs, sds, nb: int = NB):
    """Plain PyTorch M2: same outputs as :func:`run`."""
    t = bkeys.shape[0]
    dev = bkeys.device
    flat = bkeys.reshape(t, -1)
    sk, _ = torch.sort(flat, dim=1)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    drank = torch.cumsum(first, dim=1) - 1
    lst = torch.full((t, nb + 1), INF, dtype=torch.int32, device=dev)
    lst.scatter_(1, torch.where(first & (drank < nb), drank, nb), sk)
    lst = lst[:, :nb].contiguous()
    rank = torch.searchsorted(lst[:, 1:].contiguous(), flat, right=True)
    tile = torch.arange(t, device=dev)[:, None]
    cell = ((tile * nb + rank) * 512 + offs.reshape(t, -1)).reshape(-1)
    q = tile_accum.quantize_sd(sds, SD_RANGE).to(torch.int64).reshape(-1)
    accq = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
    accq.index_add_(0, cell, q)
    accw = torch.zeros_like(accq)
    accw.index_add_(0, cell, torch.ones_like(q))
    _, dscale = tile_accum.sd_scales(SD_RANGE)
    return (lst.reshape(t * nb, 1),
            (accq.to(torch.float32) * dscale).reshape(t * nb, 512),
            accw.to(torch.float32).reshape(t * nb, 512))


def run(bkeys, offs, sds, nb: int = NB):
    """M2.  bkeys/offs: i32[T, ROWS, C] (keys >= 0); sds: f32[T, ROWS, C].
    Returns (keys i32[T*nb, 1], psd, pw f32[T*nb, 512])."""
    t, rows, c = bkeys.shape
    if c != C or not 1 <= rows <= 32:
        raise ValueError(f"tiles are (rows <= 32, {C}), got {(rows, c)}")
    if bkeys.device.type == "cpu":
        return run_plain(bkeys, offs, sds, nb)
    kernels.check(bkeys, "bkeys", torch.int32)
    kernels.check(offs, "offs", torch.int32, (t, rows, c), bkeys.device)
    kernels.check(sds, "sds", torch.float32, (t, rows, c), bkeys.device)
    keys = torch.empty((t * nb, 1), dtype=torch.int32, device=bkeys.device)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=bkeys.device)
    pw = torch.empty_like(psd)
    qscale, dscale = tile_accum.sd_scales(SD_RANGE)
    p = kernels.ptr
    kernels.launch("micro_tile_accum", p(bkeys), p(offs), p(sds), t, rows,
                   nb, qscale, dscale, p(keys), p(psd), p(pw))
    return keys, psd, pw


def check(bkeys, offs, sds, time_plain: bool = False) -> dict:
    """The kernel against its plain version: keys, weights and sd sums
    equal (the same integer sums, scaled the same way).  Raises on a
    difference."""
    got = run(bkeys, offs, sds)
    ref = run_plain(bkeys, offs, sds)
    for name, a, b in zip(("keys", "psd", "pw"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"M2: {name} differs from the plain version "
                                 f"(max abs err {max_abs_err(a, b)})")
    out = {"max_abs_err": max_abs_err(got[1], ref[1])}
    if time_plain:
        out["plain_ms"] = cuda_ms(lambda: run_plain(bkeys, offs, sds),
                                  reps=3, warmup=1)
    return out


def benchmark(ntiles: int = NTILES, reps: int = 10, device: str = "cuda",
              with_check: bool = True) -> dict:
    """The script's run: the check (unless ``with_check`` is False), then
    ms and us per tile."""
    dev = require_cuda(device)
    bkeys, offs, sds = (torch.from_numpy(a).to(dev) for a in inputs(ntiles))
    res = {}
    if with_check:
        res = check(bkeys, offs, sds, time_plain=True)
        print(f"M2 check: equals its plain version (max sd err "
              f"{res['max_abs_err']})", flush=True)
    ms = cuda_ms(lambda: run(bkeys, offs, sds), reps)
    res.update(ms=ms, us_per_tile=ms * 1e3 / ntiles,
               msamples_per_s=ntiles * S / ms / 1e3)
    print(f"M2 {ms:.3f} ms for {ntiles} tiles ({res['us_per_tile']:.3f} "
          f"us/tile, {res['msamples_per_s']:.1f} M samples/s)", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ntiles", type=int, default=NTILES)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = benchmark(args.ntiles, args.reps, args.device)
    print(json.dumps({"micro_tile_accum": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
