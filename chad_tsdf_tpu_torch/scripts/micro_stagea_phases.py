"""Microbenchmark M1: which phase of the tile kernel (K1/K4) bounds it —
PyTorch / CUDA port of ``scripts/micro_stagea_phases.py``.

Modes, over the same (K = 11, N = 2^20) sample layout as that script, one
CTA per (K, 1024) tile (kernel ``csrc/micro.cu``, launch name
``micro_stagea_phases``):

  list   block list only: K1/K4's warp lists merged once
  rank   list + each sample's rank (count form: # list[1:] <= key)
  full   list + ranks + accumulate: K4's own ``tile_accumulate()``
  mxu    accumulate only, with the list 0..nb-1 and rank clamp(key, 0, nb-1)
  plist  presorted list: a Batcher network sorts each column's K keys,
         duplicates drop, then nb block-wide min rounds pop column heads
  pfull  presorted list + ranks + accumulate

Outputs are the TPU script's: keys i32[T*nb, 1] and partial rows psd/pw
f32[T*nb, 512].  list/rank/plist write zero rows except cell (0, 0) of each
tile (row 0 column 0's rank, or column 0's head after the pops); full and
pfull accumulate the samples whose key is in the list, mxu every valid one.
On the card full and pfull write only the live rows, as K1/K4 do (their
dead rows are left unwritten; the check compares live rows).
Signed distances are summed as K1/K4 sum them, as integers on the SD_QUANT
grid over [-SD_RANGE, SD_RANGE] (the TPU script summed bf16 on the MXU).

Run on the card::

    python3 -m chad_tsdf_tpu_torch.scripts.micro_stagea_phases
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from .. import kernels
from ..ops import tile_accum
from . import cuda_ms, max_abs_err, require_cuda

K = 11
N = 1 << 20
TILE = 1024
INF = 2**31 - 1
SD_RANGE = 8.0          # sd quantization range of the accumulate
MODES = ("list", "rank", "full", "mxu", "plist", "pfull")   # csrc order
PRESORT_MAX_K = 16      # the register column of the presort


def inputs(n: int = N, seed: int = 0):
    """The script's data: ~12 distinct blocks around one base per 1024
    samples of a row at full size, uniform offsets, N(0, 1) sd."""
    rng = np.random.default_rng(seed)
    base = np.repeat(rng.integers(0, 1 << 20, (1024,)), n // 1024)
    bkey = (base[None, :] + rng.integers(0, 12, (K, n))).astype(np.int32)
    okey = rng.integers(0, 512, (K, n)).astype(np.int32)
    sd = rng.normal(size=(K, n)).astype(np.float32)
    return bkey, okey, sd


def _tile_major(a: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (T, K * TILE): each tile's samples in one row."""
    k, n = a.shape
    t = n // TILE
    return a.reshape(k, t, TILE).permute(1, 0, 2).reshape(t, k * TILE)


def tile_lists(bkey: torch.Tensor, nb: int) -> torch.Tensor:
    """i32[T, nb]: each tile's nb smallest distinct keys, INF-padded."""
    sk, _ = torch.sort(_tile_major(bkey), dim=1)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    drank = torch.cumsum(first, dim=1) - 1
    lst = torch.full((sk.shape[0], nb + 1), INF, dtype=torch.int32,
                     device=bkey.device)
    lst.scatter_(1, torch.where(first & (drank < nb), drank, nb), sk)
    return lst[:, :nb]


def stagea_plain(bkey, okey, sd, nb: int, mode: str):
    """Plain PyTorch M1: same outputs as :func:`stagea`."""
    k, n = bkey.shape
    t = n // TILE
    dev = bkey.device
    if mode in ("full", "pfull"):
        return tile_accum.tile_partials_plain(bkey, okey, sd, nb,
                                              SD_RANGE)[:3]
    psd = torch.zeros((t * nb, 512), dtype=torch.float32, device=dev)
    pw = torch.zeros_like(psd)
    if mode == "mxu":
        keys = torch.arange(nb, dtype=torch.int32, device=dev).repeat(t)
        tile = torch.arange(n, device=dev)[None, :] // TILE
        use = bkey != INF
        rank = torch.clamp(bkey, 0, nb - 1).to(torch.int64)
        cell = torch.where(use, (tile * nb + rank) * 512 + okey, 0)
        q = torch.where(use, tile_accum.quantize_sd(sd, SD_RANGE), 0)
        accq = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
        accq.index_add_(0, cell.reshape(-1), q.to(torch.int64).reshape(-1))
        accw = torch.zeros_like(accq)
        accw.index_add_(0, cell.reshape(-1), use.to(torch.int64).reshape(-1))
        _, dscale = tile_accum.sd_scales(SD_RANGE)
        psd = (accq.to(torch.float32) * dscale).reshape(t * nb, 512)
        pw = accw.to(torch.float32).reshape(t * nb, 512)
        return keys.reshape(t * nb, 1), psd, pw
    lst = tile_lists(bkey, nb)
    if mode == "rank":                  # row 0, column 0 of each tile
        key0 = bkey[0, ::TILE].contiguous()
        psd[::nb, 0] = (lst[:, 1:] <= key0[:, None]).sum(1).to(torch.float32)
    elif mode == "plist":               # column 0's head after nb pops
        col0 = bkey[:, ::TILE].T
        head = torch.where(col0 > lst[:, -1:], col0, INF).amin(1)
        psd[::nb, 0] = head.to(torch.float32)
    return lst.reshape(t * nb, 1).contiguous(), psd, pw


def stagea(bkey, okey, sd, nb: int, mode: str):
    """M1.  bkey/okey: i32[K, N], keys >= 0 (INF = invalid); sd: f32[K, N];
    N % 1024 == 0.  Returns (keys i32[T*nb, 1], psd, pw f32[T*nb, 512])."""
    k, n = bkey.shape
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    tile_accum.check_tile_shape(k, n, nb)
    if mode in ("plist", "pfull") and k > PRESORT_MAX_K:
        raise ValueError(f"the presorted list takes K <= {PRESORT_MAX_K}")
    if bkey.device.type == "cpu":
        return stagea_plain(bkey, okey, sd, nb, mode)
    tile_accum.check_tile_smem(k, nb)
    kernels.check(bkey, "bkey", torch.int32)
    kernels.check(okey, "okey", torch.int32, (k, n), bkey.device)
    kernels.check(sd, "sd", torch.float32, (k, n), bkey.device)
    t = n // TILE
    keys = torch.empty((t * nb, 1), dtype=torch.int32, device=bkey.device)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=bkey.device)
    pw = torch.empty_like(psd)
    qscale, dscale = tile_accum.sd_scales(SD_RANGE)
    p = kernels.ptr
    kernels.launch("micro_stagea_phases", p(bkey), p(okey), p(sd), n, k, nb,
                   MODES.index(mode), qscale, dscale, p(keys), p(psd), p(pw))
    return keys, psd, pw


def build(nb: int, tile: int, mode: str):
    """The script's ``build``: a function of (bkey, okey, sd)."""
    if tile != TILE:
        raise ValueError(f"one CTA per tile of {TILE} columns, got {tile}")
    return functools.partial(stagea, nb=nb, mode=mode)


def check(bkey, okey, sd, nb: int = 48, time_plain: bool = False) -> dict:
    """Every mode against its plain version on the same inputs: keys and
    weights equal, sd sums equal (the same integer sums, scaled the same
    way; full and pfull on their live rows); the presorted list equals the
    min-extraction list.  Raises on a difference; returns the largest sd
    difference and, if asked, the plain version's ms per mode."""
    out = {"max_abs_err": 0.0, "plain_ms": {}}
    lists = {}
    for mode in MODES:
        got = stagea(bkey, okey, sd, nb, mode)
        ref = stagea_plain(bkey, okey, sd, nb, mode)
        if mode in ("full", "pfull"):
            live = tile_accum.live_rows(ref[0])
            got = (got[0], got[1][live], got[2][live])
            ref = (ref[0], ref[1][live], ref[2][live])
        for name, a, b in zip(("keys", "psd", "pw"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"M1 {mode} nb={nb}: {name} differs from the plain "
                    f"version (max abs err {max_abs_err(a, b)})")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 max_abs_err(got[1], ref[1]))
        lists[mode] = got[0]
        if time_plain:
            out["plain_ms"][mode] = cuda_ms(
                lambda m=mode: stagea_plain(bkey, okey, sd, nb, m),
                reps=3, warmup=1)
    if not torch.equal(lists["list"], lists["plist"]):
        raise AssertionError("M1: presorted lists differ from min extraction")
    return out


def benchmark(n: int = N, reps: int = 10, device: str = "cuda",
              with_check: bool = True) -> dict:
    """The script's run: the check at size n (unless ``with_check`` is
    False), then each phase's ms for nb = 48, 40, 32."""
    dev = require_cuda(device)
    bkey, okey, sd = (torch.from_numpy(a).to(dev) for a in inputs(n))
    res = {}
    if with_check:
        res = check(bkey, okey, sd, 48, time_plain=True)
        print(f"M1 check (K={K}, N={n}): every mode equals its plain "
              f"version; presort lists match min-extraction; max sd err "
              f"{res['max_abs_err']}", flush=True)
    res["ms"] = {}
    for nb in (48, 40, 32):
        for mode in MODES:
            ms = cuda_ms(lambda: stagea(bkey, okey, sd, nb, mode), reps)
            res["ms"][f"{mode}_nb{nb}"] = ms
            print(f"tile={TILE:5d} nb={nb:3d} {mode:5s} {ms:8.3f} ms",
                  flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="samples per row")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = benchmark(args.n, args.reps, args.device)
    print(json.dumps({"micro_stagea_phases": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
