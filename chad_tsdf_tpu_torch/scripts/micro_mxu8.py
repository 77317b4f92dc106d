"""Microbenchmark M3: int8 against bf16 one-hot contraction on the tensor
cores — PyTorch / CUDA port of ``scripts/micro_mxu8.py``.

Per 1024-point tile (K = 10 samples per point, NB = 40 list rows), the
contraction of onehot(offset) (512 x K*1024) with [sel . sdq, sel]
(K*1024 x 2 NB), sel = (lrow == row) & use, written as psd/pw f32[T*NB,
512].  The TPU script's six modes differ only in TPU layout (the 128-lane
factorized one-hot of ``bf16``/``int8``, its all-rows-in-one-dot form
``int8b``, the transposed ``formD``/``formD8`` and its batched ``formDb``)
and in input precision; all give the same outputs.  The port has one
tensor-core kernel (``csrc/micro.cu``, launch name ``micro_mxu8``,
``mma.sync`` with fragments built in registers) in two precisions:

  bf16   bf16 inputs, f32 sums (m16n8k16)  <- bf16, formD, formDb
  int8   int8 inputs, int32 sums (m16n8k32) <- int8, int8b, formD8

sdq lies in [-127, 127] and lrow in [0, NB), so both precisions and the
plain version are exact: the gate is equality.

Run on the card::

    python3 -m chad_tsdf_tpu_torch.scripts.micro_mxu8
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from .. import kernels
from . import cuda_ms, max_abs_err, require_cuda

K = 10
N = 1 << 20
TILE = 1024
NB = 40
PRECISIONS = ("bf16", "int8")
# the TPU script's modes -> the port's input precision
PRECISION = {"bf16": "bf16", "int8": "int8", "int8b": "int8",
             "formD": "bf16", "formD8": "int8", "formDb": "bf16"}
NB_SUPPORTED = (16, 32, 40, 48)   # 2 nb columns in the kernel's n-tiles


def inputs(n: int = N, seed: int = 0):
    """The script's data: okey, sdq (quantized sd in [-127, 127]), lrow in
    [0, NB) and use (72% set), each i32[K, n]."""
    rng = np.random.default_rng(seed)
    okey = rng.integers(0, 512, (K, n)).astype(np.int32)
    sdq = rng.integers(-127, 128, (K, n)).astype(np.int32)
    lrow = rng.integers(0, NB, (K, n)).astype(np.int32)
    use = (rng.random((K, n)) < 0.72).astype(np.int32)
    return okey, sdq, lrow, use


def contract_plain(okey, sdq, lrow, use, nb: int = NB):
    """Plain PyTorch M3 (a scatter-add of integers): same outputs as
    :func:`contract`."""
    k, n = okey.shape
    t = n // TILE
    dev = okey.device
    sel = (use != 0) & (lrow >= 0) & (lrow < nb)
    tile = torch.arange(n, device=dev)[None, :] // TILE
    cell = torch.where(sel, (tile * nb + lrow) * 512 + okey, 0).reshape(-1)
    acc_sd = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
    acc_sd.index_add_(0, cell, torch.where(sel, sdq, 0).to(torch.int64)
                      .reshape(-1))
    acc_w = torch.zeros_like(acc_sd)
    acc_w.index_add_(0, cell, sel.to(torch.int64).reshape(-1))
    return (acc_sd.to(torch.float32).reshape(t * nb, 512),
            acc_w.to(torch.float32).reshape(t * nb, 512))


def contract(okey, sdq, lrow, use, nb: int = NB, precision: str = "bf16"):
    """M3.  okey/sdq/lrow/use: i32[K, N], N % 1024 == 0.  Returns (psd, pw)
    f32[T*nb, 512]."""
    k, n = okey.shape
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if n % TILE != 0:
        raise ValueError(f"N % {TILE} != 0: {n}")
    if nb not in NB_SUPPORTED:
        raise ValueError(f"nb must be one of {NB_SUPPORTED}, got {nb}")
    if okey.device.type == "cpu":
        return contract_plain(okey, sdq, lrow, use, nb)
    for name, a in (("okey", okey), ("sdq", sdq), ("lrow", lrow),
                    ("use", use)):
        kernels.check(a, name, torch.int32, (k, n), okey.device)
    t = n // TILE
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=okey.device)
    pw = torch.empty_like(psd)
    p = kernels.ptr
    kernels.launch("micro_mxu8", p(okey), p(sdq), p(lrow), p(use), n, k, nb,
                   int(precision == "int8"), p(psd), p(pw))
    return psd, pw


def build(nb: int, mode: str):
    """The script's ``build``: a function of (okey, sdq, lrow, use)."""
    return functools.partial(contract, nb=nb, precision=PRECISION[mode])


def check(okey, sdq, lrow, use, time_plain: bool = False) -> dict:
    """Both precisions against the plain version: equal.  Raises on a
    difference."""
    ref = contract_plain(okey, sdq, lrow, use)
    out = {"max_abs_err": 0.0}
    for prec in PRECISIONS:
        got = contract(okey, sdq, lrow, use, NB, prec)
        for name, a, b in zip(("psd", "pw"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"M3 {prec}: {name} differs from the plain version "
                    f"(max abs err {max_abs_err(a, b)})")
    if time_plain:
        out["plain_ms"] = cuda_ms(lambda: contract_plain(okey, sdq, lrow,
                                                         use),
                                  reps=3, warmup=1)
    return out


def benchmark(n: int = N, reps: int = 10, device: str = "cuda",
              with_check: bool = True) -> dict:
    """The script's run: both precisions checked (unless ``with_check`` is
    False), then timed."""
    dev = require_cuda(device)
    args = [torch.from_numpy(a).to(dev) for a in inputs(n)]
    res = {}
    if with_check:
        res = check(*args, time_plain=True)
        print(f"M3 check (K={K}, N={n}, NB={NB}): bf16 == int8 == plain",
              flush=True)
    res["ms"] = {}
    for prec in PRECISIONS:
        ms = cuda_ms(lambda: contract(*args, NB, prec), reps)
        res["ms"][prec] = ms
        print(f"{prec:6s} {ms:8.3f} ms", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="points")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = benchmark(args.n, args.reps, args.device)
    print(json.dumps({"micro_mxu8": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
