"""Microbenchmark M3: int8 against bf16 one-hot contraction on the tensor
cores — PyTorch / CUDA port of ``scripts/micro_mxu8.py``.

Per 1024-point tile (K = 10 samples per point, NB = 40 list rows), the
contraction of onehot(offset) (512 x K*1024) with [sel . sdq, sel]
(K*1024 x 2 NB), sel = (lrow == row) & use, written as psd/pw f32[T*NB,
512].  The TPU script's six modes differ only in TPU layout (the 128-lane
factorized one-hot of ``bf16``/``int8``, its all-rows-in-one-dot form
``int8b``, the transposed ``formD``/``formD8`` and its batched ``formDb``)
and in input precision; all give the same outputs.  The port has one
tensor-core kernel (``csrc/micro.cu``, launch name ``micro_mxu8``) in two
precisions:

  bf16   bf16 inputs, f32 sums (wgmma k16)    <- bf16, formD, formDb
  int8   int8 inputs, int32 sums (wgmma k32)  <- int8, int8b, formD8

The kernel buckets each tile's kept samples by offset group (okey >> 6,
64 rows a group, each list padded to one wgmma's K: 16 bf16, 32 int8), so
a sample meets the 64 rows of its group instead of all 512; it reports the
wgmmas it issued per tile, which :func:`mma_steps_plain` counts from the
padded lists.  sdq lies in [-127, 127] and every sum is an integer below
2^24, so both precisions and the plain version are exact: the gate is
equality.

The library yardstick is one ``torch.bmm`` of the dense operands that
:func:`onehot_operands` builds (bf16[T, 512, K*1024] @ bf16[T, K*1024,
2 NB], f32 out), read back by :func:`from_bmm`; the port never calls it.

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
OFFSETS = 512
GROUP = 64                        # offset rows of a group: wgmma's M
PRECISIONS = ("bf16", "int8")
K_STEP = {"bf16": 16, "int8": 32}  # samples of one wgmma (its K)
# the TPU script's modes -> the port's input precision
PRECISION = {"bf16": "bf16", "int8": "int8", "int8b": "int8",
             "formD": "bf16", "formD8": "int8", "formDb": "bf16"}
NB_SUPPORTED = (16, 32, 40, 48)   # wgmma's N = 2 nb
MAX_K = 16                        # the kernel's 16-bit group counts
EDGE_CASES = ("one_group", "unused", "sdq127", "lrow_out")


def inputs(n: int = N, seed: int = 0):
    """The script's data: okey, sdq (quantized sd in [-127, 127]), lrow in
    [0, NB) and use (72% set), each i32[K, n]."""
    rng = np.random.default_rng(seed)
    okey = rng.integers(0, OFFSETS, (K, n)).astype(np.int32)
    sdq = rng.integers(-127, 128, (K, n)).astype(np.int32)
    lrow = rng.integers(0, NB, (K, n)).astype(np.int32)
    use = (rng.random((K, n)) < 0.72).astype(np.int32)
    return okey, sdq, lrow, use


def edge_inputs(case: str, n: int = N, nb: int = NB, seed: int = 0):
    """:func:`inputs` changed to stress one thing:

    one_group  every offset in group 5 (rows 320-383): one list holds all
    unused     use all zero: every output cell must read 0
    sdq127     sdq = +-127, every sample used, and every other column of
               each row piled into cell (row 0, offset 0) at +127: sums up
               to K * 512 * 127 per cell
    lrow_out   lrow in [-8, nb + 8): the rows outside [0, nb) add nothing
    """
    okey, sdq, lrow, use = inputs(n, seed)
    rng = np.random.default_rng(seed + 1)
    if case == "one_group":
        okey = (5 * GROUP + okey % GROUP).astype(np.int32)
    elif case == "unused":
        use = np.zeros_like(use)
    elif case == "sdq127":
        sdq = np.where(rng.random(sdq.shape) < 0.5, 127, -127).astype(
            np.int32)
        use = np.ones_like(use)
        okey[:, ::2], lrow[:, ::2], sdq[:, ::2] = 0, 0, 127
    elif case == "lrow_out":
        lrow = rng.integers(-8, nb + 8, lrow.shape).astype(np.int32)
    else:
        raise ValueError(f"case {case!r} not in {EDGE_CASES}")
    return okey, sdq, lrow, use


def _selected(lrow, use, nb):
    return (use != 0) & (lrow >= 0) & (lrow < nb)


def contract_plain(okey, sdq, lrow, use, nb: int = NB):
    """Plain PyTorch M3 (a scatter-add of integers): same outputs as
    :func:`contract`."""
    k, n = okey.shape
    t = n // TILE
    dev = okey.device
    sel = _selected(lrow, use, nb)
    tile = torch.arange(n, device=dev)[None, :] // TILE
    cell = torch.where(sel, (tile * nb + lrow) * 512 + okey, 0).reshape(-1)
    acc_sd = torch.zeros(t * nb * 512, dtype=torch.int64, device=dev)
    acc_sd.index_add_(0, cell, torch.where(sel, sdq, 0).to(torch.int64)
                      .reshape(-1))
    acc_w = torch.zeros_like(acc_sd)
    acc_w.index_add_(0, cell, sel.to(torch.int64).reshape(-1))
    return (acc_sd.to(torch.float32).reshape(t * nb, 512),
            acc_w.to(torch.float32).reshape(t * nb, 512))


def mma_steps_plain(okey, lrow, use, nb: int = NB,
                    precision: str = "bf16") -> torch.Tensor:
    """i32[T]: the wgmmas the kernel issues per tile, counted from the
    padded lists: the sum over the 8 offset groups of ceil(kept samples /
    K_STEP)."""
    n = okey.shape[1]
    t = n // TILE
    sel = _selected(lrow, use, nb)
    tile = torch.arange(n, device=okey.device)[None, :] // TILE
    bucket = (tile * (OFFSETS // GROUP) + okey // GROUP)[sel]
    kept = torch.bincount(bucket, minlength=t * OFFSETS // GROUP)
    step = K_STEP[precision]
    return ((kept + step - 1) // step).reshape(t, -1).sum(1).to(torch.int32)


def bucketed_flop(steps: torch.Tensor, nb: int = NB,
                  precision: str = "bf16") -> int:
    """Multiply-adds x 2 of the wgmmas in ``steps`` (64 x 2nb x K each)."""
    return int(steps.sum()) * 2 * GROUP * 2 * nb * K_STEP[precision]


def contract(okey, sdq, lrow, use, nb: int = NB, precision: str = "bf16",
             steps: torch.Tensor | None = None):
    """M3.  okey/sdq/lrow/use: i32[K, N], N % 1024 == 0.  Returns (psd, pw)
    f32[T*nb, 512].  ``steps`` (i32[T], optional) receives the wgmmas
    issued per tile (on the CPU: :func:`mma_steps_plain`)."""
    k, n = okey.shape
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if n % TILE != 0:
        raise ValueError(f"N % {TILE} != 0: {n}")
    if nb not in NB_SUPPORTED:
        raise ValueError(f"nb must be one of {NB_SUPPORTED}, got {nb}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must lie in [1, {MAX_K}], got {k}")
    t = n // TILE
    if okey.device.type == "cpu":
        if steps is not None:
            steps.copy_(mma_steps_plain(okey, lrow, use, nb, precision))
        return contract_plain(okey, sdq, lrow, use, nb)
    for name, a in (("okey", okey), ("sdq", sdq), ("lrow", lrow),
                    ("use", use)):
        kernels.check(a, name, torch.int32, (k, n), okey.device)
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads int4, so the data "
                             f"must be 16-byte aligned")
    if steps is not None:
        kernels.check(steps, "steps", torch.int32, (t,), okey.device)
    psd = torch.empty((t * nb, 512), dtype=torch.float32, device=okey.device)
    pw = torch.empty_like(psd)
    p = kernels.ptr
    kernels.launch("micro_mxu8", p(okey), p(sdq), p(lrow), p(use), n, k, nb,
                   int(precision == "int8"), p(psd), p(pw),
                   None if steps is None else p(steps))
    return psd, pw


def onehot_operands(okey, sdq, lrow, use, nb: int = NB,
                    dtype: torch.dtype = torch.bfloat16):
    """The dense operands of M3's product, per tile: onehot[T, 512, S] and
    vals[T, S, 2 nb] (S = K*1024 samples, row-major over (k, column)), so
    that ``torch.bmm(onehot, vals)`` read by :func:`from_bmm` is M3."""
    k, n = okey.shape
    t = n // TILE

    def per_tile(a):
        return a.reshape(k, t, TILE).permute(1, 0, 2).reshape(t, k * TILE)

    o, s, row = per_tile(okey), per_tile(sdq), per_tile(lrow)
    sel = per_tile(_selected(lrow, use, nb))
    onehot = torch.zeros((t, OFFSETS, k * TILE), dtype=dtype,
                         device=okey.device)
    onehot.scatter_(1, o.to(torch.int64)[:, None, :], 1.0)
    col = row.clamp(0, nb - 1).to(torch.int64)[..., None]
    vals = torch.zeros((t, k * TILE, 2 * nb), dtype=dtype, device=okey.device)
    vals.scatter_(2, col, torch.where(sel, s, 0).to(dtype)[..., None])
    vals.scatter_(2, col + nb, sel.to(dtype)[..., None])
    return onehot, vals


def from_bmm(out: torch.Tensor, nb: int = NB):
    """(psd, pw) f32[T*nb, 512] from the product bmm(onehot, vals)[T, 512,
    2 nb]."""
    t = out.shape[0]
    cols = out.transpose(1, 2).to(torch.float32)
    return (cols[:, :nb].reshape(t * nb, OFFSETS),
            cols[:, nb:].reshape(t * nb, OFFSETS))


def build(nb: int, mode: str):
    """The script's ``build``: a function of (okey, sdq, lrow, use)."""
    return functools.partial(contract, nb=nb, precision=PRECISION[mode])


def check(okey, sdq, lrow, use, nb: int = NB,
          time_plain: bool = False) -> dict:
    """Both precisions against the plain version: equal, and the wgmmas
    issued per tile equal to the padded lists' count.  Raises on a
    difference.  Returns the wgmmas and GFLOP of each precision."""
    ref = contract_plain(okey, sdq, lrow, use, nb)
    t = okey.shape[1] // TILE
    out = {"max_abs_err": 0.0, "wgmmas": {}, "gflop": {}}
    for prec in PRECISIONS:
        steps = torch.full((t,), -1, dtype=torch.int32, device=okey.device)
        got = contract(okey, sdq, lrow, use, nb, prec, steps)
        for name, a, b in zip(("psd", "pw"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"M3 {prec} nb {nb}: {name} differs from the plain "
                    f"version (max abs err {max_abs_err(a, b)})")
        want = mma_steps_plain(okey, lrow, use, nb, prec)
        if not torch.equal(steps, want):
            raise AssertionError(
                f"M3 {prec} nb {nb}: wgmmas per tile {steps[:8].tolist()} "
                f"differ from the padded lists' {want[:8].tolist()}")
        out["wgmmas"][prec] = int(steps.sum())
        out["gflop"][prec] = bucketed_flop(steps, nb, prec) / 1e9
    if time_plain:
        out["plain_ms"] = cuda_ms(lambda: contract_plain(okey, sdq, lrow,
                                                         use, nb),
                                  reps=3, warmup=1)
    return out


def benchmark(n: int = N, reps: int = 10, device: str = "cuda",
              with_check: bool = True) -> dict:
    """The script's run: both precisions checked (unless ``with_check`` is
    False), then timed, with the bucketed product's wgmmas and GFLOP."""
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
        steps = mma_steps_plain(args[0], args[2], args[3], NB, prec)
        gflop = bucketed_flop(steps, NB, prec) / 1e9
        print(f"{prec:6s} {ms:8.3f} ms; bucketed product {int(steps.sum())} "
              f"wgmmas, {gflop:.2f} GFLOP", flush=True)
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
