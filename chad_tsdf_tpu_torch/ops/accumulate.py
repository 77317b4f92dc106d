"""Sample accumulation into the block pool, scatter form — PyTorch port of
``accumulate_xla`` and ``GROUP`` from ``chad_tsdf_tpu/ops/accumulate.py``.

The JAX package's TPU kernel for this step (``accumulate_pallas``) is not
ported yet; the fused insert reaches this module only through its rare
fallback, as the JAX package does off the TPU.
"""

from __future__ import annotations

import torch

# pool rows per group: the last group of the pool is reserved, so a dummy
# slot never touches a live row (core/integrate.py _directory_update)
GROUP = 8


def accumulate_xla(pool_sd, pool_w, slots_per_sample, offsets, sd, valid):
    """Scatter-add samples into the pool IN PLACE; returns (pool_sd, pool_w).

    pool_sd/pool_w: f32[Cb, 512]; slots_per_sample/offsets: i32[S];
    sd: f32[S]; valid: bool[S].  Masked samples add zero to the last pool
    element, which belongs to the reserved row.  ``index_put_`` with
    ``accumulate=True`` sorts its indices on CUDA and sums duplicates in a
    fixed order, so the result is the same on every run.
    """
    cb = pool_sd.shape[0]
    idx = slots_per_sample.to(torch.int64) * 512 + offsets.to(torch.int64)
    idx = torch.where(valid, idx, cb * 512 - 1)
    pool_sd.view(-1).index_put_((idx,), torch.where(valid, sd, 0.0),
                                accumulate=True)
    pool_w.view(-1).index_put_((idx,), valid.to(torch.float32),
                               accumulate=True)
    return pool_sd, pool_w
