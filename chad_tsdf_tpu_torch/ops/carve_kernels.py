"""Space carving on either side of its sort, by hand on the card.

``carve_keys`` writes a cloud's free-space samples as int64 sort keys
``bkey << 32 | okey`` (``INT32_MAX << 32 | INT32_MAX`` for an invalid slot)
in one launch, with the count of valid samples; ``carve_apply`` reads the
sorted keys once to count and rank their blocks and once to look the
blocks up and add each voxel's evidence into the pool, in three launches
(``csrc/carve.cu``).  The JAX package has no kernel here: it leaves carving
to XLA (``chad_tsdf_tpu/core/carve.py``).

These wrappers take CUDA tensors only.  ``core/carve.py`` routes by the
tensors' device: CUDA tensors come here, CPU tensors take the plain
versions there (``carve_keys_plain``, ``carve_apply_plain``), which the
kernels equal bit for bit: keys, pool planes and counters.
"""

from __future__ import annotations

import torch

from .. import kernels

# sorted slots per CTA of carve_apply (csrc/carve.cu kTileSlots): sizes
# its workspace, whose length the C entry checks
TILE_SLOTS = 1024


def carve_keys(points, n_points, position, origin_blocks, *, k: int,
               sub: int, step_m: float, res_recip: float, trunc: float,
               extent: int):
    """The free-space sample keys of one padded cloud.

    points: f32[N, 3]; n_points: i32[] (rows from it on are padding);
    position: f32[3]; origin_blocks: i32[3].  ``step_m``, ``res_recip`` and
    ``trunc`` are f32 values.  Returns ``(key i64[k * ns], n_valid i32[])``
    with ``ns = ceil(N / sub)``, sample ``i`` of ray ``j`` at ``i * ns +
    j``.  No host read.
    """
    n = points.shape[0]
    dev = points.device
    kernels.check(points, "points", torch.float32, (n, 3))
    kernels.check(n_points, "n_points", torch.int32, (), dev)
    kernels.check(position, "position", torch.float32, (3,), dev)
    kernels.check(origin_blocks, "origin_blocks", torch.int32, (3,), dev)
    if k < 1 or sub < 1:
        raise ValueError(f"carve_steps {k}, carve_subsample {sub}: each "
                         f"must be at least 1")
    ns = -(-n // sub)
    if k * ns >= 2**31:
        raise ValueError(f"{k} x {ns} carve slots: over 2^31")
    key = torch.empty(k * ns, dtype=torch.int64, device=dev)
    n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("carve_keys", p(points), p(n_points), p(position),
                   p(origin_blocks), ns, sub, k, step_m, res_recip, trunc,
                   extent, p(key), p(n_valid))
    return key, n_valid


def carve_apply(key, n_valid, dir_keys, dir_slots, pool_sd, pool_w, *,
                t_cap: int, sd_per: float, w_per: float):
    """Add the sorted keys' evidence into the pool planes, in place.

    key: i64[S] ascending, its ``n_valid`` (i32[]) valid samples first;
    dir_keys / dir_slots: i32[cb], the sorted directory; pool_sd / pool_w:
    f32[cb, 512].  Only the first ``t_cap`` blocks are looked up; row
    ``cb - 1`` is the reserved row, which takes nothing.  Returns i32[4]:
    the samples and voxels added, the samples of looked-up blocks that the
    directory does not hold (the erosion rule's drops), and the blocks past
    ``t_cap``.  No host read.
    """
    s = key.shape[0]
    dev = key.device
    cb = dir_keys.shape[0]
    kernels.check(key, "key", torch.int64, (s,))
    kernels.check(n_valid, "n_valid", torch.int32, (), dev)
    kernels.check(dir_keys, "dir_keys", torch.int32, (cb,), dev)
    kernels.check(dir_slots, "dir_slots", torch.int32, (cb,), dev)
    kernels.check(pool_sd, "pool_sd", torch.float32, (cb, 512), dev)
    kernels.check(pool_w, "pool_w", torch.float32, (cb, 512), dev)
    if s < 1 or t_cap < 1:
        raise ValueError(f"{s} slots, t_cap {t_cap}: each must be at "
                         f"least 1")
    tiles = -(-s // TILE_SLOTS)
    ws = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    counters = torch.empty(4, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("carve_apply", p(key), s, p(n_valid), p(dir_keys),
                   p(dir_slots), cb, t_cap, sd_per, w_per, p(pool_sd),
                   p(pool_w), p(ws), ws.numel(), p(counters))
    return counters
