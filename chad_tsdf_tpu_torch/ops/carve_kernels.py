"""Space carving by hand on the card: its keys, their sort, the pool
update.

``carve_keys`` writes a cloud's free-space samples as int64 sort keys
``bkey << 32 | okey`` (``INT32_MAX << 32 | INT32_MAX`` for an invalid slot)
in one launch, with the count of valid samples and the counts of their
radix digits; ``carve_sort`` sorts them, keys only, by a radix sort over
the valid keys' significant bits (``csrc/carve_sort.cu``: one pass a
digit); ``carve_apply`` reads the sorted keys once to count and rank their
blocks and once to look the blocks up and add each voxel's evidence into
the pool, in three launches (``csrc/carve.cu``).  The JAX package has no
kernel here: it leaves carving to XLA (``chad_tsdf_tpu/core/carve.py``,
its sort to ``lax.sort``).

These wrappers take CUDA tensors only.  ``core/carve.py`` routes by the
tensors' device: CUDA tensors come here, CPU tensors take the plain
versions there (``carve_keys_plain``, ``torch.sort``,
``carve_apply_plain``), which the kernels equal bit for bit: keys, sorted
keys, pool planes and counters.
"""

from __future__ import annotations

import torch

from .. import kernels

# sorted slots per CTA of carve_apply (csrc/carve.cu kTileSlots): sizes
# its workspace, whose length the C entry checks
TILE_SLOTS = 1024
# carve_sort's digit and tile (csrc/common.cuh kSortBits, csrc/carve_sort.cu
# kSortTile): they size the digit counts and the sort's workspace
RADIX_BITS = 8
SORT_TILE = 4096


def sort_passes(key_bits: int) -> int:
    """The digit passes of a sort over ``key_bits`` significant bits."""
    return -(-key_bits // RADIX_BITS)


def sort_workspace_ints(s: int, key_bits: int) -> int:
    """carve_sort's workspace over ``s`` slots, in ints: per pass a tile
    counter and one look-back word a tile and digit."""
    tiles = -(-s // SORT_TILE)
    return sort_passes(key_bits) * (1 + tiles * (1 << RADIX_BITS))


def carve_keys(points, n_points, position, origin_blocks, *, k: int,
               sub: int, step_m: float, res_recip: float, trunc: float,
               extent: int, key_bits: int):
    """The free-space sample keys of one padded cloud, and their digit
    counts for :func:`carve_sort`.

    points: f32[N, 3]; n_points: i32[] (rows from it on are padding);
    position: f32[3]; origin_blocks: i32[3].  ``step_m``, ``res_recip`` and
    ``trunc`` are f32 values; ``key_bits`` the valid keys' significant
    bits.  Returns ``(key i64[k * ns], n_valid i32[], counts
    i32[sort_passes(key_bits), 256])`` with ``ns = ceil(N / sub)``, sample
    ``i`` of ray ``j`` at ``i * ns + j``, and ``counts[q, v]`` the valid
    keys whose digit ``q`` (bits ``8q`` to ``8q + 7`` of ``bkey << 9 |
    okey``) is ``v``.  No host read.
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
    _check_key_bits(key_bits)
    key = torch.empty(k * ns, dtype=torch.int64, device=dev)
    n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.zeros((sort_passes(key_bits), 1 << RADIX_BITS),
                         dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("carve_keys", p(points), p(n_points), p(position),
                   p(origin_blocks), ns, sub, k, step_m, res_recip, trunc,
                   extent, counts.shape[0], p(key), p(n_valid), p(counts))
    return key, n_valid, counts


def _check_key_bits(key_bits: int) -> None:
    if not 9 <= key_bits <= 39:
        raise ValueError(f"key_bits {key_bits}: a carve key has 9 to 39 "
                         f"(3 * block_bits + 9)")


def carve_sort(key, n_valid, counts, *, key_bits: int):
    """``torch.sort(key).values``, keys only, for carve keys.

    key: i64[S], ``n_valid`` (i32[]) of its slots a valid key ``bkey << 32
    | okey`` with ``bkey < 2**(key_bits - 9)`` and ``okey < 512``, the
    others ``INT32_MAX << 32 | INT32_MAX``, in any order; counts: their
    digit counts, as :func:`carve_keys` returns them.  Returns a new
    i64[S]: the valid keys ascending, then the invalid value.  ``key`` is
    not written.  No host read.
    """
    s = key.shape[0]
    dev = key.device
    _check_key_bits(key_bits)
    kernels.check(key, "key", torch.int64, (s,))
    kernels.check(n_valid, "n_valid", torch.int32, (), dev)
    kernels.check(counts, "counts", torch.int32,
                  (sort_passes(key_bits), 1 << RADIX_BITS), dev)
    if not 1 <= s < 2**30:
        raise ValueError(f"{s} slots: carve_sort takes 1 to 2^30 - 1")
    out = torch.empty_like(key)
    alt = torch.empty_like(key) if sort_passes(key_bits) > 1 else out
    ws = torch.empty(sort_workspace_ints(s, key_bits), dtype=torch.int32,
                     device=dev)
    p = kernels.ptr
    kernels.launch("carve_sort", p(key), s, p(n_valid), p(counts),
                   key_bits, p(alt), p(out), p(ws), ws.numel())
    return out


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
