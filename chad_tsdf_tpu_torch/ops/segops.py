"""Segment operations over sorted keys — PyTorch port of
``chad_tsdf_tpu/ops/segops.py``.

The reference groups voxels and neighbourhoods with hash tables (reference:
include/chad/detail/octree.hpp:187, levels.hpp:93,143); here, as in the JAX
package, they are sorted keys plus segment operations: boundary flags, exact
per-segment sums by a segmented scan, and stream compaction by rank search.
The scans keep the JAX package's Hillis-Steele rounds, so both packages add
the same pairs in the same order.  None of these functions reads a tensor
on the host.
"""

from __future__ import annotations

import torch


def boundary_flags(keys) -> torch.Tensor:
    """True where a run of equal keys starts.  ``keys``: sorted (N,) tensor
    or a tuple of parallel key tensors compared lexicographically-equal."""
    if not isinstance(keys, (tuple, list)):
        keys = (keys,)
    neq = None
    for k in keys:
        d = torch.ones_like(k, dtype=torch.bool)
        d[1:] = k[1:] != k[:-1]
        neq = d if neq is None else (neq | d)
    return neq


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Shift along the last axis by ``d``, filling with ``fill``."""
    out = torch.full_like(x, fill)
    out[..., d:] = x[..., :-d]
    return out


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    out = torch.full_like(x, fill)
    out[..., :-d] = x[..., d:]
    return out


def segmented_sum_scan(flags: torch.Tensor, values: torch.Tensor):
    """Inclusive running sum that resets at each segment start.

    ``values`` is (N,) or feature-major (F, N); ``flags`` (N,) bool.  The
    value at a segment's last element is the exact per-segment sum.
    """
    n = flags.shape[0]
    f = flags
    v = values
    d = 1
    while d < n:
        fprev = _shift_right(f, d, True)
        vprev = _shift_right(v, d, 0)
        mask = f if v.dim() == 1 else f[None, :]
        v = torch.where(mask, v, v + vprev)
        f = f | fprev
        d *= 2
    return v


def segment_broadcast_first(flags: torch.Tensor, values: torch.Tensor):
    """Each element receives ``values`` at its segment's FIRST element
    (forward last-valid scan; ``values`` (N,) or (F, N))."""
    n = flags.shape[0]
    h = flags
    v = values
    d = 1
    while d < n:
        hprev = _shift_right(h, d, False)
        vprev = _shift_right(v, d, 0)
        mask = h if v.dim() == 1 else h[None, :]
        v = torch.where(mask, v, vprev)
        h = h | hprev
        d *= 2
    return v


def segment_broadcast_last(flags: torch.Tensor, values: torch.Tensor):
    """Each element receives ``values`` at its segment's LAST element
    (backward next-valid scan in shift-left form)."""
    n = flags.shape[0]
    h = torch.ones_like(flags)
    h[:-1] = flags[1:]                              # is_end
    v = values
    d = 1
    while d < n:
        hnext = _shift_left(h, d, False)
        vnext = _shift_left(v, d, 0)
        mask = h if v.dim() == 1 else h[None, :]
        v = torch.where(mask, v, vnext)
        h = h | hnext
        d *= 2
    return v


def compact_flag_positions(flags: torch.Tensor, capacity: int):
    """Positions of set flags, padded to ``capacity``.

    Returns ``(positions, min(count, capacity), count)``: int32
    ``positions[:count]`` are the set indices in ascending order, the rest
    are ``n`` (one past the end).  One cumulative rank and one
    ``searchsorted`` with ``capacity`` queries — no scatter over ``n`` and
    no host read of the count.
    """
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
    count = rank[-1] if n > 0 else torch.zeros((), dtype=torch.int32,
                                               device=flags.device)
    j = torch.arange(1, capacity + 1, dtype=torch.int32, device=flags.device)
    pos = torch.searchsorted(rank, j, side="left").to(torch.int32)
    pos = torch.where(j <= count, pos, n)
    return pos, torch.clamp(count, max=capacity), count
