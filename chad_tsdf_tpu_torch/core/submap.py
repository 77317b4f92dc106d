"""Submap finalization: active block pool -> compressed dual DAG — PyTorch
port of the synchronous ``finalize`` of ``chad_tsdf_tpu/core/submap.py``.

Replaces the reference's post-order DFS over the active octree (reference:
include/chad/detail/submap.hpp:10-106):

* device: per-voxel mean = sd_sum / weight, 8-bit quantization
  (cluster.hpp codec), dense (block, 64 clusters, 8 leaves) packing — a
  reshape, because the pool's intra-block offsets are the Morton order —
  and compaction of the non-empty clusters into one buffer;
* host: world Morton codes per cluster, then 20 rounds of
  group-by-parent-prefix + hash-consed adds into the shared
  ``chad_tsdf_tpu.core.dag.NodeLevels`` (numpy, or the native C++ runtime).

In this port a rotation finalizes synchronously: the JAX package's
deferred rotation (``start_finalize`` / ``PendingSubmap``) is not ported
yet, so a rotation reads back the counters and the compacted clusters at
once.  The weight clamp uses min (the intent), not the reference's
always-255 ``std::max`` (submap.hpp:92-93).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.core.dag import MAX_DEPTH, NodeLevels

from ..ops import codec, morton
from .state import INT32_MAX, ActiveMapState, warn_on_overflow


@dataclasses.dataclass
class Submap:
    """Finalized submap: two DAG roots + trajectory (submap.hpp:108-110).

    ``levels``: the NodeLevels the roots index into when they are not the
    owning map's (a throwaway snapshot of the active map); None = the
    map's.  ``anchor``: (4, 4) world pose of the submap frame (first
    scanner position).
    """
    root_addr_tsdf: int
    root_addr_weight: int
    positions: list
    n_clusters: int = 0
    n_voxels: int = 0
    levels: object = None
    anchor: object = None


def _live_slots(state: ActiveMapState, n_pad: int):
    idx = torch.arange(n_pad, dtype=torch.int32, device=state.device)
    valid = idx < state.n_blocks
    idx_c = torch.minimum(idx, torch.clamp(state.n_blocks - 1, min=0))
    return idx_c, valid


def _extract_blocks(state: ActiveMapState, n_pad: int, sdf_trunc: float):
    """Gather the allocated blocks in key order and quantize.  Returns
    (keys i32[n_pad], tsdf u8[n_pad,64,8], weight u8[n_pad,64,8],
    nonempty bool[n_pad,64])."""
    idx_c, valid = _live_slots(state, n_pad)
    keys = torch.where(valid, state.dir_keys[idx_c], INT32_MAX)
    slots = state.dir_slots[idx_c]
    sd_sum = state.pool_sd[slots]                        # (n_pad, 512)
    w = state.pool_w[slots]
    occupied = w > 0
    mean = sd_sum / torch.clamp(w, min=1.0)
    keep = occupied & valid[:, None]
    q_sd = torch.where(keep, codec.encode_sd(mean, sdf_trunc), codec.EMPTY)
    q_w = torch.where(keep, codec.encode_weight(w), codec.EMPTY)
    nonempty = keep.reshape(n_pad, 64, 8).any(-1)
    return (keys, q_sd.reshape(n_pad, 64, 8), q_w.reshape(n_pad, 64, 8),
            nonempty)


def _count_nonempty_clusters(state: ActiveMapState, n_pad: int):
    """Number of (block, cluster) cells with any weight (device i32[])."""
    idx_c, valid = _live_slots(state, n_pad)
    w = state.pool_w[state.dir_slots[idx_c]].reshape(n_pad, 64, 8)
    ne = ((w > 0) & valid[:, None, None]).any(-1)
    return ne.sum(dtype=torch.int32)


def _extract_clusters_compact(state: ActiveMapState, n_pad: int, cap: int,
                              sdf_trunc: float):
    """Quantize, pack each 8-leaf cluster into two 32-bit words, drop empty
    clusters, and return ONE flat buffer of uint32 values (held as int64):
    ``[dir keys (n_pad) | 5 rows x cap]``, rows = cluster id
    (dir index * 64 + cluster), tsdf lo/hi, weight lo/hi; pad 0xFFFFFFFF.
    ``cap`` must be >= the live cluster count."""
    keys, q_sd, q_w, nonempty = _extract_blocks(state, n_pad, sdf_trunc)

    def pack2(q):                                  # (n_pad, 64, 8) u8
        q = q.to(torch.int64)
        lo = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | \
            (q[..., 3] << 24)
        hi = q[..., 4] | (q[..., 5] << 8) | (q[..., 6] << 16) | \
            (q[..., 7] << 24)
        return lo.reshape(-1), hi.reshape(-1)

    t_lo, t_hi = pack2(q_sd)
    w_lo, w_hi = pack2(q_w)
    flat_ne = nonempty.reshape(-1)
    ids = torch.arange(n_pad * 64, dtype=torch.int64, device=state.device)
    pos = torch.cumsum(flat_ne, 0, dtype=torch.int64) - 1
    pos = torch.where(flat_ne & (pos < cap), pos, cap)  # empties -> spill
    rows = torch.stack([ids, t_lo, t_hi, w_lo, w_hi])   # (5, n_pad*64)
    out = torch.full((5, cap + 1), 0xFFFFFFFF, dtype=torch.int64,
                     device=state.device)
    out[:, pos] = rows
    return torch.cat([keys.to(torch.int64), out[:, :cap].reshape(-1)])


def _unpack_cluster_buf(buf: np.ndarray, n_pad: int, cap: int, count: int,
                        origin: np.ndarray, config: MapConfig):
    """Host side: the compacted uint32 buffer -> sorted unique (cluster
    codes u64, tsdf words u64, weight words u64, n_voxels)."""
    keys = buf[:n_pad].astype(np.int32)
    body = buf[n_pad:].reshape(5, cap)[:, :count]
    ids = body[0].astype(np.int64)
    blk = ids >> 6
    cidx = (ids & 63).astype(np.uint64)

    # world 54-bit block codes -> 60-bit cluster codes
    wb = morton.np_block_key_to_world63(keys[blk], origin, config.block_bits)
    codes = (wb << np.uint64(6)) | cidx
    words_t = body[1].astype(np.uint64) | (body[2].astype(np.uint64) << 32)
    words_w = body[3].astype(np.uint64) | (body[4].astype(np.uint64) << 32)
    shifts = (np.uint64(8) * np.arange(8, dtype=np.uint64))[None, :]
    n_vox = int((((words_t[:, None] >> shifts) & np.uint64(0xFF))
                 != np.uint64(codec.EMPTY)).sum())
    order = np.argsort(codes, kind="stable")
    return codes[order], words_t[order], words_w[order], n_vox


def cap_bucket(n: int) -> int:
    """Smallest {2^k, 1.5*2^k} >= n (<= 33% padding in the transfer)."""
    p = 1 << max(7, (max(n, 1) - 1).bit_length())
    if 3 * p // 4 >= n:
        return 3 * p // 4
    return p


def extract_clusters(state: ActiveMapState, config: MapConfig):
    """Device quantization + compaction + host unpack: active map ->
    sorted unique (cluster codes u64, tsdf words u64, weight words u64,
    n_voxels).  Two scalar reads and one bulk transfer."""
    n_blocks = int(state.n_blocks)
    z = np.zeros(0, np.uint64)
    if n_blocks == 0:
        return z, z.copy(), z.copy(), 0
    n_pad = max(1, 1 << (n_blocks - 1).bit_length())
    count = int(_count_nonempty_clusters(state, n_pad))
    if count == 0:
        return z, z.copy(), z.copy(), 0
    cap = cap_bucket(count)
    buf = _extract_clusters_compact(state, n_pad, cap, config.sdf_trunc)
    buf = buf.cpu().numpy().astype(np.uint32)
    return _unpack_cluster_buf(buf, n_pad, cap, count,
                               state.origin_blocks.cpu().numpy(), config)


def build_submap(levels: NodeLevels, codes, words_t, words_w, positions,
                 n_voxels: int = 0) -> Submap:
    """Bottom-up dual-DAG build from sorted unique leaf clusters
    (submap.hpp:31-60 in sort-group form), hash-consed into ``levels``."""
    if codes.shape[0] == 0:
        root = _add_empty_chain(levels)
        return Submap(root, root, list(positions), 0, 0)
    n_clusters = codes.shape[0]
    addr_t = levels.leaf_clusters.add_batch(words_t)
    addr_w = levels.leaf_clusters.add_batch(words_w)
    for depth in range(MAX_DEPTH - 1, -1, -1):
        parent = codes >> np.uint64(3)
        child_i = (codes & np.uint64(7)).astype(np.int64)
        starts = np.concatenate([[True], parent[1:] != parent[:-1]])
        group = np.cumsum(starts) - 1
        g = int(group[-1]) + 1 if group.size else 0
        kids_t = np.zeros((g, 8), np.uint32)
        kids_w = np.zeros((g, 8), np.uint32)
        kids_t[group, child_i] = addr_t
        kids_w[group, child_i] = addr_w
        addr_t = levels.nodes[depth].add_batch(kids_t)
        addr_w = levels.nodes[depth].add_batch(kids_w)
        codes = parent[starts]
    if codes.size != 1 or int(codes[0]) != 0:
        raise RuntimeError("DAG build did not converge to one root")
    return Submap(int(addr_t[0]), int(addr_w[0]), list(positions),
                  n_clusters=n_clusters, n_voxels=n_voxels)


def finalize(state: ActiveMapState, levels: NodeLevels, config: MapConfig,
             positions: list) -> Submap:
    """Finalize the active map into a Submap, hash-consing into ``levels``
    (synchronous: reads the counters and the clusters back now)."""
    warn_on_overflow(state)
    codes, words_t, words_w, n_vox = extract_clusters(state, config)
    return build_submap(levels, codes, words_t, words_w, positions, n_vox)


def _add_empty_chain(levels: NodeLevels) -> int:
    addr = levels.leaf_clusters.add_batch(
        np.array([0xFFFFFFFFFFFFFFFF], np.uint64))
    for depth in range(MAX_DEPTH - 1, -1, -1):
        kids = np.zeros((1, 8), np.uint32)
        kids[0, 0] = addr[0]
        addr = levels.nodes[depth].add_batch(kids)
    return int(addr[0])
