"""Submap finalization: active block pool -> compressed dual DAG — PyTorch
port of ``chad_tsdf_tpu/core/submap.py`` (the single-device half).

Replaces the reference's post-order DFS over the active octree (reference:
include/chad/detail/submap.hpp:10-106):

* device: per-voxel mean = sd_sum / weight, 8-bit quantization
  (cluster.hpp codec), dense (block, 64 clusters, 8 leaves) packing — a
  reshape, because the pool's intra-block offsets are the Morton order —
  and compaction of the non-empty clusters into one buffer;
* host: world Morton codes per cluster, then 20 rounds of
  group-by-parent-prefix + hash-consed adds into the shared
  ``core/dag.py`` ``NodeLevels`` (numpy, or the native C++ runtime).

:func:`finalize` does all of it at once (the snapshot of the active map at
``save``).  A rotation mid-stream is deferred: :func:`start_finalize` only
stashes the rotated-out state in a :class:`PendingSubmap`, and the counter
read-back, the compaction, the device->host copy and the DAG build happen
at the map's next drain.  The weight clamp uses min (the intent), not the
reference's always-255 ``std::max`` (submap.hpp:92-93).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import MapConfig
from ..ops import codec, morton
from .dag import MAX_DEPTH, NodeLevels
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


# ---------------------------------------------------------------------------
# Deferred (stream-friendly) finalization
# ---------------------------------------------------------------------------

# per CUDA device: the side stream of the stubs' device->host copies
_COPY_STREAMS: dict = {}

_LOSSY = ("point_overflow", "sample_overflow", "block_overflow",
          "touched_overflow")


def _rotation_counters(state: ActiveMapState, cb: int):
    """Everything the host needs of a rotated-out map, in ONE tensor (one
    transfer): i32[9] = [n_blocks, live clusters, point / sample / block /
    touched overflow, origin_blocks x y z]."""
    count = _count_nonempty_clusters(state, cb)
    return torch.cat([
        torch.stack([state.n_blocks, count] +
                    [getattr(state, k) for k in _LOSSY]),
        state.origin_blocks])


@dataclasses.dataclass
class PendingSubmap:
    """A rotated-out active map awaiting host materialization.

    A rotation mid-stream must not stall the inserts: any read of the
    rotated-out state waits for every insert queued before it.  So
    :func:`start_finalize` only stashes the state in this stub; the counter
    read-back, the right-sized compaction and the transfer happen off the
    stream at the next drain (``save`` / ``stats`` / ``finalize_active``,
    or when ``MapConfig.max_pending_finalize`` stubs pile up).  Until then
    the stub keeps the whole pool (2 x block_capacity x 512 f32) alive in
    device memory, which ``max_pending_finalize`` bounds.

    The compacted buffer crosses to the host on a side stream that first
    waits for the stream it was built on, into pinned memory, and
    ``copy_done`` is recorded behind it: :meth:`host_buf` waits for that
    event before numpy reads the memory.  On the CPU it is the buffer
    itself.
    """
    buf: object                # device buffer (None for an empty map)
    n_pad: int
    cap: int
    count: int
    origin_blocks: np.ndarray | None
    positions: list
    anchor: object = None
    raw_state: object = None   # rotated-out ActiveMapState, on its device
    config: object = None      # MapConfig, to materialize off the stream
    host: object = None        # the buffer on the host, once copied
    copy_done: object = None   # CUDA event behind the copy

    def _materialize_device(self) -> None:
        """Counter read-back and right-sized device compaction; releases
        the stashed state."""
        if self.raw_state is None:
            return
        state, config = self.raw_state, self.config
        vals = _rotation_counters(state, config.block_capacity).cpu().numpy()
        n_blocks, count = int(vals[0]), int(vals[1])
        ovf = {k: int(v) for k, v in zip(_LOSSY, vals[2:6]) if int(v) > 0}
        if ovf:
            warnings.warn(
                f"map capacity overflow — dropped data: {ovf}; raise the "
                "corresponding MapConfig capacities (block_capacity/"
                "touched_capacity/max_points) or shrink the scan extent",
                RuntimeWarning, stacklevel=4)
        self.origin_blocks = vals[6:9].astype(np.int32)
        if n_blocks == 0 or count == 0:
            self.buf, self.count = None, 0
        else:
            self.n_pad = max(1, 1 << (n_blocks - 1).bit_length())
            self.cap = cap_bucket(count)
            self.count = count
            self.buf = _extract_clusters_compact(state, self.n_pad,
                                                 self.cap, config.sdf_trunc)
        self.raw_state = None          # release the pool

    def start_copies(self) -> None:
        self._materialize_device()
        if self.buf is None or self.host is not None:
            return
        if self.buf.device.type != "cuda":
            self.host = self.buf
            return
        dev = self.buf.device
        side = _COPY_STREAMS.get(dev)
        if side is None:
            side = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.host = torch.empty(self.buf.shape, dtype=self.buf.dtype,
                                pin_memory=True)
        with torch.cuda.stream(side):
            self.host.copy_(self.buf, non_blocking=True)
            self.copy_done = torch.cuda.Event()
            self.copy_done.record(side)

    def host_buf(self) -> np.ndarray:
        """The compacted buffer as numpy uint32, once its copy is done."""
        self.start_copies()
        if self.copy_done is not None:
            self.copy_done.synchronize()
        return self.host.numpy().astype(np.uint32)

    def finish(self, levels: NodeLevels, config: MapConfig) -> Submap:
        self._materialize_device()
        return finish_finalize(self, levels, config)


def start_finalize(state: ActiveMapState, config: MapConfig,
                   positions: list, anchor=None) -> PendingSubmap:
    """Begin finalizing the active map with no host read and no device
    work: stash the rotated-out state (see :class:`PendingSubmap`).  Even
    the compaction would need the counters to size its buffer, and reading
    them waits for every queued insert."""
    return PendingSubmap(None, 0, 0, -1, None, list(positions), anchor,
                         raw_state=state, config=config)


def finish_finalize(pending: PendingSubmap, levels: NodeLevels,
                    config: MapConfig) -> Submap:
    """Materialize a PendingSubmap into the DAG (host)."""
    if pending.buf is None:
        z = np.zeros(0, np.uint64)
        sm = build_submap(levels, z, z.copy(), z.copy(), pending.positions,
                          0)
    else:
        codes, words_t, words_w, n_vox = _unpack_cluster_buf(
            pending.host_buf(), pending.n_pad, pending.cap, pending.count,
            pending.origin_blocks, config)
        sm = build_submap(levels, codes, words_t, words_w,
                          pending.positions, n_vox)
        pending.buf = None
    sm.anchor = pending.anchor
    return sm


def _add_empty_chain(levels: NodeLevels) -> int:
    addr = levels.leaf_clusters.add_batch(
        np.array([0xFFFFFFFFFFFFFFFF], np.uint64))
    for depth in range(MAX_DEPTH - 1, -1, -1):
        kids = np.zeros((1, 8), np.uint32)
        kids[0, 0] = addr[0]
        addr = levels.nodes[depth].add_batch(kids)
    return int(addr[0])
