"""Submap finalization: active block pool -> compressed dual DAG — PyTorch
port of ``chad_tsdf_tpu/core/submap.py``.

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

A finish is the span ``chad.finalize`` (``utils/timing.py``), split into
``.counters`` (the counter read-back), ``.compact``, ``.d2h`` (the copy
and its wait), ``.unpack`` (:func:`_unpack_cluster_buf`) and ``.dag``
(:func:`build_submap`); a drain's compactions run before its finishes,
under whatever span is open then.

A Morton-sharded active map (``parallel/``) finalizes through
:func:`start_finalize_sharded` / :func:`finish_finalize_sharded`: each
shard's clusters are compacted as above, and a block that several shards
hold (a halo row deferred by routing, or a fallback's rows) is merged
exactly, by summing its raw rows before quantization.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import MapConfig
from ..ops import codec, morton
from ..utils import timing
from ..utils.timing import span
from .dag import MAX_DEPTH, NodeLevels
from .state import INT32_MAX, ActiveMapState, warn_on_overflow


@dataclasses.dataclass
class Submap:
    """Finalized submap: two DAG roots + trajectory (submap.hpp:108-110).

    ``levels``: the NodeLevels the roots index into when they are not the
    owning map's (a throwaway snapshot of the active map); None = the
    map's.  ``anchor``: (4, 4) world pose of the submap frame (first
    scanner position).  ``corrected``: a (4, 4) rigid correction that
    loop closure sets; the map applies it to the submap's voxels at
    mesh / query time (``TSDFMap._reanchor_codes``).  None = uncorrected.
    """
    root_addr_tsdf: int
    root_addr_weight: int
    positions: list
    n_clusters: int = 0
    n_voxels: int = 0
    levels: object = None
    anchor: object = None
    corrected: object = None


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
    z = np.zeros(0, np.uint64)
    with span("chad.finalize.counters"):
        n_blocks = timing.host_item(state.n_blocks)
        if n_blocks == 0:
            return z, z.copy(), z.copy(), 0
        n_pad = max(1, 1 << (n_blocks - 1).bit_length())
        count = timing.host_item(_count_nonempty_clusters(state, n_pad))
        if count == 0:
            return z, z.copy(), z.copy(), 0
    cap = cap_bucket(count)
    with span("chad.finalize.compact"):
        buf = _extract_clusters_compact(state, n_pad, cap, config.sdf_trunc)
    with span("chad.finalize.d2h"):
        buf = timing.to_host(buf).numpy().astype(np.uint32)
        origin = timing.to_host(state.origin_blocks).numpy()
    with span("chad.finalize.unpack"):
        return _unpack_cluster_buf(buf, n_pad, cap, count, origin, config)


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
    with span("chad.finalize"):
        timing.count("finishes")
        with span("chad.finalize.counters"):
            warn_on_overflow(state)
        codes, words_t, words_w, n_vox = extract_clusters(state, config)
        with span("chad.finalize.dag"):
            return build_submap(levels, codes, words_t, words_w, positions,
                                n_vox)


# ---------------------------------------------------------------------------
# Deferred (stream-friendly) finalization
# ---------------------------------------------------------------------------

# per CUDA device: the side stream of the stubs' device->host copies
_COPY_STREAMS: dict = {}

_LOSSY = ("point_overflow", "sample_overflow", "block_overflow",
          "touched_overflow")


def _warn_lossy(counts) -> None:
    """The drain's overflow warning for a rotated-out map's four lossy
    counters (host ints, in ``_LOSSY`` order)."""
    ovf = {k: int(v) for k, v in zip(_LOSSY, counts) if int(v) > 0}
    if ovf:
        warnings.warn(
            f"map capacity overflow — dropped data: {ovf}; raise the "
            "corresponding MapConfig capacities (block_capacity/"
            "touched_capacity/max_points) or shrink the scan extent",
            RuntimeWarning, stacklevel=5)


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
    device memory, which ``max_pending_finalize`` and the map's byte
    bound (``core/map.py`` ``_MAX_PENDING_BYTES``) limit.

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
        with span("chad.finalize.counters"):
            vals = timing.to_host(_rotation_counters(
                state, config.block_capacity)).numpy()
            n_blocks, count = int(vals[0]), int(vals[1])
            _warn_lossy(vals[2:6])
        self.origin_blocks = vals[6:9].astype(np.int32)
        if n_blocks == 0 or count == 0:
            self.buf, self.count = None, 0
        else:
            self.n_pad = max(1, 1 << (n_blocks - 1).bit_length())
            self.cap = cap_bucket(count)
            self.count = count
            with span("chad.finalize.compact"):
                self.buf = _extract_clusters_compact(
                    state, self.n_pad, self.cap, config.sdf_trunc)
        self.raw_state = None          # release the pool

    @property
    def pinned_bytes(self) -> int:
        """Device bytes of the pool this stub keeps alive (0 once
        materialized)."""
        if self.raw_state is None:
            return 0
        return (self.raw_state.pool_sd.nbytes +
                self.raw_state.pool_w.nbytes)

    def warn_undrained(self) -> None:
        """The drain's overflow warning, for a stub that will never be
        drained (its map is going away): reads the four lossy counters of
        the stashed state, nothing else."""
        if self.raw_state is not None:
            _warn_lossy(timing.to_host(torch.stack(
                [getattr(self.raw_state, k) for k in _LOSSY])).tolist())

    def start_copies(self) -> None:
        self._materialize_device()
        if self.buf is None or self.host is not None:
            return
        timing.count("d2h_bytes", self.buf.nbytes)
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
        with span("chad.finalize.d2h"):
            self.start_copies()
            timing.wait(self.copy_done)
            return self.host.numpy().astype(np.uint32)

    def finish(self, levels: NodeLevels, config: MapConfig) -> Submap:
        with span("chad.finalize"):
            timing.count("finishes")
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
        with span("chad.finalize.dag"):
            sm = build_submap(levels, z, z.copy(), z.copy(),
                              pending.positions, 0)
    else:
        host = pending.host_buf()
        with span("chad.finalize.unpack"):
            codes, words_t, words_w, n_vox = _unpack_cluster_buf(
                host, pending.n_pad, pending.cap, pending.count,
                pending.origin_blocks, config)
        with span("chad.finalize.dag"):
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


# ---------------------------------------------------------------------------
# Sharded finalization (parallel/)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sum_duplicate_rows(keys: np.ndarray, *rows: np.ndarray):
    """Sort ``keys`` (stable) and sum the rows of equal keys, each of
    ``rows`` (n, ...) in the sorted order: the exact merge of block rows
    that two pools hold for one block.  Returns (unique keys, summed rows
    ...)."""
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    rows = [r[order] for r in rows]
    if keys.size:
        starts = np.flatnonzero(
            np.concatenate([[True], keys[1:] != keys[:-1]]))
        keys = keys[starts]
        rows = [np.add.reduceat(r, starts, axis=0) for r in rows]
    return (keys, *rows)


def _quantize_pack_rows(codes: np.ndarray, sd: np.ndarray, w: np.ndarray,
                        config: MapConfig):
    """(world block codes u64[n], raw (sd sum, weight) rows (n, 512)) ->
    sorted unique quantized clusters (codes, tsdf words, weight words).
    Duplicate block codes merge EXACTLY: their rows sum before
    quantization, as in one pool that saw all the samples.  Host-side; the
    quantization is :func:`_extract_blocks`'."""
    ucodes, sd_m, w_m = sum_duplicate_rows(codes, sd, w)

    occupied = w_m > 0
    mean = sd_m / np.maximum(w_m, np.float32(1.0))
    q_sd = np.where(occupied,
                    codec.encode_sd(torch.from_numpy(mean),
                                    config.sdf_trunc).numpy(),
                    np.uint8(codec.EMPTY)).astype(np.uint8)
    q_w = np.where(occupied, codec.encode_weight(torch.from_numpy(w_m))
                   .numpy(), np.uint8(codec.EMPTY)).astype(np.uint8)
    nonempty = occupied.reshape(-1, 64, 8).any(-1).reshape(-1)
    cluster_codes = (ucodes[:, None] << np.uint64(6)) | \
        np.arange(64, dtype=np.uint64)[None, :]
    words_t = codec.pack_cluster_u64(q_sd.reshape(-1, 8)[nonempty])
    words_w = codec.pack_cluster_u64(q_w.reshape(-1, 8)[nonempty])
    return cluster_codes.reshape(-1)[nonempty], words_t, words_w


def _count_voxels(words_t: np.ndarray) -> int:
    shifts = (np.uint64(8) * np.arange(8, dtype=np.uint64))[None, :]
    return int((((words_t[:, None] >> shifts) & np.uint64(0xFF))
                != np.uint64(codec.EMPTY)).sum())


def _pow2(n: int) -> int:
    return max(1, 1 << (max(n, 1) - 1).bit_length())


def _fin_counters(state: ActiveMapState, cb: int):
    """i32[10] = [n_blocks, live clusters, point / sample / block / touched
    / tile overflow, origin_blocks x y z]: :func:`_rotation_counters` with
    the tile counter."""
    c = _rotation_counters(state, cb)
    return torch.cat([c[:6], state.tile_overflow.reshape(1), c[6:]])


def _local_gather(tensors) -> np.ndarray:
    """Every shard's value, stacked in shard order on the host, when the
    states at hand are all the shards."""
    return np.stack([t.cpu().numpy() for t in tensors])


@dataclasses.dataclass
class PendingShardedSubmap:
    """A Morton-sharded active map's compacted clusters, on the host,
    awaiting the DAG build.

    ``shards``: per live shard (uint32 buffer of
    :func:`_extract_clusters_compact`, n_pad, cap, count).  ``wb_dup``:
    world block codes held by more than one shard; their clusters are
    dropped from every shard's buffer at :meth:`finish` and replaced by
    ``dup_clusters``, merged exactly from the raw rows.
    """
    shards: list
    wb_dup: np.ndarray
    dup_clusters: tuple | None
    origin_blocks: np.ndarray
    positions: list
    anchor: object = None

    def finish(self, levels: NodeLevels, config: MapConfig) -> Submap:
        return finish_finalize_sharded(self, levels, config)


def start_finalize_sharded(states: list, config: MapConfig,
                           positions: list, anchor=None,
                           gather=None) -> PendingShardedSubmap:
    """Finalize a sharded active map up to the host DAG build (a drain
    point: it reads the device).

    Never gathers whole pools: one counter vector per shard; one compacted
    cluster buffer per shard at a size common to all (the largest shard's
    buckets); and, only when shards share a block key, those few blocks'
    raw rows, summed over the shards and quantized here.  ``gather``
    stacks one equal-shape tensor per state in ``states`` into a host
    array over EVERY shard of the mesh (``ShardMesh.gather``); by default
    ``states`` are all the shards.
    """
    gather = gather or _local_gather
    cb = config.block_capacity
    cnt = gather([_fin_counters(st, cb) for st in states])
    origin = cnt[0, 7:10].astype(np.int32)
    nbs, counts = cnt[:, 0], cnt[:, 1]
    _warn_lossy(cnt[:, 2:6].sum(axis=0))
    live = [i for i in range(len(nbs)) if nbs[i] > 0 and counts[i] > 0]
    if not live:
        return PendingShardedSubmap([], np.zeros(0, np.uint64), None, origin,
                                    list(positions), anchor)

    n_pad = _pow2(int(nbs.max()))
    cap = cap_bucket(int(counts.max()))
    bufs = gather([_extract_clusters_compact(st, n_pad, cap, config.sdf_trunc)
                   for st in states]).astype(np.uint32)

    wb_dup = np.zeros(0, np.uint64)
    dup_clusters = None
    if len(live) > 1:
        keys = gather([st.dir_keys[:n_pad] for st in states])
        all_keys = np.concatenate([keys[i, :nbs[i]] for i in live])
        uk, kcounts = np.unique(all_keys, return_counts=True)
        dup = uk[kcounts > 1]
        if dup.size:
            wb_dup = morton.np_block_key_to_world63(dup, origin,
                                                    config.block_bits)
            dupk = np.full(_pow2(int(dup.size)), INT32_MAX, np.int32)
            dupk[:dup.size] = dup
            rows = [_dup_rows(st, torch.from_numpy(dupk).to(st.device), cb)
                    for st in states]
            sd = gather([r[0] for r in rows]).sum(axis=0)[:dup.size]
            w = gather([r[1] for r in rows]).sum(axis=0)[:dup.size]
            dup_clusters = _quantize_pack_rows(wb_dup, sd, w, config)

    shards = [(bufs[i], n_pad, cap, int(counts[i])) for i in live]
    return PendingShardedSubmap(shards, wb_dup, dup_clusters, origin,
                                list(positions), anchor)


def _dup_rows(state: ActiveMapState, dupk, cb: int):
    """The raw (sd, w) rows of the blocks ``dupk`` (INT32_MAX = none) in
    one state, zero where the state lacks the block."""
    pos = torch.clamp(torch.searchsorted(state.dir_keys, dupk), max=cb - 1)
    found = (state.dir_keys[pos] == dupk) & (dupk != INT32_MAX)
    slots = state.dir_slots[pos].long()
    return (torch.where(found[:, None], state.pool_sd[slots], 0.0),
            torch.where(found[:, None], state.pool_w[slots], 0.0))


def finish_finalize_sharded(pending: PendingShardedSubmap,
                            levels: NodeLevels,
                            config: MapConfig) -> Submap:
    """Materialize a PendingShardedSubmap into the DAG (host)."""
    codes_l, wt_l, ww_l = [], [], []
    for buf, n_pad, cap, count in pending.shards:
        codes, wt, ww, _ = _unpack_cluster_buf(buf, n_pad, cap, count,
                                               pending.origin_blocks, config)
        if pending.wb_dup.size:
            keep = ~np.isin(codes >> np.uint64(6), pending.wb_dup)
            codes, wt, ww = codes[keep], wt[keep], ww[keep]
        codes_l.append(codes)
        wt_l.append(wt)
        ww_l.append(ww)
    if pending.dup_clusters is not None:
        for lst, a in zip((codes_l, wt_l, ww_l), pending.dup_clusters):
            lst.append(a)
    if not codes_l:
        z = np.zeros(0, np.uint64)
        sm = build_submap(levels, z, z.copy(), z.copy(), pending.positions,
                          0)
    else:
        codes = np.concatenate(codes_l)
        order = np.argsort(codes, kind="stable")
        words_t = np.concatenate(wt_l)[order]
        sm = build_submap(levels, codes[order], words_t,
                          np.concatenate(ww_l)[order], pending.positions,
                          _count_voxels(words_t))
    sm.anchor = pending.anchor
    return sm


def finalize_sharded(states: list, levels: NodeLevels, config: MapConfig,
                     positions: list) -> Submap:
    """Finalize a Morton-sharded active map (per-shard states, all the
    shards) into one Submap, synchronously."""
    return finish_finalize_sharded(
        start_finalize_sharded(states, config, positions), levels, config)
