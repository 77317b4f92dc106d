"""Morton-range sharding over a mesh of shards — PyTorch port of
``chad_tsdf_tpu/parallel/sharded.py``.

The map's block-key space is cut into contiguous Morton ranges, one per
shard, so each shard owns a compact region of space.  Design (the JAX
package's v2, block-row halo exchange):

* Points are data-parallel over the shards: the host gives each shard the
  points of the blocks it owns (``owner_split``), Morton-sorted.
* Each shard runs the FULL single-device insert (K2 and K1, or ``seg`` on a
  sparse scan) into a small per-step scratch pool; its occupied rows are
  the shard's partial sums for this batch, one row per distinct block.
* Halo exchange: scratch rows whose block lies outside the shard's range
  go to their owner in one all-to-all of fixed-size buffers; the owner
  merges its own and the received rows into its persistent pool through
  ``update_pool_tiled`` (K3).  Rows beyond the per-pair ``halo_capacity``
  stay in the sender's pool under their own key, counted in
  ``route_overflow``; finalize merges such duplicates exactly, so routing
  never loses a sample.

What takes the place of ``jax.sharding.Mesh`` + ``shard_map``:
:class:`ShardMesh` lists the shards this process runs (``devices``, one
``torch.device`` each, several may share a card) and, across processes, a
``torch.distributed`` process group.  The shard body runs once per local
shard, in shard order.  Within one process the all-to-all is an index
exchange of the send buffers (``recv[d][s] = send[s][d]``), a psum a sum;
across processes they are ``all_to_all_single``, ``all_reduce`` and
``all_gather`` of the same fixed-size buffers, so no size is exchanged and
nothing is read on the host.  A CUDA mesh needs the ``nccl`` backend and a
CPU mesh ``gloo``.

Where the JAX step branches on a device value, the port does not read it:
extraction, routing and the merge run at the full scratch capacity (dead
rows are keyed INT32_MAX and K3 leaves them unwritten; the JAX package's
``lax.switch`` on a ``pmax`` of the live count picked a smaller bucket, a
TPU measurement), and a fused scratch insert's fallback is deferred as in
``core/integrate.py`` and settled into the shard's PERSISTENT pool, where
its rows are local rows under their own key, merged exactly at finalize.

The JAX package's jit caches (``sharded_map._STEP_CACHE``,
``_GLOBAL_STEP_CACHE``) have no counterpart: nothing here compiles.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..config import MapConfig
from ..core import carve as carve_mod
from ..core import integrate, submap as submap_mod
from ..core.state import (_FIELDS, INT32_MAX, ActiveMapState, create_state,
                          resolve_device, state_from_numpy, state_to_numpy)
from ..ops import accumulate, morton


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The shards of a 1-D mesh that this process runs.

    ``devices``: one ``torch.device`` per local shard, in shard order;
    ``first``: the global index of the first local shard; ``n_shards``:
    shards over all processes; ``group``: the ``torch.distributed`` process
    group joining the processes, or None within one process.
    """
    devices: tuple
    n_shards: int
    first: int = 0
    group: object = None
    axis: str = "shard"

    def _stack(self, vals) -> torch.Tensor:
        return torch.stack([v.to(self.devices[0]) for v in vals])

    def exchange(self, sends: list) -> list:
        """All-to-all: ``sends[i]`` is local shard i's (n_shards, ...)
        buffer, row d for shard d; returns each local shard's
        (n_shards, ...) buffer, row s from shard s, on its device."""
        n = self.n_shards
        if self.group is None:
            return [torch.stack([s[d].to(dev) for s in sends])
                    for d, dev in enumerate(self.devices)]
        import torch.distributed as dist
        n_loc = len(self.devices)
        rest = sends[0].shape[1:]
        # x[q, i, j] = local shard i's row for shard q * n_loc + j
        x = self._stack(sends).reshape(n_loc, n // n_loc, n_loc, *rest)
        x = x.transpose(0, 1).contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=self.group)
        # y[p, i, j] = shard (p * n_loc + i)'s row for local shard j
        return [y[:, :, j].reshape(n, *rest).to(dev)
                for j, dev in enumerate(self.devices)]

    def psum(self, vals: list) -> torch.Tensor:
        """The sum over every shard of one equal-shape tensor per local
        shard, on the first local device."""
        total = vals[0].to(self.devices[0])
        for v in vals[1:]:
            total = total + v.to(self.devices[0])
        if self.group is not None:
            import torch.distributed as dist
            total = total.clone()
            dist.all_reduce(total, group=self.group)
        return total

    def all_gather(self, vals: list) -> torch.Tensor:
        """Every shard's value of one equal-shape tensor per local shard,
        stacked in shard order on the first local device (no host read)."""
        local = self._stack(vals)
        if self.group is None:
            return local
        import torch.distributed as dist
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts)

    def gather(self, vals: list) -> np.ndarray:
        """:meth:`all_gather`, read back to the host (a drain point)."""
        return self.all_gather(vals).cpu().numpy()


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device="cuda") -> ShardMesh:
    """A 1-D mesh of ``n_devices`` shards.

    Within one process the shards take the visible cards in turn (a
    ``device`` with an index puts them all on that card), so ``make_mesh(4)``
    on a one-card machine runs four shards on ``cuda:0``; ``None`` is one
    shard per card (one on the CPU).  When ``torch.distributed`` is
    initialized (``parallel.distributed.initialize``) the shards are split
    evenly over its processes, each process's on its own card
    (``LOCAL_RANK``), and the exchanges go through the process group: a CUDA
    mesh needs the ``nccl`` backend and a CPU mesh ``gloo``.
    """
    import torch.distributed as dist
    dev = resolve_device(device)
    group = dist.group.WORLD if (dist.is_available() and
                                 dist.is_initialized()) else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
    else:
        n_cards = 1
    if n_devices is None:
        n_devices = world * (n_cards if world == 1 else 1)
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} shards do not split over {world} "
                         "processes")
    n_loc = n_devices // world
    if group is not None:
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(f"a {dev.type} mesh needs the {want} backend, "
                               f"not {dist.get_backend()}")
        if dev.type == "cuda" and dev.index is None:
            import os
            dev = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count())))
        devices = (dev,) * n_loc
    elif dev.type == "cuda" and dev.index is None:
        devices = tuple(torch.device("cuda", i % n_cards)
                        for i in range(n_loc))
    else:
        devices = (dev,) * n_loc
    return ShardMesh(devices, n_devices, rank * n_loc, group, axis)


def key_bounds(n_shards: int, config: MapConfig) -> np.ndarray:
    """Static equal partition of the block-key space into owner ranges:
    shard d owns ``bounds[d] .. bounds[d + 1]``; n + 1 entries."""
    space = 1 << (3 * config.block_bits)
    b = np.linspace(0, space, n_shards + 1).astype(np.int64)
    return b.astype(np.int32)


def scratch_config(config: MapConfig) -> MapConfig:
    """Per-step scratch-pool config: the same pipeline with a pool of
    ``touched_capacity`` usable rows (the distinct blocks one insert can
    touch) plus the reserved group."""
    scb = config.touched_capacity + accumulate.GROUP
    return dataclasses.replace(config, block_capacity=scb)


def default_halo_capacity(n_shards: int, config: MapConfig) -> int:
    """Per-(src, dst) row capacity of the halo exchange: a thirty-second
    of the uniform ``touched_capacity`` share, at least 64 rows, a
    multiple of 8 (the JAX package's value).  Rows beyond it defer locally
    (``route_overflow``), so a small capacity costs deduplication at
    finalize, not data."""
    cap = config.touched_capacity // (32 * max(n_shards, 1))
    return max(64, -(-cap // 8) * 8)


def create_sharded_state(config: MapConfig, mesh: ShardMesh,
                         origin_blocks=None) -> list:
    """One empty ``ActiveMapState`` per local shard, on its device."""
    return [create_state(config, origin_blocks, dev) for dev in mesh.devices]


def _route_block_rows(keys, sd_rows, w_rows, bounds, me: int,
                      capacity: int):
    """One shard's send buffers for the halo exchange.

    ``keys`` must be ascending (INT32_MAX = dead) with ``sd_rows`` /
    ``w_rows`` the matching (R, 512) rows; ``bounds`` the (n + 1,) owner
    ranges on the same device.  Rows owned by shard ``me``, and rows
    beyond ``capacity`` in another shard's segment, stay local.  Returns
    (local_keys (R,), send_keys (n, c), send_sd (n, c, 512), send_w,
    deferred, sent): ``deferred`` counts rows kept local only because a
    segment exceeded the capacity, ``sent`` the rows that travel."""
    r = keys.shape[0]
    n = bounds.shape[0] - 1
    c = capacity
    dev = keys.device

    seg = torch.searchsorted(keys, bounds).to(torch.int32)     # (n + 1,)
    starts = seg[:-1]
    lens = seg[1:] - starts
    dst = torch.arange(n, dtype=torch.int32, device=dev)
    valid = keys != INT32_MAX
    j = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    idx = torch.clamp(starts[:, None] + j, max=r - 1).long()
    send_ok = (j < lens[:, None]) & (dst[:, None] != me) & valid[idx]

    send_k = torch.where(send_ok, keys[idx], INT32_MAX)
    send_sd = torch.where(send_ok[:, :, None], sd_rows[idx], 0.0)
    send_w = torch.where(send_ok[:, :, None], w_rows[idx], 0.0)

    row_dst = torch.clamp(
        torch.searchsorted(bounds, keys, right=True).to(torch.int32) - 1,
        0, n - 1)
    pos_in_seg = torch.arange(r, dtype=torch.int32, device=dev) - \
        starts[row_dst.long()]
    remote = valid & (row_dst != me)
    sent = remote & (pos_in_seg < c)
    deferred = (remote & (pos_in_seg >= c)).sum(dtype=torch.int32)
    local_keys = torch.where(valid & ~sent, keys, INT32_MAX)
    return (local_keys, send_k, send_sd, send_w, deferred,
            sent.sum(dtype=torch.int32))


def global_shard_array(host_value: np.ndarray, mesh: ShardMesh) -> list:
    """This process's local shards' rows of a host array split evenly over
    the mesh's shards along its first axis (every process passes the same
    ``host_value``)."""
    rows = host_value.shape[0] // mesh.n_shards
    return [host_value[(mesh.first + i) * rows:(mesh.first + i + 1) * rows]
            for i in range(len(mesh.devices))]


def _psum_metrics(mesh: ShardMesh, per_shard: list) -> dict:
    """Sum per-shard dicts of int32 device scalars over the mesh in one
    reduction."""
    names = list(per_shard[0])
    tot = mesh.psum([torch.stack([d[k].to(torch.int32) for k in names])
                     for d in per_shard])
    return {k: tot[i] for i, k in enumerate(names)}


def make_sharded_insert(config: MapConfig, mesh: ShardMesh,
                        halo_capacity: int | None = None,
                        force_generic: bool = False):
    """The sharded insert step.

    Returns ``(step, halo_capacity)`` where ``step(state_stack, points,
    n_points, position, bounds) -> (state_stack, metrics, tails)``:
    ``state_stack`` is the list of local shards' states (updated in place,
    as the JAX step donates them); ``points`` the host (n_shards * B, 3)
    split, f32 or, under ``packed_ingest``, i16 from ``pack_points``;
    ``n_points`` host i32 (n_shards,); ``position`` host f32 (3,);
    ``bounds`` host i32 (n_shards + 1,), the ownership partition.
    ``metrics`` are device scalars summed over the shards; ``tails`` one
    ``FallbackTail`` or None per local shard, to be settled
    (:func:`settle_stack`) before anything else touches the states.

    ``route_overflow`` counts halo rows deferred to the local pool because
    the per-pair capacity was hit; ``route_sent`` the rows exchanged.  At
    one shard (unless ``force_generic``) the step IS the single-device
    insert: no scratch pool, no routing, no second merge.
    """
    n_shards = mesh.n_shards
    if halo_capacity is None:
        halo_capacity = default_halo_capacity(n_shards, config)
    single = n_shards == 1 and not force_generic
    scfg = scratch_config(config)
    # the local + received row stream touches at most this many blocks:
    # exact headroom, so the merge plan never drops one
    merge_cfg = dataclasses.replace(
        config, touched_capacity=config.touched_capacity +
        n_shards * halo_capacity)

    def upload(state, pts, position):
        dev = state.device
        pos_t = torch.from_numpy(np.ascontiguousarray(position)).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        if config.packed_ingest:
            p = integrate.unpack_points(p, pos_t, config)
        return p, pos_t

    def step(state_stack, points, n_points, position, bounds):
        pts_l = global_shard_array(points, mesh)
        n_l = global_shard_array(np.asarray(n_points), mesh)
        position = np.asarray(position, np.float32)
        out, metrics, tails = [], [], []
        if single:
            (state,) = state_stack
            p, pos_t = upload(state, pts_l[0], position)
            state, m, tail = integrate.insert_step_deferred(
                state, p, int(n_l[0][0]), pos_t, config)
            zero = torch.zeros((), dtype=torch.int32, device=state.device)
            m.update(route_overflow=zero, route_sent=zero)
            return [state], _psum_metrics(mesh, [m]), [tail]

        # 1. the full single-device insert into a fresh scratch pool,
        # then the rows to send
        scratch_l, routed = [], []
        for i, state in enumerate(state_stack):
            p, pos_t = upload(state, pts_l[i], position)
            scratch = dataclasses.replace(
                create_state(scfg, None, state.device),
                origin_blocks=state.origin_blocks)
            scratch, sm, tail = integrate.insert_step_deferred(
                scratch, p, int(n_l[i][0]), pos_t, scfg)
            if tail is not None:
                # settled into the persistent pool (module docstring)
                tail.config = config
            tails.append(tail)
            slots = scratch.dir_slots.long()
            sd_rows = scratch.pool_sd[slots]
            w_rows = scratch.pool_w[slots]
            b = torch.from_numpy(np.asarray(bounds, np.int32)).to(
                state.device)
            routed.append((sd_rows, w_rows) + _route_block_rows(
                scratch.dir_keys, sd_rows, w_rows, b, mesh.first + i,
                halo_capacity))
            scratch_l.append((scratch, sm["n_valid_samples"]))

        # 2. the halo exchange
        recv_k = mesh.exchange([r[3] for r in routed])
        recv_sd = mesh.exchange([r[4] for r in routed])
        recv_w = mesh.exchange([r[5] for r in routed])

        # 3. local + received rows merged into the persistent pool (K3)
        for i, state in enumerate(state_stack):
            sd_rows, w_rows, local_k, _, _, _, deferred, sent = routed[i]
            scratch, n_valid = scratch_l[i]
            pkeys = torch.cat([local_k, recv_k[i].reshape(-1)])
            psd = torch.cat([sd_rows, recv_sd[i].reshape(-1, 512)])
            pw = torch.cat([w_rows, recv_w[i].reshape(-1, 512)])
            state, m = integrate.update_pool_tiled(
                state, pkeys.reshape(-1, 1), psd, pw, scratch.tile_overflow,
                n_valid, scratch.sample_overflow, scratch.point_overflow,
                merge_cfg)
            # the scratch's capacity overflows are real: carry them over
            state = dataclasses.replace(
                state,
                block_overflow=state.block_overflow + scratch.block_overflow,
                touched_overflow=(state.touched_overflow +
                                  scratch.touched_overflow))
            m.update(route_overflow=deferred, route_sent=sent)
            out.append(state)
            metrics.append(m)
        return out, _psum_metrics(mesh, metrics), tails

    return step, halo_capacity


def settle_stack(state_stack: list, tails: list, mesh: ShardMesh):
    """Settle each local shard's ``FallbackTail`` (``integrate.settle``)
    into its persistent pool.  Returns (state_stack, the blocks the
    fallbacks allocated as {"n_new_blocks", "n_blocks"} device scalars
    summed over the mesh)."""
    out, deltas = [], []
    for state, tail in zip(state_stack, tails):
        zero = torch.zeros((), dtype=torch.int32, device=state.device)
        d = {"n_new_blocks": zero, "n_blocks": zero}
        if tail is not None:
            state = integrate.settle(tail, state, d)
        out.append(state)
        deltas.append(torch.stack([d["n_new_blocks"], d["n_blocks"]]))
    tot = mesh.psum(deltas)
    return out, {"n_new_blocks": tot[0], "n_blocks": tot[1]}


def make_sharded_carve(config: MapConfig, mesh: ShardMesh):
    """The sharded space-carving step (``core/carve.py`` semantics).

    Every shard sees the whole scan and computes the same free-space
    entries (once per distinct device); each looks the entries' blocks up
    in its own directory (erosion only: nothing is allocated).  A
    sample's evidence is applied by ONE shard: the owner of its block if
    it holds the block, else the lowest-index shard that holds it (a
    deferred halo row or a fallback's row); it is dropped only when no
    shard holds the block.  Carving is additive, so the result equals the
    single-device carve of the merged map.  (The JAX package applies it on
    every holder, twice for a block its owner and a deferrer both hold,
    and its dropped count can go negative; the port repairs that.)  The
    blocks past the touched capacity are lost, as on one device: every
    shard ranks the same entries against the same capacity, and shard 0
    counts them in its ``touched_overflow``, their samples left out
    of ``n_carve_dropped``.

    Returns ``step(state_stack, points, n_points, position, bounds) ->
    (state_stack, metrics)``: ``points`` the whole (padded) host scan, f32
    or the packed i16 of the insert; ``bounds`` the insert's ownership
    partition.
    """
    def step(state_stack, points, n_points, position, bounds):
        position = np.asarray(position, np.float32)
        entries = {}
        looked = []
        for state in state_stack:
            dev = state.device
            if dev not in entries:
                pos_t = torch.from_numpy(position).to(dev)
                p = torch.from_numpy(np.ascontiguousarray(points)).to(dev)
                if config.packed_ingest:
                    p = integrate.unpack_points(p, pos_t, config)
                entries[dev] = carve_mod.carve_entries(
                    p, n_points, pos_t, state.origin_blocks, config)
            looked.append(carve_mod.lookup_blocks(state, entries[dev][0],
                                                  config))
        # (n_shards, t_cap): which shards hold each touched block
        holders = mesh.all_gather([lk[2].to(torch.int32) for lk in looked])
        out, hits = [], []
        for i, state in enumerate(state_stack):
            dev = state.device
            flags, tb_keys, found, slots, _, _ = looked[i]
            h = holders.to(dev)
            b = torch.from_numpy(np.asarray(bounds, np.int32)).to(dev)
            owner = torch.clamp(
                torch.searchsorted(b, tb_keys, right=True) - 1, 0,
                mesh.n_shards - 1)
            owner_holds = h.gather(0, owner[None]).squeeze(0) != 0
            first_holder = torch.argmax(h, dim=0)
            applier = torch.where(owner_holds, owner, first_holder)
            apply = found & (applier == mesh.first + i)
            e_b, e_o, e_c, n_valid, _ = entries[dev]
            state, m = carve_mod.apply_entries(
                state, e_b, e_o, e_c, n_valid, flags, apply, slots, config)
            out.append(state)
            hits.append(torch.stack([m["n_carve_samples"],
                                     m["n_carved_voxels"]]))
        tot = mesh.psum(hits)
        _, _, _, n_valid, e_end = entries[state_stack[0].device]
        first_lost, overflow = looked[0][4:]
        lost = carve_mod.lost_samples(e_end, n_valid, first_lost)
        if mesh.first == 0:
            out[0] = dataclasses.replace(
                out[0], touched_overflow=out[0].touched_overflow + overflow)
        return out, {"n_carve_samples": tot[0], "n_carved_voxels": tot[1],
                     "n_carve_dropped": (n_valid - lost).to(tot.device)
                     - tot[0]}

    return step


def point_block_keys(points: np.ndarray, origin_blocks: np.ndarray,
                     config: MapConfig) -> np.ndarray:
    """Host-side local block key per point, the mapping of
    ``core.integrate.point_keys_soa`` (out-of-extent points clamp; the
    step counts them as point_overflow)."""
    vox = np.floor(points.astype(np.float64) /
                   config.sdf_res).astype(np.int64)
    extent = config.blocks_per_axis * 8
    loc = np.clip(vox - np.asarray(origin_blocks, np.int64) * 8, 0,
                  extent - 1)
    blk = (loc >> 3).astype(np.int32)
    return np.asarray(morton.encode_block(blk[:, 0], blk[:, 1], blk[:, 2]))


def adaptive_bounds(points: np.ndarray, origin_blocks, n_shards: int,
                    config: MapConfig) -> np.ndarray:
    """Occupancy-adaptive ownership partition: the OBSERVED block keys cut
    into equal-count ranges, so the halo shrinks to the truncation band
    around the n - 1 cut keys (a scan occupies a tiny part of the 2^30 key
    space, so :func:`key_bounds` puts nearly all of it in one range)."""
    keys = np.sort(point_block_keys(points, origin_blocks, config))
    if keys.size == 0:
        return key_bounds(n_shards, config)
    cuts = keys[np.minimum((np.arange(1, n_shards) * keys.size) //
                           n_shards, keys.size - 1)]
    space = 1 << (3 * config.block_bits)
    b = np.concatenate([[0], cuts.astype(np.int64), [space]])
    return np.maximum.accumulate(b).astype(np.int32)


def owner_split(points: np.ndarray, bounds: np.ndarray,
                origin_blocks, config: MapConfig):
    """Split a scan by OWNERSHIP under ``bounds``, each chunk
    Morton-sorted: every point integrates on the shard that owns its
    block, so only the truncation band crosses a boundary.  Returns a list
    of (count_i, 3) arrays."""
    pts = np.asarray(points, np.float32)
    n_shards = bounds.shape[0] - 1
    if len(pts) == 0:
        return [pts[:0] for _ in range(n_shards)]
    keys = point_block_keys(pts, origin_blocks, config)
    owner = np.clip(np.searchsorted(bounds, keys, side="right") - 1,
                    0, n_shards - 1)
    vox = np.floor(pts.astype(np.float64) / config.sdf_res).astype(np.int64)
    codes = morton.np_encode63(vox)
    order = np.lexsort((codes, owner))
    pts_s, owner_s = pts[order], owner[order]
    starts = np.searchsorted(owner_s, np.arange(n_shards + 1))
    return [pts_s[starts[i]:starts[i + 1]] for i in range(n_shards)]


def rebalance_chunks(chunks: list, cap: int) -> list:
    """Cap each chunk at ``cap`` points, spilling the excess into chunks
    with room.  Spilled points integrate on a non-owner shard and their
    rows travel back through the halo exchange (or defer): skew costs
    traffic, never data."""
    if all(len(c) <= cap for c in chunks):
        return chunks
    excess = [c[cap:] for c in chunks if len(c) > cap]
    chunks = [c[:cap] for c in chunks]
    pool = np.concatenate(excess)
    out = []
    k = 0
    for c in chunks:
        spare = cap - len(c)
        if spare > 0 and k < len(pool):
            take = pool[k:k + spare]
            c = np.concatenate([c, take])
            k += len(take)
        out.append(c)
    if k != len(pool):
        raise ValueError("total points exceed n_shards * cap")
    return out


def morton_split(points: np.ndarray, n_shards: int, sdf_res: float):
    """Morton-contiguous split of a scan: sorted by 63-bit voxel code and
    cut into ``n_shards`` equal-count chunks.  Returns a list of (count_i,
    3) arrays."""
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        return [pts[:0] for _ in range(n_shards)]
    vox = np.floor(pts.astype(np.float64) / sdf_res).astype(np.int64)
    codes = morton.np_encode63(vox)
    order = np.argsort(codes, kind="stable")
    return np.array_split(pts[order], n_shards)


def _occupied_rows(st):
    """(keys, sd rows, w rows) of a state's allocated blocks in directory
    order, on the host; a device state is indexed before the copy."""
    nb = int(st.n_blocks)
    if torch.is_tensor(st.pool_sd):
        slots = st.dir_slots[:nb].long()
        return (st.dir_keys[:nb].cpu().numpy(),
                st.pool_sd[slots].cpu().numpy(),
                st.pool_w[slots].cpu().numpy())
    slots = np.asarray(st.dir_slots)[:nb]
    return (np.asarray(st.dir_keys)[:nb], np.asarray(st.pool_sd)[slots],
            np.asarray(st.pool_w)[slots])


def merge_states_host(states: list, config: MapConfig,
                      device="cuda") -> ActiveMapState:
    """Merge per-shard states (port states, or the host states of
    :func:`gather_states_global` / the JAX package) into one
    single-device-equivalent state on ``device``, exactly: duplicate block
    keys sum their rows.  A sharded map checkpoints as the merged state and
    resumes on any shard count."""
    keys_l, sd_l, w_l = zip(*[_occupied_rows(st) for st in states])
    keys, sd, w = submap_mod.sum_duplicate_rows(
        np.concatenate(keys_l), np.concatenate(sd_l), np.concatenate(w_l))

    cb = config.block_capacity
    u = keys.shape[0]
    if u > cb - accumulate.GROUP:
        raise ValueError(f"merged map has {u} blocks > usable "
                         f"{cb - accumulate.GROUP}; raise block_capacity to "
                         "merge this sharded state")
    out = {"dir_keys": np.full(cb, INT32_MAX, np.int32),
           "dir_slots": np.zeros(cb, np.int32),
           "n_blocks": np.int32(u),
           "pool_sd": np.zeros((cb, 512), np.float32),
           "pool_w": np.zeros((cb, 512), np.float32),
           "origin_blocks": submap_mod._host(
               states[0].origin_blocks).astype(np.int32)}
    out["dir_keys"][:u] = keys
    out["dir_slots"][:u] = np.arange(u, dtype=np.int32)
    out["pool_sd"][:u] = sd
    out["pool_w"][:u] = w
    for name in _FIELDS[6:]:
        out[name] = np.int32(sum(int(getattr(st, name)) for st in states))
    return state_from_numpy(out, device)


def shard_state_host(state, mesh: ShardMesh,
                     config: MapConfig) -> list:
    """Partition a single-device state (port or host arrays) onto the mesh
    by the static Morton ranges of :func:`key_bounds`, the inverse of
    :func:`merge_states_host`; the counters' totals go to shard 0.
    Returns the local shards' states."""
    bounds = key_bounds(mesh.n_shards, config)
    cb = config.block_capacity
    keys, sd, w = _occupied_rows(state)
    out = []
    for i, dev in enumerate(mesh.devices):
        d = mesh.first + i
        sel = (keys >= bounds[d]) & (keys < bounds[d + 1])
        u = int(sel.sum())
        st = {"dir_keys": np.full(cb, INT32_MAX, np.int32),
              "dir_slots": np.zeros(cb, np.int32), "n_blocks": np.int32(u),
              "pool_sd": np.zeros((cb, 512), np.float32),
              "pool_w": np.zeros((cb, 512), np.float32),
              "origin_blocks": submap_mod._host(
                  state.origin_blocks).astype(np.int32)}
        st["dir_keys"][:u] = keys[sel]
        st["dir_slots"][:u] = np.arange(u, dtype=np.int32)
        st["pool_sd"][:u] = sd[sel]
        st["pool_w"][:u] = w[sel]
        for name in _FIELDS[6:]:
            st[name] = np.int32(int(getattr(state, name)) if d == 0 else 0)
        out.append(state_from_numpy(st, dev))
    return out


def state_stack_to_numpy(state_stack: list) -> list:
    """The local shards' states as numpy dicts keyed by the JAX state's
    field names (``core.state.state_to_numpy`` per shard)."""
    return [state_to_numpy(st) for st in state_stack]


def state_stack_from_numpy(states: list, mesh: ShardMesh) -> list:
    """Per-shard states from numpy — dicts of :func:`state_stack_to_numpy`
    or objects with the fields as attributes, such as the JAX package's
    ``gather_states`` — onto the mesh's local shards (``states`` lists
    every shard of the mesh)."""
    if len(states) != mesh.n_shards:
        raise ValueError(f"{len(states)} states for {mesh.n_shards} shards")
    out = []
    for i, dev in enumerate(mesh.devices):
        st = states[mesh.first + i]
        d = st if isinstance(st, dict) else \
            {f: np.asarray(getattr(st, f)) for f in _FIELDS}
        out.append(state_from_numpy(d, dev))
    return out


def gather_states(state_stack: list) -> list:
    """The local shards' states copied to the host (CPU tensors), whole
    pools included: for tests and inspection; finalize and checkpoints
    read only what they need."""
    return [ActiveMapState(**{f: getattr(st, f).cpu().clone()
                              for f in _FIELDS}) for st in state_stack]


def start_finalize_sharded_global(state_stack: list, mesh: ShardMesh,
                                  config: MapConfig, positions: list,
                                  anchor=None):
    """Sharded finalize over the whole mesh: every process reads the same
    gathered buffers and builds the same submap
    (``core.submap.start_finalize_sharded`` with the mesh's all_gather).
    Returns a ``core.submap.PendingShardedSubmap``.  A drain point."""
    return submap_mod.start_finalize_sharded(state_stack, config, positions,
                                             anchor, gather=mesh.gather)


def gather_states_global(state_stack: list, mesh: ShardMesh,
                         config: MapConfig) -> list:
    """Host-side states of every shard of the mesh, occupied rows only
    (directory order), for :func:`merge_states_host` (checkpoints)."""
    cb = config.block_capacity
    cnt = mesh.gather([submap_mod._fin_counters(st, cb)
                       for st in state_stack])
    knb = min(submap_mod._pow2(int(max(cnt[:, 0].max(), 1))), cb)
    keys = mesh.gather([st.dir_keys[:knb] for st in state_stack])
    rows = [st.dir_slots[:knb].long() for st in state_stack]
    sd = mesh.gather([st.pool_sd[r] for st, r in zip(state_stack, rows)])
    w = mesh.gather([st.pool_w[r] for st, r in zip(state_stack, rows)])
    names = ("point_overflow", "sample_overflow", "block_overflow",
             "touched_overflow", "tile_overflow")
    return [types.SimpleNamespace(
        n_blocks=int(cnt[i, 0]), dir_keys=keys[i],
        dir_slots=np.arange(knb, dtype=np.int32), pool_sd=sd[i],
        pool_w=w[i], origin_blocks=cnt[0, 7:10].astype(np.int32),
        **{k: int(cnt[i, 2 + j]) for j, k in enumerate(names)})
        for i in range(mesh.n_shards)]


@dataclasses.dataclass
class PendingShardedStub:
    """A rotated-out sharded map, stashed with no host read: the whole
    :func:`start_finalize_sharded_global` waits for the next drain point.
    Until then it keeps the shards' pools alive on their devices
    (``pinned_bytes``, bounded like ``core.submap.PendingSubmap``'s)."""
    state_stack: list | None
    mesh: ShardMesh
    config: MapConfig
    positions: list
    anchor: object = None
    inner: object = None

    def _materialize(self) -> None:
        if self.inner is None:
            self.inner = start_finalize_sharded_global(
                self.state_stack, self.mesh, self.config, self.positions,
                anchor=self.anchor)
            self.state_stack = None        # release the pools

    @property
    def pinned_bytes(self) -> int:
        if self.state_stack is None:
            return 0
        return sum(st.pool_sd.nbytes + st.pool_w.nbytes
                   for st in self.state_stack)

    def warn_undrained(self) -> None:
        """The drain's overflow warning for a stub never drained: the
        local shards' four lossy counters, nothing else."""
        if self.state_stack is not None:
            submap_mod._warn_lossy(np.sum([
                torch.stack([getattr(st, k) for k in submap_mod._LOSSY])
                .tolist() for st in self.state_stack], axis=0))

    def start_copies(self) -> None:
        self._materialize()

    def finish(self, levels, config):
        self._materialize()
        return self.inner.finish(levels, config)
