"""Checkpoint / resume — PyTorch port of ``chad_tsdf_tpu/io/checkpoint.py``,
in the same file format, so a checkpoint written by either package loads
into the other.

The reference never serializes its DAG and has no load path (reference:
src/chad/detail/lvr2.cpp:170-200, 317-319).  A checkpoint is one ``.npz``:

* the DAG levels as their flat pools (uint32 node pools, uint64 cluster
  pool); the hash-consing indexes are rebuilt on load from the pools;
* each submap's two roots, trajectory, anchor and loop-closure correction;
* the active block pool's occupied prefix (allocation is sequential, so
  the live rows are ``pool[:n_blocks]``), its directory, origin and the six
  counters;
* ``__meta__``: JSON with ``FORMAT_VERSION``, the ``MapConfig`` and the
  per-level dedup counters.  Versions 1 and 2 load.

Saving is a drain point: it materializes the deferred rotations, settles
the last insert and reads the occupied prefix back from the card.  A
``ShardedTSDFMap`` checkpoints as its shards' states merged exactly on the
host, so a checkpoint does not depend on the shard count: one written on N
shards (by either package) resumes on M shards with
``load_checkpoint(mesh=...)``, or on one device.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import MapConfig
from ..core import dag
from ..core.map import TSDFMap
from ..core.state import INT32_MAX, ActiveMapState
from ..core.submap import Submap

FORMAT_VERSION = 2


def _active_state(m: TSDFMap):
    """The map's active state (the last insert settled); a sharded map's
    shards, occupied rows only, gathered from every process and merged on
    the host."""
    if getattr(m, "state_stack", None) is None:
        return m.state
    from ..parallel.sharded import gather_states_global, merge_states_host
    if not m._active_nonempty():
        return None
    return merge_states_host(
        gather_states_global(m.state_stack, m.mesh, m.config), m.config,
        device="cpu")


def save_checkpoint(path: str, m: TSDFMap) -> None:
    m._drain_pending()          # materialize deferred rotations first
    active = _active_state(m)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(m.config),
        "n_submaps": len(m.submaps),
        "submaps": [
            {"root_addr_tsdf": sm.root_addr_tsdf,
             "root_addr_weight": sm.root_addr_weight,
             "n_clusters": sm.n_clusters, "n_voxels": sm.n_voxels}
            for sm in m.submaps
        ],
        "has_active": active is not None,
        "level_counters": {
            "nodes": [[lv.uniques_n, lv.dupes_n] for lv in m.levels.nodes],
            "leaf_clusters": [m.levels.leaf_clusters.uniques_n,
                              m.levels.leaf_clusters.dupes_n],
        },
    }
    for d, lv in enumerate(m.levels.nodes):
        arrays[f"node_level_{d}"] = lv.raw.copy()
    arrays["leaf_clusters"] = m.levels.leaf_clusters.raw.copy()
    for i, sm in enumerate(m.submaps):
        arrays[f"submap_{i}_positions"] = np.asarray(sm.positions,
                                                    np.float32).reshape(-1, 3)
        if sm.anchor is not None:
            arrays[f"submap_{i}_anchor"] = np.asarray(sm.anchor, np.float64)
        if sm.corrected is not None:
            arrays[f"submap_{i}_corrected"] = np.asarray(sm.corrected,
                                                         np.float64)
    if active is not None:
        counters = torch.stack([
            active.n_blocks, active.point_overflow, active.sample_overflow,
            active.block_overflow, active.touched_overflow,
            active.tile_overflow]).cpu().numpy().astype(np.int64)
        nb = int(counters[0])
        arrays["active_dir_keys"] = active.dir_keys[:nb].cpu().numpy()
        arrays["active_dir_slots"] = active.dir_slots[:nb].cpu().numpy()
        arrays["active_pool_sd"] = active.pool_sd[:nb].cpu().numpy()
        arrays["active_pool_w"] = active.pool_w[:nb].cpu().numpy()
        arrays["active_origin"] = active.origin_blocks.cpu().numpy()
        arrays["active_counters"] = counters
        arrays["active_positions"] = np.asarray(m._positions,
                                                np.float32).reshape(-1, 3)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def load_checkpoint(path: str, device="cuda", mesh=None) -> TSDFMap:
    """Restore a map onto ``device`` (the card unless the caller passes
    ``device="cpu"``).  With ``mesh`` (``parallel.make_mesh``) a
    ``ShardedTSDFMap`` is returned on the mesh's devices, its active state
    partitioned by the static Morton ranges (``shard_state_host``)."""
    if mesh is not None:
        device = "cpu"          # the state is partitioned from the host
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta["format_version"] not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version "
                         f"{meta['format_version']}")
    config = MapConfig(**meta["config"])
    m = TSDFMap(config=config, device=device)

    for d in range(dag.MAX_DEPTH):
        _restore_node_level(m.levels.nodes[d], z[f"node_level_{d}"])
    _restore_lc_level(m.levels.leaf_clusters, z["leaf_clusters"])
    lc = meta.get("level_counters")
    if lc is not None:   # exact dedup-counter round trip (v2)
        for lv, (u, dup) in zip(m.levels.nodes, lc["nodes"]):
            _set_counters(lv, int(u), int(dup))
        _set_counters(m.levels.leaf_clusters, int(lc["leaf_clusters"][0]),
                      int(lc["leaf_clusters"][1]))

    for i, sm_meta in enumerate(meta["submaps"]):
        sm = Submap(sm_meta["root_addr_tsdf"], sm_meta["root_addr_weight"],
                    list(z[f"submap_{i}_positions"]),
                    sm_meta["n_clusters"], sm_meta["n_voxels"])
        if f"submap_{i}_anchor" in z:
            sm.anchor = np.asarray(z[f"submap_{i}_anchor"])
        if f"submap_{i}_corrected" in z:
            sm.corrected = np.asarray(z[f"submap_{i}_corrected"])
        m.submaps.append(sm)
    if meta["has_active"]:
        counters = [int(x) for x in z["active_counters"]]
        counters += [0] * (6 - len(counters))   # older checkpoints
        cb = config.block_capacity
        dev = m.device

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        m.state = ActiveMapState(
            dir_keys=tensor(_pad_to(z["active_dir_keys"], cb,
                                    np.int32(INT32_MAX))),
            dir_slots=tensor(_pad_to(z["active_dir_slots"], cb, 0)),
            n_blocks=scalar(counters[0]),
            pool_sd=tensor(_pad_to(z["active_pool_sd"], cb, 0.0)),
            pool_w=tensor(_pad_to(z["active_pool_w"], cb, 0.0)),
            origin_blocks=tensor(z["active_origin"]),
            point_overflow=scalar(counters[1]),
            sample_overflow=scalar(counters[2]),
            block_overflow=scalar(counters[3]),
            touched_overflow=scalar(counters[4]),
            tile_overflow=scalar(counters[5]))
        m._positions = list(z["active_positions"])
    if mesh is None:
        return m
    from ..parallel import sharded
    from ..parallel.sharded_map import ShardedTSDFMap
    sm = ShardedTSDFMap(config=config, mesh=mesh)
    sm.levels = m.levels
    sm.submaps = m.submaps
    sm._positions = m._positions
    if m.state is not None:
        sm.state_stack = sharded.shard_state_host(m.state, mesh, config)
        sm._origin = m.state.origin_blocks.numpy()
        # further inserts route with the ownership the state was cut by
        sm._bounds = sharded.key_bounds(mesh.n_shards, config)
    return sm


def _set_counters(lv, uniques: int, dupes: int) -> None:
    if hasattr(lv, "set_counters"):     # native backend (read-only props)
        lv.set_counters(uniques, dupes)
    else:
        lv.uniques_n, lv.dupes_n = uniques, dupes


def _restore_node_level(lv, raw: np.ndarray) -> None:
    """Rebuild pool + hash index by replaying the packed layout."""
    if hasattr(lv, "restore"):          # native backend
        lv.restore(raw)
        return
    lv._raw = raw.copy()
    lv._occupied = raw.shape[0]
    lv._index.clear()
    addr = 1
    n = raw.shape[0]
    uniques = 0
    while addr < n:
        mask = int(raw[addr])
        cnt = bin(mask & 0xFF).count("1")
        kids = np.zeros(8, np.uint32)
        k = 0
        for ci in range(8):
            if mask & (1 << ci):
                kids[ci] = raw[addr + 1 + k]
                k += 1
        lv._index[kids.tobytes()] = addr
        addr += 1 + cnt
        uniques += 1
    lv.uniques_n = uniques
    lv.dupes_n = 0


def _restore_lc_level(lv, raw: np.ndarray) -> None:
    if hasattr(lv, "restore"):          # native backend
        lv.restore(raw)
        return
    lv._raw = raw.copy()
    lv._n = raw.shape[0]
    lv._index = {int(v): i for i, v in enumerate(raw) if i > 0}
    lv.uniques_n = raw.shape[0] - 1
    lv.dupes_n = 0
