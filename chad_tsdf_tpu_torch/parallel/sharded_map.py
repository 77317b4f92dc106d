"""ShardedTSDFMap — PyTorch port of ``chad_tsdf_tpu/parallel/sharded_map.py``.

The sharded counterpart of ``core.map.TSDFMap``, with its surface: the
active map is Morton-range sharded over a :class:`~.sharded.ShardMesh` and
every insert runs the sharded step of ``parallel/sharded.py`` (the
single-device insert per shard, the block-row halo exchange, the K3
merge).  Rotation, ``save``, ``extract_mesh``, ``raycast``,
``leaf_arrays``, ``merge``, checkpoints and loop closure are inherited:
the active map reaches them through the sharded finalize, which merges the
shards' pools exactly.

Across processes (``parallel.distributed``) the same object runs on every
process with the same scans: each process computes the identical split
and integrates its own shards; finalize gathers the shards' compacted
buffers to every process, which all build the identical DAG.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..config import MapConfig
from ..core import integrate
from ..core.map import LazyMetrics, TSDFMap
from ..core.state import origin_blocks_for_position
from . import sharded


class ShardedTSDFMap(TSDFMap):
    def __init__(self, sdf_res: float = 0.05, sdf_trunc: float = 0.1,
                 config: MapConfig | None = None, mesh=None,
                 halo_capacity: int | None = None, axis: str = "shard",
                 device="cuda"):
        """``mesh`` defaults to ``make_mesh(axis=axis, device=device)``,
        one shard per card (the card unless ``device="cpu"``)."""
        if mesh is None:
            mesh = sharded.make_mesh(axis=axis, device=device)
        super().__init__(sdf_res, sdf_trunc, config, device=mesh.devices[0])
        self.mesh = mesh
        self.axis = mesh.axis
        self.n_shards = mesh.n_shards
        self.halo_capacity = halo_capacity
        # one step per (point bucket, accumulate backend) the scans used:
        # scans pad to the smallest bucket that fits, as in TSDFMap.insert
        self._steps: dict = {}
        self._carve_step = None
        self._state_stack = None
        # the last insert's unsettled end: (each local shard's FallbackTail
        # or None, carve arguments or None, that insert's LazyMetrics)
        self._deferred = None
        self._origin = None
        self._bounds = None

    @property
    def state_stack(self):
        """The local shards' active states, with the last insert settled."""
        self._settle()
        return self._state_stack

    @state_stack.setter
    def state_stack(self, value) -> None:
        self._settle()
        self._state_stack = value

    def _settle(self) -> None:
        """Settle the last insert: each shard's deferred fallback into its
        persistent pool, then the deferred carve, in the JAX package's
        order.  A no-op when nothing is pending."""
        if self._deferred is None:
            return
        tails, carve_args, metrics = self._deferred
        self._deferred = None
        stack, delta = sharded.settle_stack(self._state_stack, tails,
                                            self.mesh)
        for k, v in delta.items():
            metrics._data[k] = metrics._data[k] + v
        if carve_args is not None:
            stack, cmetrics = self._carve_step(stack, *carve_args)
            metrics.add(cmetrics)
        self._state_stack = stack

    def _step_for(self, bucket: int, impl: str):
        step = self._steps.get((bucket, impl))
        if step is None:
            cfg = dataclasses.replace(self.config, max_points=bucket,
                                      point_buckets=(), accumulate_impl=impl)
            step, self.halo_capacity = sharded.make_sharded_insert(
                cfg, self.mesh, halo_capacity=self.halo_capacity)
            self._steps[(bucket, impl)] = step
        return step

    def insert(self, points, position) -> LazyMetrics:
        """Insert one scan across the shards.  As ``TSDFMap.insert``: the
        metrics stay on the device and chunks pad to the point buckets, so
        a stream that ignores the metrics reads nothing on the host."""
        t0 = time.perf_counter()
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        position = np.asarray(position, np.float32).reshape(3)

        if self.state_stack is None:
            self._start_submap(position)
        elif self._positions and np.linalg.norm(
                position - self._positions[0]) > self.config.submap_distance:
            self._finalize_active()
            self._start_submap(position)
        self._positions.append(position.copy())
        self._active_snapshot = None

        cap = self.config.max_points
        batch = self.n_shards * cap
        metrics_acc = LazyMetrics(settle=self._settle)
        for beg in range(0, max(len(points), 1), batch):
            chunk = points[beg:beg + batch]
            # the single-device density dispatch: a sparse scan runs the
            # sparse backend in every shard's scratch
            impl = self._dispatch_config(chunk).accumulate_impl
            if self._bounds is None and self.n_shards > 1 and len(chunk):
                # occupancy-adaptive ownership, fixed for the submap's life
                # (consistent row ownership), from its first non-empty chunk
                self._bounds = sharded.adaptive_bounds(
                    chunk, self._origin, self.n_shards, self.config)
            bounds = self._bounds if self._bounds is not None else \
                sharded.key_bounds(self.n_shards, self.config)
            if self.n_shards == 1:
                shards = [chunk]     # the insert Morton-sorts on the device
            else:
                shards = sharded.rebalance_chunks(
                    sharded.owner_split(chunk, bounds, self._origin,
                                        self.config), cap)
            n_per = np.asarray([len(c) for c in shards], np.int32)
            bucket = next((b for b in self.config.buckets
                           if b >= n_per.max()), cap)
            if self.n_shards == 1 and len(chunk) == bucket:
                padded = chunk      # a full bucket goes as is, as in TSDFMap
            else:
                padded = np.zeros((self.n_shards * bucket, 3), np.float32)
                for i, c in enumerate(shards):
                    padded[i * bucket:i * bucket + len(c)] = c
            if self.config.packed_ingest:
                padded = integrate.pack_points(padded, position,
                                               self.config.sdf_res)
            stack, metrics, tails = self._step_for(bucket, impl)(
                self.state_stack, padded, n_per, position, bounds)
            self._state_stack = stack
            metrics_acc.add(metrics)
            carve_args = None
            if self.config.carve_steps > 0:
                # the whole scan on every shard: each applies the evidence
                # of the blocks it is responsible for (make_sharded_carve)
                full = np.zeros((self.n_shards * bucket, 3), np.float32)
                full[:len(chunk)] = chunk
                if self.config.packed_ingest:
                    full = integrate.pack_points(full, position,
                                                 self.config.sdf_res)
                if self._carve_step is None:
                    self._carve_step = sharded.make_sharded_carve(
                        self.config, self.mesh)
                carve_args = (full, len(chunk), position, bounds)
            if any(t is not None for t in tails):
                self._deferred = (tails, carve_args, metrics_acc)
            elif carve_args is not None:
                self._state_stack, cmetrics = self._carve_step(
                    self._state_stack, *carve_args)
                metrics_acc.add(cmetrics)
        if self.config.profile:
            self._settle()
            for dev in set(self.mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            metrics_acc["wall_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"insert   {metrics_acc['wall_ms']:8.2f} ms  "
                  f"samples={metrics_acc['n_valid_samples']} "
                  f"blocks={metrics_acc['n_blocks']} "
                  f"deferred={metrics_acc['route_overflow']}")
        self._n_inserts += 1
        if self._n_inserts % 64 == 0 or self.config.profile:
            self._warn_overflow()
        self.last_metrics = metrics_acc
        return metrics_acc

    def _active_nonempty(self) -> bool:
        return self.state_stack is not None and int(self.mesh.psum(
            [st.n_blocks for st in self._state_stack])) > 0

    def _clear_active(self) -> None:
        self.state_stack = None
        self._origin = None
        self._bounds = None

    def _start_submap(self, position: np.ndarray) -> None:
        self._origin = origin_blocks_for_position(position, self.config)
        self._bounds = None        # adaptive, set by the first insert
        self.state_stack = sharded.create_sharded_state(
            self.config, self.mesh, self._origin)
        self._positions = []

    def _stash_active(self):
        return sharded.PendingShardedStub(
            self.state_stack, self.mesh, self.config, list(self._positions),
            self._anchor_from(self._positions))

    def _snapshot_active(self, levels):
        return sharded.start_finalize_sharded_global(
            self.state_stack, self.mesh, self.config,
            self._positions).finish(levels, self.config)

    def _stacked_overflow(self, local: bool = False) -> dict:
        """The five overflow counters summed over the shards in one read;
        ``local``: this process's shards as they stand, last insert
        unsettled (settling runs collectives), and no psum."""
        names = ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow", "tile_overflow")
        stack = self._state_stack if local else self.state_stack
        vals = [torch.stack([getattr(st, k) for k in names]) for st in stack]
        tot = sum(v.cpu() for v in vals) if local else self.mesh.psum(vals)
        return dict(zip(names, (int(v) for v in tot)))

    def _warn_overflow(self, local: bool = False) -> None:
        """``TSDFMap._warn_overflow`` over the shards: a lossy overflow on
        any shard warns once per kind."""
        if (self._state_stack if local else self.state_stack) is None:
            return
        knob = {"point_overflow": "block_bits (local extent)",
                "sample_overflow": "block_bits (local extent)",
                "block_overflow": "block_capacity",
                "touched_overflow": "touched_capacity"}
        ovf = self._stacked_overflow(local)
        for name in self._LOSSY_OVERFLOWS:
            if name in self._overflow_warned or ovf[name] == 0:
                continue
            warnings.warn(
                f"ShardedTSDFMap: {name} = {ovf[name]} across shards — "
                f"samples were dropped and counted; the map is degraded in "
                f"those regions. Raise MapConfig.{knob[name]} to avoid "
                "this.", stacklevel=3)
            self._overflow_warned.add(name)
        self._checked_at_insert = self._n_inserts

    def __del__(self):
        # TSDFMap.__del__, on this process's shards only and without
        # settling: a collective here would pair with whatever the peer
        # process calls next, or wait forever
        try:
            n = getattr(self, "_n_inserts", 0)
            if n and n != getattr(self, "_checked_at_insert", -1):
                self._warn_overflow(local=True)
            for p in getattr(self, "_pending", ()):
                p.warn_undrained()
        except Exception:     # interpreter shutdown: modules may be gone
            pass

    def stats(self) -> dict:
        self._warn_overflow()
        self._drain_pending()
        s = self.levels.stats()
        s["n_submaps"] = len(self.submaps)
        s["n_shards"] = self.n_shards
        if self.state_stack is not None:
            s["active_blocks"] = int(self.mesh.psum(
                [st.n_blocks for st in self.state_stack]))
            ovf = self._stacked_overflow()
            s["overflow"] = {
                "points": ovf["point_overflow"],
                "samples": ovf["sample_overflow"],
                "blocks": ovf["block_overflow"],
                "touched": ovf["touched_overflow"],
                "tile": ovf["tile_overflow"],
            }
        return s
