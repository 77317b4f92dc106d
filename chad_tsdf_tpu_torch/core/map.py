"""TSDFMap — the public API of the PyTorch port (``chad_tsdf_tpu/core/map.py``).

Mirrors the reference's entry class ``chad::TSDFMap`` (reference:
include/chad/tsdf.hpp:21-171, src/chad/tsdf.cpp:26-86):

* ``insert(points, position)``: submap rotation after ``submap_distance``
  of travel (tsdf.cpp:46-61), then the sort -> normals -> DDA -> integrate
  pipeline of core/integrate.py on the map's device.  A rotation only
  stashes the rotated-out state (core/submap.py ``start_finalize``); its
  read-back and DAG build wait for the next drain (``save``, ``stats``,
  ``finalize_active``, or when ``max_pending_finalize`` stubs or
  ``_MAX_PENDING_BYTES`` of their pools pile up);
* ``save(filename)``: snapshot the active submap into the DAG, mesh the
  union of all submaps with marching cubes on the map's device
  (``mesh/device_mc.py``; ``mesh_impl="auto"`` meshes on the host for a
  CPU map) and write a PLY (tsdf.cpp:76-86), and the ``.grid`` dump with
  ``save_grid``.  As in the JAX package, save() is idempotent and meshes
  every submap unless ``mesh_first_submap_only``;
* the read side: ``extract_mesh`` (optionally contour-optimized),
  ``voxel_samples`` (re-anchoring corrected submaps), ``leaf_arrays`` /
  ``leaf_items``, ``raycast`` and ``merge``;
* ``optimize_loop_closures``: pose-graph loop closure over the submaps
  (slam/posegraph.py), applied as per-submap rigid corrections.

Space carving (``carve_steps > 0``, core/carve.py) follows each insert.

Each chunk of an insert goes through one ``core/graph.py``
``InsertGraph``, on every device, as the JAX package issues one executable
per chunk: the upload into its input buffers, then the padding, packing,
insert and fallback on the device, and on a carving map the carve (the
span ``chad.insert.carve``, its device time read by the map's
``timing.CarveClock``).  The graphs are the map's own, cached by
(dispatched config, point bucket, packed ingest, carving) and bound to
the map's active state, which a rotation copies out for its stub and
resets in place.  Replacing the active state from outside (the ``state``
setter, a checkpoint load) drops them; ``finalize_active``, ``merge`` and
``optimize_loop_closures`` leave the active state's tensors where they
are.  On the card the first insert of a key runs eagerly and captures
the graph after it, and the others replay it, the fallback an IF node
decided on the device; on the CPU, or with ``graphs_enabled = False``,
every insert runs the graph's step eagerly, the fallback unconditionally
(a no-op where no sample needs it).  No insert reads the device on the
host.

The map runs on the card (``device="cuda"``, the default) unless the
caller passes ``device="cpu"``; without a card the default raises rather
than falling back to the CPU.  ``accumulate_impl`` may be ``auto``,
``fused``, ``tile``, ``sample_tile``, ``pallas``, ``xla`` or ``seg``
(core/integrate.py); under ``auto`` on CUDA each scan goes to the dense
``fused`` backend or, below ``sparse_points_per_block``, to
``sparse_impl`` (``seg``, or ``sample_tile``, ...).
``packed_ingest`` quantizes the points to int16 steps (on the card inside
the insert's graph).  The sharded map
(``parallel.ShardedTSDFMap``) is a subclass that keeps its active map in
``state_stack``, one state per shard, and inserts eagerly.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import warnings
import weakref

import numpy as np

from .. import native
from ..config import MapConfig
from ..mesh import device_mc, grid as grid_io, optimize, write_ply
from ..mesh.mc import TriangleMesh, _vertex_normals, triangulate
from ..ops import codec, morton
from ..utils import timing
from ..utils.timing import span
from . import carve, dag, graph, integrate, submap as submap_mod
from .state import (clone_state, create_state, origin_blocks_for_position,
                    reset_state_, resolve_device)

# the device bytes the deferred rotations' stubs may pin (each keeps a whole
# pool alive): the oldest is materialized while they exceed it.  Four pools
# at the default block_capacity, so there ``max_pending_finalize`` decides;
# a larger block_capacity lets fewer wait
_MAX_PENDING_BYTES = 1 << 30
# the rows of a chunk the density estimate looks at, about
_DENSITY_SAMPLE = 8192


def block_density(chunk: np.ndarray, block: float) -> float:
    """Points per distinct block of ``block`` metres, estimated from about
    ``_DENSITY_SAMPLE`` evenly strided rows of the (n, 3) ``chunk``, taken
    in float32: a block is ``floor(p / block)`` in float32, and the
    distinct blocks are counted by ``native.distinct_block_keys``, or by
    ``np.unique`` over the same keys without the library."""
    chunk = np.ascontiguousarray(chunk, np.float32)
    stride = max(1, len(chunk) // _DENSITY_SAMPLE)
    n_sub = -(-len(chunk) // stride)
    distinct = native.distinct_block_keys(chunk, stride, block)
    if distinct is None:
        b = np.floor(chunk[::stride] / np.float32(block)).astype(np.int64)
        distinct = np.unique((b[:, 0] << 42) ^ (b[:, 1] << 21) ^
                             b[:, 2]).shape[0]
    return stride * n_sub / max(1, distinct)


class LazyMetrics(collections.abc.MutableMapping):
    """Per-insert metrics whose values stay on the device until first read.

    Reading a key converts (and caches) that value as a Python scalar; a
    streaming loop that ignores the metrics never waits for the device.
    A ``MutableMapping`` rather than a dict subclass, so ``dict(m)``,
    ``**m`` and ``==`` all go through the converting ``__getitem__``.
    ``raw(key)`` returns the stored value unconverted.  ``settle`` (the
    sharded map's) runs before any read, so a deferred fallback or carve
    of the insert is counted.
    """

    def __init__(self, data=None, settle=None):
        self._data = dict(data or {})
        # weak: the map holds its metrics, and a cycle would keep the map's
        # device pools alive until the garbage collector runs
        self._settle = None if settle is None else weakref.WeakMethod(settle)

    def _settled(self) -> dict:
        settle = None if self._settle is None else self._settle()
        if settle is not None:
            settle()
        return self._data

    def add(self, metrics: dict) -> None:
        """Sum one cloud's device metrics in, without reading them."""
        for k, v in metrics.items():
            self._data[k] = self._data[k] + v if k in self._data else v

    def __getitem__(self, key):
        v = self._settled()[key]
        if not isinstance(v, (int, float)):
            v = timing.host_item(v)
            self._data[key] = v
        return v

    def __setitem__(self, key, value):
        self._data[key] = value

    def __delitem__(self, key):
        del self._data[key]

    def __iter__(self):
        return iter(list(self._settled()))

    def __len__(self):
        return len(self._settled())

    def raw(self, key):
        return self._settled()[key]

    def materialize(self) -> "LazyMetrics":
        for k in self._settled():
            self[k]
        return self

    def copy(self) -> dict:
        return dict(self.materialize())

    def __repr__(self):
        return repr(dict(self.materialize()))


class TSDFMap:
    # inserts on the card capture and replay their graphs (module
    # docstring); False runs the graphs' step eagerly there too, for
    # comparisons
    graphs_enabled = True

    def __init__(self, sdf_res: float = 0.05, sdf_trunc: float = 0.1,
                 config: MapConfig | None = None, device="cuda"):
        if config is None:
            config = MapConfig(sdf_res=sdf_res, sdf_trunc=sdf_trunc)
        elif (sdf_res, sdf_trunc) != (config.sdf_res, config.sdf_trunc):
            config = dataclasses.replace(config, sdf_res=sdf_res,
                                         sdf_trunc=sdf_trunc)
        self.config = config
        self.device = resolve_device(device)
        self.levels = dag.NodeLevels()
        self.submaps: list[submap_mod.Submap] = []
        self._pending: list[submap_mod.PendingSubmap] = []
        self._state = None
        self._positions: list[np.ndarray] = []
        self._active_snapshot: submap_mod.Submap | None = None
        self.last_metrics: dict = {}
        self._n_inserts = 0
        # the lossy overflow kinds warned of, and the insert count at the
        # last check
        self._overflow_warned: set = set()
        self._checked_at_insert = 0
        # (map key, codes, sd) for point queries: _sorted_samples
        self._query_cache = None
        # the insert graphs (their private memory pools bounded as
        # insert_steps_scan's) and the active state they are bound to
        self._graphs = integrate.GraphCache(integrate.MAX_GRAPH_BYTES)
        self._gstate = None
        # the device time of the map's carves
        self._carve_clock = timing.CarveClock(self.device)

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The active map's state."""
        return self._state

    @state.setter
    def state(self, value) -> None:
        """Replace the active state.  Another state than the one the map's
        graphs are bound to drops them (the next insert captures anew);
        None keeps them for the next submap, which resets their state in
        place."""
        if value is not None and value is not self._gstate:
            self.drop_graphs()
        self._state = value

    def drop_graphs(self) -> None:
        """Drop the map's insert graphs and their memory pools."""
        self._graphs.clear()
        self._gstate = None

    @property
    def n_submaps(self) -> int:
        """Finalized submaps, including rotations still materializing."""
        return len(self.submaps) + len(self._pending)

    @property
    def sdf_res(self) -> float:
        return self.config.sdf_res

    @property
    def sdf_trunc(self) -> float:
        return self.config.sdf_trunc

    # ------------------------------------------------------------------
    def insert(self, points, position) -> LazyMetrics:
        """Integrate one point cloud scanned from ``position``.

        points: array-like (N, 3) float; position: (3,) float.  Returns the
        per-insert metrics (device values until read).

        The call is the span ``chad.insert`` (``utils/timing.py``; its
        argument the map's insert index), split into ``.rotate``,
        ``.dispatch``, ``.load``, ``.replay`` or ``.step``, ``.carve``,
        ``.capture`` and ``.overflow_check``.  A carving map's inserts
        are counted in ``carve_inserts`` and its carves' device time in
        ``carve_device_us`` / ``carve_timed`` (``timing.CarveClock``,
        read without a wait).
        """
        with span("chad.insert", self._n_inserts) as sp:
            timing.count("inserts")
            if self.config.carve_steps > 0:
                timing.count("carve_inserts")
            metrics = self._insert(points, position)
        if self.config.profile:
            metrics["wall_ms"] = sp.ms
            print(f"insert   {sp.ms:8.2f} ms  "
                  f"samples={metrics['n_valid_samples']} "
                  f"blocks={metrics['n_blocks']}")
        return metrics

    def _insert(self, points, position) -> LazyMetrics:
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        position = np.asarray(position, np.float32).reshape(3)

        # submap rotation policy (tsdf.cpp:46-61)
        if self.state is None:
            with span("chad.insert.rotate"):
                self._start_submap(position)
        elif self._positions and np.linalg.norm(
                position - self._positions[0]) > self.config.submap_distance:
            with span("chad.insert.rotate"):
                timing.count("finishes_in_insert", self._finalize_active())
                self._start_submap(position)
        self._positions.append(position.copy())
        self._active_snapshot = None

        cap = self.config.max_points
        metrics_acc = LazyMetrics()
        for beg in range(0, max(len(points), 1), cap):
            chunk = points[beg:beg + cap]
            # the smallest shape bucket that fits (map.py:155-164 of the
            # JAX package): the tile kernels need N % 1024 == 0, and a
            # small scan skips most of the max_points pipeline
            bucket = next((b for b in self.config.buckets
                           if b >= len(chunk)), cap)
            with span("chad.insert.dispatch"):
                cfg = self._dispatch_config(chunk)
            metrics_acc.add(self._insert_chunk(cfg, bucket, chunk, position))
        if self.config.profile:
            timing.synchronize(self.device)
        self._n_inserts += 1
        # the overflow check reads the device: amortize it over the stream
        if self._n_inserts % 64 == 0 or self.config.profile:
            with span("chad.insert.overflow_check"):
                self._warn_overflow(stacklevel=4)   # insert's caller
        self.last_metrics = metrics_acc
        return metrics_acc

    def _insert_chunk(self, cfg: MapConfig, bucket: int, chunk: np.ndarray,
                      position: np.ndarray) -> dict:
        """One chunk (unpadded) through the map's graph for (``cfg``,
        ``bucket``, packed ingest, carving), made on first use on the
        active state.  On the card one replay of it, captured after an
        eager first insert when new; on the CPU, or with ``graphs_enabled``
        off, its step run eagerly.  A carving map carves right after (the
        carve takes the map's config: it does not depend on the accumulate
        backend), timed by the map's carve clock.  Returns the chunk's
        metrics."""
        carving = self.config.carve_steps > 0
        key = (cfg, bucket, cfg.packed_ingest, carving)
        g = self._graphs.get(key)
        fresh = g is None
        if fresh:
            if self._gstate is None:
                self._gstate = self._state
            g = graph.InsertGraph(self._gstate, cfg, bucket,
                                  cfg.packed_ingest,
                                  self.config if carving else None)
        with span("chad.insert.load"):
            g.load(chunk, position, len(chunk))
        if not (self.graphs_enabled and graph.use_graph(self.device)):
            with span("chad.insert.step"):
                g.run_step()
            if carving:
                with span("chad.insert.carve"), self._carve_clock:
                    g.run_carve()
            metrics = g.metrics()
        elif g.graph is None:
            with span("chad.insert.capture"):
                metrics = g.warm()
                g.capture()
        else:
            with span("chad.insert.replay"):
                g.replay()
            if carving:
                with span("chad.insert.carve"), self._carve_clock:
                    g.replay_carve()
            return g.metrics()
        if fresh:
            self._graphs.put(key, g)
        return metrics

    # overflow kinds that drop content; tile_overflow is excluded (those
    # samples are integrated exactly by the fallback)
    _LOSSY_OVERFLOWS = ("point_overflow", "sample_overflow",
                        "block_overflow", "touched_overflow")

    def _warn_overflow(self, stacklevel: int = 3) -> None:
        """Warn once per counter kind when dropped-data overflow appears
        (``stacklevel``: the frame the warning names, as ``warnings.warn``
        counts)."""
        if self.state is None:
            return
        knob = {"point_overflow": "block_bits (local extent)",
                "sample_overflow": "block_bits (local extent)",
                "block_overflow": "block_capacity",
                "touched_overflow": "touched_capacity"}
        for name in self._LOSSY_OVERFLOWS:
            if name in self._overflow_warned:
                continue
            v = timing.host_item(getattr(self.state, name))
            if v > 0:
                warnings.warn(
                    f"TSDFMap: {name} = {v} — samples were dropped and "
                    f"counted; the map is degraded in those regions. "
                    f"Raise MapConfig.{knob[name]} to avoid this.",
                    stacklevel=stacklevel)
                self._overflow_warned.add(name)
        self._checked_at_insert = self._n_inserts

    def __del__(self):
        # a short-lived map (< 64 inserts, never rotated or saved) would
        # otherwise drop data without warning; read the counters only when
        # inserts happened since the last check.  A rotated-out map still
        # pending was never drained, so its counters were never read.
        try:
            n = getattr(self, "_n_inserts", 0)
            if n and n != getattr(self, "_checked_at_insert", -1):
                self._warn_overflow()
            for p in getattr(self, "_pending", ()):
                p.warn_undrained()
        except Exception:     # interpreter shutdown: modules may be gone
            pass

    def _dispatch_config(self, chunk: np.ndarray) -> MapConfig:
        """Pick the accumulate backend per scan under ``auto`` (on CUDA
        only, where the JAX package does it on the TPU): the fused tile
        kernels pay off on dense clouds (many points per touched block);
        sparse outdoor scans run ``sparse_impl`` (``seg``: voxel-sorted
        segment sums and a scatter of unique voxels, no tile overflow by
        construction; ``sample_tile``: K4 over tiles of the block-sorted
        samples, with the sort fallback).  The density is estimated on the
        host from a subsample: its distinct blocks, counted in one pass by
        ``native.distinct_block_keys`` (``np.unique`` without the library:
        the same count)."""
        if (self.config.accumulate_impl != "auto"
                or self.device.type != "cuda" or len(chunk) == 0):
            return self.config
        density = block_density(chunk, 8.0 * self.config.sdf_res)
        if density >= self.config.sparse_points_per_block:
            return self.config
        return dataclasses.replace(self.config,
                                   accumulate_impl=self.config.sparse_impl)

    def _start_submap(self, position: np.ndarray) -> None:
        origin = origin_blocks_for_position(position, self.config)
        if self._gstate is not None:
            # the graphs' state, reset in place (its tensors stay bound)
            self._state = reset_state_(self._gstate, origin)
        else:
            self.state = create_state(self.config, origin, self.device)
        self._positions = []

    @staticmethod
    def _anchor_from(positions) -> np.ndarray:
        a = np.eye(4, dtype=np.float64)
        if positions:
            a[:3, 3] = np.asarray(positions[0], np.float64)
        return a

    def _stash_active(self):
        """The rotated-out active map as a pending stub
        (``submap_mod.start_finalize``: no host read, no device work on the
        stream).  The graphs' state is copied for the stub (a device copy,
        no host read): the next submap resets it in place."""
        state = self.state
        if state is self._gstate:
            state = clone_state(state)
        return submap_mod.start_finalize(
            state, self.config, self._positions,
            anchor=self._anchor_from(self._positions))

    def _finalize_active(self) -> int:
        """Deferred rotation: stash the rotated-out active map; counter
        read-back, compaction, transfer and DAG build all happen at
        :meth:`_drain_pending`, unless the stubs pile up past their bound.
        Returns the number of submaps finished here."""
        timing.count("rotations")
        self._pending.append(self._stash_active())
        # bound the device memory the stubs hold (a whole pool each), by
        # count and by bytes; the oldest has waited longest
        n = 0
        while (len(self._pending) > self.config.max_pending_finalize or
               sum(p.pinned_bytes for p in self._pending) >
               _MAX_PENDING_BYTES):
            self.submaps.append(
                self._pending.pop(0).finish(self.levels, self.config))
            n += 1
        return n

    def _drain_pending(self) -> None:
        """Materialize all pending (rotated-out) submaps, in order.  All
        device->host copies are started first, so the transfer of submap
        k + 1 overlaps the host DAG build of submap k."""
        for p in self._pending:
            p.start_copies()
        while self._pending:
            self.submaps.append(
                self._pending.pop(0).finish(self.levels, self.config))

    def _active_nonempty(self) -> bool:
        return self.state is not None and \
            timing.host_item(self.state.n_blocks) > 0

    def finalize_active(self) -> None:
        """Finalize the current active map into a submap immediately (the
        rotation step of tsdf.cpp:46-61, callable explicitly)."""
        if self._active_nonempty():
            self._finalize_active()
        self._drain_pending()
        self._clear_active()
        self._positions = []
        self._active_snapshot = None

    def _clear_active(self) -> None:
        self.state = None

    # ------------------------------------------------------------------
    def _all_submaps(self) -> list[submap_mod.Submap]:
        """Finalized submaps plus a cached snapshot of the active one,
        consed into throwaway levels so repeated save() calls never grow
        the persistent ``self.levels``."""
        self._drain_pending()
        out = list(self.submaps)
        if self._active_nonempty():
            if self._active_snapshot is None:
                scratch = dag.NodeLevels()
                sm = self._snapshot_active(scratch)
                sm.levels = scratch
                sm.anchor = self._anchor_from(self._positions)
                self._active_snapshot = sm
            out.append(self._active_snapshot)
        return out

    def _snapshot_active(self, levels: dag.NodeLevels) -> submap_mod.Submap:
        """The active map finalized into ``levels``."""
        return submap_mod.finalize(self.state, levels, self.config,
                                   self._positions)

    def _sm_levels(self, sm: submap_mod.Submap) -> dag.NodeLevels:
        return sm.levels if sm.levels is not None else self.levels

    def _reanchor_codes(self, codes: np.ndarray,
                        transform: np.ndarray) -> np.ndarray:
        """Map world voxel codes through a rigid correction: decode to voxel
        centers, transform, re-discretize (floor(p/res), morton.hpp:71)."""
        coords = morton.np_decode63(codes)
        res = self.config.sdf_res
        centers = (coords.astype(np.float64) + 0.5) * res
        t = np.asarray(transform, np.float64)
        moved = centers @ t[:3, :3].T + t[:3, 3]
        vox = np.floor(moved / res).astype(np.int32)
        return morton.np_encode63(vox)

    def _leaf_voxels(self, sm: submap_mod.Submap):
        """(voxel codes uint64, signed distances f32, weights uint8) of a
        submap's present voxels, in its own frame."""
        levels = self._sm_levels(sm)
        ccodes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
        _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
        lt = codec.unpack_cluster_u64(words_t)               # (M, 8)
        lw = codec.unpack_cluster_u64(words_w)
        present = lt != codec.EMPTY
        vox_codes = (ccodes[:, None] << np.uint64(3)) | \
            np.arange(8, dtype=np.uint64)[None, :]
        sd = codec.np_decode_sd(lt, self.config.sdf_trunc)
        return vox_codes[present], sd[present], lw[present]

    def voxel_samples(self, submaps=None):
        """All (voxel Morton code uint64, signed distance f32) samples of
        the selected submaps.  Voxels seen by several submaps are fused by
        a weighted mean over the stored quantized weights.  Submaps with a
        ``corrected`` pose are re-anchored first."""
        if submaps is None:
            submaps = self._all_submaps()
        all_codes, all_sd, all_w = [], [], []
        for sm in submaps:
            codes_i, sd_i, w_i = self._leaf_voxels(sm)
            if sm.corrected is not None:
                codes_i = self._reanchor_codes(codes_i, sm.corrected)
            all_codes.append(codes_i)
            all_sd.append(sd_i.astype(np.float32))
            all_w.append(np.maximum(w_i.astype(np.float32), 1.0))
        if not all_codes:
            return np.zeros(0, np.uint64), np.zeros(0, np.float32)
        codes = np.concatenate(all_codes)
        sd = np.concatenate(all_sd)
        w = np.concatenate(all_w)
        order = np.argsort(codes, kind="stable")
        codes, sd, w = codes[order], sd[order], w[order]
        starts = np.flatnonzero(
            np.concatenate([[True], codes[1:] != codes[:-1]]))
        wsum = np.add.reduceat(w, starts)
        sdw = np.add.reduceat(sd * w, starts)
        return codes[starts], (sdw / wsum).astype(np.float32)

    def _mesh_impl(self) -> str:
        """``mesh_impl`` resolved: ``auto`` meshes on the card for a CUDA
        map (where the JAX package meshes on the TPU) and on the host for
        a CPU map; ``device`` on a CPU map runs the same torch ops there."""
        impl = self.config.mesh_impl
        if impl == "auto":
            impl = "device" if self.device.type == "cuda" else "host"
        return impl

    def _mesh_timed(self, optimize_iterations: int = 0,
                    optimize_method: str = "planar"):
        """:meth:`extract_mesh`, the milliseconds of its stages
        (``voxel_samples_ms``, ``mc_ms``: marching cubes through the weld
        and the read-back, ``normals_ms``) and the meshed samples."""
        submaps = self._all_submaps()
        if self.config.mesh_first_submap_only and submaps:
            submaps = submaps[:1]   # reference parity (tsdf.cpp:85)
        with span("chad.save.voxel_samples") as s_vs:
            codes, sd = self.voxel_samples(submaps)
        with span("chad.save.mc") as s_mc:
            if self._mesh_impl() == "device":
                v, f = device_mc.triangulate_device(
                    codes, sd, self.config.sdf_res, device=self.device)
            else:
                v, f = triangulate(codes, sd, self.config.sdf_res)
        with span("chad.save.normals") as s_n:
            mesh = TriangleMesh(v, f, _vertex_normals(v, f))
        if optimize_iterations > 0:
            if optimize_method == "planar":
                mesh = optimize.optimize_planar_faces(mesh,
                                                      optimize_iterations)
            elif optimize_method == "taubin":
                mesh = optimize.taubin_smooth(mesh, optimize_iterations)
            else:
                raise ValueError(f"bad optimize_method {optimize_method!r}")
        split = {"voxel_samples_ms": s_vs.ms, "mc_ms": s_mc.ms,
                 "normals_ms": s_n.ms}
        return mesh, split, (codes, sd)

    def extract_mesh(self, optimize_iterations: int = 0,
                     optimize_method: str = "planar"):
        """Marching-cubes mesh of the map (``mesh_impl``, see
        :meth:`_mesh_impl`).

        ``optimize_iterations > 0`` runs contour optimization analogous to
        the reference's LVR2 ``optimizePlanarFaces(mesh, 5)``
        (lvr2.cpp:262-266): method ``"planar"`` (default) clusters planar
        regions and projects contour vertices onto plane intersections;
        ``"taubin"`` is the generic shrink-free smoother.
        """
        return self._mesh_timed(optimize_iterations, optimize_method)[0]

    def save(self, filename: str) -> None:
        """Reconstruct the mesh and write it to ``filename`` (tsdf.cpp:76-86),
        and the ``.grid`` dump to ``hashgrid.grid`` in the working directory
        when ``config.save_grid`` is set (lvr2.cpp:290 writes it on every
        save).  ``last_metrics`` gets ``sub_fin_ms``, ``mesh_ms`` and its
        split (``voxel_samples_ms``, ``mc_ms``, ``normals_ms``), ``grid_ms``
        with the dump, and ``ply_ms``: the lengths of the span ``chad.save``'s
        children ``.snapshot`` (the finalized submaps and the active
        snapshot), ``.voxel_samples``, ``.mc``, ``.normals``, ``.grid``
        and ``.ply`` (``mesh_ms`` is the sum of the middle three)."""
        with span("chad.save"):
            with span("chad.save.snapshot") as s_fin:
                self._all_submaps()        # finalizes the active snapshot
            mesh, split, samples = self._mesh_timed()
            mesh_ms = sum(split.values())
            if self.config.profile:
                print(f"sub fin  {s_fin.ms:8.2f} ms")
                print(f"mesh     {mesh_ms:8.2f} ms  "
                      f"({mesh.n_vertices} verts, {mesh.n_faces} faces)")
            self.last_metrics["sub_fin_ms"] = s_fin.ms
            self.last_metrics["mesh_ms"] = mesh_ms
            self.last_metrics.update(split)
            if self.config.save_grid:
                with span("chad.save.grid") as s:
                    if self.config.mesh_first_submap_only:  # the dump has all
                        samples = self.voxel_samples()
                    grid_io.write_grid("hashgrid.grid", *samples,
                                       self.config.sdf_res)
                self.last_metrics["grid_ms"] = s.ms
            with span("chad.save.ply") as s:
                write_ply(filename, mesh)
            self.last_metrics["ply_ms"] = s.ms

    def save_grid(self, filename: str) -> None:
        """The reference's binary ``.grid`` dump of every submap's samples
        (``mesh/grid.py``)."""
        codes, sd = self.voxel_samples()
        grid_io.write_grid(filename, codes, sd, self.config.sdf_res)

    # ------------------------------------------------------------------
    def leaf_arrays(self, submap: submap_mod.Submap | None = None):
        """Vectorized leaf export: (world voxel coords (N, 3) int32,
        signed distances (N,) f32, weights (N,) uint8) over the selected
        submaps — the bulk form of :meth:`leaf_items`."""
        submaps = [submap] if submap is not None else self._all_submaps()
        coords_l, sd_l, w_l = [], [], []
        for sm in submaps:
            codes, sd, w = self._leaf_voxels(sm)
            coords_l.append(morton.np_decode63(codes))
            sd_l.append(sd)
            w_l.append(w)
        if not coords_l:
            return (np.zeros((0, 3), np.int32), np.zeros(0, np.float32),
                    np.zeros(0, np.uint8))
        return (np.concatenate(coords_l), np.concatenate(sd_l),
                np.concatenate(w_l))

    def leaf_items(self, submap: submap_mod.Submap | None = None):
        """Iterate (world voxel coord (3,) int32, signed distance, weight)
        — the leaf-iterator API the reference sketches but never builds
        (tsdf.hpp:120-155).  For bulk access use :meth:`leaf_arrays`."""
        coords, sds, ws = self.leaf_arrays(submap)
        for i in range(coords.shape[0]):
            yield coords[i], float(sds[i]), int(ws[i])

    def _sorted_samples(self):
        """Code-sorted (codes, sd) for point queries, cached until the map
        changes: the key moves with every insert (a rotation happens in
        one), drain, ``finalize_active`` and ``merge``."""
        cache = self._query_cache
        key = (self._n_inserts, len(self.submaps), len(self._pending))
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        codes, sd = self.voxel_samples()        # already code-sorted/unique
        self._query_cache = (key, codes, sd)
        return codes, sd

    def raycast(self, origin, direction, max_dist: float = 100.0):
        """March a ray through the map; returns the first zero-crossing hit
        position or None — the reference's declared-but-unbuilt raycast
        (tsdf.hpp:158-161).  The sorted query index is cached, so repeated
        raycasts on an unchanged map cost one searchsorted each.

        Every grid-plane crossing along the ray is enumerated (the
        vectorized form of the Amanatides-Woo walk the integrator uses,
        ops/dda.py; octree.hpp:92-152), so no voxel the ray passes through
        is skipped, even at glancing incidence."""
        codes, sd = self._sorted_samples()
        if codes.shape[0] == 0:
            return None
        origin = np.asarray(origin, np.float64)
        direction = np.asarray(direction, np.float64)
        direction = direction / np.linalg.norm(direction)
        res = float(self.config.sdf_res)

        # all grid-plane crossing parameters t in (0, max_dist), per axis
        ts = [np.asarray([0.0, max_dist])]
        for k in range(3):
            dk = direction[k]
            if dk == 0.0:
                continue
            lo = origin[k] + min(0.0, dk * max_dist)
            hi = origin[k] + max(0.0, dk * max_dist)
            planes = np.arange(np.ceil(lo / res), np.floor(hi / res) + 1)
            tk = (planes * res - origin[k]) / dk
            ts.append(tk[(tk > 0.0) & (tk < max_dist)])
        t_all = np.sort(np.concatenate(ts))
        # midpoints of consecutive crossings are strictly inside one voxel
        mid = (t_all[:-1] + t_all[1:]) * 0.5
        pts = origin[None, :] + mid[:, None] * direction[None, :]
        vox = np.floor(pts / res).astype(np.int32)
        qc = morton.np_encode63(vox)
        pos = np.minimum(np.searchsorted(codes, qc), codes.shape[0] - 1)
        hitm = codes[pos] == qc
        vals = np.where(hitm, sd[pos], np.nan)
        sign = vals < 0
        crossings = np.nonzero(hitm[:-1] & hitm[1:] & ~sign[:-1] & sign[1:])[0]
        if crossings.size == 0:
            return None
        i = crossings[0]
        a, b = vals[i], vals[i + 1]
        frac = a / (a - b) if a != b else 0.5
        return origin + (mid[i] + frac * (mid[i + 1] - mid[i])) * direction

    def merge(self, other: "TSDFMap") -> None:
        """Merge another map's finalized submaps into this one — the
        reference's declared-but-unbuilt map merging (tsdf.hpp:161).
        DAG contents are re-consed into this map's levels."""
        for sm in other._all_submaps():
            levels = other._sm_levels(sm)
            codes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
            _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
            new_sm = submap_mod.build_submap(self.levels, codes, words_t,
                                             words_w, sm.positions)
            new_sm.anchor = sm.anchor
            new_sm.corrected = sm.corrected
            self.submaps.append(new_sm)

    def optimize_loop_closures(self, loop_edges=(), iterations: int = 20,
                               damping: float = 1e-6, mesh=None,
                               huber_delta: float = 1.0) -> dict:
        """Pose-graph loop closure over the submaps — the reference's
        roadmap item (README.md:59; declared surface tsdf.hpp:158-161).

        Odometry edges come from the submap anchors (the measured relative
        pose of consecutive submaps); ``loop_edges`` is an iterable of
        ``(i, j, T_rel (4, 4), weight)`` constraints from, e.g., place
        recognition and scan matching (outside this library).  The solve
        runs in ``slam/posegraph.py`` on the map's device; each submap's
        correction ``T_opt[i] @ inv(anchor[i])`` is then applied to its
        voxels at mesh and query time.  A non-empty active map takes part
        as a trailing node through its snapshot.  With ``mesh``
        (``parallel.make_mesh``) the edges are split over its shards and
        their normal equations summed.  Returns the optimizer's stats.
        """
        from ..slam import posegraph as pg
        if self._active_nonempty():
            subs = self._all_submaps()
        else:
            self._drain_pending()
            subs = list(self.submaps)
        if len(subs) < 2:
            return {"initial_cost": 0.0, "final_cost": 0.0, "iterations": 0}
        anchors = np.stack([
            sm.anchor if sm.anchor is not None else np.eye(4)
            for sm in subs]).astype(np.float64)
        graph = pg.make_odometry_edges(anchors.astype(np.float32))
        for (i, j, z, w) in loop_edges:
            graph = pg.add_edge(graph, int(i), int(j),
                                np.asarray(z, np.float32), float(w))
        poses_opt, stats = pg.optimize_poses(
            graph, anchors.astype(np.float32), iterations=iterations,
            damping=damping, mesh=mesh, huber_delta=huber_delta,
            device=self.device)
        for sm, a, p in zip(subs, anchors, poses_opt):
            corr = p.astype(np.float64) @ np.linalg.inv(a)
            sm.corrected = None if np.allclose(corr, np.eye(4), atol=1e-7) \
                else corr
        self._query_cache = None       # re-anchoring moves voxels
        return stats

    def stats(self) -> dict:
        """DAG compression counters, finalized submaps and, for the active
        map, its blocks and overflow counters.  Drains pending rotations
        and reads the device."""
        self._warn_overflow()
        self._drain_pending()
        s = self.levels.stats()
        s["n_submaps"] = len(self.submaps)
        if self.state is not None:
            st, read = self.state, timing.host_item
            s["active_blocks"] = read(st.n_blocks)
            s["overflow"] = {
                "points": read(st.point_overflow),
                "samples": read(st.sample_overflow),
                "blocks": read(st.block_overflow),
                "touched": read(st.touched_overflow),
                "tile": read(st.tile_overflow),
            }
        return s
