"""TSDFMap — the public API of the PyTorch port (``chad_tsdf_tpu/core/map.py``).

Mirrors the reference's entry class ``chad::TSDFMap`` (reference:
include/chad/tsdf.hpp:21-171, src/chad/tsdf.cpp:26-86):

* ``insert(points, position)``: submap rotation after ``submap_distance``
  of travel (tsdf.cpp:46-61), then the sort -> normals -> DDA -> integrate
  pipeline of core/integrate.py on the map's device;
* ``save(filename)``: snapshot the active submap into the DAG, mesh the
  union of all submaps with host marching cubes and write a PLY
  (tsdf.cpp:76-86).  As in the JAX package, save() is idempotent and
  meshes every submap unless ``mesh_first_submap_only``.

The map runs on the card (``device="cuda"``, the default) unless the
caller passes ``device="cpu"``; without a card the default raises rather
than falling back to the CPU.  ``accumulate_impl`` may be ``auto``,
``fused``, ``tile``, ``pallas`` or ``xla`` (core/integrate.py).  Not ported yet (ROADMAP.md):
the sparse ``seg`` and ``sample_tile`` backends, packed ingest, carving,
deferred rotation, device marching cubes, the ``.grid`` dump,
raycast/merge/leaf_arrays/stats and loop closure; the options that select
them raise NotImplementedError.
"""

from __future__ import annotations

import collections.abc
import time
import warnings

import numpy as np
import torch

from ..config import MapConfig
from ..mesh import marching_cubes, write_ply
from ..ops import codec
from . import dag, integrate, submap as submap_mod
from .state import create_state, origin_blocks_for_position, resolve_device


class LazyMetrics(collections.abc.MutableMapping):
    """Per-insert metrics whose values stay on the device until first read.

    Reading a key converts (and caches) that value as a Python scalar; a
    streaming loop that ignores the metrics never waits for the device.
    A ``MutableMapping`` rather than a dict subclass, so ``dict(m)``,
    ``**m`` and ``==`` all go through the converting ``__getitem__``.
    ``raw(key)`` returns the stored value unconverted.
    """

    def __init__(self, data=None):
        self._data = dict(data or {})

    def __getitem__(self, key):
        v = self._data[key]
        if not isinstance(v, (int, float)):
            v = v.item()
            self._data[key] = v
        return v

    def __setitem__(self, key, value):
        self._data[key] = value

    def __delitem__(self, key):
        del self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def raw(self, key):
        return self._data[key]

    def materialize(self) -> "LazyMetrics":
        for k in self._data:
            self[k]
        return self

    def copy(self) -> dict:
        return dict(self.materialize())

    def __repr__(self):
        return repr(dict(self.materialize()))


def _check_ported(config: MapConfig) -> None:
    missing = []
    if config.packed_ingest:
        missing.append("packed_ingest")
    if config.carve_steps > 0:
        missing.append("carve_steps")
    if config.save_grid:
        missing.append("save_grid")
    if config.mesh_impl == "device":
        missing.append("mesh_impl='device'")
    if config.accumulate_impl not in ("auto", "fused", "tile", "pallas",
                                      "xla"):
        missing.append(f"accumulate_impl={config.accumulate_impl!r}")
    if missing:
        raise NotImplementedError(
            f"not ported to PyTorch yet (see ROADMAP.md): {missing}")


class TSDFMap:
    def __init__(self, sdf_res: float = 0.05, sdf_trunc: float = 0.1,
                 config: MapConfig | None = None, device="cuda"):
        if config is None:
            config = MapConfig(sdf_res=sdf_res, sdf_trunc=sdf_trunc)
        elif (sdf_res, sdf_trunc) != (config.sdf_res, config.sdf_trunc):
            import dataclasses
            config = dataclasses.replace(config, sdf_res=sdf_res,
                                         sdf_trunc=sdf_trunc)
        _check_ported(config)
        self.config = config
        self.device = resolve_device(device)
        self.levels = dag.NodeLevels()
        self.submaps: list[submap_mod.Submap] = []
        self.state = None
        self._positions: list[np.ndarray] = []
        self._active_snapshot: submap_mod.Submap | None = None
        self.last_metrics: dict = {}

    # ------------------------------------------------------------------
    @property
    def n_submaps(self) -> int:
        """Finalized submaps."""
        return len(self.submaps)

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
        """
        t0 = time.perf_counter()
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        position = np.asarray(position, np.float32).reshape(3)

        # submap rotation policy (tsdf.cpp:46-61)
        if self.state is None:
            self._start_submap(position)
        elif self._positions and np.linalg.norm(
                position - self._positions[0]) > self.config.submap_distance:
            self._finalize_active()
            self._start_submap(position)
        self._positions.append(position.copy())
        self._active_snapshot = None
        pos_t = torch.from_numpy(position.copy()).to(self.device)

        cap = self.config.max_points
        buckets = self.config.buckets
        metrics_acc: dict = {}
        for beg in range(0, max(len(points), 1), cap):
            chunk = points[beg:beg + cap]
            n = chunk.shape[0]
            # pad to the smallest shape bucket that fits (map.py:155-164 of
            # the JAX package): the tile kernels need N % 1024 == 0, and a
            # small scan skips most of the max_points pipeline
            bucket = next((b for b in buckets if b >= n), cap)
            if n < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - n, 3), np.float32)])
            cfg = self._dispatch_config(points[beg:beg + cap])
            self.state, metrics = integrate.insert_step(
                self.state, torch.from_numpy(chunk).to(self.device), n,
                pos_t, cfg)
            for k, v in metrics.items():
                metrics_acc[k] = (metrics_acc[k] + v) if k in metrics_acc \
                    else v
        metrics_acc = LazyMetrics(metrics_acc)
        if self.config.profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            metrics_acc["wall_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"insert   {metrics_acc['wall_ms']:8.2f} ms  "
                  f"samples={metrics_acc['n_valid_samples']} "
                  f"blocks={metrics_acc['n_blocks']}")
        self._n_inserts = getattr(self, "_n_inserts", 0) + 1
        # the overflow check reads the device: amortize it over the stream
        if self._n_inserts % 64 == 0 or self.config.profile:
            self._warn_overflow()
        self.last_metrics = metrics_acc
        return metrics_acc

    # overflow kinds that drop content; tile_overflow is excluded (those
    # samples are integrated exactly by the fallback)
    _LOSSY_OVERFLOWS = ("point_overflow", "sample_overflow",
                        "block_overflow", "touched_overflow")

    def _warn_overflow(self) -> None:
        """Warn once per counter kind when dropped-data overflow appears."""
        if self.state is None:
            return
        warned = getattr(self, "_overflow_warned", set())
        knob = {"point_overflow": "block_bits (local extent)",
                "sample_overflow": "block_bits (local extent)",
                "block_overflow": "block_capacity",
                "touched_overflow": "touched_capacity"}
        for name in self._LOSSY_OVERFLOWS:
            if name in warned:
                continue
            v = int(getattr(self.state, name))
            if v > 0:
                warnings.warn(
                    f"TSDFMap: {name} = {v} — samples were dropped and "
                    f"counted; the map is degraded in those regions. "
                    f"Raise MapConfig.{knob[name]} to avoid this.",
                    stacklevel=3)
                warned.add(name)
        self._overflow_warned = warned
        self._checked_at_insert = getattr(self, "_n_inserts", 0)

    def __del__(self):
        # a short-lived map (< 64 inserts, never rotated or saved) would
        # otherwise drop data without warning; read the counters only when
        # inserts happened since the last check
        try:
            n = getattr(self, "_n_inserts", 0)
            if n and n != getattr(self, "_checked_at_insert", -1):
                self._warn_overflow()
        except Exception:     # interpreter shutdown: modules may be gone
            pass

    def _dispatch_config(self, chunk: np.ndarray) -> MapConfig:
        """The JAX package picks the sparse ``seg`` backend per scan on the
        TPU; that backend is not ported, so every scan takes the config's
        own backend — what the JAX package does off the TPU."""
        return self.config

    def _start_submap(self, position: np.ndarray) -> None:
        origin = origin_blocks_for_position(position, self.config)
        self.state = create_state(self.config, origin, self.device)
        self._positions = []

    @staticmethod
    def _anchor_from(positions) -> np.ndarray:
        a = np.eye(4, dtype=np.float64)
        if positions:
            a[:3, 3] = np.asarray(positions[0], np.float64)
        return a

    def _finalize_active(self) -> None:
        """Rotation: finalize the active map into a submap now (synchronous
        in this port; deferred rotation is not ported yet)."""
        sm = submap_mod.finalize(self.state, self.levels, self.config,
                                 self._positions)
        sm.anchor = self._anchor_from(self._positions)
        self.submaps.append(sm)
        self._checked_at_insert = getattr(self, "_n_inserts", 0)

    def _active_nonempty(self) -> bool:
        return self.state is not None and int(self.state.n_blocks) > 0

    def finalize_active(self) -> None:
        """Finalize the current active map into a submap immediately (the
        rotation step of tsdf.cpp:46-61, callable explicitly)."""
        if self._active_nonempty():
            self._finalize_active()
        self.state = None
        self._positions = []
        self._active_snapshot = None

    # ------------------------------------------------------------------
    def _all_submaps(self) -> list[submap_mod.Submap]:
        """Finalized submaps plus a cached snapshot of the active one,
        consed into throwaway levels so repeated save() calls never grow
        the persistent ``self.levels``."""
        out = list(self.submaps)
        if self._active_nonempty():
            if self._active_snapshot is None:
                scratch = dag.NodeLevels()
                sm = submap_mod.finalize(self.state, scratch, self.config,
                                         self._positions)
                sm.levels = scratch
                sm.anchor = self._anchor_from(self._positions)
                self._active_snapshot = sm
            out.append(self._active_snapshot)
        return out

    def _sm_levels(self, sm: submap_mod.Submap) -> dag.NodeLevels:
        return sm.levels if sm.levels is not None else self.levels

    def voxel_samples(self, submaps=None):
        """All (voxel Morton code uint64, signed distance f32) samples of
        the selected submaps.  Voxels seen by several submaps are fused by
        a weighted mean over the stored quantized weights."""
        if submaps is None:
            submaps = self._all_submaps()
        all_codes, all_sd, all_w = [], [], []
        for sm in submaps:
            levels = self._sm_levels(sm)
            ccodes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
            _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
            lt = codec.unpack_cluster_u64(words_t)           # (M, 8)
            lw = codec.unpack_cluster_u64(words_w)
            present = lt != codec.EMPTY
            vox_codes = (ccodes[:, None] << np.uint64(3)) | \
                np.arange(8, dtype=np.uint64)[None, :]
            sd = codec.np_decode_sd(lt, self.config.sdf_trunc)
            all_codes.append(vox_codes[present])
            all_sd.append(sd[present].astype(np.float32))
            all_w.append(np.maximum(lw[present].astype(np.float32), 1.0))
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

    def extract_mesh(self):
        """Marching-cubes mesh of the map (host numpy, as the JAX package
        runs it off the TPU)."""
        submaps = self._all_submaps()
        if self.config.mesh_first_submap_only and submaps:
            submaps = submaps[:1]   # reference parity (tsdf.cpp:85)
        codes, sd = self.voxel_samples(submaps)
        return marching_cubes(codes, sd, self.config.sdf_res)

    def save(self, filename: str) -> None:
        """Reconstruct the mesh and write it to ``filename`` (tsdf.cpp:76-86).
        ``last_metrics`` gets ``sub_fin_ms`` and ``mesh_ms``."""
        t0 = time.perf_counter()
        self._all_submaps()                # finalizes the active snapshot
        t_fin = time.perf_counter() - t0
        mesh = self.extract_mesh()
        t_mesh = time.perf_counter() - t0 - t_fin
        if self.config.profile:
            print(f"sub fin  {t_fin * 1e3:8.2f} ms")
            print(f"mesh     {t_mesh * 1e3:8.2f} ms  "
                  f"({mesh.n_vertices} verts, {mesh.n_faces} faces)")
        self.last_metrics["sub_fin_ms"] = t_fin * 1e3
        self.last_metrics["mesh_ms"] = t_mesh * 1e3
        write_ply(filename, mesh)
