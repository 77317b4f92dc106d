"""One insert as one CUDA graph replay — the JAX package's one donated
``jax.jit`` executable per chunk of ``TSDFMap.insert`` (``insert_step`` or
``insert_step_packed``, then ``carve_step`` or ``carve_step_packed``;
``chad_tsdf_tpu/core/map.py:152-180``).

:class:`InsertGraph` captures, on a state it is given and on its own
static input buffers (the cloud's f32 points, as many rows as the scan
has, in a buffer of the bucket's size; the scanner position; the point
count as an i32[] tensor):

1. the padding (rows from the count on are zero, as the host pads them)
   and, under ``MapConfig.packed_ingest``, ``pack_points`` and the unpack,
   on the device and bit-equal to the host's (``integrate.
   pack_points_device``);
2. the insert of ``core/integrate.py`` ``insert_body`` under the config's
   backend, its directory and counters written back into the state (the
   pools are updated in place);
3. under ``fused``, ``tile`` and ``sample_tile``, the fallback as a CUDA
   conditional IF node on the count of uncovered samples
   (``ops/conditional.py``): a one-thread kernel sets the node's handle on
   the device, and the node's body (the uncovered samples — under
   ``fused`` the sample grids and K4 first — sorted, then the sort-based
   ``update_pool`` through K5) runs only where the count is positive —
   ``lax.cond`` itself, with no host read;
4. the metrics into a static i32 vector.

When the map carves, the carve (``core/carve.py``) is a second graph,
captured right after the first and replayed right after it
(:meth:`InsertGraph.replay_carve`): it reads the first graph's padded
(and, under packed ingest, unpacked) points, which stay where that
capture put them, and writes its metrics into the same vector.  Apart,
its device time can be bracketed by events between the two replays.

``TSDFMap.insert`` sends every chunk through one per (dispatched config,
point bucket, packed ingest, carving) on the map's own active state, on
every device: a scan is one host-to-device copy of its points into the
input buffer, then the step, with no copy of the state in or out and no
padding or packing on the host.  On CUDA (:func:`use_graph`, and
``TSDFMap.graphs_enabled``) the step is captured and replayed; otherwise
:meth:`InsertGraph.run_step` and :meth:`InsertGraph.run_carve` run it
eagerly on each insert, the fallback unconditionally (no IF node outside
a capture), which changes nothing when no sample needs it.
``insert_steps_scan`` keeps one per (config, cloud shape) on a copy of
the state it is given.

Before capture, :meth:`InsertGraph.warm` runs the same insert eagerly on
the same buffers, so every kernel is built, every lazily loaded module
loaded and K5's cached workspace allocated.  The warm insert is a real
insert: its result stays.  A capture that fails raises; nothing falls
back to the eager insert.  The stage hook of ``profile_insert`` is off
while capturing.  ``kernels.LAUNCHES`` counts
the launches of the warm insert and the capture, never a replay:
``launches`` holds what one replay (both graphs) launches outside the IF
node and ``body_launches`` what its body launches when the count is
positive; ``replays`` and ``timing.COUNTS["graph_replays"]`` count
inserts replayed, the carve's graph with its insert's.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import MapConfig
from ..ops import accumulate, conditional
from ..utils import timing
from . import carve, integrate
from .state import ActiveMapState

INSERT_KEYS = ("n_valid_samples", "n_touched_blocks", "n_new_blocks",
               "n_blocks")
CARVE_KEYS = ("n_carve_samples", "n_carved_voxels", "n_carve_dropped")


def use_graph(device: torch.device) -> bool:
    """Whether an :class:`InsertGraph` on ``device`` is captured and
    replayed (on CUDA) rather than run eagerly."""
    return device.type == "cuda"


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


class InsertGraph:
    """One insert of a ``bucket``-point cloud on ``state`` (module
    docstring); ``carve_config`` carves after it (the map's config, as
    ``TSDFMap.insert`` carves) in a graph of its own, ``carve_graph``;
    None does not.  ``nbytes`` is what the graphs hold on the device:
    ``owned_bytes`` (a state copy it owns), their buffers and, once
    captured, the memory their captures reserved."""

    def __init__(self, state: ActiveMapState, config: MapConfig,
                 bucket: int, packed: bool = False,
                 carve_config: MapConfig | None = None,
                 owned_bytes: int = 0):
        dev = state.device
        self.state = state
        self.config = config
        self.packed = packed
        self.carve_config = carve_config
        self.points = torch.zeros((bucket, 3), dtype=torch.float32,
                                  device=dev)
        self.position = torch.zeros(3, dtype=torch.float32, device=dev)
        self.n_points = torch.zeros((), dtype=torch.int32, device=dev)
        self.keys = INSERT_KEYS + (CARVE_KEYS if carve_config else ())
        self.out = torch.zeros(len(self.keys), dtype=torch.int32, device=dev)
        self.graph = None
        self.carve_graph = None
        self._pts = None              # the carve's input: the padded points
        self.launches: dict = {}
        self.body_launches: dict = {}
        self.replays = 0
        self.nbytes = owned_bytes + sum(
            t.nbytes for t in (self.points, self.position, self.n_points,
                               self.out))
        self._pool = None
        self._workspace = None

    def load(self, points, position, n_points) -> None:
        """Copy the next cloud's f32 points (numpy or a tensor, at most the
        bucket's rows; rows from ``n_points`` on count as padding), the
        scanner position and the point count into the input buffers.  A
        copy from host memory is queued without waiting for the stream
        (pageable memory is staged at once); ``timing.COUNTS["h2d_bytes"]``
        counts what comes from the host."""
        points, position = torch.as_tensor(points), torch.as_tensor(position)
        self.points[:points.shape[0]].copy_(points, non_blocking=True)
        self.position.copy_(position, non_blocking=True)
        sent = sum(t.nbytes for t in (points, position)
                   if t.device.type == "cpu")
        if isinstance(n_points, torch.Tensor):
            self.n_points.copy_(n_points)
        else:
            self.n_points.fill_(int(n_points))
            sent += self.n_points.nbytes
        timing.count("h2d_bytes", sent)

    def _step(self, eager: bool) -> None:
        cfg = self.config
        st = self.state
        rows = torch.arange(self.points.shape[0], dtype=torch.int32,
                            device=self.points.device)
        pts = torch.where((rows < self.n_points)[:, None], self.points, 0.0)
        if self.packed:
            pts = integrate.unpack_points(integrate.pack_points_device(
                pts, self.position, cfg.sdf_res), self.position, cfg)
        new, met, tile_ovf, make_fallback = integrate.insert_body(
            st, pts, self.n_points, self.position, cfg)
        integrate.write_back(st, new)
        n_ins = len(INSERT_KEYS)
        self.out[:n_ins].copy_(torch.stack([met[k] for k in INSERT_KEYS]))
        if tile_ovf is not None:
            def fallback():
                before = dict(kernels.LAUNCHES)
                grown = {"n_new_blocks": self.out[2], "n_blocks": self.out[3]}
                fb = integrate._apply_fallback(make_fallback, st, grown,
                                               cfg)
                integrate.write_back(st, fb)
                self.out[2:4].copy_(torch.stack([grown["n_new_blocks"],
                                                 grown["n_blocks"]]))
                self.body_launches = _launched(before)
            if eager:
                fallback()
            else:
                conditional.if_positive(tile_ovf, fallback, self._pool)
        if self.carve_config is not None:
            self._pts = pts

    def run_carve(self) -> None:
        """The carve of the insert just run, eagerly (and what the carve's
        graph captures)."""
        new, cm = carve.carve_step(self.state, self._pts, self.n_points,
                                   self.position, self.carve_config)
        integrate.write_back(self.state, new)
        self.out[len(INSERT_KEYS):].copy_(
            torch.stack([cm[k] for k in CARVE_KEYS]))

    def metrics(self) -> dict:
        """The last insert's metrics as device scalars of a copy of the
        metric vector (the next replay overwrites the vector, not them)."""
        vals = self.out.clone()
        return {k: vals[i] for i, k in enumerate(self.keys)}

    def run_step(self) -> None:
        """The insert, eagerly on the graph's buffers: its fallback runs
        unconditionally (no IF node outside a capture), which changes
        nothing when no sample needs it.  A carving graph's carve is
        :meth:`run_carve`, which must follow."""
        integrate._stage("host prep + upload")
        self._step(eager=True)

    def warm(self) -> dict:
        """The insert and its carve, eagerly (module docstring); returns
        their metrics."""
        self.run_step()
        if self.carve_config is not None:
            self.run_carve()
        return self.metrics()

    def capture(self) -> None:
        """Capture the insert, then its carve when it carves; raises if a
        capture fails."""
        dev = self.state.device
        cuda = dev.type == "cuda"
        if cuda:
            self._pool = torch.cuda.MemPool()
            timing.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        hook, integrate.STAGE_HOOK = integrate.STAGE_HOOK, None
        try:
            with torch.cuda.graph(graph):
                self._step(eager=False)
            if self.carve_config is not None:
                carve_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(carve_graph):
                    self.run_carve()
                self.carve_graph = carve_graph
        finally:
            integrate.STAGE_HOOK = hook
        timing.count("graph_captures")
        launched = _launched(before)
        self.launches = {k: v - self.body_launches.get(k, 0)
                         for k, v in launched.items()
                         if v != self.body_launches.get(k, 0)}
        self.graph = graph
        if cuda:
            self.nbytes += torch.cuda.memory_reserved(dev) - reserved
            # K5's cached workspace, alive for the graph's pointers even if
            # a later call grows the cache past it
            self._workspace = accumulate._WORKSPACE.get(dev)

    def replay(self) -> None:
        """Replay the insert (its carve, if any, is :meth:`replay_carve`,
        which must follow)."""
        self.graph.replay()
        self.replays += 1
        timing.count("graph_replays")

    def replay_carve(self) -> None:
        """Replay the carve of the insert just replayed."""
        self.carve_graph.replay()
