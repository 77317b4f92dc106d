"""Tracing and profiling — PyTorch port of ``chad_tsdf_tpu/utils/timing.py``.

The reference brackets every pipeline stage with wall-clock timers and
always-on prints ("mc  calc", "mc  sort", "norm est", "oct  upd", "sub fin",
"total": reference morton.hpp:76-78, 98-100, normals.hpp:144-146,
octree.hpp:167-169, submap.hpp:103-105, tsdf.cpp:72-74).  The port's
insert is a queue of asynchronous launches, so per-stage timing is a
diagnostic: :class:`StageTimer` brackets stages with CUDA events on the card
(device milliseconds, read once at :meth:`StageTimer.report`) and with the
host clock on the CPU, and :func:`profile_insert` runs the sort-based
pipeline stage by stage in the JAX module's layout.  :func:`trace` wraps
``torch.profiler`` and writes a Chrome trace; :class:`JsonMetricsSink`
writes one JSON object per insert.

The program itself is instrumented with :class:`span` (named host
intervals at each layer boundary: ``chad.insert``, ``chad.finalize``,
``chad.save`` and their stages), which become ranges in a running
profiler's timeline and cost two clock reads otherwise, and
with the process-wide counters :data:`COUNTS` (:func:`count`,
:func:`counts`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# Process-wide event counters (plain ints, as ``kernels.LAUNCHES``):
# ``inserts`` (TSDFMap.insert calls), ``graph_replays``, ``graph_captures``,
# ``rotations`` (submaps rotated out), ``finishes`` (submaps built into the
# DAG, the active snapshot of ``save`` included), ``finishes_in_insert``
# (those an insert had to run because too many rotations were pending),
# ``h2d_bytes`` (the clouds, positions and point counts sent to the
# device), ``d2h_bytes`` (counters, compacted clusters and meshes read
# back), ``host_syncs`` (every place the host waits for the device: a
# tensor read, an event or a stream synchronisation; counted at the same
# sites on a CPU map), ``carve_inserts`` (inserts of a carving map),
# ``carve_device_us`` (the device time of the carves timed so far, in
# whole microseconds: :class:`CarveClock`) and ``carve_timed`` (those
# carves).
COUNTS = dict.fromkeys(("inserts", "graph_replays", "graph_captures",
                        "rotations", "finishes", "finishes_in_insert",
                        "h2d_bytes", "d2h_bytes", "host_syncs",
                        "carve_inserts", "carve_device_us", "carve_timed"),
                       0)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of :data:`COUNTS`."""
    COUNTS[name] += n


def counts() -> dict:
    """A copy of :data:`COUNTS`."""
    return dict(COUNTS)


def host_item(t):
    """``t.item()``, counted as one host wait reading ``t``'s bytes."""
    COUNTS["host_syncs"] += 1
    COUNTS["d2h_bytes"] += t.nbytes
    return t.item()


def to_host(t):
    """``t.cpu()``, counted as one host wait reading ``t``'s bytes."""
    COUNTS["host_syncs"] += 1
    COUNTS["d2h_bytes"] += t.nbytes
    return t.cpu()


def wait(event) -> None:
    """``event.synchronize()`` (None: nothing to wait for on the CPU),
    counted as one host wait."""
    COUNTS["host_syncs"] += 1
    if event is not None:
        event.synchronize()


def synchronize(device) -> None:
    """Wait for everything queued on ``device`` (nothing to wait for on
    the CPU), counted as one host wait."""
    COUNTS["host_syncs"] += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Profiled:
    """The spans closed while a profiler ran: (name, start s, end s) on
    the host clock, and :data:`COUNTS` at the first span's start and at
    the last span's end.  Emptied when a span opens under a profiler after
    one opened without."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.counts0: dict = {}
        self.counts1: dict = {}


_PROFILED = _Profiled()


def profiled() -> dict | None:
    """The spans of the last profiled stretch and the counters' growth
    over it: ``{"spans": [(name, start s, end s), ...], "counts": {name:
    delta}}``, or None when no span has closed under a profiler."""
    p = _PROFILED
    if not p.spans:
        return None
    return {"spans": list(p.spans),
            "counts": {k: p.counts1[k] - p.counts0[k] for k in p.counts0}}


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class span:
    """A named host interval: ``with span("chad.insert", args=i) as s:``,
    then ``s.ms`` is its length in milliseconds (the host clock).  Spans
    nest; a span's parent is the span open around it.

    While a ``torch.profiler`` runs (and no CUDA graph is being
    captured), the block is also a profiler range named ``name`` with
    ``str(args)`` as its input, on the clock the profiler traces the
    device on, so the device's idle time can be put down to the span the
    host was in; the span is then kept for :func:`profiled`.  Otherwise
    the profiler is not touched.  The range is an operator's
    (``_RecordFunctionFast``), not a ``record_function`` user annotation:
    the profiler mirrors each user annotation onto the device's timeline
    as one interval over the kernels launched inside it, which would read
    as device work wherever the device's busy time is a union of its
    intervals."""

    __slots__ = ("name", "args", "ms", "_t0", "_range")

    def __init__(self, name: str, args=None):
        self.name = name
        self.args = args
        self.ms = None
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            if not _capturing():
                p = _PROFILED
                if not p.on:
                    p.on, p.spans, p.counts0 = True, [], counts()
                fast = torch._C._profiler._RecordFunctionFast
                self._range = fast(self.name) if self.args is None else \
                    fast(self.name, [str(self.args)])
                self._range.__enter__()
        else:
            _PROFILED.on = False
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.ms = (t1 - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
            _PROFILED.spans.append((self.name, self._t0, t1))
            _PROFILED.counts1 = counts()
        return False


# the event pairs a CarveClock keeps in flight
CLOCK_RING = 64


class CarveClock:
    """The device time of a map's carves, summed into :data:`COUNTS` with
    no host wait: ``with clock:`` around a carve's launches;
    ``carve_device_us`` grows by its microseconds (rounded to whole ones),
    ``carve_timed`` by one, once the time is known.

    On CUDA the carve is bracketed by a pair of timing events, recorded by
    the host on the current stream, from a ring of :data:`CLOCK_RING`
    pairs.  A pair is folded in when its end event's ``query()`` says the
    device has passed it, which is checked (oldest first, never waited
    for) each time a carve starts and at :meth:`fold`.  A carve that finds
    every pair of the ring still pending goes untimed.  On the CPU the
    carve is timed by the host clock and folded in at once."""

    __slots__ = ("cuda", "_pending", "_free", "_made", "_pair", "_t0")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._pending: collections.deque = collections.deque()
        self._free: list = []
        self._made = 0
        self._pair = None

    def fold(self) -> None:
        """Add the pairs the device has passed to the counters."""
        while self._pending and self._pending[0][1].query():
            a, b = self._pending.popleft()
            COUNTS["carve_device_us"] += round(a.elapsed_time(b) * 1e3)
            COUNTS["carve_timed"] += 1
            self._free.append((a, b))

    def __enter__(self):
        if not self.cuda:
            self._t0 = time.perf_counter()
            return self
        self.fold()
        if not self._free and self._made < CLOCK_RING:
            self._free.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
            self._made += 1
        self._pair = self._free.pop() if self._free else None
        if self._pair is not None:
            self._pair[0].record()
        return self

    def __exit__(self, *exc):
        if not self.cuda:
            COUNTS["carve_device_us"] += round(
                (time.perf_counter() - self._t0) * 1e6)
            COUNTS["carve_timed"] += 1
        elif self._pair is not None:
            self._pair[1].record()
            self._pending.append(self._pair)
            self._pair = None
        return False


class StageTimer:
    """Named stage times in milliseconds: CUDA events on ``device="cuda"``
    (the device's own clock; nothing waits until :attr:`stages` or
    :meth:`report` is read), the host clock on ``device="cpu"``.

    ``stage(name)`` brackets a block; a nested stage ends first and is
    listed first, as in the JAX timer.  ``mark(name)`` ends a stage named
    ``name`` here, begun where the previous mark (or the timer) began, for
    stages whose ends are all that is known (``core.integrate.STAGE_HOOK``).
    """

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: list = []        # (name, start, end) clock readings
        self._t0 = self._now()
        self._last = self._t0

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _ms(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the block as stage ``name``.  ``sync_on`` (a tensor) makes
        the host wait for the device at the end of the block, as the JAX
        timer's ``block_until_ready`` does; events need no wait."""
        t0 = self._now()
        yield
        if sync_on is not None and getattr(sync_on, "is_cuda", False):
            torch.cuda.synchronize(sync_on.device)
        self._marks.append((name, t0, self._now()))

    def mark(self, name: str) -> None:
        """End stage ``name`` here; it began at the previous mark."""
        now = self._now()
        self._marks.append((name, self._last, now))
        self._last = now

    @property
    def stages(self) -> list[tuple[str, float]]:
        """[(name, ms)] in the order the stages ended."""
        return [(name, self._ms(a, b)) for name, a, b in self._marks]

    def report(self) -> str:
        """One line per stage and a ``total`` line (since the timer was
        made), in the JAX module's layout."""
        lines = [f"{name:<8} {ms:8.2f}" for name, ms in self.stages]
        total = self._ms(self._t0, self._now())
        lines.append(f"{'total':<8} {total:8.2f}")
        return "\n".join(lines)


def profile_insert(state, points, n_points, position, config):
    """Stage-by-stage timed insert through the sort-based pipeline
    (diagnostic): ``mc+norm`` (keys, sort, normals, DDA), ``smp sort`` and
    ``pool upd``.  ``state`` is consumed as ``insert_step`` consumes it.

    Returns (new_state, metrics, report string).
    """
    from ..core import integrate

    t = StageTimer(state.device)
    with t.stage("mc+norm"):
        batch = integrate.compute_samples(points, n_points, position,
                                          state.origin_blocks, config)
    with t.stage("smp sort"):
        batch = integrate.sort_samples(batch)
    with t.stage("pool upd"):
        state, metrics = integrate.update_pool(state, batch, config)
    return state, metrics, t.report()


@contextlib.contextmanager
def trace(logdir: str | None = None, device=None):
    """``torch.profiler`` over the block; on exit a Chrome trace
    (``trace_<pid>_<ns>.json``) is written into ``logdir`` (made if
    missing; by default ``chad_tsdf_trace`` in the temporary directory).
    CUDA activity is traced when ``device`` is a CUDA device, or, with no
    device given, when a card is present.  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "chad_tsdf_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class JsonMetricsSink:
    """Structured metrics log: one JSON object per insert.  Values with an
    ``item`` method (tensors, numpy scalars) are written as ints: reading
    them waits for the device, a drain point the caller chose.  Values of a
    ``TSDFMap.insert`` result (``LazyMetrics``) arrive as Python scalars."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, record: dict) -> None:
        record = {k: (int(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record["ts"] = time.time()
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
