"""Run one benchmark cell of ``chad_tsdf_tpu_torch`` once.

    python3 -m tsdf_bench.run --workload kitti_drive --seed 7 --seconds 10 \\
        --trace 0

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its file
``tsdf_bench/workloads/<cell>.json`` names the configuration
(``configs/<config>.json``: the ``MapConfig`` it runs and the widths of
its inputs), the traffic generator (``traffic/<generator>.py``) and its
parameters, the step
(``insert``, or ``insert_save``: an insert then ``TSDFMap.save``), the
lead-in (``lead_in``, optional: steps that only insert, before the
warm-up), the warm-up and traced steps, and the limits of the numbers
that decide ``correct`` (``check.py``).  Every metric is read by
``metrics/<name>.py`` (the part of the name before the first dot), from
the run's record.

A run: the traffic from ``--seed``; one ``TSDFMap`` on the card; the
lead-in; the warm-up steps (every shape the cell uses, rotations
included); with ``--trace 1`` a profiled slice of ``trace_steps`` steps;
then the window, a closed loop of steps for ``--seconds`` closed by
``stats()`` (pending submaps finished, the device synchronised).  Then
the program's outputs are read back, the map is freed, and the plain
reference judges them.
The last line of standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# a fixed cache directory inside the checkout, for anything that compiles
# through Triton
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from . import check  # noqa: E402
from .reference import tsdf_ref  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chad_tsdf_tpu")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_spec(name: str, overrides: dict | None = None):
    """(BENCHMARK.json, its workload entry, the workload file, the
    configuration file), updated from ``overrides``: a key of the
    configuration file (``map_config``, ``sensor``, ``world``, ``cloud``)
    updates it, any other key the workload file; a group of keys is
    merged."""
    bench = load_json("BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    conf = load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    for k, v in (overrides or {}).items():
        d = conf if k in conf else cell
        d[k] = {**d[k], **v} if isinstance(d.get(k), dict) else v
    return bench, entry, cell, conf


def traffic_of(cell: dict, conf: dict, seed: int):
    """The cell's traffic generator, ``traffic/<generator>.py``, on the
    configuration's widths and the cell's parameters."""
    gen = importlib.import_module(f"tsdf_bench.traffic.{cell['generator']}")
    return gen.Traffic(conf, cell["params"], seed)


def reader(name: str):
    """The module that reads metric ``name`` and the part after its
    first dot."""
    base, _, suffix = name.partition(".")
    return importlib.import_module(f"tsdf_bench.metrics.{base}"), suffix


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics in this mode: end-to-end ones that list it (or
    list no cells); per-layer ones that list it, or that list no cells and
    move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def gpu_info() -> dict:
    out = {"name": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["power_limit"] = r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


class Record:
    """What a run measured; the metric readers take their numbers from
    it."""

    def __init__(self):
        self.steps: list = []        # one dict per window step
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace: dict | None = None
        self.overflow = 0            # lossy overflow counts at the close
        self.touched: dict = {}      # template -> voxels one insert updates
        # template -> its points (every point of these clouds lies inside
        # the map's +-204.8 m extent)
        self.valid_points: dict = {}
        self.gpu: dict = {}


class Runner:
    """One map under one cell's traffic; ``step()`` takes the cell's next
    step."""

    def __init__(self, cell: dict, conf: dict, traffic, device):
        from chad_tsdf_tpu_torch import MapConfig, TSDFMap
        self.map = TSDFMap(config=MapConfig(**conf["map_config"]),
                           device=device)
        self.traffic = traffic
        self.save = cell["step"] == "insert_save"
        self.device = torch.device(device)
        self.ply = os.path.join(tempfile.gettempdir(),
                                f"tsdf_bench_{os.getpid()}.ply")
        self.n = 0                   # steps taken
        self.positions: list = []    # every insert's index, in order

    def step(self, out: dict | None = None, h0: float = 0.0,
             save: bool = True) -> None:
        """One step; ``out`` gets its host times (from ``h0``).  With
        ``save`` False the step only inserts (a lead-in step)."""
        pts, pos, _ = self.traffic.step(self.n)
        n_sub = len(self.map.submaps)
        t0 = time.perf_counter()
        with record_function("bench.insert"):
            self.map.insert(pts, pos)
        t1 = time.perf_counter()
        self.positions.append(self.n)
        self.n += 1
        if out is not None:
            out.update(t_call=t0 - h0, call_s=t1 - t0, points=len(pts),
                       grew=len(self.map.submaps) > n_sub)
        if self.save and save:
            ok = True
            try:
                with record_function("bench.save"):
                    self.map.save(self.ply)
            except (OSError, RuntimeError) as exc:
                print(f"save failed: {exc!r}", file=sys.stderr)
                ok = False
            if out is not None:
                out.update(save_s=time.perf_counter() - t1, save_ok=ok,
                           save_metrics={
                               k: self.map.last_metrics[k]
                               for k in ("sub_fin_ms", "voxel_samples_ms",
                                         "mc_ms", "normals_ms", "ply_ms")
                               if k in self.map.last_metrics})

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def window(run: Runner, seconds: float, rec: Record) -> None:
    """The closed loop: steps until ``seconds`` have passed, then
    ``stats()``.  Each step's latency is the device's end of its work
    (an event recorded after the call returns) less the call's start, both
    from the window's start, without a synchronisation per step."""
    cuda = run.device.type == "cuda"
    run.sync()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    h0 = time.perf_counter()
    events = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        while True:
            s: dict = {}
            n_warn = len(caught)
            run.step(s, h0)
            s["lossy"] = any("dropped" in str(w.message)
                             for w in caught[n_warn:])
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            else:
                s["end_s"] = time.perf_counter() - h0
            rec.steps.append(s)
            if time.perf_counter() - h0 >= seconds:
                break
        stats = run.map.stats()
        run.sync()
    rec.window_s = time.perf_counter() - h0
    rec.overflow = sum(v for k, v in stats.get("overflow", {}).items()
                       if k != "tile")
    for s, ev in zip(rec.steps, events):
        s["end_s"] = start.elapsed_time(ev) / 1e3
    for s, lat in zip(rec.steps, latencies_ms(
            [s["t_call"] for s in rec.steps],
            [s["end_s"] for s in rec.steps])):
        s["lat_ms"] = lat


def latencies_ms(t_call_s: list, end_s: list) -> list:
    """Each step's latency: the end of its device work (an event, in
    seconds after the window's start event) less the start of its call
    (host clock, seconds after the host read the clock at that event)."""
    return [(e - t) * 1e3 for t, e in zip(t_call_s, end_s)]


def traced_slice(run: Runner, n_steps: int) -> dict:
    """``n_steps`` steps under ``torch.profiler``: the device's busy time
    (the union of its operations' intervals) in the slice, the time by
    device operation, and the longest idle gaps named by what the host was
    doing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    templates = []
    run.sync()
    with profile(activities=acts) as prof:
        with record_function("bench.slice"):
            for _ in range(n_steps):
                templates.append(check.template_of(run.traffic, run.n))
                with record_function("bench.step"):
                    run.step()
            run.sync()
    events = prof.events()
    span = next(e for e in events if e.name == "bench.slice"
                and e.device_type.name == "CPU")
    s0, s1 = span.time_range.start, span.time_range.end
    # the harness's own ranges also appear on the device's timeline
    dev = [e for e in events if e.device_type.name == "CUDA"
           and not e.name.startswith("bench.")]
    cpu = [e for e in events if e.device_type.name == "CPU"
           and e.name != "bench.slice"]
    return {"steps": n_steps, "templates": templates,
            **reduce_trace(dev, cpu, s0, s1)}


def union(intervals: list) -> list:
    """Merged [start, end) intervals, sorted."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(dev: list, cpu: list, s0: float, s1: float) -> dict:
    """Device busy time, ops by time and idle gaps of one traced window
    [s0, s1] (profiler microseconds)."""
    busy = union([[max(e.time_range.start, s0), min(e.time_range.end, s1)]
                  for e in dev if e.time_range.end > s0
                  and e.time_range.start < s1])
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    # kernels by name without template and argument lists
    short: dict = {}
    for k, v in by_name.items():
        k = re.split(r"[<(]", k, 1)[0].strip()
        short[k] = short.get(k, 0.0) + v
    gaps, prev = [], s0
    for a, b in busy + [[s1, s1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [e for e in cpu
                if e.time_range.start <= mid <= e.time_range.end]
        inner = min(over, key=lambda e: e.time_range.end -
                    e.time_range.start).name if over else "python"
        named.append([f"host: {inner}", (b - a) / 1e6])
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (s1 - s0) / 1e6,
            "kernel_s": by_name,
            "device_ops": sorted(([k, v] for k, v in short.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": named}


def check_outputs(run: Runner, cell: dict, conf: dict, rec: Record,
                  seed: int, first_window_sub: int, device) -> dict:
    """Read the program's outputs, free the map, and compare them with the
    reference.  Returns the numbers compared (a submap count that differs
    from the rotation policy's counts in ``w_mismatch``).  The finished
    submaps checked are drawn from those the window finished, or, where it
    finished none, from those finished before it."""
    sem = tsdf_ref.Semantics.from_map_config(conf["map_config"])
    m = run.map
    active = check.read_active(m.state, sem.block_bits)
    groups = tsdf_ref.submap_groups(
        [run.traffic.position(i) for i in run.positions], sem)
    finished = list(range(first_window_sub, len(m.submaps))) or \
        list(range(len(m.submaps)))
    rng = np.random.default_rng([seed % (1 << 63), 3])
    pick = sorted(rng.choice(finished, min(len(finished),
                                           cell["check"]["submaps"]),
                             replace=False).tolist()) if finished else []
    leaves = {j: check.read_leaves(*m.leaf_arrays(m.submaps[j]),
                                   sem.sdf_trunc) for j in pick}
    verts = check.read_ply_vertices(run.ply) if run.save else None
    n_submaps = len(m.submaps)
    run.map = m = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    ref = check.Reference(run.traffic, sem, device)
    numbers = []
    if n_submaps != len(groups) - 1:
        numbers.append({"w_mismatch": abs(n_submaps - len(groups) + 1)})
    # each group's reference voxels, once; a save meshes every group
    last = len(groups) - 1
    need = range(len(groups)) if run.save else [last, *pick]
    vox = {j: ref.voxels([run.positions[i] for i in groups[j]])
           for j in need}
    numbers.append(check.active_numbers(active, vox[last]))
    if run.save:
        rv = check.mesh_reference([vox[j] for j in need], sem)
        numbers.append(check.mesh_numbers(verts, rv))
    for j in pick:
        numbers.append(check.leaf_numbers(leaves[j], vox[j], sem.sdf_trunc))
    rec.touched = dict(ref.touched)
    rec.valid_points = {k: len(run.traffic.templates[k])
                        for k in rec.touched}
    if os.path.exists(run.ply):
        os.remove(run.ply)
    return check.merge(numbers)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result object."""
    return run_record(name, seed, seconds, trace, device, overrides)[0]


def run_record(name: str, seed: int, seconds: float, trace: bool,
               device: str = "cuda", overrides: dict | None = None):
    """:func:`run_cell`'s result object and the run's ``Record``."""
    bench, entry, cell, conf = cell_spec(name, overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < entry["chips"]):
        raise SystemExit(f"{name} needs {entry['chips']} CUDA device(s); "
                         f"torch.cuda.is_available() = "
                         f"{torch.cuda.is_available()}")
    rec = Record()
    if cuda:
        rec.gpu = gpu_info()
        torch.cuda.reset_peak_memory_stats()
    traffic = traffic_of(cell, conf, seed)
    run = Runner(cell, conf, traffic, device)
    for _ in range(cell.get("lead_in", 0)):
        run.step(save=False)
    for _ in range(cell["warm_steps"]):
        run.step()
    run.sync()
    if trace:
        rec.trace = traced_slice(run, cell["trace_steps"])
    rec.setup_s = time.perf_counter() - T_START
    first_window_sub = len(run.map.submaps)
    window(run, seconds, rec)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = check_outputs(run, cell, conf, rec, seed, first_window_sub,
                            device)
    limits = cell["limits"]
    failed = sum(1 for s in rec.steps if s["lossy"]
                 or not s.get("save_ok", True))
    if rec.overflow:
        failed = len(rec.steps)
    correct = check.judge(numbers, limits) and failed == 0
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        mod, suffix = reader(m["name"])
        v = mod.read(rec, suffix)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(rec.steps),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": rec.gpu.get("name", "cpu"),
                      "count": entry["chips"] if cuda else 0,
                      "memory_peak_bytes": peak,
                      "power_limit": rec.gpu.get("power_limit")}}
    if trace:
        out["device"].update(busy_s=rec.trace["busy_s"],
                             window_s=rec.trace["window_s"])
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()}
    return out, rec


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
