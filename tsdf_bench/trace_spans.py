"""Where a cell's traced slice spends its time, by the program's spans.

    python3 -m tsdf_bench.trace_spans --workload sphere_save --seed 7 \\
        [--turns 4]

Sets a cell up as ``run.py`` does (its traffic from the seed, the map on
the card, the warm-up steps), profiles ``trace_steps`` steps as
``run.py``'s traced slice does, and prints one JSON object: the slice's
busy and window seconds and device operations (``run.reduce_trace``),
each ``chad.*`` span's count, total and self seconds on the profiler's
clock (``metrics/spans.py``), the growth of the program's counters over
the slice, and ``idle_by_span``: the device's idle seconds in the slice
by the innermost ``chad.*`` span open on the host (``outside`` for
none).  With ``--turns k`` it then runs ``k`` pairs of ``trace_steps``
steps, untraced then traced, and adds each one's mean host time of an
insert call: what the profiler and the spans' ranges cost a call.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import run
from .metrics import spans


def _profiler(device: torch.device):
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def traced(runner: run.Runner, n_steps: int) -> dict:
    """``n_steps`` steps under the profiler, as ``run.traced_slice``
    takes them, reduced by the spans the host was in."""
    from chad_tsdf_tpu_torch.utils import timing
    runner.sync()
    c0 = timing.counts()
    with _profiler(runner.device) as prof:
        with record_function("bench.slice"):
            for _ in range(n_steps):
                with record_function("bench.step"):
                    runner.step()
            runner.sync()
    c1 = timing.counts()
    events = prof.events()
    sl = next(e for e in events if e.name == "bench.slice"
              and e.device_type.name == "CPU")
    s0, s1 = sl.time_range.start, sl.time_range.end
    dev = [e for e in events if e.device_type.name == "CUDA"
           and not e.name.startswith("bench.")]
    cpu = [e for e in events if e.device_type.name == "CPU"
           and e.name != "bench.slice"]
    chad = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in cpu if e.name.startswith("chad.")]
    busy = run.union([[max(e.time_range.start, s0) / 1e6,
                       min(e.time_range.end, s1) / 1e6] for e in dev
                      if e.time_range.end > s0 and e.time_range.start < s1])
    t = run.reduce_trace(dev, cpu, s0, s1)
    return {"steps": n_steps, "busy_s": t["busy_s"],
            "window_s": t["window_s"], "device_ops": t["device_ops"],
            "spans": spans.table(chad),
            "counts": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]},
            "idle_by_span": spans.idle_by_span(busy, chad, s0 / 1e6,
                                               s1 / 1e6)}


def call_ms(runner: run.Runner, n_steps: int, profiled: bool) -> float:
    """Mean host milliseconds of the insert calls of ``n_steps`` steps,
    under the profiler or not."""
    calls = []
    runner.sync()
    with _profiler(runner.device) if profiled else contextlib.nullcontext():
        for _ in range(n_steps):
            s: dict = {}
            runner.step(s)
            calls.append(s["call_s"])
        runner.sync()
    return sum(calls) / len(calls) * 1e3


def report(name: str, seed: int, turns: int = 0, device: str = "cuda",
           overrides: dict | None = None) -> dict:
    """The JSON object the module docstring describes."""
    _, _, cell, conf = run.cell_spec(name, overrides)
    runner = run.Runner(cell, conf, run.traffic_of(cell, conf, seed),
                        device)
    for _ in range(cell["warm_steps"]):
        runner.step()
    out = {"workload": name, "seed": seed,
           "device": run.gpu_info() if runner.device.type == "cuda"
           else "cpu", **traced(runner, cell["trace_steps"])}
    out["turns"] = [
        {"untraced_ms": call_ms(runner, cell["trace_steps"], False),
         "traced_ms": call_ms(runner, cell["trace_steps"], True)}
        for _ in range(turns)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_spans needs a CUDA card")
    print(json.dumps(report(args.workload, args.seed, args.turns)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
