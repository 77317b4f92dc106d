"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 that the
configurations state, judged by the same numbers and limits as a run.

    python3 -m tsdf_bench.control --workload kitti_drive --seeds 1 2 3

For each seed it makes the cell's traffic, takes the inserts of a run of
``--steps`` steps (the lead-in, the warm-up and a window's worth), and
compares what the reference computes in bfloat16 (the normal fit and the
signed distances; ``reference/tsdf_ref.py``) with what it computes in
float64, for the active submap, the last ``check.submaps`` finished
submaps and, in a cell that saves, the mesh of every submap
(``check.mesh_reference``).  It prints one JSON line a seed: the numbers,
their limits and whether the control came out correct (it must not).  The
program is not run.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import check, run
from .reference import tsdf_ref as R


def control_numbers(name: str, seed: int, steps: int | None = None,
                    device: str = "cuda", overrides: dict | None = None,
                    dtype=torch.bfloat16) -> dict:
    _, _, cell, conf = run.cell_spec(name, overrides)
    sem = R.Semantics.from_map_config(conf["map_config"])
    traffic = run.traffic_of(cell, conf, seed)
    if steps is None:
        steps = cell.get("lead_in", 0) + cell["warm_steps"] + 70
    groups = R.submap_groups([traffic.position(i) for i in range(steps)],
                             sem)
    ref = check.Reference(traffic, sem, device)
    low = check.Reference(traffic, sem, device, dtype)
    saves = cell["step"] == "insert_save"
    # every group where the cell saves (the mesh fuses them all)
    need = range(len(groups)) if saves else [len(groups) - 1]
    want = {j: ref.voxels(groups[j]) for j in need}
    got = {j: low.voxels(groups[j]) for j in need}
    numbers = []
    last = got[len(groups) - 1]
    as_prog = (last.keys.cpu().numpy(), last.sums.cpu().numpy(),
               last.counts.cpu().numpy().astype(float))
    numbers.append(check.active_numbers(as_prog, want[len(groups) - 1]))
    if saves:
        numbers.append(check.mesh_numbers(
            check.mesh_reference([got[j] for j in need], sem),
            check.mesh_reference([want[j] for j in need], sem)))
    n = cell["check"]["submaps"]
    for j in range(len(groups) - 1)[-n:] if n else []:
        if j not in want:
            want[j], got[j] = ref.voxels(groups[j]), low.voxels(groups[j])
        code, wcode = R.leaf_codes(got[j], sem.sdf_trunc)
        numbers.append(check.leaf_numbers(
            (got[j].keys.cpu().numpy(), code.cpu().numpy(),
             wcode.cpu().numpy()), want[j], sem.sdf_trunc))
    return check.merge(numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, cell, _ = run.cell_spec(args.workload)
    for seed in args.seeds:
        nums = control_numbers(args.workload, seed, args.steps, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": nums, "limits": cell["limits"],
                          "correct": check.judge(nums, cell["limits"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
