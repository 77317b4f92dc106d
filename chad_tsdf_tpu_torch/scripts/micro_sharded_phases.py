"""The sharded step's fixed cost F split in two at one shard — the port of
the JAX package's ``scripts/micro_sharded_phases.py``.

    python3 -m chad_tsdf_tpu_torch.scripts.micro_sharded_phases      # card
    python3 -m chad_tsdf_tpu_torch.scripts.micro_sharded_phases \\
        --device cpu --scans 2 --bucket 4096 --block-capacity 8192 \\
        --touched-capacity 4096

Three variants of one step on ``sharded_overhead_bench``'s packed ``seg``
stream, timed the same way (median of ``--rounds`` rounds of the mean ms a
step, one synchronisation a round):

a. ``direct``: the insert into the persistent pool (unpack on the device,
   then ``insert_step``), the one-shard step;
b. ``scratch_only``: the insert into a fresh scratch pool
   (``parallel.scratch_config``) and no merge; a checksum of the scratch
   (its first pool row's weights, first key and block count) is added into
   the persistent pool times zero, so the scratch is consumed;
c. ``generic``: the many-shard step forced at one shard (scratch insert,
   row extract, routing, K3 merge).

b - a is the scratch pipeline's own cost; c - b is extract + route + merge.
With ``--json`` the times go to a file, with ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..core import integrate
from ..core.state import create_state, origin_blocks_for_position
from ..parallel.sharded import scratch_config
from .sharded_overhead_bench import (POSITION, add_args, device_name,
                                     packed_scans, raw_scans, step_ms,
                                     stream_config, timed_rounds)


def variant_ms(name: str, config, device: torch.device, scans: list,
               rounds: int) -> float:
    """ms a step of ``direct`` or ``scratch_only`` (module docstring)."""
    scfg = scratch_config(config)
    pos = torch.from_numpy(POSITION).to(device)
    origin = origin_blocks_for_position(POSITION, config)
    dev_scans = [(torch.from_numpy(q).to(device), n) for q, n in scans]
    box = {"state": create_state(config, origin, device)}

    def run_once():
        for q, n in dev_scans:
            pts = integrate.unpack_points(q, pos, config)
            state = box["state"]
            if name == "direct":
                box["state"], _ = integrate.insert_step(state, pts, n, pos,
                                                        config)
                continue
            scratch = dataclasses.replace(
                create_state(scfg, None, device),
                origin_blocks=state.origin_blocks)
            scratch, _ = integrate.insert_step(scratch, pts, n, pos, scfg)
            chk = (scratch.pool_w[0].sum() + scratch.dir_keys[0] +
                   scratch.n_blocks).to(torch.float32)
            state.pool_sd[0, 0] += 0.0 * chk

    return timed_rounds(run_once, device, rounds, len(dev_scans))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = device_name(device)
    print(card, flush=True)
    config = stream_config(args)
    scans = packed_scans(raw_scans(args.scans, args.bucket), config)
    out = {"backend": device.type, "device": card}
    for name in ("direct", "scratch_only"):
        out[f"{name}_ms"] = variant_ms(name, config, device, scans,
                                       args.rounds)
    out["generic_ms"], _ = step_ms(config, device, scans, True, args.rounds)
    out["scratch_pipeline_ms"] = out["scratch_only_ms"] - out["direct_ms"]
    out["extract_route_merge_ms"] = out["generic_ms"] - \
        out["scratch_only_ms"]
    for k in ("direct_ms", "scratch_only_ms", "generic_ms",
              "scratch_pipeline_ms", "extract_route_merge_ms"):
        print(f"{k}: {out[k]:.3f} ({card})", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
