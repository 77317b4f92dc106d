"""Microbenchmarks of the port's tile kernels — ports of the JAX package's
``scripts/micro_stagea_phases.py`` (M1), ``scripts/micro_tile_accum.py``
(M2) and ``scripts/micro_mxu8.py`` (M3), one module each with the same
name and the same ``main()``: a check of the CUDA kernel against its plain
PyTorch version, then timings at the script's full sizes.  Run on a card::

    python3 -m chad_tsdf_tpu_torch.scripts.micro_stagea_phases
    python3 -m chad_tsdf_tpu_torch.scripts.micro_tile_accum
    python3 -m chad_tsdf_tpu_torch.scripts.micro_mxu8

Four more time the port's own kernels: ``k1_k2_turns`` (K1, K2 and K4 of
an older ``csrc/`` against this checkout's, in turns, and the older unpack
+ K4 of the ``sample_tile`` path against its sorted K4), ``k5_turns`` (K5
the same way), ``m3_turns`` (M3 by phase, and an older M3 in turns) and
``kernel_phases`` (K1's device time split by phase, K2's by pass);
``insert_turns`` times whole dense inserts of several checkouts of the
package in turns.
"""

from __future__ import annotations

import statistics

import torch


def require_cuda(device: str) -> torch.device:
    """The device to time on; raises unless it is an available CUDA card
    (a timing never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"timing needs a CUDA device, got {device!r} "
                         f"(cuda available: {torch.cuda.is_available()})")
    return dev


def cuda_ms(fn, reps: int = 10, warmup: int = 2,
            lead_cycles: int = 2_000_000) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events).
    Each timed call is queued behind a spin kernel (``torch.cuda._sleep``,
    about 1 ms), so that its launches reach the card before it starts and
    the events bracket device time, not the host's launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k4_stream_bytes(bkey: torch.Tensor, ovfmask: torch.Tensor, nb: int,
                    n_live: int, sample_bytes: int) -> int:
    """The bytes K4 must move over a (1, S) sample stream: every key read
    and every mask entry written (8 B a sample), ``sample_bytes`` of
    payload for each valid sample its list covers (the payload of an
    invalid or uncovered sample is never needed), the T x nb list and the
    ``n_live`` live partial rows (4 KiB each) written."""
    s = bkey.numel()
    covered = int((bkey != 2**31 - 1).sum()) - int(ovfmask.sum())
    return 8 * s + sample_bytes * covered + s // 1024 * nb * 4 + \
        n_live * 4096


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
