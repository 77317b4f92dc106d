"""Multi-process meshes — PyTorch port of
``chad_tsdf_tpu/parallel/distributed.py``.

The JAX package forms its process group with ``jax.distributed`` and lays
one global device mesh over it.  Here ``torch.distributed`` joins the
processes (``nccl`` for a CUDA mesh, ``gloo`` for a CPU mesh) and
:func:`~.sharded.make_mesh` splits the shards evenly over them; each
process feeds its own shards' rows of the identically computed split
(:func:`~.sharded.global_shard_array`) and the halo exchange, the psums
and finalize's gathers go through the group.  Nothing tells a program of a
cluster: the address, the world size and the rank come from the arguments
or from the usual environment (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``).  A one-process run needs none of it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .sharded import global_shard_array, make_mesh  # noqa: F401


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout_s: float = 600.0) -> None:
    """Join the process group: ``nccl`` for ``device="cuda"``, ``gloo``
    for ``"cpu"``.  ``coordinator_address`` is ``host:port`` or a URL
    (``tcp://localhost:29500``); without it the environment's
    ``MASTER_ADDR`` / ``MASTER_PORT`` are used.  A no-op for one process
    unless an address is given."""
    import torch.distributed as dist
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    if dev.type == "cuda":
        # nccl's communicator binds the card current when it is created
        torch.cuda.set_device(dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK",
                           process_id % torch.cuda.device_count())))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(axis: str = "shard", device="cuda"):
    """One 1-D mesh over every process's shards (one per process)."""
    return make_mesh(axis=axis, device=device)


def host_local_points(points: np.ndarray, max_points_per_device: int):
    """Split this process's cloud over its cards (one part on a CPU-only
    machine) and pad each to the static capacity.  Returns (padded
    (n_local * cap, 3) f32, n_per_device i32)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    cap = max_points_per_device
    out = np.zeros((local * cap, 3), np.float32)
    n_per = np.zeros((local,), np.int32)
    for i, c in enumerate(np.array_split(np.asarray(points, np.float32),
                                         local)):
        c = c[:cap]
        out[i * cap:i * cap + len(c)] = c
        n_per[i] = len(c)
    return out, n_per


def process_info() -> dict:
    import torch.distributed as dist
    on = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    world = dist.get_world_size() if on else 1
    return {"process_index": dist.get_rank() if on else 0,
            "process_count": world,
            "local_devices": local,
            "global_devices": local * world}
