"""A branch on a device count inside a CUDA graph — the JAX package's
``lax.cond`` on the fused and tile inserts' count of uncovered samples
(``chad_tsdf_tpu/core/integrate.py:652-675``), as a CUDA conditional IF
node.

:func:`if_positive` runs ``body`` where ``flag > 0``:

* for a CPU ``flag``, through the plain version :func:`set_conditional_plain`
  (the value the kernel gives the node's handle, read on the host), then
  ``body`` in Python;
* for a CUDA ``flag``, while a CUDA graph is being captured, through the
  kernel: C entry ``chad_set_conditional`` (``csrc/conditional.cu``) adds
  an IF node behind a one-thread kernel that sets the node's handle from
  ``flag > 0``, and ``body`` is captured into the node's body graph on a
  side stream.  Every replay then decides on the device, with no host read.
  Outside a capture a CUDA ``flag`` raises: the node exists only in a graph.
  K5's programmatic dependent launch (``csrc/accumulate.cu``) works inside
  the body as it is.

The body's allocations come from ``pool``, a ``torch.cuda.MemPool`` that
the caller keeps alive as long as the graph: their addresses are recorded
in the body graph, so the caching allocator must not hand them to anything
else, and memory freed inside the body returns to that pool only.
"""

from __future__ import annotations

import torch

from .. import kernels

# the side stream each device captures bodies on
_STREAMS: dict = {}


def set_conditional_plain(flag: torch.Tensor) -> bool:
    """Whether the IF node's body runs: the count is positive."""
    return bool(flag > 0)


def _body_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def if_positive(flag: torch.Tensor, body, pool=None) -> None:
    """Run ``body()`` where the i32[] count ``flag`` is positive (module
    docstring); on CUDA only while capturing, with ``pool`` the
    ``torch.cuda.MemPool`` for the body's allocations."""
    if flag.device.type == "cpu":
        if set_conditional_plain(flag):
            body()
        return
    kernels.check(flag, "flag", torch.int32, ())
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("if_positive on a CUDA count needs a CUDA graph "
                           "capture: the IF node exists only in a graph")
    if pool is None:
        raise ValueError("if_positive needs a MemPool for the body")
    stream = _body_stream(flag.device)
    kernels.launch("set_conditional", kernels.ptr(flag), stream.cuda_stream)
    try:
        with torch.cuda.stream(stream), \
                torch.cuda.use_mem_pool(pool, flag.device):
            body()
    finally:
        kernels.call("end_conditional", stream.cuda_stream)
