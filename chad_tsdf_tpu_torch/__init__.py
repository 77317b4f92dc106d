"""chad_tsdf_tpu_torch — the PyTorch / CUDA port of chad_tsdf_tpu.

The JAX package ``chad_tsdf_tpu`` is the reference; this package holds the
same modules under the same names (``ops/``, ``core/``, ``mesh/``), written
in PyTorch, with the TPU's Pallas kernels replaced by hand-written CUDA
kernels for Hopper (``csrc/``, built on first use by :mod:`.kernels`).  It
imports neither jax nor anything of the JAX package: it keeps its own copies
of the framework-free host modules (``config.MapConfig``, ``core/dag.py``,
``native.py`` with ``csrc/chadrt.cpp``).  Its entry points run on the card
(``device="cuda"``, the default) unless the caller passes ``device="cpu"``.

    from chad_tsdf_tpu_torch import TSDFMap
    m = TSDFMap(sdf_res=0.05, sdf_trunc=0.1)          # on the card
    m.insert(points, position)       # numpy (N,3), (3,)
    m.save("mesh.ply")

The sharded map is ``chad_tsdf_tpu_torch.parallel.ShardedTSDFMap``, as in
the JAX package: the same surface over a ``parallel.make_mesh`` mesh of
Morton-range shards, on one card or several, or across processes.
"""

from .config import MapConfig

# the JAX package's version (chad_tsdf_tpu/__init__.py): the port follows it
__version__ = "0.1.0"

__all__ = ["TSDFMap", "MapConfig"]


def __getattr__(name):
    # lazy, so the ops tests do not load the map stack
    if name == "TSDFMap":
        from .core.map import TSDFMap
        return TSDFMap
    raise AttributeError(name)
