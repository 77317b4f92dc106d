"""chad_tsdf_tpu_torch — the PyTorch / CUDA port of chad_tsdf_tpu.

The JAX package ``chad_tsdf_tpu`` is the reference; this package holds the
same modules under the same names (``ops/``, ``core/``, ``mesh/``), written
in PyTorch, with the TPU's Pallas kernels replaced by hand-written CUDA
kernels for Hopper (``csrc/``, built on first use by :mod:`.kernels`).  It
never imports jax; from the JAX package it uses only the framework-free
``config.MapConfig``, ``core.dag`` and ``native``.

    from chad_tsdf_tpu_torch import TSDFMap
    m = TSDFMap(sdf_res=0.05, sdf_trunc=0.1, device="cuda")
    m.insert(points, position)       # numpy (N,3), (3,)
    m.save("mesh.ply")
"""

from chad_tsdf_tpu.config import MapConfig

__all__ = ["TSDFMap", "MapConfig"]


def __getattr__(name):
    # lazy, so the ops tests do not load the map stack
    if name == "TSDFMap":
        from .core.map import TSDFMap
        return TSDFMap
    raise AttributeError(name)
