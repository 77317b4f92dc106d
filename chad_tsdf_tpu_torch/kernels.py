"""Build, load and launch the port's hand-written Hopper kernels.

The CUDA sources live in ``csrc/`` beside this file.  On first use each
``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a`` (all started
together), the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``, and cached in ``_build/`` (which git
ignores) under a name that hashes the sources and flags, so an edited
source is rebuilt.  Nothing is compiled at import time: the CPU tests
import every module, and a CPU tensor never reaches a kernel.

Every C entry point takes ``data_ptr()``s and PyTorch's current stream and
returns ``cudaGetLastError()``; :func:`launch` raises on a non-zero code and
only then counts the launch in :data:`LAUNCHES`.

Kernels and the TPU kernels they replace (``chad_tsdf_tpu/ops/...``):

* K1 ``fused_tile_partials``  <- fused_integrate.py:fused_tile_partials
* K2 ``estimate_normals``     <- normals_pallas.py:estimate_normals_pallas
* K3 ``merge_partials``       <- tile_accum.py:merge_partials
* K4 ``tile_partials``        <- tile_accum.py:tile_partials
* K4 ``tile_partials_sorted`` <- tile_accum.py:tile_partials, on the
  ``sample_tile`` insert's block-sorted sample stream
* K5 ``accumulate_segments``  <- accumulate.py:accumulate_pallas (its
  chunk list alone: ``plan_chunks``, for checks)
* M1 ``micro_stagea_phases``  <- scripts/micro_stagea_phases.py:build
* M2 ``micro_tile_accum``     <- scripts/micro_tile_accum.py:run
* M3 ``micro_mxu8``           <- scripts/micro_mxu8.py:build

and kernels of the port's own, with no Pallas kernel behind them:

* ``set_conditional``, the one-thread kernel that sets a CUDA graph's IF
  node from a device count (``ops/conditional.py``), the JAX package's
  ``lax.cond`` on the fused/tile fallback.  Its host half,
  ``end_conditional``, launches nothing and is called through :func:`call`.
* ``seg_samples``, the ``seg`` insert's ray samples as int64 sort keys in
  one launch (``ops/seg_samples.py``): K1's DDA, signed distances and keys
  where the JAX package leaves the same work to XLA
  (``core/integrate.py`` ``sparse_seg_entry_stream``);
* ``carve_keys``, ``carve_sort`` and ``carve_apply``, space carving's
  free-space sample keys, their keys-only radix sort and the pool update
  from the sorted keys (``ops/carve_kernels.py``): the work that the JAX
  package leaves to XLA (``core/carve.py``, its ``lax.sort`` included).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# -fmad=false: no multiply-add contraction, so K1's DDA and K2's fit are the
# same rounded f32 operations as their plain PyTorch versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each C entry point, without the trailing stream
_SIGNATURES = {
    "fused_tile_partials": [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] +
                           [_F] * 2 + [_P] * 4,
    "estimate_normals": [_P] * 6 + [_I] * 2 + [_F] + [_P] * 4,
    "merge_partials": [_P] * 10 + [_I],
    "tile_partials": [_P] * 3 + [_I] * 3 + [_F] * 2 + [_P] * 4,
    "tile_partials_sorted": [_P] * 2 + [_I] * 2 + [_F] + [_P] * 6,
    "accumulate_segments": [_P] * 6 + [_I] * 2 + [_F] + [_I] * 2 +
                           [_P] * 3,
    "plan_chunks": [_P] * 2 + [_I] * 4 + [_P],
    "micro_stagea_phases": [_P] * 3 + [_I] * 4 + [_F] * 2 + [_P] * 3,
    "micro_tile_accum": [_P] * 3 + [_I] * 3 + [_F] * 2 + [_P] * 3,
    "micro_mxu8": [_P] * 4 + [_I] * 4 + [_P] * 3,
    "set_conditional": [_P] * 2,
    "seg_samples": [_P] * 9 + [_I] * 2 + [_F] * 3 + [_I] + [_F] + [_P] * 2,
    "carve_keys": [_P] * 4 + [_I] * 3 + [_F] * 3 + [_I] * 2 + [_P] * 3,
    "carve_apply": [_P] + [_I] + [_P] * 3 + [_I] * 2 + [_F] * 2 +
                   [_P] * 3 + [_I] + [_P],
    "carve_sort": [_P] + [_I] + [_P] * 2 + [_I] + [_P] * 3 + [_I],
}
# C entry points that launch no kernel (not counted), without the stream
_HOST_SIGNATURES = {
    "end_conditional": [_P],
}

# launches per kernel since the last reset_launches(); a wrapper adds one
# right after its kernel launched without error, and nowhere else
LAUNCHES = dict.fromkeys(_SIGNATURES, 0)

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit on PATH to build the port's kernels")
    return found


def _sources(csrc: str = CSRC) -> list[str]:
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith((".cu", ".cuh")))


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; return their joined output, or raise with
    it if any failed.  Every process is waited for (or killed) here."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=900)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"{' '.join(c)} -> {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = "".join(outs)
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{text}")
    return text


def build_library(csrc: str = CSRC, build_dir: str = BUILD_DIR):
    """Compile ``csrc``'s ``.cu`` files into ``build_dir`` (once per source
    hash), one nvcc per source in parallel, then link; returns the library
    path and the compiler's resource report."""
    srcs = _sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as fh:
            h.update(fh.read())
    tag = h.hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, f"libchad_kernels_{tag}.so")
    log = os.path.join(build_dir, f"build_{tag}.log")
    if not os.path.exists(lib):
        nvcc = _nvcc()
        tmp = f"{lib}.{os.getpid()}"
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for o, s in zip(objs, cus)]
        try:
            text = _run_all(compiles)
            text += _run_all([[nvcc, "-shared", "-o", f"{tmp}.tmp",
                               *objs]])
            with open(log, "w") as fh:
                fh.write(text)
            os.replace(f"{tmp}.tmp", lib)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
    with open(log) as fh:
        return lib, fh.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path, BUILD_LOG = build_library()
            lib = ctypes.CDLL(path)
            for name, argtypes in (*_SIGNATURES.items(),
                                   *_HOST_SIGNATURES.items()):
                fn = getattr(lib, "chad_" + name)
                fn.argtypes = argtypes + [_P]        # + stream
                fn.restype = ctypes.c_int
            lib.chad_error_string.argtypes = [ctypes.c_int]
            lib.chad_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def call(name: str, *args) -> None:
    """Call C entry ``chad_<name>`` on the current stream; raise if it
    returned an error."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, "chad_" + name)(*args, stream)
    if err != 0:
        msg = lib.chad_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


def launch(name: str, *args) -> None:
    """:func:`call` for an entry that launches a kernel, counted once it
    launched."""
    call(name, *args)
    LAUNCHES[name] += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    (and shape / device, where given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
