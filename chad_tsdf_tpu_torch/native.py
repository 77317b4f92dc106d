"""ctypes bindings for the native host runtime (``csrc/chadrt.cpp``) — the
port's own copy of ``chad_tsdf_tpu/native.py``, with one helper of its own
(:func:`distinct_block_keys`, the insert's density estimate).

The shared library is built on demand with g++ the first time it is needed
into ``_build/`` beside this file (which git ignores), never into the JAX
package's tree (no pip dependencies; the binding layer is plain ctypes over
an extern-C API).  All users fall back to the pure-numpy implementation
(``core/dag.py``; the density estimate to its numpy form in
``core/map.py``) when a compiler is unavailable — ``available()`` reports
which path is active.  This is host code: the fallback is the DAG's own
numpy form, not a plain version of a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "chadrt.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")


def _build_and_load():
    out = os.path.join(BUILD_DIR, "libchadrt.so")
    if not os.path.exists(SRC):
        return None
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(SRC)):
        tmp = f"{out}.{os.getpid()}"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC",
                 "-shared", SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except Exception:
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None

    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sigs = {
        "nodelevel_new": ([], ctypes.c_void_p),
        "nodelevel_free": ([ctypes.c_void_p], None),
        "nodelevel_add_batch": ([ctypes.c_void_p, u32p, ctypes.c_uint64,
                                 u32p], None),
        "nodelevel_size": ([ctypes.c_void_p], ctypes.c_uint64),
        "nodelevel_copy_raw": ([ctypes.c_void_p, u32p], None),
        "nodelevel_uniques": ([ctypes.c_void_p], ctypes.c_uint64),
        "nodelevel_dupes": ([ctypes.c_void_p], ctypes.c_uint64),
        "nodelevel_set_counters": ([ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_uint64], None),
        "nodelevel_restore": ([ctypes.c_void_p, u32p, ctypes.c_uint64], None),
        "nodelevel_child_addrs": ([ctypes.c_void_p, u32p, ctypes.c_uint64,
                                   u32p], None),
        "lclevel_new": ([], ctypes.c_void_p),
        "lclevel_free": ([ctypes.c_void_p], None),
        "lclevel_add_batch": ([ctypes.c_void_p, u64p, ctypes.c_uint64,
                               u32p], None),
        "lclevel_size": ([ctypes.c_void_p], ctypes.c_uint64),
        "lclevel_copy_raw": ([ctypes.c_void_p, u64p], None),
        "lclevel_get": ([ctypes.c_void_p, u32p, ctypes.c_uint64, u64p], None),
        "lclevel_uniques": ([ctypes.c_void_p], ctypes.c_uint64),
        "lclevel_dupes": ([ctypes.c_void_p], ctypes.c_uint64),
        "lclevel_set_counters": ([ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint64], None),
        "lclevel_restore": ([ctypes.c_void_p, u64p, ctypes.c_uint64], None),
        "distinct_block_keys": ([ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_uint64, ctypes.c_float],
                                ctypes.c_uint64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            if os.environ.get("CHAD_TSDF_NO_NATIVE") != "1":
                _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return get_lib() is not None


def distinct_block_keys(points: np.ndarray, stride: int,
                        block: float) -> int | None:
    """The number of distinct blocks ``np.unique`` counts in
    ``core/map.py`` ``_dispatch_config`` over ``points[::stride]`` (C-
    contiguous float32 (n, 3)), blocks of ``block`` metres taken in
    float32; None without the library."""
    if (points.dtype != np.float32 or points.ndim != 2
            or points.shape[1] != 3 or not points.flags.c_contiguous):
        raise ValueError("points must be C-contiguous float32 (n, 3)")
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.distinct_block_keys(points.ctypes.data, points.shape[0],
                                       stride, block))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class NativeNodeLevel:
    """Drop-in replacement for core.dag.NodeLevel backed by C++."""

    def __init__(self):
        self._lib = get_lib()
        self._ptr = self._lib.nodelevel_new()

    def __del__(self):
        if getattr(self, "_ptr", None) and self._lib:
            self._lib.nodelevel_free(self._ptr)
            self._ptr = None

    @property
    def uniques_n(self) -> int:
        return int(self._lib.nodelevel_uniques(self._ptr))

    @property
    def dupes_n(self) -> int:
        return int(self._lib.nodelevel_dupes(self._ptr))

    @property
    def raw(self) -> np.ndarray:
        n = int(self._lib.nodelevel_size(self._ptr))
        out = np.empty(n, np.uint32)
        self._lib.nodelevel_copy_raw(self._ptr, _u32(out))
        return out

    def add_batch(self, children: np.ndarray) -> np.ndarray:
        children = np.ascontiguousarray(children, np.uint32)
        m = children.shape[0]
        out = np.empty(m, np.uint32)
        if m:
            self._lib.nodelevel_add_batch(self._ptr, _u32(children),
                                          ctypes.c_uint64(m), _u32(out))
        return out

    def child_addrs(self, addrs: np.ndarray) -> np.ndarray:
        addrs = np.ascontiguousarray(addrs, np.uint32)
        m = addrs.shape[0]
        out = np.empty((m, 8), np.uint32)
        if m:
            self._lib.nodelevel_child_addrs(self._ptr, _u32(addrs),
                                            ctypes.c_uint64(m), _u32(out))
        return out

    def restore(self, raw: np.ndarray) -> None:
        raw = np.ascontiguousarray(raw, np.uint32)
        self._lib.nodelevel_restore(self._ptr, _u32(raw),
                                    ctypes.c_uint64(raw.shape[0]))

    def set_counters(self, uniques: int, dupes: int) -> None:
        self._lib.nodelevel_set_counters(self._ptr, ctypes.c_uint64(uniques),
                                         ctypes.c_uint64(dupes))


class NativeLeafClusterLevel:
    """Drop-in replacement for core.dag.LeafClusterLevel backed by C++."""

    def __init__(self):
        self._lib = get_lib()
        self._ptr = self._lib.lclevel_new()

    def __del__(self):
        if getattr(self, "_ptr", None) and self._lib:
            self._lib.lclevel_free(self._ptr)
            self._ptr = None

    @property
    def uniques_n(self) -> int:
        return int(self._lib.lclevel_uniques(self._ptr))

    @property
    def dupes_n(self) -> int:
        return int(self._lib.lclevel_dupes(self._ptr))

    @property
    def raw(self) -> np.ndarray:
        n = int(self._lib.lclevel_size(self._ptr))
        out = np.empty(n, np.uint64)
        self._lib.lclevel_copy_raw(self._ptr, _u64(out))
        return out

    def add_batch(self, words: np.ndarray) -> np.ndarray:
        words = np.ascontiguousarray(words, np.uint64)
        m = words.shape[0]
        out = np.empty(m, np.uint32)
        if m:
            self._lib.lclevel_add_batch(self._ptr, _u64(words),
                                        ctypes.c_uint64(m), _u32(out))
        return out

    def get(self, addrs: np.ndarray) -> np.ndarray:
        addrs = np.ascontiguousarray(addrs, np.uint32)
        m = addrs.shape[0]
        out = np.empty(m, np.uint64)
        if m:
            self._lib.lclevel_get(self._ptr, _u32(addrs),
                                  ctypes.c_uint64(m), _u64(out))
        return out

    def restore(self, raw: np.ndarray) -> None:
        raw = np.ascontiguousarray(raw, np.uint64)
        self._lib.lclevel_restore(self._ptr, _u64(raw),
                                  ctypes.c_uint64(raw.shape[0]))

    def set_counters(self, uniques: int, dupes: int) -> None:
        self._lib.lclevel_set_counters(self._ptr, ctypes.c_uint64(uniques),
                                       ctypes.c_uint64(dupes))
