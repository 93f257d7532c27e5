"""The native BVH builder, bound with ctypes.

The source is the port's own copy, bvh_builder.cpp beside this file (binned
SAH, threaded depth-first layout; the same code as the JAX package's, so
both build bit-equal trees), compiled with g++ at first use into
gpu_ray_tracing_tpu_torch/_build/.  The port reads no file of the JAX
package and does not import its binding.  As there, `available()` reports whether the library compiled and
loaded; `ops/bvh.build_bvh(method='auto')` then takes it, else the numpy
builder.  The library is rebuilt when the source is newer, and a file lock
keeps concurrent processes from building at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_HERE, "bvh_builder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libbvh_builder.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _compile() -> str | None:
    """Compile LIBRARY if missing or stale; returns an error string or None."""
    if not os.path.isfile(SOURCE):
        return f"source not found: {SOURCE}"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "bvh_builder.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if (os.path.exists(LIBRARY)
                    and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
                return None
            tmp = f"{LIBRARY}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, LIBRARY)
            return None
        except FileNotFoundError:
            return "g++ not found"
        except subprocess.TimeoutExpired:
            return "g++ timed out"
        except subprocess.CalledProcessError as e:
            return f"g++ failed: {e.stderr[:500]}"
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        _build_error = _compile()
        if _build_error is not None:
            return None
        lib = ctypes.CDLL(LIBRARY)
        lib.build_bvh_sah.restype = ctypes.c_int
        lib.build_bvh_sah.argtypes = [
            _f32p, _f32p, _f32p,  # centroids, bounds_min, bounds_max
            ctypes.c_int32, ctypes.c_int32,  # n, leaf_size
            _f32p, _f32p,  # node_bmin, node_bmax
            _i32p, _i32p, _i32p,  # miss_link, leaf_start, leaf_count
            _i32p, _i32p,  # order, n_nodes_out
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native builder compiled and loaded."""
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def build_bvh_sah(centroids: np.ndarray, bounds_min: np.ndarray,
                  bounds_max: np.ndarray, leaf_size: int = 4):
    """Binned-SAH build: (node_bmin, node_bmax, miss_link, leaf_start,
    leaf_count, order), the numpy builder's tuple layout."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native BVH builder unavailable: {_build_error}")
    n = centroids.shape[0]
    cent = np.ascontiguousarray(centroids, np.float32)
    bmin = np.ascontiguousarray(bounds_min, np.float32)
    bmax = np.ascontiguousarray(bounds_max, np.float32)
    cap = max(1, 2 * n - 1)
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    miss = np.empty((cap,), np.int32)
    start = np.empty((cap,), np.int32)
    count = np.empty((cap,), np.int32)
    order = np.empty((n,), np.int32)
    n_nodes = np.zeros((1,), np.int32)
    f = lambda a: a.ctypes.data_as(_f32p)
    i = lambda a: a.ctypes.data_as(_i32p)
    rc = lib.build_bvh_sah(f(cent), f(bmin), f(bmax), n, leaf_size,
                           f(node_bmin), f(node_bmax), i(miss), i(start), i(count),
                           i(order), i(n_nodes))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    m = int(n_nodes[0])
    return (node_bmin[:m].copy(), node_bmax[:m].copy(), miss[:m].copy(),
            start[:m].copy(), count[:m].copy(), order.astype(np.int64))
