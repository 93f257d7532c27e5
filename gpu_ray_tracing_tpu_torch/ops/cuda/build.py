"""Build ops/cuda/megakernel.cu at first use and bind it with ctypes.

`nvcc` compiles the source into a shared library with a plain C interface
under gpu_ray_tracing_tpu_torch/_build/, which is then loaded with ctypes
(the pattern of the JAX package's native/__init__.py).  This route needs
neither ninja nor PyTorch's headers, so a build takes seconds.  The library
is rebuilt when the source is newer, and a file lock keeps concurrent
processes from building at once.  There is no fallback: a missing compiler
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "megakernel.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
LIBRARY = os.path.join(BUILD_DIR, "libgrt_megakernel.so")

#: No fast math (IEEE divide and sqrt, full-range sin/cos) and no FMA
#: contraction, so that rounding stays close to the reference's.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_uint = ctypes.c_uint
_c_float = ctypes.c_float

_SIGNATURES = {
    "grt_render": (
        _c_int,
        [_c_ptr, _c_ptr, _c_int,  # camera, sphere planes, n
         _c_ptr, _c_ptr, _c_int,  # sphere BVH planes, nodes
         _c_ptr, _c_int, _c_int,  # mesh table, triangles, smooth
         _c_ptr, _c_ptr, _c_int,  # mesh BVH planes, nodes
         _c_ptr, _c_int, _c_ptr, _c_int,  # light planes, L, tri-light planes, T
         _c_int, _c_int,  # nee, mis
         _c_int, _c_int, _c_int, _c_int,  # sampler kind, kx, ky, nbits
         _c_int, _c_int, _c_uint, _c_uint, _c_uint,
         _c_uint, _c_int, _c_float, _c_float, _c_int, _c_int, _c_float,
         _c_float, _c_int,  # ... clamp, spp
         _c_ptr, _c_ptr, _c_ptr,  # out, rays, adaptive state
         _c_int, _c_int, _c_int, _c_float,  # tile rows, min spp, chunk, tol
         _c_ptr],  # stream
    ),
    "grt_hash_probe": (
        _c_int,
        [_c_ptr, _c_int, _c_ptr, _c_int, _c_uint, _c_uint, _c_ptr, _c_ptr,
         _c_ptr, _c_ptr, _c_ptr],
    ),
    "grt_sampler_probe": (
        _c_int,
        [_c_ptr, _c_ptr, _c_int, _c_ptr, _c_int, _c_uint, _c_int, _c_int, _c_int,
         _c_int, _c_ptr, _c_ptr, _c_ptr],
    ),
    "grt_error_string": (ctypes.c_char_p, [_c_int]),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What the last load did: the library, whether it was compiled in this
    process, the seconds that took, and the compiler's own report."""

    library: str
    compiled: bool
    seconds: float
    nvcc_version: str
    ptxas_report: str


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: BuildInfo | None = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA megakernel must be compiled from ops/cuda/megakernel.cu"
    )


def _nvcc_version(path: str) -> str:
    out = subprocess.run([path, "--version"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else out


def _compile(path: str) -> tuple[float, str]:
    """Compile SOURCE into LIBRARY (atomically); returns (seconds, ptxas report)."""
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [path, *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, timeout=900,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}) building {SOURCE}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, LIBRARY)
    return seconds, (proc.stdout + proc.stderr).strip()


def _stale() -> bool:
    return (not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE))


def load() -> ctypes.CDLL:
    """The bound megakernel library, compiled first if missing or stale."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        path = nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        compiled, seconds, report = False, 0.0, ""
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if _stale():
                    seconds, report = _compile(path)
                    compiled = True
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        lib = ctypes.CDLL(LIBRARY)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _info = BuildInfo(LIBRARY, compiled, seconds, _nvcc_version(path), report)
        _lib = lib
        return _lib


def build_info() -> BuildInfo:
    """Build details of the loaded library (loads it first)."""
    load()
    return _info


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = load().grt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")
