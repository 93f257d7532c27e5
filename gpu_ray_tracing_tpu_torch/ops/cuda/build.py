"""Build the CUDA sources of ops/cuda/ at first use and bind them with ctypes.

`nvcc` compiles each source (megakernel.cu: the render kernels of both
engines; wavefront.cu: the wavefront engine's compaction and loop step;
probes.cu: the FP32 and bf16 probes) into a shared library with a
plain C interface under gpu_ray_tracing_tpu_torch/_build/, which is then
loaded with ctypes (the pattern of the JAX package's native/__init__.py).
This route needs neither ninja nor PyTorch's headers, so a build takes
seconds.  A library is rebuilt when its source is newer, and a file lock
keeps concurrent processes from building at once; `build_all` compiles the
stale ones side by side, one nvcc each.  There is no fallback: a missing
compiler or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import fcntl
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")

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
_c_double = ctypes.c_double

# The scene, light and sampler arguments grt_render and grt_wavefront_bounce
# share (after grt_render's camera).
_SCENE_ARGS = [
    _c_ptr, _c_int,  # sphere planes, n
    _c_ptr, _c_int,  # sphere BVH node records, nodes
    _c_ptr, _c_ptr, _c_int, _c_int,  # mesh table, face records, triangles, smooth
    _c_ptr, _c_int,  # mesh BVH node records, nodes
    _c_ptr, _c_int, _c_ptr, _c_int,  # light planes, L, tri-light planes, T
    _c_int, _c_int,  # nee, mis
    _c_int, _c_int, _c_int, _c_int,  # sampler kind, kx, ky, nbits
]

_MEGAKERNEL_SIGNATURES = {
    "grt_render": (
        _c_int,
        [_c_ptr, *_SCENE_ARGS,  # camera, scene
         _c_int, _c_int, _c_uint, _c_uint, _c_uint,
         _c_uint, _c_int, _c_float, _c_float, _c_int, _c_int, _c_float,
         _c_float, _c_int,  # ... clamp, spp
         _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # out, rays, walks, adaptive state
         _c_int, _c_int, _c_int, _c_float,  # tile rows, min spp, chunk, tol
         _c_ptr, _c_int, _c_ptr],  # pixel-group cursor, stage bytes, stream
    ),
    # nee, count, stage (0 global, 1 spheres, 2 BVH), stage bytes, blocks an SM (out)
    "grt_render_occupancy": (_c_int, [_c_int, _c_int, _c_int, _c_int, _c_ptr]),
    "grt_wavefront_bounce": (
        _c_int,
        [*_SCENE_ARGS,
         _c_uint, _c_int, _c_float, _c_float, _c_int,  # frame seed, depth, t_min, t_max, rr
         _c_float, _c_float,  # sky intensity, clamp
         _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,  # f0, f1, i0, i1, stride, slots
         _c_ptr, _c_int, _c_int,  # counts, per-ray sample, regen
         _c_uint, _c_int, _c_uint, _c_int,  # sample, bounce, sample base, pixels
         _c_ptr, _c_ptr, _c_int, _c_ptr],  # out, rays out, staged, stream
    ),
    "grt_wavefront_raygen": (
        _c_int,
        [_c_ptr, _c_int, _c_int, _c_int, _c_int,  # camera, sampler kind, kx, ky, nbits
         _c_uint, _c_uint,  # frame seed, total width
         _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,  # f0, f1, i0, i1, stride
         _c_int, _c_int, _c_uint, _c_int, _c_int,  # per-ray sample, regen, sample, mode, count
         _c_int, _c_int, _c_uint, _c_uint, _c_uint,  # pool, width, y offset, row stride, s0
         _c_ptr, _c_double, _c_double, _c_int,  # counts, thresholds, stream length
         _c_ptr, _c_ptr, _c_ptr, _c_ptr],  # perm, stats, bounds, stream
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
    "grt_adaptive_cluster": (_c_int, [_c_int]),
    "grt_error_string": (ctypes.c_char_p, [_c_int]),
}

_PROBES_SIGNATURES = {
    # x, out, n, rounds, mix, chains, stream
    "grt_fma_peak": (_c_int, [_c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr]),
    # x, out, n, rounds, bf16, compare, stream
    "grt_slab_dtype": (_c_int, [_c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr]),
    "grt_error_string": (ctypes.c_char_p, [_c_int]),
}


# The schedule's constants every kernel of the device loop takes
# (wavefront.cuh::WfSched): thresholds, stream length, pool, regen, last.
_SCHED_ARGS = [_c_double, _c_double, _c_int, _c_int, _c_int, _c_int]

_WAVEFRONT_SIGNATURES = {
    "grt_wf_partition": (
        _c_int,
        [_c_ptr, *_SCHED_ARGS,  # counts, schedule
         _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,  # f0, f1, i0, i1, i planes, stride
         _c_int, _c_int, _c_int,  # sort, bounce bucket, live keys
         _c_ptr, _c_ptr, _c_ptr,  # keys, look-back status, ticket and epoch
         _c_ptr, _c_ptr, _c_ptr],  # perm, bounds, stream
    ),
    "grt_wf_advance": (
        _c_int,
        [_c_ptr, *_SCHED_ARGS, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr],
    ),
    "grt_error_string": (ctypes.c_char_p, [_c_int]),
}


@dataclasses.dataclass(frozen=True)
class _Target:
    source: str
    library: str
    signatures: dict
    headers: tuple = ()


# The headers the sources include: what the wavefront kernels share, and
# the launch helper every launcher sizes its grid with.
_WAVEFRONT_HEADER = os.path.join(_HERE, "wavefront.cuh")
_LAUNCH_HEADER = os.path.join(_HERE, "launch.cuh")

TARGETS = {
    "megakernel": _Target(os.path.join(_HERE, "megakernel.cu"),
                          os.path.join(BUILD_DIR, "libgrt_megakernel.so"),
                          _MEGAKERNEL_SIGNATURES, (_WAVEFRONT_HEADER, _LAUNCH_HEADER)),
    "wavefront": _Target(os.path.join(_HERE, "wavefront.cu"),
                         os.path.join(BUILD_DIR, "libgrt_wavefront.so"),
                         _WAVEFRONT_SIGNATURES, (_WAVEFRONT_HEADER, _LAUNCH_HEADER)),
    "probes": _Target(os.path.join(_HERE, "probes.cu"),
                      os.path.join(BUILD_DIR, "libgrt_probes.so"), _PROBES_SIGNATURES,
                      (_LAUNCH_HEADER,)),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What a load did: the library, whether it was compiled in this
    process, the seconds that took, and the compiler's own report;
    build_info adds the compiler's version."""

    library: str
    compiled: bool
    seconds: float
    ptxas_report: str
    nvcc_version: str = ""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_infos: dict[str, BuildInfo] = {}


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
        "the CUDA kernels must be compiled from ops/cuda/*.cu"
    )


def _nvcc_version(path: str) -> str:
    out = subprocess.run([path, "--version"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else out


def _compile(path: str, target: _Target, extra: tuple = ()) -> tuple[float, str]:
    """Compile a target's source into its library (atomically); returns
    (seconds, ptxas report)."""
    tmp = f"{target.library}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [path, *NVCC_FLAGS, *extra, "-o", tmp, target.source],
        capture_output=True, text=True, timeout=900,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}) building {target.source}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, target.library)
    return seconds, (proc.stdout + proc.stderr).strip()


def _stale(target: _Target) -> bool:
    return (not os.path.exists(target.library)
            or any(os.path.getmtime(target.library) < os.path.getmtime(src)
                   for src in (target.source, *target.headers)))


def _build(name: str, path: str) -> tuple[bool, float, str]:
    """Compile target `name` if missing or stale, under its file lock;
    returns (compiled, seconds, ptxas report)."""
    target = TARGETS[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"build_{name}.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if _stale(target):
                return (True, *_compile(path, target))
            return False, 0.0, ""
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _bind(name: str, built: tuple[bool, float, str]) -> ctypes.CDLL:
    target = TARGETS[name]
    lib = ctypes.CDLL(target.library)
    for fn_name, (restype, argtypes) in target.signatures.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    _infos[name] = BuildInfo(target.library, *built)
    _libs[name] = lib
    return lib


def load(name: str = "megakernel") -> ctypes.CDLL:
    """The bound library of target `name` ('megakernel', 'wavefront' or
    'probes'), compiled first if missing or stale."""
    with _lock:
        if name in _libs:
            return _libs[name]
        return _bind(name, _build(name, nvcc()))


def build_all() -> dict[str, BuildInfo]:
    """Load every target, compiling the stale ones side by side (one nvcc
    per source, all started together); returns their build details."""
    with _lock:
        missing = [name for name in TARGETS if name not in _libs]
        if missing:
            path = nvcc()
            with concurrent.futures.ThreadPoolExecutor(len(missing)) as pool:
                built = list(pool.map(lambda name: _build(name, path), missing))
            for name, b in zip(missing, built):
                _bind(name, b)
        return dict(_infos)


def compile_copy(name: str, source: str, library: str) -> tuple[ctypes.CDLL, str]:
    """Compile `source`, a copy of target `name`'s source that differs from
    it (a measurement's variant), with the same flags into `library`, and
    bind it with the target's signatures without making it the target's
    library; returns (library, ptxas report)."""
    target = TARGETS[name]
    copy = _Target(source, library, target.signatures)
    # The copy includes the target's headers from the target's directory.
    _, report = _compile(nvcc(), copy, ("-I", os.path.dirname(target.source)))
    lib = ctypes.CDLL(library)
    for fn_name, (restype, argtypes) in target.signatures.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib, report


def build_info(name: str = "megakernel") -> BuildInfo:
    """Build details of a loaded library (loads it first), with the
    version nvcc reports."""
    load(name)
    return dataclasses.replace(_infos[name], nvcc_version=_nvcc_version(nvcc()))


def check(rc: int, what: str, name: str = "megakernel") -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = load(name).grt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")
