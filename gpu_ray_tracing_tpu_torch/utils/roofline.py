"""Arithmetic probes of the card (ports of benchmarks/vpu_roofline.py
`measure_peak` and benchmarks/bf16_probe.py).

`measure_peak()` answers "what FP32 rate does this card sustain on the
traversal's instruction mix, and on pure multiply-add chains": the measured
speed of light to set beside the data sheet's 67 TFLOP/s, which every
`bound` of PERF.md divides by.  `bf16_probe()` answers "what would packed
bf16 buy the slab-test-shaped math": microseconds per launch in f32 and in
packed bf16, with and without a compare.  Both launch the hand-written
kernels of ops/cuda/probes.cu (`fma_peak_kernel`, K3; `slab_kernel`, K4) and
time them with CUDA events; they need a CUDA device.  `slab_bound_ms` is
K4's least time: its operations a round at the issue rate of the type.

`fma_peak` and `slab_dtype` are the kernels' wrappers: on a CUDA tensor they
launch, on a CPU tensor they take the plain versions beside them
(`fma_peak_reference`, `slab_dtype_reference`: the same loops in elementwise
torch), which the tests and chip_smoke.py hold the kernels against at a few
rounds.  The price and sweep models of vpu_roofline.py are host code around
a BVH walk model and are not ported here.
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch.ops.cuda import build
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import LAUNCHES
from gpu_ray_tracing_tpu_torch.ops.rounding import fma

MIXES = {"slab": 0, "fma": 1}
CHAINS = (1, 2, 4)

#: Operations per bundle as the TPU probe counts them (`ops_of`,
#: vpu_roofline.py:113, :121, :147), kept so that counts compare across the
#: two probes.
PROBE_OPS = {"slab": 19, "fma": 12}
#: FP32 operations per bundle as the kernel's source writes them, a fused
#: multiply-add as 2.  slab: 3 sub + 3 mul, 6 min/max, 1 compare-select, the
#: blend a = m tn + (1 - m) a + 1e-6 (5), b = m tf + (1 - m) b with 1 - m
#: shared (3), c + a 1e-7 (2): 23 instructions, none fused (-fmad=false).
#: fma: 3 fused multiply-adds and 1 multiply: 4 instructions, 7 operations.
BUNDLE_FLOPS = {"slab": 23, "fma": 7}
BUNDLE_INSTRUCTIONS = {"slab": 23, "fma": 4}

#: FP32 outside the tensor cores, H100 SXM data sheet (700 W).
NOMINAL_FP32 = 67e12
#: The H100 SXM's SMs and boost clock (NVIDIA's data sheet: 67 TFLOP/s =
#: 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz).
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
#: K4's operations a round and element as bf16_probe.py counts them (9: sub,
#: add, 3 multiplies, min, max, the accumulation's add, the carry's
#: multiply; the compare form adds a compare).  None is fused
#: (-fmad=false), so each is an instruction of its own: `slab_bound_ms`
#: puts them at the H100's issue rate of 128 instructions a clock an SM (4
#: schedulers x 32 lanes; CUDA C++ Programming Guide, "Arithmetic
#: Instructions", compute capability 9.0), which is 128 results a clock in
#: f32 and 256 in packed bf16.  The min/max pipe's 64 a clock does not bind:
#: 2 of the 9.  The kernel's SASS has exactly these instructions a round
#: (PERF.md, Findings).
SLAB_OPS_PER_ROUND = 9
SLAB_RESULTS_PER_CLOCK = {torch.float32: 128, torch.bfloat16: 256}

_SLAB_C1 = 1.0009765625  # keeps values near 1 (1 exactly in bf16)


def ops_of(mix: str, chains: int, rounds: int, n: int) -> int:
    """Operations of one launch as the TPU probe counts them."""
    return chains * PROBE_OPS[mix] * rounds * n


def flops_of(mix: str, chains: int, rounds: int, n: int) -> int:
    """FP32 operations of one launch as written (an FMA as 2)."""
    return chains * BUNDLE_FLOPS[mix] * rounds * n


def _check_mix(mix: str, chains: int, rounds: int) -> None:
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {tuple(MIXES)}, got {mix!r}")
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def fma_peak_reference(x: torch.Tensor, rounds: int, mix: str = "slab",
                       chains: int = 2) -> torch.Tensor:
    """Plain version of fma_peak: the same bundles in elementwise f32 torch
    (the multiply-add mix through ops/rounding.fma, one rounding each)."""
    _check_mix(mix, chains, rounds)
    x = x.to(torch.float32)
    carry = []
    for g in range(chains):
        carry.append([x + _f32(0.1 * g), x * 0.5 + 0.25 + _f32(0.05 * g), x * 0.25 + 0.5])
    k1, k2, k3 = _f32(1.000001), _f32(0.999999), _f32(1.000002)
    for _ in range(rounds):
        for tri in carry:
            a, b, c = tri
            if mix == "slab":
                t0, t1, t2 = (a - c) * b, (b - c) * a, (a - b) * c
                tn = torch.maximum(torch.minimum(t0, t1), torch.minimum(t1, t2))
                tf = torch.minimum(torch.maximum(t0, t1), torch.maximum(t1, t2))
                m = (tf >= tn).to(torch.float32)
                a = m * tn + (1.0 - m) * a + 1e-6
                b = m * tf + (1.0 - m) * b
                c = c + a * 1e-7
            else:
                a = fma(a, k1, b)
                b = fma(b, k2, c)
                c = fma(c, k3, a * 1e-8)
            tri[:] = a, b, c
    acc = None
    for tri in carry:
        for v in tri:
            acc = v if acc is None else acc + v
    return acc


def _probe_input(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probes take a contiguous f32 tensor")
    if x.requires_grad:
        raise RuntimeError("the probes have no backward")
    return x


def fma_peak(x: torch.Tensor, rounds: int, mix: str = "slab", chains: int = 2) -> torch.Tensor:
    """`rounds` loop-carried bundles of `mix` ('slab': the traversal mix;
    'fma': multiply-add chains) on `chains` independent triples per element
    of x, summed into one f32 output of x's shape.  On a CUDA tensor it
    launches `fma_peak_kernel`; on a CPU tensor it is the plain version."""
    _check_mix(mix, chains, rounds)
    if not x.is_cuda:
        return fma_peak_reference(x, rounds, mix, chains)
    _probe_input(x)
    lib = build.load("probes")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.grt_fma_peak(x.data_ptr(), out.data_ptr(), x.numel(), rounds, MIXES[mix],
                              chains, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "fma_peak", "probes")
    LAUNCHES["fma_peak"] += 1
    return out


def slab_dtype_reference(x: torch.Tensor, rounds: int, dtype: torch.dtype = torch.float32,
                         compare: bool = False) -> torch.Tensor:
    """Plain version of slab_dtype: bf16_probe.py's body in elementwise
    torch, every operation rounded to `dtype`; returns f32."""
    v = x.to(dtype)
    c1 = torch.tensor(_SLAB_C1, dtype=dtype, device=x.device)
    acc = torch.zeros_like(v)
    for _ in range(rounds):
        t0 = (v - c1) * v
        t1 = (v + c1) * v
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        acc = acc + ((tf >= tn).to(dtype) * tn if compare else tf * tn)
        v = v * c1
    return acc.to(torch.float32)


def slab_dtype(x: torch.Tensor, rounds: int, dtype: torch.dtype = torch.float32,
               compare: bool = False) -> torch.Tensor:
    """`rounds` loop-carried rounds of slab-test-shaped math on x (f32, an
    even element count) in `dtype` (torch.float32, or torch.bfloat16: two
    values a thread, each operation rounded to bf16), accumulating tf * tn,
    or (tf >= tn) * tn with `compare`; returns f32 of x's shape.  On a CUDA
    tensor it launches `slab_kernel`; on a CPU tensor it is the plain
    version."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if not x.is_cuda:
        return slab_dtype_reference(x, rounds, dtype, compare)
    _probe_input(x)
    if x.numel() % 2:
        raise ValueError("slab_dtype takes an even number of elements")
    lib = build.load("probes")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.grt_slab_dtype(x.data_ptr(), out.data_ptr(), x.numel(), rounds,
                                int(dtype == torch.bfloat16), int(compare),
                                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "slab_dtype", "probes")
    LAUNCHES["bf16_probe"] += 1
    return out


def slab_bound_ms(n: int, rounds: int, dtype: torch.dtype = torch.float32,
                  compare: bool = False) -> float:
    """K4's least time on the H100 for n elements and `rounds` rounds: its
    operations (SLAB_OPS_PER_ROUND, one more with `compare`) at the issue
    rate of the type."""
    ops = SLAB_OPS_PER_ROUND + int(compare)
    clocks = ops * n * rounds / (SLAB_RESULTS_PER_CLOCK[dtype] * H100_SMS)
    return clocks / H100_CLOCK_HZ * 1e3


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card and need an NVIDIA GPU; "
                           "none is visible")
    return torch.device("cuda", torch.cuda.current_device())


def _time_ms(fn, repeats: int) -> float:
    """Mean device milliseconds of `repeats` calls (CUDA events), after one
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def card_threads(waves: int = 4) -> int:
    """Elements that fill the card `waves` times over: SMs x 2,048 threads."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return props.multi_processor_count * 2048 * waves


def measure_peak(rounds: int = 4096, waves: int = 4, repeats: int = 5) -> dict:
    """Time K3 on a card-filling grid: per mix and chain count the ms per
    launch and the rate in three counts: FP32 operations as written (an FMA
    as 2; its share of the nominal 67 TFLOP/s), instructions, and the TPU
    probe's op count (a count only: it overcounts the multiply-add mix, 12
    against the 7 its code computes).  `best` per mix is the chain count
    with the highest rate."""
    dev = _device()
    n = card_threads(waves)
    x = torch.full((n,), 1.0, dtype=torch.float32, device=dev)
    out = {"n": n, "rounds": rounds, "repeats": repeats, "nominal_fp32": NOMINAL_FP32,
           "runs": [], "best": {}}
    for mix in MIXES:
        for chains in CHAINS:
            ms = _time_ms(lambda: fma_peak(x, rounds, mix, chains), repeats)
            flops = flops_of(mix, chains, rounds, n)
            rate = flops / (ms * 1e-3)
            rec = {"mix": mix, "chains": chains, "ms": ms, "flops": flops,
                   "tflops": rate / 1e12,
                   "tinstr_per_s": chains * BUNDLE_INSTRUCTIONS[mix] * rounds * n
                   / (ms * 1e-3) / 1e12,
                   "probe_ops": ops_of(mix, chains, rounds, n),
                   "share_of_nominal": rate / NOMINAL_FP32}
            out["runs"].append(rec)
            if mix not in out["best"] or rate > out["best"][mix]["tflops"] * 1e12:
                out["best"][mix] = rec
    return out


def bf16_probe(rounds: int = 2048, waves: int = 4, repeats: int = 20) -> dict:
    """Time K4: microseconds per launch in f32 and in packed bf16 and their
    ratio, on the (32, 128) tile of the original probe and on a card-filling
    grid, for the product form and for the compare form."""
    dev = _device()
    sizes = {"tile_32x128": 32 * 128, "card": card_threads(waves)}
    out = {"rounds": rounds, "repeats": repeats, "runs": []}
    for label, n in sizes.items():
        x = torch.linspace(0.5, 1.5, n, dtype=torch.float32, device=dev)
        for compare in (False, True):
            us = {name: _time_ms(lambda: slab_dtype(x, rounds, dt, compare), repeats) * 1e3
                  for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
            out["runs"].append({"size": label, "n": n, "compare": compare,
                                "f32_us": us["f32"], "bf16_us": us["bf16"],
                                "bf16_over_f32": us["bf16"] / us["f32"]})
    return out
