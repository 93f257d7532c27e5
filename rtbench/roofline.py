"""Peaks of the card and the roofline arithmetic of a frame.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
67 TFLOP/s in FP32 outside the tensor cores, 3.35 TB/s of HBM3.  They
assume the full 700 W power limit; the harness prints the card's limit
beside its numbers.  A frame's operations are the rays its kernels count
(`count_traced_rays`) times the work a traced ray needs, counted once a
configuration by the reference (rtbench/reference/work.py); its bytes are
the frame written once and read once (f32 RGB).
"""

from __future__ import annotations

PEAK_FLOPS = {"NVIDIA H100": 67e12}
PEAK_BYTES = {"NVIDIA H100": 3.35e12}


def _peak(table: dict, kind: str) -> float:
    for prefix, value in table.items():
        if kind.startswith(prefix):
            return value
    raise KeyError(f"no published peak for {kind!r}")


def known(kind: str) -> bool:
    """Whether the device has a published peak here (a CPU has none, so no
    share of a peak is read from a CPU run)."""
    return any(kind.startswith(p) for p in PEAK_FLOPS)


def frame_bytes(width: int, height: int) -> float:
    return 2.0 * width * height * 3 * 4


def frame_ops(rays_traced: float, work_per_ray_flops: float) -> float:
    return rays_traced * work_per_ray_flops


def bound_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time one card could take: the larger of operations over
    peak FLOP/s and bytes over peak bandwidth."""
    return max(ops / _peak(PEAK_FLOPS, kind), nbytes / _peak(PEAK_BYTES, kind))


def peak_flops(kind: str) -> float:
    return _peak(PEAK_FLOPS, kind)
