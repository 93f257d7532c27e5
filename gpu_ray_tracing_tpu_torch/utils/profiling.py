"""Frame timing, device traces and the program's spans (port of
gpu_ray_tracing_tpu/utils/profiling.py).

`time_frames` times a render callable over windows of frames with a
checksum read once a window, which proves the frames ran; on the card the
windows are CUDA events on the current stream, on the CPU the host clock.
`FrameStats` carries the record and its derived rates, `check_plausible`
refuses a ray rate above what the H100's HBM could write, and
`device_trace` is a torch.profiler context.  `span` is the only way the
program marks a part of its host work on torch.profiler's timeline, and
`span_table` sums a trace's spans and the CUDA calls they enclose.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable

import torch

#: Prefix of every span the program records (`span`).
SPAN_PREFIX = "grt."
#: Prefixes of the CUDA calls, as the profiler names them, that make the
#: host wait for the card, and that launch a kernel: the runtime's
#: `cudaLaunchKernel[ExC]` and the driver's `cuLaunchKernel[Ex]` (NCCL's
#: collectives); a name may carry a version suffix (`_v11060`).
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
_NO_SPAN = contextlib.nullcontext()

# No honest ray rate exceeds the card's HBM bandwidth at 12 bytes (one f32
# RGB) written a ray: NVIDIA H100 SXM, 3.35 TB/s -> ~279 Grays/s.
H100_HBM_BYTES_PER_SEC = 3.35e12
MIN_BYTES_PER_RAY = 12.0
MAX_PLAUSIBLE_MRAYS = H100_HBM_BYTES_PER_SEC / MIN_BYTES_PER_RAY / 1e6


def check_plausible(mrays_per_sec: float) -> None:
    """Raise if a ray rate exceeds the HBM-bandwidth ceiling of one H100:
    the timing then did not include the work."""
    if mrays_per_sec > MAX_PLAUSIBLE_MRAYS:
        raise RuntimeError(
            f"measured {mrays_per_sec:.0f} Mrays/s exceeds the H100 HBM-bandwidth "
            f"ceiling (~{MAX_PLAUSIBLE_MRAYS:.0f} Mrays/s at {MIN_BYTES_PER_RAY:.0f} B/ray, "
            f"{H100_HBM_BYTES_PER_SEC / 1e12:.2f} TB/s)"
            " — the timing did not include the work; refusing to report it"
        )


@dataclasses.dataclass
class FrameStats:
    """Throughput record of a timed render workload.  `seconds` is the
    median window of `frames` frames; `checksum` sums every frame of every
    window (proof that they ran)."""

    frames: int
    seconds: float
    width: int
    height: int
    spp: int
    checksum: float = 0.0
    window_seconds: tuple = ()
    device: str = "cpu"

    @property
    def ms_per_frame(self) -> float:
        return self.seconds / self.frames * 1e3

    @property
    def rays_per_frame(self) -> int:
        """Primary rays; bounce rays depend on the scene."""
        return self.width * self.height * self.spp

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_per_frame * self.frames / self.seconds / 1e6

    @property
    def spp_per_sec(self) -> float:
        return self.spp * self.frames / self.seconds

    @property
    def window_spread(self) -> float:
        """max/min over the windows (1.0 = perfectly stable)."""
        ws = self.window_seconds
        return max(ws) / max(min(ws), 1e-12) if len(ws) >= 2 else 1.0

    def to_dict(self) -> dict:
        return {
            "frames": self.frames,
            "ms_per_frame": round(self.ms_per_frame, 3),
            "mrays_per_sec": round(self.mrays_per_sec, 2),
            "spp_per_sec": round(self.spp_per_sec, 2),
            "checksum": self.checksum,
            "window_spread": round(self.window_spread, 3),
            "device": self.device,
        }

    def __str__(self) -> str:
        return json.dumps(self.to_dict())


def time_frames(
    frame_fn: Callable[[int], torch.Tensor],
    *,
    width: int,
    height: int,
    spp: int,
    frames: int = 10,
    warmup: int = 1,
    repeats: int = 3,
    device=None,
) -> FrameStats:
    """Time `frame_fn(i)` over `repeats` windows of `frames` frames after
    `warmup` frames, and report the median window.  Each window sums its
    frames on their device and reads the sum once at its end, so it cannot
    close before every frame has run.  Frames on the card are timed with
    CUDA events on the current stream, frames on the CPU with the host
    clock.  `device` is where the frames lie; None takes the first warm-up
    frame's device (the CPU without a warm-up)."""
    acc = None
    for i in range(warmup):
        frame = frame_fn(i)
        device = frame.device if device is None else device
        acc = frame.sum() if acc is None else acc + frame.sum()
    if acc is not None:
        float(acc)
    device = torch.device("cpu" if device is None else device)
    on_card = device.type == "cuda"
    windows, checksum = [], 0.0
    for r in range(repeats):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        acc = None
        for i in range(frames):
            s = frame_fn(warmup + r * frames + i).sum()
            acc = s if acc is None else acc + s
        if on_card:
            end.record()
        # float() forces every frame of the window; summed over windows so
        # the record covers each repeat.
        checksum += float(acc)
        if on_card:
            end.synchronize()
            windows.append(start.elapsed_time(end) / 1e3)
        else:
            windows.append(time.perf_counter() - t0)
    stats = FrameStats(
        frames=frames, seconds=sorted(windows)[len(windows) // 2], width=width,
        height=height, spp=spp, checksum=checksum, window_seconds=tuple(windows),
        device=torch.cuda.get_device_name(device) if on_card else "cpu",
    )
    check_plausible(stats.mrays_per_sec)
    return stats


def robust_spread(ts) -> float:
    """Window-to-window spread with the single worst window dropped, but
    only when at least 5 windows remain an estimate of the rest; below 5
    the full max - min stands, since dropping one of 3 would report the
    gap of the two closest as the spread."""
    s = sorted(ts)
    return (s[-2] - s[0]) if len(s) >= 5 else (s[-1] - s[0])


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """A torch.profiler trace of the enclosed work (the host and, for
    device 'cuda', the card's kernels), written as a Chrome trace to
    `log_dir`/trace.json on exit.  Yields the profiler, whose
    key_averages() sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A span named SPAN_PREFIX + `name` on torch.profiler's timeline while a
    profiler records on this thread, else one shared no-op context: with
    the profiler off a span costs one check and allocates nothing.

    The span is recorded as a host operation, not as a user annotation
    (torch.profiler.record_function), so the profiler does not mirror it
    onto the card's timeline, where a reader of device activity would take
    it for a kernel: the device's busy time and kernel sums read the same
    with spans and without."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def span_table(events, frames: int) -> dict:
    """Each span name of a trace (torch.profiler's `events()`) with its
    calls, total ms and self ms (less the spans directly inside it), and
    the synchronising (SYNC_CALLS) and launching (LAUNCH_CALLS) CUDA calls
    it is the innermost span of, all divided by `frames`; calls under no
    span count under "outside".  Spans nest by their host times, as the
    profiler's timeline draws them."""
    spans, calls = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            spans.append((s, t, e.name))
        elif e.name.startswith(SYNC_CALLS):
            calls.append((s, t, "syncs"))
        elif e.name.startswith(LAUNCH_CALLS):
            calls.append((s, t, "launches"))
    row = lambda: dict(calls=0.0, total_ms=0.0, self_ms=0.0, syncs=0.0, launches=0.0)
    table = {"outside": row()}
    # A sweep in start order, the enclosing item first: the open spans form
    # a stack whose top is the innermost span around the next item.
    stack = []
    for s, t, name in sorted(spans + calls, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] < t:
            stack.pop()
        parent = stack[-1][2] if stack else "outside"
        if name in ("syncs", "launches"):
            table[parent][name] += 1.0 / frames
            continue
        r = table.setdefault(name, row())
        ms = (t - s) * 1e-3 / frames
        r["calls"] += 1.0 / frames
        r["total_ms"] += ms
        r["self_ms"] += ms
        if stack:
            table[parent]["self_ms"] -= ms
        stack.append((s, t, name))
    return table
