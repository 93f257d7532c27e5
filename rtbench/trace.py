"""Reading a traced window: torch.profiler's device timeline, summed by
kernel, its busy and idle time, and its longest idle gaps named by what the
host was doing.  The harness marks its own spans with record_function
(`rtbench.window`, `rtbench.call`, `rtbench.sync`), so a gap is named by
the harness's span and the innermost host operation that covers it.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

WINDOW = "rtbench.window"
CALL = "rtbench.call"
# Host spans the profiler mirrors onto the device's timeline: the
# harness's own, and c10d's around each collective (`nccl:all_gather`).
ANNOTATIONS = ("rtbench.", "nccl:")
_KERNEL = re.compile(r"(\w+_kernel)\b")


def kernel_key(name: str) -> str:
    """A device operation's short name: `render_kernel` for
    `void render_kernel<true, false, true>(...)`, else the name before its
    template and argument lists (`ncclDevKernel_AllGather_RING_LL`,
    `at::native::elementwise_kernel`, `Memcpy DtoD ...`)."""
    m = _KERNEL.search(name)
    if m:
        return m.group(1)
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name)[0].strip()


def is_collective(key: str) -> bool:
    return key.startswith("nccl")


@dataclasses.dataclass
class RankTrace:
    """One rank's traced window: its length, the frames in it, the union of
    device activity, device seconds by kernel key, and the ten longest idle
    gaps."""

    window_s: float
    frames: int
    busy_s: float
    kernel_s: dict
    gaps: list  # [(host label, seconds)], longest first

    def per_frame_ms(self, match) -> float:
        return 1e3 * sum(s for k, s in self.kernel_s.items() if match(k)) / self.frames


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of (start, end) rows, sorted and merged."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(events, n_gaps: int = 10) -> RankTrace:
    """A RankTrace from profiler events (prof.events()): device operations
    clipped to the `rtbench.window` span.  Host spans that the profiler
    mirrors onto the device's timeline (ANNOTATIONS) are not operations."""
    from torch.autograd import DeviceType  # noqa: PLC0415 - torch is the harness's

    win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no rtbench.window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, kernel_s = [], {}
    cpu = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(ANNOTATIONS):
                continue
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                key = kernel_key(e.name)
                kernel_s[key] = kernel_s.get(key, 0.0) + (t - s) * 1e-6
        elif e.name != WINDOW and t > w0 and s < w1:
            cpu.append((s, t, e.name))
    busy = _merge(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_us = float(np.sum(busy[:, 1] - busy[:, 0])) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    lengths = edges[:, 1] - edges[:, 0]
    order = np.argsort(-lengths)[:n_gaps]
    starts = np.asarray([c[0] for c in cpu], dtype=np.float64)
    ends = np.asarray([c[1] for c in cpu], dtype=np.float64)
    gaps = []
    for i in order:
        if lengths[i] <= 0:
            break
        gaps.append((_host_label(edges[i], starts, ends, cpu), float(lengths[i]) * 1e-6))
    frames = sum(1 for c in cpu if c[2] == CALL)
    return RankTrace(window_s=(w1 - w0) * 1e-6, frames=frames, busy_s=busy_us * 1e-6,
                     kernel_s=kernel_s, gaps=gaps)


def _host_label(gap, starts, ends, cpu) -> str:
    """The harness span and the innermost host operation covering the gap's
    middle: `rtbench.call > aten::copy_`; `host between spans` if none covers
    it."""
    mid = 0.5 * (gap[0] + gap[1])
    idx = np.flatnonzero((starts <= mid) & (ends >= mid))
    if len(idx) == 0:
        return "host between spans"
    span = [cpu[i][2] for i in idx if cpu[i][2].startswith("rtbench.")]
    inner = min(idx, key=lambda i: ends[i] - starts[i])
    parts = span[:1] + ([cpu[inner][2]] if not cpu[inner][2].startswith("rtbench.") else [])
    return " > ".join(parts) if parts else cpu[inner][2]


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read: every rank's traced window; the
    host's time inside the timed call and the time a frame, both over the
    frames before the trace began, so the profiler's own cost (7-15% of a
    frame on the host) is not in them; and the frame's work."""

    ranks: list
    enqueue_s: list
    untraced_frame_s: float  # the window's time a frame before the trace began
    rays_traced: float
    work_per_ray_flops: float
    width: int
    height: int
    kind: str

    def busy_share(self) -> float:
        """The device's busy time a traced frame over an untraced frame's
        time, averaged over ranks."""
        return sum(r.busy_s / r.frames for r in self.ranks) / (
            len(self.ranks) * self.untraced_frame_s)

    def kernel_ms(self, rank: int, match) -> float:
        return self.ranks[rank].per_frame_ms(match)
