"""The statistics of a measured window."""

from __future__ import annotations

import math


def frame_ms(window_s: float, frames: int) -> float:
    """The whole window over the frames completed in it."""
    return 1e3 * window_s / frames


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every frame's latency (nearest rank)."""
    xs = sorted(latencies_s)
    k = max(0, math.ceil(0.95 * len(xs)) - 1)
    return 1e3 * xs[k]

