"""What decides `correct`: frames the timed path produced, compared with the
plain reference at pixels drawn from the seed.

During the window a reservoir keeps `check_frames` frames drawn uniformly
from all the window's frames (the draws from the seed), and of each only the
`check_pixels` sampled pixels, gathered on the card as the frame is kept.
Once the window has closed and the program's state is freed, the reference
(rtbench/reference/tracer.py) renders those pixels of those frames from the
same scene data and frame seeds; over several ranks each traces a share
and the shares are summed, so every rank compares its own copy of the
gathered frame at every sampled pixel.

The numbers compared: `flip_frac`, the share of sampled pixels whose
largest channel differs from the reference's by more than 1e-3 (a path
flipped by rounding where a ray grazes an edge), and `mean_abs`, the mean
absolute difference over the sampled channels.  A frame with a value that
is not finite fails outright.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import spec
from rtbench.reference import tracer

FLIP = 1e-3
NUMBERS = ("flip_frac", "mean_abs")


def frame_seed(seed: int, k: int) -> int:
    """Frame k's seed: (seed * 65536 + k) mod 2^32."""
    return (int(seed) * 65536 + int(k)) & 0xFFFFFFFF


class Reservoir:
    """A uniform sample of `m` frames of a stream of unknown length, drawn
    from the seed; keeps each kept frame's sampled pixels only."""

    def __init__(self, seed: int, m: int, n_pixels: int, width: int, height: int, device):
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0xC0FFEE])
        pick = np.sort(self.rng.choice(width * height, n_pixels, replace=False))
        self.pixels = torch.as_tensor(pick, dtype=torch.int64, device=device)
        self.m = m
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}

    def warm(self, frame: torch.Tensor) -> None:
        """Run the gather once at set-up, so that its kernel is loaded
        before the window."""
        frame.reshape(-1, 3)[self.pixels].clone()

    def offer(self, k: int, frame: torch.Tensor) -> None:
        slot = k if k < self.m else int(self.rng.integers(0, k + 1))
        if slot < self.m:
            self.kept[slot] = (k, frame.reshape(-1, 3)[self.pixels].clone())

    def frames(self) -> list[int]:
        return [self.kept[s][0] for s in sorted(self.kept)]

    def values(self) -> torch.Tensor:
        return torch.cat([self.kept[s][1] for s in sorted(self.kept)])


def reference_values(config: dict, data, seed: int, frames: list[int], pixels: torch.Tensor,
                     spp: int, *, rank: int = 0, world: int = 1,
                     precision=torch.float32) -> torch.Tensor:
    """The reference's (len(frames) * P, 3) values of the sampled pixels of
    the given frames; with world > 1 this rank's share (every world-th
    pixel) is filled and the rest left 0, for the caller to sum."""
    dev = pixels.device
    opt = tracer.Options(**spec.trace_options(config))
    sc = tracer.build_scene(data, dev, precision)
    cam = tracer.derive_camera(data.camera, config["width"], config["height"], dev, precision)
    pid = pixels.repeat(len(frames))
    fs = torch.as_tensor([frame_seed(seed, k) for k in frames], dtype=torch.int64,
                         device=dev).repeat_interleave(pixels.numel())
    out = torch.zeros((pid.numel(), 3), dtype=torch.float32, device=dev)
    mine = torch.arange(rank, pid.numel(), world, device=dev)
    out[mine] = tracer.render_pixels(sc, cam, pid[mine], fs[mine], width=config["width"],
                                     spp=spp, opt=opt, precision=precision)
    return out


def sums(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per frame of (F, P, 3) values: [flipped pixels, sum |diff|, pixels,
    channels, values not finite], an (F, 5) f64 tensor."""
    d = (got.double() - ref.double()).abs()
    bad = ~torch.isfinite(got)
    flipped = ((d.amax(-1) > FLIP) | bad.any(-1)).sum(-1).double()
    n = torch.full_like(flipped, float(got.shape[1]))
    return torch.stack([flipped, torch.nan_to_num(d, nan=0.0, posinf=0.0).sum((-1, -2)),
                        n, 3.0 * n, bad.sum((-1, -2)).double()], dim=-1)


def readings(s: torch.Tensor) -> dict:
    """The numbers compared, from summed rows of `sums`."""
    s = [float(x) for x in s.cpu()]
    return {"flip_frac": s[0] / s[2], "mean_abs": s[1] / s[3], "nonfinite": int(s[4])}


def verdict(read: dict, limits: dict | None) -> bool:
    """Every number within its limit, and no value that is not finite."""
    if not limits or read["nonfinite"]:
        return False
    return all(read[n] <= limits[n] for n in NUMBERS)


def decide(per_frame: torch.Tensor, limits: dict | None) -> tuple[dict, int, bool]:
    """From the (F, 5) `sums` of the checked frames: the pooled readings,
    the frames that fail their limits on their own, and `correct`: the
    pooled readings within the limits and no frame failing.  One frame
    wrong among several would pass the pooled readings alone."""
    pooled = readings(per_frame.sum(0))
    failed = sum(not verdict(readings(row), limits) for row in per_frame)
    return pooled, failed, verdict(pooled, limits) and failed == 0
