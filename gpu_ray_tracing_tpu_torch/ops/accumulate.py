"""Progressive accumulation: the resumable render state (port of
gpu_ray_tracing_tpu/ops/accumulate.py).

Reference mapping (compute_shader.wgsl `update`, wgsl:333-364):
  - rgb  = running mean color      <- the texel's rgb (wgsl:339-341)
  - count = samples accumulated    <- the texel's alpha channel (wgsl:341)
  - reset-on-camera-move           <- camera_has_moved (wgsl:345-350), here
                                      an explicit argument
  - freeze at the spp target       <- `samples < samples_per_pixel` (wgsl:352)
  - incremental mean               <- c += (x - c) / (n + 1) (wgsl:356)

The sample count is a 0-d int32 tensor on the host, whatever device the
image lies on: the kernel takes the sample index by value, so a count on
the card would make every progressive frame wait on a device-to-host copy.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AccumState:
    """Progressive accumulation state: rgb = running mean, count = samples."""

    rgb: torch.Tensor  # (H, W, 3) f32 running mean in linear space
    count: torch.Tensor  # () i32 samples accumulated so far, on the host


def init_accum(height: int, width: int, device=None) -> AccumState:
    """Zero state, the `init` kernel entry point (wgsl:65-70)."""
    return AccumState(
        rgb=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class AdaptiveAccumState:
    """Adaptive progressive accumulation state (the megakernel's adaptive
    resume): per-pixel raw sums and the Welford luminance statistics, so a
    chunked run takes exactly the samples of the one-shot adaptive render
    and ends in the same bits.  `count` is per-pixel f32, constant within
    each kernel tile; `image` is the current estimate."""

    rgb_sum: torch.Tensor  # (H, W, 3) f32 raw radiance sums
    count: torch.Tensor  # (H, W) f32 samples taken per pixel (tile-constant)
    mlum: torch.Tensor  # (H, W) f32 Welford running luminance mean
    m2: torch.Tensor  # (H, W) f32 Welford running luminance M2

    @property
    def image(self) -> torch.Tensor:
        """Current per-pixel mean estimate (zeros where count == 0)."""
        return self.rgb_sum / torch.clamp(self.count, min=1.0)[..., None]


def init_adaptive_accum(height: int, width: int, device=None) -> AdaptiveAccumState:
    """Zero adaptive accumulation state."""
    z = torch.zeros((height, width), dtype=torch.float32, device=device)
    return AdaptiveAccumState(
        rgb_sum=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        count=z, mlum=z.clone(), m2=z.clone(),
    )


def fold_sample(state: AccumState, sample_rgb: torch.Tensor, spp_target: int, reset,
                num_samples: int = 1) -> AccumState:
    """Fold a render into the running mean (wgsl:345-358), with JAX's
    arithmetic.  `sample_rgb` is the mean of `num_samples` fresh samples.
    Reset clears the state first; the update freezes once the count reaches
    spp_target.  One sample divides, c + (x - c) / (n + 1), the reference's
    rounding; a batch weights its mean by the taken fraction,
    c + (x - c) * (k / max(n + k, 1)) with k = clip(target - n, 0, batch),
    so a batch that straddles the target freezes the count exactly there.
    The result lies on the sample's device."""
    reset = bool(reset)
    rgb = torch.zeros_like(sample_rgb) if reset else state.rgb.to(sample_rgb.device)
    count = 0 if reset else int(state.count)
    if count >= spp_target:
        return AccumState(rgb=rgb, count=torch.tensor(count, dtype=torch.int32))
    if num_samples == 1:
        new_rgb = rgb + (sample_rgb - rgb) / torch.tensor(float(count + 1), dtype=torch.float32)
        take = 1
    else:
        take = min(max(spp_target - count, 0), num_samples)
        k = torch.tensor(float(take), dtype=torch.float32)
        denom = torch.clamp(torch.tensor(float(count), dtype=torch.float32) + k, min=1.0)
        new_rgb = rgb + (sample_rgb - rgb) * (k / denom)
    return AccumState(rgb=new_rgb, count=torch.tensor(count + take, dtype=torch.int32))
