"""Counter-based ray generation (port of gpu_ray_tracing_tpu/ops/rays.py:89-146).

Every draw keys on the GLOBAL pixel id, so a row band of a larger frame
generates exactly the rays the full frame would.  Directions are not
normalized (wgsl:322); the intersection math uses a = dot(d, d).  The
pixel center and lens point round as the reference renders them (fused
multiply-adds, see ops/rounding.py): a ray one ulp off can graze a sphere
differently.
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.rounding import cos_sin, fma, sqrt

_TWO_PI = 6.283185307179586


def hash_pixel_ids(
    width: int,
    height: int,
    *,
    y_offset: int = 0,
    total_width: int | None = None,
    row_stride: int = 1,
    device=None,
) -> torch.Tensor:
    """(height, width) global pixel ids (int64 holding u32): local row r is
    global row `y_offset + r * row_stride` of a total_width-wide frame."""
    tw = width if total_width is None else total_width
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    y = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    y = (y * row_stride + y_offset) & rng_ops._MASK
    return (y * tw + x) & rng_ops._MASK


def generate_rays_hash(
    camera: Camera,
    width: int,
    height: int,
    sample_index,
    frame_seed_u32,
    *,
    y_offset: int = 0,
    total_width: int | None = None,
    row_stride: int = 1,
    sampler_spec: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-stream primary rays: returns (origins, dirs, pixel_seeds), the
    first two (height, width, 3) f32, the seeds (height, width) u32-in-int64."""
    tw = width if total_width is None else total_width
    pid = hash_pixel_ids(
        width, height, y_offset=y_offset, total_width=tw,
        row_stride=row_stride, device=camera.device,
    )
    return generate_rays_for_ids(
        camera, pid, sample_index, frame_seed_u32, total_width=tw,
        sampler_spec=sampler_spec,
    )


def generate_rays_for_ids(
    camera: Camera,
    pixel_ids: torch.Tensor,
    sample_index,
    frame_seed_u32,
    *,
    total_width: int,
    sampler_spec: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-stream rays for an array of global pixel ids (the same draws and
    arithmetic as the JAX generate_rays_for_ids)."""
    pid = rng_ops.as_u32(pixel_ids)
    seeds = rng_ops.hash_pixel_seeds(pid, sample_index, frame_seed_u32)
    u1 = rng_ops.uniform_hash(seeds, 1)
    u2 = rng_ops.uniform_hash(seeds, 2)
    jx, jy = rng_ops.sampler_jitter(
        u1, u2, pid, sample_index, frame_seed_u32, sampler_spec
    )
    fx = ((pid % total_width).to(torch.float32) + 0.5 + jx)[..., None]
    fy = ((pid // total_width).to(torch.float32) + 0.5 + jy)[..., None]
    # upper_left + du*fx + dv*fy as XLA:CPU rounds it (fused multiply-adds).
    centers = fma(camera.pixel_delta_v, fy,
                  fma(camera.pixel_delta_u, fx, camera.viewport_upper_left))
    u3 = rng_ops.uniform_hash(seeds, 3)
    u4 = rng_ops.uniform_hash(seeds, 4)
    # The thin-lens point is its own sampler pair (salt 7), uncorrelated
    # with the AA jitter's strata; its angle is the second draw times 2 pi.
    u3, angle = rng_ops.sampler_uniforms(
        u3, u4, pid, sample_index, frame_seed_u32, sampler_spec,
        rot_salt=rng_ops._LENS_ROT_SALT, y_scale=_TWO_PI,
    )
    radius = sqrt(u3)
    cos_a, sin_a = cos_sin(angle)
    px = radius * cos_a
    py = radius * sin_a
    lens = fma(py[..., None], camera.defocus_disk_v,
               fma(px[..., None], camera.defocus_disk_u, camera.center))
    # Pinhole when defocus_angle <= 0 (wgsl:319).
    origins = torch.where(camera.defocus_angle > 0.0, lens, camera.center)
    dirs = centers - origins
    return origins, dirs, seeds
