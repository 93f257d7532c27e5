"""Public rendering API (port of gpu_ray_tracing_tpu/api.py:232-342).

`render(scene, camera, config, frame_seed=...)` renders one frame of a
Spheres or a Scene (spheres, sphere BVH, mesh with its BVH, sphere and
triangle lights) at config.spp samples per pixel on the counter-based hash
stream, with config.nee/mis and config.sampler:

  backend='torch'  the plain PyTorch integrator (render_reference with
                   light_pick='lane'), on the device the scene lies on; the
                   counterpart of 'jax'.
  backend='cuda'   the hand-written megakernel (render_cuda); the
                   counterpart of 'pallas'.  It needs a CUDA device and
                   raises without one; a scene on the CPU is moved to the
                   current CUDA device explicitly.  It has no backward, so
                   inputs that require grad raise.

Above 4 lights the two backends pick the NEE light differently, as JAX's
'jax' and 'pallas' do: 'torch' per lane, 'cuda' once per (sample,
bounce).  Their images then differ per pixel and agree in the mean.
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera, CameraSettings, derive_camera
from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_cuda, render_reference
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig


def _cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "backend='cuda' needs an NVIDIA GPU and none is visible; use "
            "backend='torch' for the plain PyTorch integrator"
        )
    return torch.device("cuda", torch.cuda.current_device())


def render(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
           frame_seed: int = 0) -> torch.Tensor:
    """Render one frame; returns linear-RGB f32 of shape (height, width, 3)."""
    sc = as_scene(scene)
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    if isinstance(frame_seed, torch.Tensor):
        frame_seed = int(frame_seed.item())
    kwargs = dict(
        width=config.width, height=config.height, sample_index=0,
        frame_seed=int(frame_seed) & 0xFFFFFFFF, max_depth=config.max_depth,
        t_min=config.t_min, t_max=config.t_max, mode=config.integrator,
        russian_roulette_depth=config.russian_roulette_depth,
        sky_intensity=config.sky_intensity, spp=config.spp, clamp=config.clamp,
        nee=config.nee, mis=config.mis, sampler_spec=config.sampler_spec,
    )
    if config.backend == "cuda":
        device = _cuda_device()
        return render_cuda(sc.to(device), camera.to(device), **kwargs)
    return render_reference(sc, camera.to(sc.device), light_pick="lane", **kwargs)
