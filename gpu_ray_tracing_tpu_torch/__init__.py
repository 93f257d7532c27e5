"""gpu_ray_tracing_tpu_torch: the PyTorch + CUDA port of gpu_ray_tracing_tpu.

The port renders the hash-stream path tracer on a sphere scene with a
hand-written sm_90a megakernel (backend='cuda') or the plain PyTorch
integrator (backend='torch').  It imports torch and numpy, never jax.

    from gpu_ray_tracing_tpu_torch import (
        CameraSettings, RenderConfig, one_weekend_scene, render)
    img = render(one_weekend_scene(0), CameraSettings.default(),
                 RenderConfig(width=1280, height=720, spp=16, backend="cuda"),
                 frame_seed=7)
"""

from gpu_ray_tracing_tpu_torch.api import render
from gpu_ray_tracing_tpu_torch.convert import from_reference
from gpu_ray_tracing_tpu_torch.models.camera import (
    Camera,
    CameraSettings,
    derive_camera,
    validate_camera,
)
from gpu_ray_tracing_tpu_torch.models.scene import (
    SPHERE_BVH_THRESHOLD,
    Scene,
    as_scene,
    make_scene,
)
from gpu_ray_tracing_tpu_torch.models.spheres import (
    DIELECTRIC,
    EMISSIVE,
    LAMBERTIAN,
    METAL,
    Spheres,
    base_scene,
    make_spheres,
    one_weekend_scene,
)
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_cuda, render_reference
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig
from gpu_ray_tracing_tpu_torch.utils.parity import images_match

__all__ = [
    "Camera", "CameraSettings", "DIELECTRIC", "EMISSIVE", "LAMBERTIAN", "METAL",
    "RenderConfig", "SPHERE_BVH_THRESHOLD", "Scene", "Spheres",
    "as_scene", "base_scene", "derive_camera", "from_reference", "images_match",
    "make_scene", "make_spheres", "one_weekend_scene", "render", "render_cuda",
    "render_reference", "validate_camera",
]
