"""gpu_ray_tracing_tpu_torch: the PyTorch + CUDA port of gpu_ray_tracing_tpu.

The port renders the hash-stream path tracer on sphere scenes (brute scan
or sphere BVH) and triangle meshes behind a BVH, lit by the sky or by
sphere and triangle lights (next-event estimation with MIS), under the
independent, stratified or Sobol sampler, in one shot, progressively, or
adaptively per tile, differentiably (render() on every backend) and
through the AOV-guided a-trous denoiser (render_denoised), with a
hand-written sm_90a megakernel (backend='cuda',
the default), the wavefront engine's sm_90a kernels (backend='wavefront',
one launch per bounce over compacted rays, with ray regeneration) or their
plain PyTorch versions (backend='torch', 'wavefront_torch'); the
reference shader's own WGSL stream (rng='wgsl') and the threefry mode
(rng='threefry', jax.random's stream bit for bit) through 'torch'.  Rows and
samples shard over ranks and cards with `parallel.mesh.make_mesh` (a
torch.distributed DeviceMesh, distinct from the top-level `make_mesh`,
which builds triangle geometry) and `parallel.sharding.render_sharded` /
`progressive_step_sharded` / `accum_image`.  It imports torch and numpy,
never jax.  `python -m gpu_ray_tracing_tpu_torch` is its command line
(cli.py: render, animate, progressive, view).

    from gpu_ray_tracing_tpu_torch import (
        CameraSettings, RenderConfig, one_weekend_scene, render)
    img = render(one_weekend_scene(0), CameraSettings.default(),
                 RenderConfig(width=1280, height=720, spp=16), frame_seed=7)
"""

from gpu_ray_tracing_tpu_torch.api import (
    adaptive_progressive_step,
    count_traced_rays,
    progressive_step,
    render,
    render_animation,
    render_denoised,
    render_progressive,
    stack_camera_track,
)
from gpu_ray_tracing_tpu_torch.convert import from_reference
from gpu_ray_tracing_tpu_torch.models.camera import (
    Camera,
    CameraSettings,
    derive_camera,
    dolly,
    elevate,
    orbit_pitch,
    orbit_yaw,
    strafe,
    validate_camera,
    zoom,
)
from gpu_ray_tracing_tpu_torch.models.cornell import cornell_box_scene, cornell_camera
from gpu_ray_tracing_tpu_torch.models.mesh import (
    TriangleMesh,
    box,
    bunny_stand_in,
    icosphere,
    load_obj,
    make_mesh,
    merge_meshes,
    torus,
    transform_mesh,
    trefoil,
)
from gpu_ray_tracing_tpu_torch.models.scene import (
    SPHERE_BVH_THRESHOLD,
    Lights,
    Scene,
    TriLights,
    as_scene,
    extract_lights,
    extract_tri_lights,
    make_scene,
    tri_light_id_per_face,
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
from gpu_ray_tracing_tpu_torch.ops.accumulate import (
    AccumState,
    AdaptiveAccumState,
    fold_sample,
    init_accum,
    init_adaptive_accum,
)
from gpu_ray_tracing_tpu_torch.ops.autograd import render_vjp
from gpu_ray_tracing_tpu_torch.ops.bvh import (
    BVH,
    build_bvh,
    build_mesh_bvh,
    build_sphere_bvh,
    validate_bvh,
)
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_cuda, render_reference
from gpu_ray_tracing_tpu_torch.ops.denoise import atrous_denoise, decode_normal_aov
from gpu_ray_tracing_tpu_torch.ops.cuda.wavefront import (
    render_wavefront,
    render_wavefront_reference,
)
from gpu_ray_tracing_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    load_accum,
    render_fingerprint,
    save_accum,
)
from gpu_ray_tracing_tpu_torch.utils.config import REFERENCE_CONFIG, RenderConfig
from gpu_ray_tracing_tpu_torch.utils.parity import images_match

__all__ = [
    "AccumState", "AdaptiveAccumState", "BVH", "Camera", "CameraSettings", "DIELECTRIC",
    "EMISSIVE", "LAMBERTIAN", "Lights", "METAL", "REFERENCE_CONFIG", "RenderConfig", "SPHERE_BVH_THRESHOLD",
    "Scene", "Spheres", "TriLights", "TriangleMesh", "adaptive_progressive_step",
    "as_scene", "atrous_denoise", "base_scene", "box", "build_bvh", "build_mesh_bvh", "build_sphere_bvh",
    "bunny_stand_in", "checkpoint_path", "cornell_box_scene", "cornell_camera",
    "count_traced_rays", "decode_normal_aov", "derive_camera", "dolly", "elevate", "extract_lights",
    "extract_tri_lights", "fold_sample", "from_reference", "icosphere", "images_match",
    "init_accum", "init_adaptive_accum", "load_accum", "load_obj", "make_mesh",
    "make_scene", "make_spheres", "merge_meshes", "one_weekend_scene", "orbit_pitch",
    "orbit_yaw", "progressive_step", "render", "render_animation", "render_cuda", "render_denoised",
    "render_fingerprint", "render_progressive", "render_reference", "render_wavefront",
    "render_vjp", "render_wavefront_reference", "save_accum",
    "stack_camera_track", "strafe", "torus", "transform_mesh", "trefoil",
    "tri_light_id_per_face", "validate_bvh", "validate_camera", "zoom",
]
