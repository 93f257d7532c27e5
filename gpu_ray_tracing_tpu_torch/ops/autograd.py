"""Gradients through the card's render kernels (port of the custom VJP of
gpu_ray_tracing_tpu/api.py:345-392, `_render_kernel_frame`).

The CUDA kernels have no backward.  `KernelFrame` is the
`torch.autograd.Function` that gives them one, as `jax.custom_vjp` does
for the Pallas kernels: its forward runs the kernel backend ('cuda' or
'wavefront') on detached copies of the scene's and the camera's tensors;
its backward replays the plain integrator (the 'torch' backend: the same
hash stream, sample for sample, at the full config.spp) and takes the
vector-Jacobian product of that replay.  Like `_render_kernel_frame_bwd`,
the replay keeps frame_seed and the sample indices, drops `regenerate`
and `adaptive_tol`, and picks the NEE light per lane (the 'jax' engine's
pick).  The kernel's image and the replay's agree to the flip contract of
chip_smoke.py, and the gradient is the replay's.

Where the port departs from JAX: `jax.vjp` over the spp loop keeps every
sample's residuals at once.  At 1280x720 and depth 30 that is more than a
card holds, so the replay takes one (sample, pixel block) at a time: it
builds that block's graph, calls `torch.autograd.grad` with the block's
rows of the output gradient (divided by spp, as the mean's backward
divides), and sums into the leaves' gradients.  A block holds at most
REPLAY_BLOCK_CUDA (on the card; REPLAY_BLOCK_CPU on the CPU) ray-bounces,
so the graph's size does not grow with the frame.  Only the order in which
the gradient is summed changes.  The sphere scan keeps no (P, N) planes in
the graph (ops/intersect.py recomputes the winner's root
straight-through), so a ray-bounce costs the same whatever the sphere
count.

`render_vjp` is the replay as a plain function, so that the CPU tests can
hold it to `jax.grad` without a card; `KernelFrame.backward` runs the same
replay on the leaves that need a gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera
from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import (
    _trace_block,
    dataclass_tensors,
    trace_pixels,
)
from gpu_ray_tracing_tpu_torch.ops.rays import hash_pixel_ids
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig

#: Ray-bounces (pixels x max_depth; pixels for the AOV modes) in one replay
#: block's autograd graph, on the card and on the CPU.  On the card a block
#: of 2^23 (279,620 pixels at depth 30) peaks at 3.5 GB for the One-Weekend
#: albedo gradient (chip_smoke.py phase 27, H100).
REPLAY_BLOCK_CUDA = 1 << 23
REPLAY_BLOCK_CPU = 1 << 18


def needs_grad(*objs) -> bool:
    """Whether autograd records and any tensor of the scene or camera
    dataclasses `objs` requires grad: then a kernel backend renders
    through KernelFrame."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for o in objs for t in dataclass_tensors(o))


def with_tensors(obj, tensors):
    """`obj` (a scene or camera dataclass) with its tensors, in
    dataclass_tensors order, replaced by the next items of the iterator
    `tensors` (an item may be None: a gradient that does not exist)."""
    new = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            new[f.name] = next(tensors)
        elif dataclasses.is_dataclass(v):
            new[f.name] = with_tensors(v, tensors)
    return dataclasses.replace(obj, **new)


def replay_block(num_pixels: int, sc, config: RenderConfig, device: torch.device) -> int:
    """Pixels of one replay block: at most REPLAY_BLOCK_* ray-bounces in
    the graph, and within the plain version's (P, N) scan budget."""
    budget = REPLAY_BLOCK_CUDA if device.type == "cuda" else REPLAY_BLOCK_CPU
    bounces = config.max_depth if config.integrator == "path" else 1
    return max(1, min(_trace_block(num_pixels, sc), budget // bounces))


def _vjp_flat(sc, camera: Camera, config: RenderConfig, grad_image: torch.Tensor,
              frame_seed: int, wants: list[bool]) -> list[torch.Tensor | None]:
    """The replay: d<grad_image, render>/d(tensor) for each tensor of
    dataclass_tensors(sc) + dataclass_tensors(camera) whose `wants` entry
    is true (None for the others), on grad_image's device."""
    dev = grad_image.device
    tensors = dataclass_tensors(sc) + dataclass_tensors(camera)
    leaves = [t.detach().to(dev).requires_grad_(w) for t, w in zip(tensors, wants)]
    it = iter(leaves)
    sc, camera = with_tensors(sc, it), with_tensors(camera, it)
    wrt = [t for t in leaves if t.requires_grad]
    grads = [None] * len(wrt)
    if not wrt:
        return [None] * len(leaves)
    w, h, spp = config.width, config.height, config.spp
    p = w * h
    pid = hash_pixel_ids(w, h, total_width=w, device=dev).reshape(p)
    # The mean's backward: each sample's image gets grad / spp.
    g = grad_image.detach().to(torch.float32).reshape(p, 3) / float(spp)
    block = replay_block(p, sc, config, dev)
    kw = dict(width=w, max_depth=config.max_depth, t_min=config.t_min, t_max=config.t_max,
              mode=config.integrator, russian_roulette_depth=config.russian_roulette_depth,
              sky_intensity=config.sky_intensity, clamp=config.clamp, nee=config.nee,
              mis=config.mis, sampler_spec=config.sampler_spec, light_pick="lane")
    with torch.enable_grad():
        for s in range(spp):
            for start in range(0, p, block):
                sl = slice(start, start + block)
                rgb, _ = trace_pixels(sc, camera, pid[sl], s, frame_seed, **kw)
                if not rgb.requires_grad:
                    continue
                part = torch.autograd.grad(rgb, wrt, g[sl], allow_unused=True)
                grads = [a if b is None else b if a is None else a + b
                         for a, b in zip(grads, part)]
    it = iter(grads)
    return [next(it) if t.requires_grad else None for t in leaves]


def render_vjp(scene, camera: Camera, config: RenderConfig, grad_image: torch.Tensor,
               frame_seed=0):
    """The vector-Jacobian product of a render: given grad_image ((H, W, 3),
    d loss / d image), return (d_scene, d_camera), dataclasses shaped as
    the Scene and the derived Camera with d loss / d tensor in every float
    tensor (zeros where the image does not depend on it, as the BVH's
    bounds) and None in every integer one.  It replays the 'torch'
    backend on grad_image's device, block by block (module docstring)."""
    sc = as_scene(scene)
    tensors = dataclass_tensors(sc) + dataclass_tensors(camera)
    wants = [t.is_floating_point() for t in tensors]
    flat = _vjp_flat(sc, camera, config, grad_image, int(frame_seed) & 0xFFFFFFFF, wants)
    flat = [None if not w else torch.zeros_like(t, device=grad_image.device) if d is None
            else d for t, w, d in zip(tensors, wants, flat)]
    it = iter(flat)
    return with_tensors(sc, it), with_tensors(camera, it)


class KernelFrame(torch.autograd.Function):
    """One frame of a kernel backend with the replay as its backward.
    apply(render_fn, scene, camera, config, frame_seed, *tensors): `tensors`
    are dataclass_tensors(scene) + dataclass_tensors(camera), passed flat
    so that autograd sees them; render_fn(scene, camera) runs the kernel
    on the dataclasses rebuilt from their detached copies."""

    @staticmethod
    def forward(ctx, render_fn, sc, camera, config, frame_seed, *tensors):
        # The inputs still require grad in here, and the kernels refuse such
        # tensors: the forward gets detached copies.
        it = iter([t.detach() for t in tensors])
        img = render_fn(with_tensors(sc, it), with_tensors(camera, it))
        ctx.save_for_backward(*tensors)
        ctx.spec = (sc, camera, config, frame_seed)
        return img

    @staticmethod
    def backward(ctx, grad_image):
        sc, camera, config, frame_seed = ctx.spec
        tensors = ctx.saved_tensors
        it = iter(tensors)
        sc, camera = with_tensors(sc, it), with_tensors(camera, it)
        wants = [need and t.is_floating_point()
                 for t, need in zip(tensors, ctx.needs_input_grad[5:])]
        # The replay reads neither config.backend nor regenerate nor
        # adaptive_tol: it is the plain integrator at the full config.spp.
        grads = _vjp_flat(sc, camera, config, grad_image, frame_seed, wants)
        return (None,) * 5 + tuple(None if d is None else d.to(t.device)
                                   for t, d in zip(tensors, grads))


def kernel_frame(render_fn, scene, camera: Camera, config: RenderConfig,
                 frame_seed: int) -> torch.Tensor:
    """render_fn(scene, camera), a kernel backend's frame of `config`,
    differentiable through KernelFrame."""
    sc = as_scene(scene)
    tensors = dataclass_tensors(sc) + dataclass_tensors(camera)
    return KernelFrame.apply(render_fn, sc, camera, config, frame_seed, *tensors)
