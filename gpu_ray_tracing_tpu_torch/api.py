"""Public rendering API (port of gpu_ray_tracing_tpu/api.py).

  render(scene, camera, config)                   one converged frame
  progressive_step(state, scene, camera, config)  one accumulation step
  render_progressive(scene, camera, config)       the reference's frame loop
  render_animation(scene, settings_track, config) a camera fly-through
  adaptive_progressive_step(state, ...)           adaptive accumulation
  count_traced_rays(scene, camera, config)        the rays a render traces

Every entry point renders a Spheres or a Scene (spheres, sphere BVH, mesh
with its BVH, sphere and triangle lights) on the counter-based hash stream,
with config.nee/mis and config.sampler, through the config's backend:

  backend='cuda'   the default: the hand-written megakernel (render_cuda),
                   the counterpart of 'pallas'.  It needs a CUDA device and
                   raises without one; a scene on the CPU is moved to the
                   current CUDA device.  It has no backward, so inputs that
                   require grad raise.  adaptive_tol > 0 runs its adaptive
                   spp loop.
  backend='wavefront'  the wavefront engine on the card (render_wavefront:
                   one kernel launch per bounce over compacted rays), the
                   counterpart of JAX's 'wavefront'.  It needs a CUDA device
                   and raises without one, like 'cuda'.  The path integrator
                   only: the AOV integrators go to the megakernel.
                   config.regenerate ('on', or 'auto' when more than one
                   sample is traced) keeps one persistent ray pool across
                   the samples.  With regeneration off its image equals
                   'cuda''s bit for bit.
  backend='torch'  the plain PyTorch integrator (render_reference with
                   light_pick='lane'), on the device the scene lies on; the
                   counterpart of 'jax'.
  backend='wavefront_torch'  the wavefront engine's plain version
                   (render_wavefront_reference), on the device the scene
                   lies on: how the CPU tests ask for the wavefront engine.

Above 4 lights the two backends pick the NEE light differently, as JAX's
'jax' and 'pallas' do: 'torch' per lane, 'cuda' once per (sample,
bounce).  Their images then differ per pixel and agree in the mean.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera, CameraSettings, derive_camera
from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.ops.accumulate import (
    AccumState,
    AdaptiveAccumState,
    fold_sample,
    init_accum,
)
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_cuda, render_reference
from gpu_ray_tracing_tpu_torch.ops.cuda.wavefront import (
    render_wavefront,
    render_wavefront_reference,
)
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig


def _cuda_device(backend: str) -> torch.device:
    if not torch.cuda.is_available():
        plain = "wavefront_torch" if backend == "wavefront" else "torch"
        raise RuntimeError(
            f"backend={backend!r} needs an NVIDIA GPU and none is visible; use "
            f"backend={plain!r} for its plain PyTorch version"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _seed(frame_seed) -> int:
    """A frame seed (int, numpy or 0-d tensor; None is 0) as a u32 int."""
    return 0 if frame_seed is None else int(frame_seed) & 0xFFFFFFFF


def _camera(camera: Camera | CameraSettings, config: RenderConfig) -> Camera:
    if isinstance(camera, CameraSettings):
        return derive_camera(camera, config.width, config.height)
    return camera


def _render(scene, camera: Camera, config: RenderConfig, *, frame_seed: int,
            sample_index: int = 0, spp: int, adaptive: bool = False, **extra):
    """One call of the config's backend over samples sample_index ..
    sample_index + spp - 1.  `adaptive` engages config.adaptive_tol: the
    one-shot renders set it, the fold-based progressive steps never do
    (they need exact per-sample counts)."""
    sc = as_scene(scene)
    if config.backend in ("wavefront", "wavefront_torch") and config.integrator == "path":
        return _render_wavefront(sc, camera, config, frame_seed=frame_seed,
                                 sample_index=sample_index, spp=spp, **extra)
    kwargs = dict(
        width=config.width, height=config.height, sample_index=sample_index,
        frame_seed=frame_seed, max_depth=config.max_depth, t_min=config.t_min,
        t_max=config.t_max, mode=config.integrator,
        russian_roulette_depth=config.russian_roulette_depth,
        sky_intensity=config.sky_intensity, spp=spp, clamp=config.clamp,
        nee=config.nee, mis=config.mis, sampler_spec=config.sampler_spec,
        adaptive_tol=config.adaptive_tol if adaptive else 0.0,
        adaptive_min_spp=config.adaptive_min_spp, **extra,
    )
    if config.backend in ("cuda", "wavefront"):
        device = _cuda_device(config.backend)
        return render_cuda(sc.to(device), camera.to(device), **kwargs)
    return render_reference(sc, camera.to(sc.device), light_pick="lane", **kwargs)


def _render_wavefront(sc, camera: Camera, config: RenderConfig, *, frame_seed: int,
                      sample_index: int, spp: int, **extra):
    """The wavefront engine over samples sample_index .. sample_index + spp
    - 1 (the JAX package's dispatch, api.py:193-211): on the card for
    'wavefront', its plain version on the scene's device for
    'wavefront_torch'."""
    kwargs = dict(
        width=config.width, height=config.height, sample_index=sample_index,
        frame_seed=frame_seed, max_depth=config.max_depth, t_min=config.t_min,
        t_max=config.t_max, russian_roulette_depth=config.russian_roulette_depth,
        sky_intensity=config.sky_intensity, nee=config.nee, mis=config.mis,
        clamp=config.clamp, spp=spp, sampler_spec=config.sampler_spec,
        regenerate=(config.regenerate == "on"
                    or (config.regenerate == "auto" and spp > 1)), **extra,
    )
    if config.backend == "wavefront":
        device = _cuda_device(config.backend)
        return render_wavefront(sc.to(device), camera.to(device), **kwargs)
    return render_wavefront_reference(sc, camera.to(sc.device), **kwargs)


def render(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
           frame_seed=0) -> torch.Tensor:
    """Render one frame at config.spp samples per pixel (a per-tile budget
    when config.adaptive_tol > 0); returns linear-RGB f32 of shape
    (height, width, 3)."""
    return _render(scene, _camera(camera, config), config, frame_seed=_seed(frame_seed),
                   spp=config.spp, adaptive=True)


def progressive_step(state: AccumState, scene, camera: Camera | CameraSettings,
                     config: RenderConfig, *, frame_seed=0, reset=False,
                     spp_per_step: int = 1) -> AccumState:
    """One progressive frame: trace spp_per_step samples at absolute sample
    indices count .. count + spp_per_step - 1 and fold their mean into the
    running mean (the reference's `update`, wgsl:333-364).  `reset` is the
    camera_has_moved flag; the state freezes once config.spp samples have
    accumulated, and a frozen state renders nothing."""
    if spp_per_step < 1:
        raise ValueError(f"spp_per_step must be >= 1, got {spp_per_step}")
    if config.adaptive_tol > 0.0:
        # The fold weights each batch by its exact sample count; adaptive
        # tiles take data-dependent counts the fold cannot see.
        raise ValueError(
            "adaptive_tol > 0 does not compose with fold-based "
            "progressive_step; use adaptive_progressive_step (exact "
            "in-kernel resume) or a one-shot render()"
        )
    if spp_per_step > 1 and config.spp % spp_per_step != 0:
        raise ValueError(
            f"spp_per_step={spp_per_step} must divide config.spp="
            f"{config.spp} so accumulation freezes exactly at the target"
        )
    count = 0 if bool(reset) else int(state.count)
    if count >= config.spp:
        return state
    sample = _render(scene, _camera(camera, config), config, frame_seed=_seed(frame_seed),
                     sample_index=count, spp=spp_per_step)
    return fold_sample(state, sample, config.spp, reset, num_samples=spp_per_step)


def render_progressive(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
                       frame_seed=0, num_frames: int | None = None) -> AccumState:
    """Run progressive accumulation for num_frames (default: to the spp
    target): the reference's steady-state frame loop with a static camera,
    the accumulated count acting as the sample index."""
    camera = _camera(camera, config)
    state = init_accum(config.height, config.width)
    for _ in range(config.spp if num_frames is None else num_frames):
        state = progressive_step(state, scene, camera, config, frame_seed=frame_seed)
    return state


def render_animation(scene, settings_track: CameraSettings, config: RenderConfig, *,
                     frame_seeds=None) -> torch.Tensor:
    """Render a camera fly-through: settings_track is a CameraSettings with a
    leading frame axis (stack_camera_track builds one), each frame a full
    config.spp render.  Returns (frames, height, width, 3)."""
    num_frames = settings_track.look_from.shape[0]
    if frame_seeds is not None and len(frame_seeds) != num_frames:
        raise ValueError(
            f"frame_seeds has {len(frame_seeds)} entries for "
            f"{num_frames} track frames"
        )
    frames = []
    for f in range(num_frames):
        settings = CameraSettings(*(getattr(settings_track, fl.name)[f]
                                    for fl in dataclasses.fields(CameraSettings)))
        frames.append(render(scene, settings, config,
                             frame_seed=None if frame_seeds is None else frame_seeds[f]))
    return torch.stack(frames)


def stack_camera_track(settings_list: list[CameraSettings]) -> CameraSettings:
    """Stack per-frame CameraSettings into a single track."""
    return CameraSettings(*(torch.stack([getattr(s, fl.name) for s in settings_list])
                            for fl in dataclasses.fields(CameraSettings)))


def adaptive_progressive_step(state: AdaptiveAccumState, scene,
                              camera: Camera | CameraSettings, config: RenderConfig, *,
                              frame_seed=0, spp_per_step: int = 8) -> AdaptiveAccumState:
    """One adaptive progressive step: resume the kernel's adaptive loop from
    `state` (init_adaptive_accum to start) and take at most spp_per_step
    more samples per tile, stopping tiles that converge.  The carried
    Welford statistics make the stopping test the one-shot render's at every
    absolute sample index, so ceil(spp / spp_per_step) steps give a state
    whose `.image` equals render() with the same config bit for bit.
    Requires backend='cuda', rng='hash', integrator='path', adaptive_tol > 0."""
    if config.adaptive_tol <= 0.0:
        raise ValueError(
            "adaptive_progressive_step requires adaptive_tol > 0 (use "
            "progressive_step for fixed-spp accumulation)"
        )
    if config.backend != "cuda" or config.rng != "hash":
        raise ValueError(
            "adaptive_progressive_step is a megakernel mode: backend="
            f"'cuda', rng='hash' (got {config.backend!r}/{config.rng!r})"
        )
    if config.integrator != "path":
        raise ValueError("adaptive sampling applies to the path integrator")
    if spp_per_step < 1:
        raise ValueError(f"spp_per_step must be >= 1, got {spp_per_step}")
    outs = _render(
        scene, _camera(camera, config), config, frame_seed=_seed(frame_seed),
        spp=config.spp, adaptive=True, adaptive_chunk=spp_per_step,
        adaptive_state=(state.rgb_sum[..., 0], state.rgb_sum[..., 1],
                        state.rgb_sum[..., 2], state.count, state.mlum, state.m2),
    )
    return AdaptiveAccumState(rgb_sum=torch.stack(outs[:3], dim=-1),
                              count=outs[3], mlum=outs[4], m2=outs[5])


def count_traced_rays(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
                      frame_seed=0, return_map: bool = False) -> dict:
    """Count the rays a render of `config` traces (measured, not inferred):
    closest-hit walks per live bounce plus NEE shadow rays whose light
    sample is valid, summed over all samples; an AOV integrator traces one
    per sample.  The megakernel's counters on 'cuda' and 'wavefront', the
    plain version's on 'torch' and 'wavefront_torch'.  Returns `rays_traced` (a host f64 sum: a frame total can pass
    f32's exact-integer range), `primary_rays` (width * height * spp), the
    frame's width, height and spp, and with return_map=True the (H, W)
    per-pixel count plane as `map`."""
    if config.rng != "hash":
        raise ValueError(
            "count_traced_rays requires rng='hash' (the counter stream is "
            "what makes the count engine-invariant)"
        )
    # The wavefront backends count through the megakernel (or its plain
    # version): the count is engine-invariant, and the regenerating pool
    # keeps no per-sample count.
    config = dataclasses.replace(
        config, regenerate="off",
        backend={"wavefront": "cuda", "wavefront_torch": "torch"}.get(config.backend,
                                                                      config.backend))
    ray_map = _render(scene, _camera(camera, config), config, frame_seed=_seed(frame_seed),
                      spp=config.spp, adaptive=True, return_ray_count=True)[-1]
    result = {
        "rays_traced": float(np.sum(ray_map.cpu().numpy(), dtype=np.float64)),
        "primary_rays": config.width * config.height * config.spp,
        "width": config.width,
        "height": config.height,
        "spp": config.spp,
    }
    if return_map:
        result["map"] = ray_map
    return result
