"""Public rendering API (port of gpu_ray_tracing_tpu/api.py).

  render(scene, camera, config)                   one converged frame
  progressive_step(state, scene, camera, config)  one accumulation step
  render_progressive(scene, camera, config)       the reference's frame loop
  render_animation(scene, settings_track, config) a camera fly-through
  adaptive_progressive_step(state, ...)           adaptive accumulation
  count_traced_rays(scene, camera, config)        the rays a render traces
  render_denoised(scene, camera, config)          a frame through the a-trous filter

Every entry point renders a Spheres or a Scene (spheres, sphere BVH, mesh
with its BVH, sphere and triangle lights) on the counter-based hash stream,
with config.nee/mis and config.sampler, through the config's backend.
config.rng='wgsl' renders the reference's own stream instead (sample s
seeded 1 + s + frame_seed, update() at wgsl:353; parity=True keeps its
sampler quirks), and config.rng='threefry' jax.random's stream bit for
bit from `key=` (ops/rng.py: an int k is jax.random.PRNGKey(k), or pass
the key's two u32 words as jax.random.key_data gives them; sample s of a
frame under fold_in(key, s), frame f of a progressive run or an
animation under fold_in(key, f), as the JAX package folds its key): both
through backend='torch' only, as the JAX package sends them to 'jax',
since the kernels draw the hash stream.  A `key` given to the hash or
wgsl stream becomes the frame seed: its low word (key & 0xFFFFFFFF for
an int, the last of two words), unless frame_seed is given.
The backends:

  backend='cuda'   the default: the hand-written megakernel (render_cuda),
                   the counterpart of 'pallas'.  It needs a CUDA device and
                   raises without one; a scene on the CPU is moved to the
                   current CUDA device.  adaptive_tol > 0 runs its adaptive
                   spp loop.  render() is differentiable on it: when
                   autograd records and a tensor of the scene or camera
                   requires grad, the frame goes through
                   ops/autograd.KernelFrame, whose forward is the kernel
                   and whose backward replays 'torch' on the same stream
                   (JAX's custom VJP); otherwise straight to the kernel.
  backend='wavefront'  the wavefront engine on the card (render_wavefront:
                   one kernel launch per bounce over compacted rays), the
                   counterpart of JAX's 'wavefront'.  It needs a CUDA device
                   and raises without one, like 'cuda'.  The path integrator
                   only: the AOV integrators go to the megakernel.
                   config.regenerate ('on', or 'auto' when more than one
                   sample is traced) keeps one persistent ray pool across
                   the samples.  With regeneration off its image equals
                   'cuda''s bit for bit.  Differentiable as 'cuda' is.
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
from gpu_ray_tracing_tpu_torch.ops import denoise as denoise_ops
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.accumulate import (
    AccumState,
    AdaptiveAccumState,
    fold_sample,
    init_accum,
)
from gpu_ray_tracing_tpu_torch.ops.autograd import kernel_frame, needs_grad
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import (
    render_cuda,
    render_guides,
    render_guides_reference,
    render_reference,
)
from gpu_ray_tracing_tpu_torch.ops.cuda.wavefront import (
    render_wavefront,
    render_wavefront_reference,
)
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig
from gpu_ray_tracing_tpu_torch.utils.profiling import span


def _cuda_device(backend: str, hint: str | None = None) -> torch.device:
    """The current CUDA device; raises when no card is visible, naming what
    to ask for instead (`hint`, by default the backend's plain version)."""
    if not torch.cuda.is_available():
        plain = "wavefront_torch" if backend == "wavefront" else "torch"
        raise RuntimeError(
            f"backend={backend!r} needs an NVIDIA GPU and none is visible; "
            + (hint or f"use backend={plain!r} for its plain PyTorch version")
        )
    return torch.device("cuda", torch.cuda.current_device())


def _seed(frame_seed) -> int:
    """A frame seed (int, numpy or 0-d tensor; None is 0) as a u32 int."""
    return 0 if frame_seed is None else int(frame_seed) & 0xFFFFFFFF


def _resolve_rng(config: RenderConfig, key, frame_seed) -> tuple[rng_ops.Key | None, int]:
    """(key, frame seed) for config.rng (the JAX package's _resolve_rng,
    api.py:276-291): threefry needs a key (ops/rng.as_key: an int or two
    u32 words) and draws no frame seed; the hash and wgsl streams take
    frame_seed, else the key's low word, else 0."""
    if config.rng == "threefry":
        if key is None:
            raise ValueError("config.rng='threefry' requires key=")
        return rng_ops.as_key(key), 0
    if frame_seed is None and key is not None:
        return None, rng_ops.as_key(key)[1]
    return None, _seed(frame_seed)


def _camera(camera: Camera | CameraSettings, config: RenderConfig) -> Camera:
    if isinstance(camera, CameraSettings):
        with span("camera"):
            return derive_camera(camera, config.width, config.height)
    return camera


def _render(scene, camera: Camera, config: RenderConfig, *, frame_seed: int,
            sample_index: int = 0, spp: int, adaptive: bool = False,
            key: rng_ops.Key | None = None, **extra):
    """One call of the config's backend over samples sample_index ..
    sample_index + spp - 1 (`key` for rng='threefry').  `adaptive` engages
    config.adaptive_tol: the one-shot renders set it, the fold-based
    progressive steps never do (they need exact per-sample counts)."""
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
    return render_reference(sc, camera.to(sc.device), light_pick="lane", rng=config.rng,
                            parity=config.parity, key=key, **kwargs)


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
           key=None, frame_seed=None) -> torch.Tensor:
    """Render one frame at config.spp samples per pixel (a per-tile budget
    when config.adaptive_tol > 0); returns linear-RGB f32 of shape
    (height, width, 3).  `key` (an int or two u32 words) draws
    rng='threefry'; `frame_seed`
    (u32, default 0) seeds the hash and wgsl streams.  Differentiable on
    every backend: on 'cuda' and 'wavefront' through KernelFrame (module
    docstring), the camera derived outside it so that gradients reach the
    CameraSettings."""
    with span("render"):
        camera = _camera(camera, config)
        key, seed = _resolve_rng(config, key, frame_seed)

        def run(sc, cam):
            return _render(sc, cam, config, frame_seed=seed, spp=config.spp, adaptive=True,
                           key=key)

        if config.backend in ("cuda", "wavefront") and needs_grad(as_scene(scene), camera):
            return kernel_frame(run, scene, camera, config, seed)
        return run(scene, camera)


def _refuse_grad(entry: str, scene, camera, config: RenderConfig) -> None:
    """The progressive entry points of the kernel backends have no
    backward (the JAX package's have none either)."""
    if config.backend in ("cuda", "wavefront") and needs_grad(as_scene(scene), camera):
        raise RuntimeError(
            f"{entry} has no backward on backend={config.backend!r}; differentiate "
            "through render(), whose backward replays the plain integrator"
        )


def progressive_step(state: AccumState, scene, camera: Camera | CameraSettings,
                     config: RenderConfig, *, key=None, frame_seed=None, reset=False,
                     spp_per_step: int = 1) -> AccumState:
    """One progressive frame: trace spp_per_step samples at absolute sample
    indices count .. count + spp_per_step - 1 and fold their mean into the
    running mean (the reference's `update`, wgsl:333-364).  `reset` is the
    camera_has_moved flag; the state freezes once config.spp samples have
    accumulated, and a frozen state renders nothing.  rng='threefry' draws
    its one sample from `key` as render(spp=1, key=key) does, whatever the
    count: pass a fresh key a step (render_progressive folds the frame in)."""
    if spp_per_step < 1:
        raise ValueError(f"spp_per_step must be >= 1, got {spp_per_step}")
    if spp_per_step > 1 and config.rng == "threefry":
        raise ValueError(
            "spp_per_step > 1 requires a counter-based rng ('hash'/'wgsl'): "
            "threefry cannot address absolute sample indices from a running count"
        )
    _refuse_grad("progressive_step", scene, camera, config)
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
    key, seed = _resolve_rng(config, key, frame_seed)
    count = 0 if bool(reset) else int(state.count)
    if count >= config.spp:
        return state
    sample = _render(scene, _camera(camera, config), config, frame_seed=seed,
                     sample_index=0 if key is not None else count, spp=spp_per_step, key=key)
    return fold_sample(state, sample, config.spp, reset, num_samples=spp_per_step)


def render_progressive(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
                       key=None, frame_seed=None,
                       num_frames: int | None = None) -> AccumState:
    """Run progressive accumulation for num_frames (default: to the spp
    target): the reference's steady-state frame loop with a static camera,
    the accumulated count acting as the sample index (hash, wgsl), or
    frame f drawing from fold_in(key, f) (threefry)."""
    camera = _camera(camera, config)
    key, seed = _resolve_rng(config, key, frame_seed)
    state = init_accum(config.height, config.width)
    for f in range(config.spp if num_frames is None else num_frames):
        state = progressive_step(state, scene, camera, config, frame_seed=seed,
                                 key=_frame_key(key, f))
    return state


def _frame_key(key, f: int) -> rng_ops.Key | None:
    """Frame f's key (the JAX package's fold_in(key, f), api.py:512, :551),
    None without a key."""
    return None if key is None else rng_ops.fold_in(rng_ops.as_key(key), f)


def render_animation(scene, settings_track: CameraSettings, config: RenderConfig, *,
                     key=None, frame_seeds=None) -> torch.Tensor:
    """Render a camera fly-through: settings_track is a CameraSettings with a
    leading frame axis (stack_camera_track builds one), each frame a full
    config.spp render, frame f with key fold_in(key, f) when a key
    is given, and with frame_seeds[f] when those are.  Returns (frames,
    height, width, 3)."""
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
        frames.append(render(scene, settings, config, key=_frame_key(key, f),
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
    _refuse_grad("adaptive_progressive_step", scene, camera, config)
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
    per-pixel count plane as `map`.  On the kernel backends also
    `bvh_nodes` and `face_tests`, host f64 sums of the BVH nodes the
    kernel's closest-hit and shadow walks visited and the faces they
    tested."""
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
    walks = None
    if config.backend == "cuda":
        walks = torch.zeros((2, config.height, config.width), dtype=torch.int32,
                            device=_cuda_device(config.backend))
    ray_map = _render(scene, _camera(camera, config), config, frame_seed=_seed(frame_seed),
                      spp=config.spp, adaptive=True, return_ray_count=True,
                      **({} if walks is None else {"walk_counts": walks}))[-1]
    result = {
        "rays_traced": float(np.sum(ray_map.cpu().numpy(), dtype=np.float64)),
        "primary_rays": config.width * config.height * config.spp,
        "width": config.width,
        "height": config.height,
        "spp": config.spp,
    }
    if walks is not None:
        w = walks.cpu().numpy().view(np.uint32)
        result["bvh_nodes"] = float(np.sum(w[0], dtype=np.float64))
        result["face_tests"] = float(np.sum(w[1], dtype=np.float64))
    if return_map:
        result["map"] = ray_map
    return result


def render_denoised(scene, camera: Camera | CameraSettings, config: RenderConfig, *,
                    key=None, frame_seed=None, iterations: int = 4,
                    sigma_color: float = 0.45,
                    sigma_normal: float = 64.0, sigma_depth: float = 2.0,
                    return_aovs: bool = False):
    """Render one frame and denoise it with the AOV-guided a-trous filter
    (the JAX package's render_denoised, api.py:707-776).

    Renders the beauty pass with `config` as it is, then the three
    first-hit guide planes (albedo, normal and depth AOVs, with the same
    sampler and spp so that guide edges match beauty edges), and runs
    ops/denoise.atrous_denoise with albedo demodulation.  With no input
    requiring grad the guides come from one closest hit per sample
    (render_guides on 'cuda' and 'wavefront': one launch of
    render_aov_kernel; render_guides_reference on the plain backends),
    each plane equal bit for bit to its own render() pass; otherwise, and
    on the WGSL and threefry streams (whose guides are their own rays, as
    in the JAX package), from three render() calls, so that each goes
    through KernelFrame's replay.
    Returns the denoised (H, W, 3) image, or (denoised, beauty, {"albedo",
    "normal", "depth"}) with return_aovs.  Differentiable end to end: the
    filter is plain arithmetic."""
    if config.integrator != "path":
        raise ValueError(
            "render_denoised denoises the path integrator's beauty pass; "
            f"got integrator={config.integrator!r}"
        )
    camera = _camera(camera, config)
    beauty = render(scene, camera, config, key=key, frame_seed=frame_seed)
    # Every path-only knob the AOV integrators reject or ignore dropped.
    guide_cfg = dataclasses.replace(config, integrator="albedo", nee=False, mis=False,
                                    clamp=0.0, adaptive_tol=0.0, regenerate="off")
    if config.rng != "hash" or needs_grad(as_scene(scene), camera):
        aovs = {m: render(scene, camera, dataclasses.replace(guide_cfg, integrator=m),
                          key=key, frame_seed=frame_seed)
                for m in ("albedo", "normal", "depth")}
    else:
        aovs = _guides(scene, camera, guide_cfg, _resolve_rng(config, key, frame_seed)[1])
    out = denoise_ops.atrous_denoise(
        beauty, albedo=aovs["albedo"], normal=denoise_ops.decode_normal_aov(aovs["normal"]),
        depth=aovs["depth"][..., 0], iterations=iterations, sigma_color=sigma_color,
        sigma_normal=sigma_normal, sigma_depth=sigma_depth,
    )
    if return_aovs:
        return out, beauty, aovs
    return out


def _guides(scene, camera: Camera, config: RenderConfig, frame_seed: int) -> dict:
    """The three guide planes of render_denoised from one closest hit per
    sample, through the config's backend (render()'s stream and keywords)."""
    sc = as_scene(scene)
    kwargs = dict(width=config.width, height=config.height, frame_seed=frame_seed,
                  t_min=config.t_min, t_max=config.t_max, spp=config.spp,
                  sampler_spec=config.sampler_spec)
    if config.backend in ("cuda", "wavefront"):
        device = _cuda_device(config.backend)
        return render_guides(sc.to(device), camera.to(device), **kwargs)
    return render_guides_reference(sc, camera.to(sc.device), **kwargs)
