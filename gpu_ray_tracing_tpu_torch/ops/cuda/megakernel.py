"""Host side of the CUDA megakernel (port of gpu_ray_tracing_tpu/ops/pallas/megakernel.py).

`render_cuda` launches ops/cuda/megakernel.cu for the K1a-K1f slices of
the Pallas `_kernel`: spheres by the brute scan or through a sphere BVH,
triangle meshes behind a BVH (flat or smooth), next-event estimation toward
sphere and triangle lights with MIS, the independent, stratified and Sobol
samplers, the fixed spp loop (warps that regenerate paths; one thread per
pixel over a staged sphere table for the AOV modes, and `render_guides`,
the denoiser's three AOV planes in one launch), Russian roulette and the
clamp, and the adaptive spp loop (a cluster of blocks per tile, warps that
regenerate paths) with its resume state, the spp map and the ray counters.
`render_reference` is its plain PyTorch version with the same signature
(`render_guides_reference` is render_guides'), composed of ops/rays,
ops/intersect, ops/materials and ops/integrators; the tests and the
'torch' backend run it, and chip_smoke.py holds the kernel against it on
the card.  The plain version scans every sphere whether or not the scene
has a sphere BVH, as the JAX package's 'jax' backend does.  Above 4
lights it picks the light as the kernel does, once per (sample, bounce)
(`light_pick='sample'`), unless told to pick per lane as the 'jax' engine
does.

`render_cuda` takes CUDA tensors only and never falls back: no device, a
failed build or a failed launch raises.  The only torch operations around
its launch pack the (16, N) scene, (1, 24) camera, (F, 32) mesh table,
BVH, (8, L) light and (16, T) triangle-light plane layouts, as
render_pallas's XLA code does, and allocate the outputs and the adaptive
state planes.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera
from gpu_ray_tracing_tpu_torch.models.mesh import TriangleMesh
from gpu_ray_tracing_tpu_torch.models.scene import (
    Lights,
    Scene,
    TriLights,
    as_scene,
    sphere_light_ids,
)
from gpu_ray_tracing_tpu_torch.models.spheres import Spheres
from gpu_ray_tracing_tpu_torch.ops import integrators
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.bvh import BVH
from gpu_ray_tracing_tpu_torch.ops.cuda import build
from gpu_ray_tracing_tpu_torch.ops.rays import (
    generate_rays_for_ids,
    generate_rays_wgsl,
    hash_pixel_ids,
)
from gpu_ray_tracing_tpu_torch.ops.rounding import fma

#: Kernel launches per wrapper and route ("megakernel:brute",
#: "megakernel:sphere_bvh", "megakernel:mesh_bvh", "hash_probe",
#: "sampler_probe"): each wrapper adds one where it launches, keyed by the
#: geometry the launch was given (a mesh, else a sphere BVH, else the brute
#: scan), suffixed "+nee" when the launch ran next-event estimation,
#: "+stratified" or "+sobol" when it ran that sampler, "+adaptive" when it
#: ran the adaptive loop, "+guides" for render_guides' launch and "+rays"
#: when it counted rays (e.g. "megakernel:mesh_bvh+nee",
#: "megakernel:brute+adaptive", "megakernel:brute+guides"), so a run can
#: show which paths it used.
LAUNCHES: collections.Counter = collections.Counter()

# Rows of the (16, N) scene planes (the Pallas layout, megakernel.py:84).
_CX, _CY, _CZ, _RAD, _C2R2, _ALR, _ALG, _ALB, _KIND, _PARAM, _ACTIVE = range(11)
_LIGHTID = 11
_SCENE_ROWS = 16

MODES = {"path": 0, "normal": 1, "albedo": 2, "depth": 3}
# render_guides: the albedo, normal and depth planes of one closest hit per
# sample, in one launch (the kernel's mode GUIDES).
GUIDES = integrators.GUIDES
_GUIDES = "guides"
_GUIDES_MODE = 4
SAMPLERS = {None: 0, "stratified": 1, "sobol": 2}

# Mesh table: one row of 32 f32 slots per face (the Pallas table's
# per-triangle group, megakernel.py:153-159, without its 4-per-row VMEM
# layout): v0 0-2, e1 3-5, e2 6-8, corner normals 9-17 (the face normal
# three times when flat), albedo 18-20, kind 21, param 22, light id 23.
_TRI_SLOTS = 32

# The adaptive stopping test's tile (megakernel.py:105-114): TILE_ROWS x
# 128 pixels of the local frame for the path integrator, AOV_TILE_ROWS for
# the bounce-free modes.  The tile belongs to the semantics: the spp map is
# constant within it.
TILE_ROWS = 32
AOV_TILE_ROWS = 64
TILE_COLS = 128

# Pixels x spheres elements per chunk of the plain version's (P, N) planes.
_CPU_BLOCK = 1 << 22
_CUDA_BLOCK = 1 << 27


def scene_planes(spheres: Spheres) -> torch.Tensor:
    """Pack a Spheres SoA into the (16, N) f32 scene layout of the Pallas
    kernel: centers, radius, |c|^2 - r^2, albedo, kind, param, active flag,
    light id (the ordinal of an active emissive sphere, else -1)."""
    c = spheres.centers.to(torch.float32)
    r = spheres.radii.to(torch.float32)
    n = spheres.count
    planes = torch.zeros((_SCENE_ROWS, n), dtype=torch.float32, device=c.device)
    planes[_CX] = c[:, 0]
    planes[_CY] = c[:, 1]
    planes[_CZ] = c[:, 2]
    planes[_RAD] = r
    planes[_C2R2] = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - r * r
    planes[_ALR] = spheres.albedo[:, 0]
    planes[_ALG] = spheres.albedo[:, 1]
    planes[_ALB] = spheres.albedo[:, 2]
    planes[_KIND] = spheres.mat_kind.to(torch.float32)
    planes[_PARAM] = spheres.mat_param
    planes[_ACTIVE] = (r > 0.0).to(torch.float32)
    planes[_LIGHTID] = sphere_light_ids(spheres).to(torch.float32)
    return planes


def mesh_table(mesh: TriangleMesh, tri_light_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Pack a TriangleMesh into the (F, 32) f32 table the kernel reads.  The
    light-id slot (23) holds `tri_light_ids` ((F,), the global NEE light
    ordinal per face, -1 for non-lights), or -1 everywhere without it."""
    f = mesh.num_triangles
    dev = mesh.device
    n0, n1, n2 = (mesh.n0, mesh.n1, mesh.n2) if mesh.smooth else (mesh.normals,) * 3
    if tri_light_ids is None:
        lid = torch.full((f, 1), -1.0, dtype=torch.float32, device=dev)
    else:
        lid = tri_light_ids.to(torch.float32).reshape(f, 1)
    return torch.cat([
        mesh.v0, mesh.e1, mesh.e2, n0, n1, n2, mesh.albedo,
        mesh.mat_kind.to(torch.float32)[:, None], mesh.mat_param[:, None], lid,
        torch.zeros((f, _TRI_SLOTS - 24), dtype=torch.float32, device=dev),
    ], dim=1).contiguous()


def lights_planes(lights: Lights) -> torch.Tensor:
    """Pack a Lights list into the (8, L) f32 layout: rows cx, cy, cz,
    radius, emission r/g/b, 0."""
    planes = torch.zeros((8, lights.count), dtype=torch.float32, device=lights.centers.device)
    planes[0:3] = lights.centers.T
    planes[3] = lights.radii
    planes[4:7] = lights.emission.T
    return planes


def tri_lights_planes(tri_lights: TriLights) -> torch.Tensor:
    """Pack a TriLights list into the (16, T) f32 layout: rows v0 0-2,
    e1 3-5, e2 6-8, unit normal 9-11, area 12, emission 13-15."""
    tl = tri_lights
    return torch.cat([tl.v0.T, tl.e1.T, tl.e2.T, tl.normal.T, tl.area[None],
                      tl.emission.T]).to(torch.float32).contiguous()


def bvh_planes(bvh: BVH) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a threaded BVH into ((8, M) f32 bounds, (4, M) i32 links): rows
    bmin x/y/z, bmax x/y/z, 0, 0 and miss link, leaf start, leaf count, 0."""
    m, dev = bvh.num_nodes, bvh.device
    f = torch.zeros((8, m), dtype=torch.float32, device=dev)
    f[0:3] = bvh.bbox_min.T
    f[3:6] = bvh.bbox_max.T
    i = torch.zeros((4, m), dtype=torch.int32, device=dev)
    i[0] = bvh.miss_link
    i[1] = bvh.leaf_start
    i[2] = bvh.leaf_count
    return f, i


def camera_vector(camera: Camera) -> torch.Tensor:
    """Pack a derived Camera into the (1, 24) layout: center 0-2, upper
    left 3-5, pixel deltas 6-8 and 9-11, defocus disk 12-14 and 15-17,
    defocus angle 18, zeros."""
    parts = [
        camera.center, camera.viewport_upper_left, camera.pixel_delta_u,
        camera.pixel_delta_v, camera.defocus_disk_u, camera.defocus_disk_v,
    ]
    dev = camera.center.device
    return torch.cat(
        [p.to(torch.float32).reshape(3) for p in parts]
        + [camera.defocus_angle.to(torch.float32).reshape(1),
           torch.zeros(5, dtype=torch.float32, device=dev)]
    ).reshape(1, 24)


def _check_args(width, height, spp, max_depth, mode, nee, mis, sampler_spec):
    if mis and not nee:
        raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
    if sampler_spec is not None and sampler_spec[0] not in SAMPLERS:
        raise ValueError(f"unknown sampler spec {sampler_spec!r}")
    if width <= 0 or height <= 0:
        raise ValueError(f"invalid resolution {width}x{height}")
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")


@dataclasses.dataclass(frozen=True)
class _AdaptivePlan:
    """What a render call's adaptive options ask of the spp loop: `state`
    is the (6, H, W) f32 resume state (zeros for a one-shot render), or
    None for the fixed loop."""

    state: torch.Tensor | None
    resume: bool
    tile_rows: int
    min_spp: int
    chunk: int
    tol: float


def _adaptive_plan(width, height, spp, mode, dev, adaptive_tol, adaptive_min_spp,
                   return_spp_map, return_ray_count, adaptive_state,
                   adaptive_chunk) -> _AdaptivePlan:
    """Validate the adaptive options as render_pallas does
    (megakernel.py:2006-2025) and plan the loop.  A one-shot adaptive
    render (adaptive_tol > 0, spp > 1) is the resume loop from zero planes
    with chunk = spp; at spp = 1 the fixed loop takes the one sample."""
    tile_rows = TILE_ROWS if mode == "path" else AOV_TILE_ROWS
    min_spp = min(max(2, adaptive_min_spp), spp)
    if adaptive_state is not None:
        if adaptive_tol <= 0.0 or mode != "path" or adaptive_chunk <= 0:
            raise ValueError(
                "adaptive_state requires adaptive_tol > 0, mode='path' and "
                "adaptive_chunk > 0"
            )
        if return_spp_map or return_ray_count:
            raise ValueError(
                "adaptive_state already returns the per-pixel count plane; "
                "return_spp_map/return_ray_count do not compose with it"
            )
        if len(adaptive_state) != 6:
            raise ValueError(
                f"adaptive_state must be a 6-tuple, got {len(adaptive_state)}"
            )
        for st in adaptive_state:
            if tuple(st.shape) != (height, width):
                raise ValueError(f"adaptive_state planes must be ({height}, {width}), "
                                 f"got {tuple(st.shape)}")
        state = torch.stack([st.to(device=dev, dtype=torch.float32)
                             for st in adaptive_state]).contiguous()
        return _AdaptivePlan(state, True, tile_rows, min_spp, adaptive_chunk,
                             float(adaptive_tol))
    if adaptive_tol > 0.0 and spp > 1:
        state = torch.zeros((6, height, width), dtype=torch.float32, device=dev)
        return _AdaptivePlan(state, False, tile_rows, min_spp, spp, float(adaptive_tol))
    return _AdaptivePlan(None, False, tile_rows, min_spp, 0, 0.0)


def _outputs(img, plan: _AdaptivePlan, spp: int, return_spp_map: bool, rays):
    """render_pallas's return shapes: the 6 updated state planes on resume;
    else the image, then the spp map and the ray-count plane if asked."""
    if plan.resume:
        return tuple(plan.state.unbind(0))
    extras = []
    if return_spp_map:
        extras.append(plan.state[3] if plan.state is not None
                      else torch.full(img.shape[:2], float(spp), dtype=torch.float32,
                                      device=img.device))
    if rays is not None:
        extras.append(rays)
    return (img, *extras) if extras else img


def _sampler_args(spec: tuple | None) -> tuple[int, int, int, int]:
    """The kernel's (kind, kx, ky, nbits) of a sampler spec."""
    kind = SAMPLERS[None if spec is None else spec[0]]
    kx, ky = spec[1:] if kind == SAMPLERS["stratified"] else (1, 1)
    nbits = spec[1] if kind == SAMPLERS["sobol"] else 0
    return kind, kx, ky, nbits


def _trace_block(num_pixels: int, sc: Scene) -> int:
    """Pixels per chunk of the plain version, so that its (P, N) sphere
    planes (and (P, F) triangle planes for a mesh without a BVH) stay
    within a budget."""
    budget = _CUDA_BLOCK if sc.device.type == "cuda" else _CPU_BLOCK
    width = sc.spheres.count
    if sc.mesh is not None and sc.bvh is None:
        width += sc.mesh.num_triangles
    return max(1, min(num_pixels, budget // width))


_THIRD = torch.tensor(1.0 / 3.0, dtype=torch.float32)


def _adaptive_loop_reference(sample, width: int, height: int, plan: _AdaptivePlan,
                             spp: int, rays: torch.Tensor | None) -> None:
    """The kernel's adaptive spp loop in plain PyTorch, updating plan.state
    in place: per-pixel Welford planes, per-tile sums over the in-frame
    pixels of each (tile_rows x 128) tile of the local frame, one "wants
    more" per tile broadcast to its pixels, and samples added only where
    the tile still wants more.  `sample(idx, k)` traces sample k of the
    local pixels idx and returns (rgb, rays or None)."""
    st = plan.state.reshape(6, -1)
    dev = st.device
    ty = torch.arange(height, device=dev) // plan.tile_rows
    tx = torch.arange(width, device=dev) // TILE_COLS
    n_tx = -(-width // TILE_COLS)
    n_tiles = -(-height // plan.tile_rows) * n_tx
    tile = (ty[:, None] * n_tx + tx[None, :]).reshape(-1)
    n_valid = torch.bincount(tile, minlength=n_tiles).to(torch.float32).clamp(min=1.0)
    # The tile's count, read at its first pixel (tile-constant).
    first = torch.full((n_tiles,), -1, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, tile, torch.arange(tile.numel(), device=dev),
                                 reduce="amin", include_self=False)
    k0 = st[3][first].to(torch.int64)
    k = k0.clone()
    while True:
        mean_m2 = torch.zeros(n_tiles, device=dev).index_add_(0, tile, st[5]) / n_valid
        mean_ml = torch.zeros(n_tiles, device=dev).index_add_(0, tile, st[4]) / n_valid
        kf = k.to(torch.float32)
        stderr2 = mean_m2 / torch.clamp(kf - 1.0, min=1.0) / kf
        scale = fma(mean_ml, torch.tensor(plan.tol, dtype=torch.float32),
                    torch.tensor(1e-4, dtype=torch.float32))
        want = (k < plan.min_spp) | ((k < spp) & (stderr2 > scale * scale))
        want = want & (k < k0 + plan.chunk)
        if not bool(want.any()):
            break
        for kv in torch.unique(k[want]).tolist():
            idx = torch.nonzero((want & (k == kv))[tile]).squeeze(1)
            rgb, r = sample(idx, kv)
            lum = (rgb[:, 0] + rgb[:, 1] + rgb[:, 2]) * _THIRD
            ml, m2 = st[4][idx], st[5][idx]
            d = lum - ml
            ml = ml + d / torch.tensor(float(kv + 1), dtype=torch.float32)
            st[4][idx] = ml
            # As XLA:CPU rounds it in the reference: one fused multiply-add.
            st[5][idx] = fma(d, lum - ml, m2)
            st[0:3, idx] += rgb.T
            if r is not None:
                rays[idx] += r
        k = k + want.to(torch.int64)
    st[3] = k[tile].to(torch.float32)


def trace_pixels(sc: Scene, camera: Camera, ids: torch.Tensor, sample: int, frame_seed: int,
                 *, width: int, max_depth: int, t_min: float, t_max: float, mode: str,
                 russian_roulette_depth: int, sky_intensity: float, clamp: float, nee: bool,
                 mis: bool, sampler_spec: tuple | None, light_pick: str,
                 count_rays: bool = False, wgsl_rays: tuple | None = None,
                 parity: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Hash-stream sample `sample` (u32) of the global pixel ids `ids` (1-D)
    of a `width`-wide frame, traced by the plain integrator of `mode`:
    ((n, 3) rgb after the clamp, (n,) rays traced or None), or ((3, n, 3)
    albedo, normal and depth, rays) in render_guides_reference's mode.
    Each pixel is independent of the others, so any partition of the ids
    gives the same values; render_reference traces blocks of them, and the
    autograd replay (ops/autograd.py) blocks of its own.  `wgsl_rays` =
    (origins, dirs, bounce_seeds), the WGSL stream's rays of these pixels
    and its frame-uniform bounce seeds, takes the place of the hash
    stream's rays and seeds; `parity` keeps that stream's sky leak."""
    if wgsl_rays is None:
        o, d, seeds = generate_rays_for_ids(camera, ids, sample, frame_seed,
                                            total_width=width, sampler_spec=sampler_spec)
        stream = dict(pixel_seeds=seeds)
    else:
        o, d, bounce_seeds = wgsl_rays
        stream = dict(bounce_seeds=bounce_seeds, parity=parity)
    aov = {"normal": integrators.shade_normals, "albedo": integrators.shade_albedo,
           "depth": integrators.shade_depth, _GUIDES: integrators.shade_guides}.get(mode)
    if aov is not None:
        rays = torch.ones(ids.numel(), dtype=torch.float32, device=ids.device)
        return aov(o, d, sc, t_min, t_max), rays if count_rays else None
    out = integrators.trace_path(
        o, d, sc, max_depth, t_min, t_max, **stream,
        russian_roulette_depth=russian_roulette_depth, sky_intensity=sky_intensity,
        nee=nee, mis=mis, pixel_ids=ids, sample_index=sample,
        frame_seed_u32=int(frame_seed) & 0xFFFFFFFF, sampler_spec=sampler_spec,
        light_pick=light_pick, count_rays=count_rays,
    )
    img, rays = out if count_rays else (out, None)
    return (integrators.clamp_radiance(img, clamp) if clamp > 0.0 else img), rays


def render_reference(
    scene_or_spheres,
    camera: Camera,
    *,
    width: int,
    height: int,
    sample_index: int = 0,
    frame_seed: int = 0,
    max_depth: int,
    t_min: float,
    t_max: float = 3.4e35,
    mode: str = "path",
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    y_offset: int = 0,
    spp: int = 1,
    row_stride: int = 1,
    clamp: float = 0.0,
    nee: bool = False,
    mis: bool = False,
    sampler_spec: tuple | None = None,
    adaptive_tol: float = 0.0,
    adaptive_min_spp: int = 8,
    return_spp_map: bool = False,
    return_ray_count: bool = False,
    adaptive_state: tuple | None = None,
    adaptive_chunk: int = 0,
    light_pick: str = "sample",
    rng: str = "hash",
    parity: bool = False,
):
    """The plain PyTorch version of render_cuda: the mean of spp hash-stream
    samples as a (height, width, 3) f32 image, on the scene's device, with
    render_cuda's adaptive options and return shapes.  Sample s uses stream
    index sample_index + s.  `light_pick` ('sample', the kernel's, or
    'lane', the 'jax' engine's) chooses the > 4-light pick
    (ops/integrators.trace_path).

    rng='wgsl' draws the reference shader's stream instead, which no kernel
    draws (the JAX package's _render_one_sample, api.py:263-273): sample s
    seeds generate_rays_wgsl with 1 + sample_index + s + frame_seed and its
    bounces (make_bounce_seeds) with that + 1; `parity` keeps its sampler
    quirks.  That stream is drawn a whole frame at a time, so it takes no
    sampler, adaptive option, ray count, y_offset or row_stride."""
    _check_args(width, height, spp, max_depth, mode, nee, mis, sampler_spec)
    if rng not in ("hash", "wgsl"):
        raise ValueError(f"rng must be 'hash' or 'wgsl', got {rng!r}")
    if rng == "wgsl" and (sampler_spec is not None or adaptive_tol > 0.0
                          or adaptive_state is not None or return_ray_count
                          or y_offset != 0 or row_stride != 1):
        raise ValueError(
            "rng='wgsl' takes no sampler_spec, adaptive options, ray count, "
            "y_offset or row_stride"
        )
    if parity and rng != "wgsl":
        raise ValueError("parity=True requires rng='wgsl'")
    sc = as_scene(scene_or_spheres)
    sc.nee_light_counts(nee)
    dev = sc.spheres.device
    plan = _adaptive_plan(width, height, spp, mode, dev, adaptive_tol, adaptive_min_spp,
                          return_spp_map, return_ray_count, adaptive_state,
                          adaptive_chunk)
    camera = camera.to(dev)
    p = width * height
    block = _trace_block(p, sc)
    pid = hash_pixel_ids(width, height, y_offset=y_offset, total_width=width,
                         row_stride=row_stride, device=dev).reshape(p)
    kw = dict(width=width, max_depth=max_depth, t_min=t_min, t_max=t_max, mode=mode,
              russian_roulette_depth=russian_roulette_depth, sky_intensity=sky_intensity,
              clamp=clamp, nee=nee, mis=mis, sampler_spec=sampler_spec,
              light_pick=light_pick, count_rays=return_ray_count)

    def sample(idx, s: int):
        """Sample s of the local pixels idx (all when None): (rgb, rays)."""
        s_u32 = (int(sample_index) + s) & 0xFFFFFFFF
        ids = pid if idx is None else pid[idx]
        n = ids.numel()
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        rays = torch.empty(n, dtype=torch.float32, device=dev) if return_ray_count else None
        if rng == "wgsl":  # the whole frame: idx is None without the adaptive loop
            seed = (1 + s_u32 + int(frame_seed)) & 0xFFFFFFFF
            o, d = generate_rays_wgsl(camera, width, height, seed, frame_seed, parity)
            o, d = o.reshape(p, 3), d.reshape(p, 3)
            bounce_seeds = integrators.make_bounce_seeds(seed + 1, max_depth).to(dev)
        for start in range(0, n, block):
            sl = slice(start, start + block)
            wgsl_rays = None if rng == "hash" else (o[sl], d[sl], bounce_seeds)
            rgb[sl], r = trace_pixels(sc, camera, ids[sl], s_u32, frame_seed,
                                      wgsl_rays=wgsl_rays, parity=parity, **kw)
            if r is not None:
                rays[sl] = r
        return rgb, rays

    rays = torch.zeros(p, dtype=torch.float32, device=dev) if return_ray_count else None
    if plan.state is not None:
        _adaptive_loop_reference(sample, width, height, plan, spp, rays)
        st = plan.state.reshape(6, p)
        img = (st[0:3] / st[3]).T
    else:
        acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            rgb, r = sample(None, s)
            acc += rgb
            if r is not None:
                rays += r
        img = acc / float(spp)
    rays = None if rays is None else rays.reshape(height, width)
    return _outputs(img.reshape(height, width, 3), plan, spp, return_spp_map, rays)


def dataclass_tensors(obj) -> list[torch.Tensor]:
    """Every tensor of a scene or camera dataclass, depth first."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += dataclass_tensors(v)
    return out


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """A scene as the kernels read it: `args`, the scene, light and sampler
    arguments every render entry point of the library takes, in C order
    (pointers into `tensors`, which this object keeps alive), and `route`,
    the launch-count key of the geometry and options ("brute",
    "sphere_bvh" or "mesh_bvh", suffixed "+nee" and "+<sampler>")."""

    args: tuple
    tensors: tuple
    route: str


def pack_scene(sc: Scene, nee: bool, mis: bool, sampler_spec: tuple | None) -> PackedScene:
    """Pack a Scene on a CUDA device into the kernels' plane layouts, as
    render_pallas's XLA code does around its launch."""
    if sc.mesh is not None and sc.bvh is None:
        raise ValueError("the CUDA kernels render a mesh through its BVH; "
                         "build the scene with make_scene(use_bvh=True)")
    n_sl, n_tl = sc.nee_light_counts(nee)
    planes = scene_planes(sc.spheres).contiguous()
    sbvh = bvh_planes(sc.sphere_bvh) if sc.sphere_bvh is not None else (None, None)
    if sc.mesh is not None:
        table = mesh_table(sc.mesh, sc.global_tri_light_ids() if nee else None)
        mbvh = bvh_planes(sc.bvh)
        n_tris, smooth = sc.mesh.num_triangles, int(sc.mesh.smooth)
    else:
        table, mbvh, n_tris, smooth = None, (None, None), 0, 0
    lplanes = lights_planes(sc.lights).contiguous() if n_sl else None
    tplanes = tri_lights_planes(sc.tri_lights) if n_tl else None
    kind, kx, ky, nbits = _sampler_args(sampler_spec)
    ptr = lambda t: None if t is None else t.data_ptr()
    nodes = lambda planes: 0 if planes[0] is None else planes[0].shape[1]
    args = (
        planes.data_ptr(), sc.spheres.count,
        ptr(sbvh[0]), ptr(sbvh[1]), nodes(sbvh),
        ptr(table), n_tris, smooth, ptr(mbvh[0]), ptr(mbvh[1]), nodes(mbvh),
        ptr(lplanes), n_sl, ptr(tplanes), n_tl, int(nee), int(mis and nee),
        kind, kx, ky, nbits,
    )
    route = "mesh_bvh" if n_tris else "sphere_bvh" if nodes(sbvh) else "brute"
    route += ("+nee" if nee else "") + ("" if kind == 0 else "+" + sampler_spec[0])
    return PackedScene(args, (planes, *sbvh, table, *mbvh, lplanes, tplanes), route)


def _require_cuda(*tensors: torch.Tensor) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA megakernel needs an NVIDIA GPU; none is visible")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"the CUDA megakernel takes tensors on one CUDA device; got "
                f"{t.device} (move the scene and camera with .to(device))"
            )
        if t.requires_grad:
            raise RuntimeError(
                "the CUDA kernels take no tensor that requires grad: "
                "differentiate through render(), whose backward replays the "
                "plain integrator (ops/autograd.py)"
            )
    return dev


def render_cuda(
    scene_or_spheres,
    camera: Camera,
    *,
    width: int,
    height: int,
    sample_index: int = 0,
    frame_seed: int = 0,
    max_depth: int,
    t_min: float,
    t_max: float = 3.4e35,
    mode: str = "path",
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    y_offset: int = 0,
    spp: int = 1,
    row_stride: int = 1,
    clamp: float = 0.0,
    nee: bool = False,
    mis: bool = False,
    sampler_spec: tuple | None = None,
    adaptive_tol: float = 0.0,
    adaptive_min_spp: int = 8,
    return_spp_map: bool = False,
    return_ray_count: bool = False,
    adaptive_state: tuple | None = None,
    adaptive_chunk: int = 0,
):
    """Render spp samples in one launch of the CUDA megakernel; returns the
    (height, width, 3) f32 mean on the scene's CUDA device.  Same signature
    and stream as render_reference (whose default light_pick='sample' is
    the kernel's > 4-light pick).  A scene with a sphere BVH walks it; a
    mesh must have its BVH (make_scene builds one).

    The options of render_pallas: `adaptive_tol > 0` makes spp a per-tile
    budget (the adaptive kernel, a cluster of blocks per tile); `return_spp_map` and
    `return_ray_count` append the (height, width) samples-taken and
    rays-traced planes; `adaptive_state` (six (height, width) planes: rgb
    sums, count, Welford mean and M2) resumes the adaptive loop for at most
    `adaptive_chunk` more samples per tile and returns the updated six."""
    _check_args(width, height, spp, max_depth, mode, nee, mis, sampler_spec)
    sc = as_scene(scene_or_spheres)
    dev = _require_cuda(*dataclass_tensors(sc), *dataclass_tensors(camera))
    plan = _adaptive_plan(width, height, spp, mode, dev, adaptive_tol, adaptive_min_spp,
                          return_spp_map, return_ray_count, adaptive_state,
                          adaptive_chunk)
    packed = pack_scene(sc, nee, mis, sampler_spec)
    out = (None if plan.resume
           else torch.empty((height, width, 3), dtype=torch.float32, device=dev))
    rays = (torch.zeros((height, width), dtype=torch.float32, device=dev)
            if return_ray_count else None)
    # The path kernel's pixel-group cursor, zero at launch.
    cursor = (torch.zeros(1, dtype=torch.int32, device=dev)
              if plan.state is None and mode == "path" else None)
    _launch(packed, camera, dev, MODES[mode], out, rays, plan, cursor, width=width,
            height=height, sample_index=sample_index, frame_seed=frame_seed,
            y_offset=y_offset, row_stride=row_stride, max_depth=max_depth, t_min=t_min,
            t_max=t_max, russian_roulette_depth=russian_roulette_depth,
            sky_intensity=sky_intensity, clamp=clamp, spp=spp)
    route = packed.route + ("+adaptive" if plan.state is not None else "")
    LAUNCHES["megakernel:" + route + ("+rays" if rays is not None else "")] += 1
    return _outputs(out, plan, spp, return_spp_map, rays)


def _launch(packed: PackedScene, camera: Camera, dev: torch.device, mode: int, out, rays,
            plan: _AdaptivePlan, cursor, *, width: int, height: int, sample_index: int,
            frame_seed: int, y_offset: int, row_stride: int, max_depth: int, t_min: float,
            t_max: float, russian_roulette_depth: int, sky_intensity: float, clamp: float,
            spp: int) -> None:
    """One grt_render launch on dev's current stream; raises if refused."""
    lib = build.load()
    cam = camera_vector(camera).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_render(
            cam.data_ptr(), *packed.args,
            width, height,
            int(sample_index) & 0xFFFFFFFF, int(frame_seed) & 0xFFFFFFFF,
            int(y_offset) & 0xFFFFFFFF, int(row_stride) & 0xFFFFFFFF,
            max_depth, float(t_min), float(t_max), mode,
            int(russian_roulette_depth), float(sky_intensity), float(clamp),
            spp, ptr(out), ptr(rays), ptr(plan.state),
            plan.tile_rows, plan.min_spp, plan.chunk, plan.tol, ptr(cursor), stream,
        )
    build.check(rc, "megakernel")


def render_guides(
    scene_or_spheres,
    camera: Camera,
    *,
    width: int,
    height: int,
    sample_index: int = 0,
    frame_seed: int = 0,
    t_min: float,
    t_max: float = 3.4e35,
    y_offset: int = 0,
    spp: int = 1,
    row_stride: int = 1,
    sampler_spec: tuple | None = None,
    return_ray_count: bool = False,
) -> dict[str, torch.Tensor]:
    """The denoiser's guide planes in one launch of render_aov_kernel:
    {"albedo", "normal", "depth"}, each (height, width, 3) f32 and equal
    bit for bit to render_cuda(mode=<that key>) with these keywords (at any
    max_depth), from one closest hit per sample; with return_ray_count also "rays", the
    (height, width) rays traced (one a sample, as each single mode counts).
    The fixed spp loop only: the adaptive loop would stop each plane's
    tiles at its own count.  CUDA tensors only: no fallback."""
    _check_args(width, height, spp, 1, "albedo", False, False, sampler_spec)
    sc = as_scene(scene_or_spheres)
    dev = _require_cuda(*dataclass_tensors(sc), *dataclass_tensors(camera))
    plan = _AdaptivePlan(None, False, AOV_TILE_ROWS, 1, 0, 0.0)
    packed = pack_scene(sc, False, False, sampler_spec)
    out = torch.empty((3, height, width, 3), dtype=torch.float32, device=dev)
    rays = (torch.zeros((height, width), dtype=torch.float32, device=dev)
            if return_ray_count else None)
    _launch(packed, camera, dev, _GUIDES_MODE, out, rays, plan, None, width=width,
            height=height, sample_index=sample_index, frame_seed=frame_seed,
            y_offset=y_offset, row_stride=row_stride, max_depth=1, t_min=t_min,
            t_max=t_max, russian_roulette_depth=0, sky_intensity=1.0, clamp=0.0, spp=spp)
    LAUNCHES["megakernel:" + packed.route + "+guides" + ("+rays" if rays is not None else "")] += 1
    return _guides_dict(out, rays)


def _guides_dict(planes: torch.Tensor, rays) -> dict[str, torch.Tensor]:
    out = dict(zip(GUIDES, planes.unbind(0)))
    if rays is not None:
        out["rays"] = rays
    return out


def render_guides_reference(
    scene_or_spheres,
    camera: Camera,
    *,
    width: int,
    height: int,
    sample_index: int = 0,
    frame_seed: int = 0,
    t_min: float,
    t_max: float = 3.4e35,
    y_offset: int = 0,
    spp: int = 1,
    row_stride: int = 1,
    sampler_spec: tuple | None = None,
    return_ray_count: bool = False,
) -> dict[str, torch.Tensor]:
    """The plain PyTorch version of render_guides, on the scene's device:
    per sample one integrators.intersect_scene and the three shade_*
    planes of it (integrators.shade_guides), summed in sample order and
    divided by spp, so each plane equals render_reference(mode=<key>) bit
    for bit.  Same keywords and return as render_guides."""
    _check_args(width, height, spp, 1, "albedo", False, False, sampler_spec)
    sc = as_scene(scene_or_spheres)
    dev = sc.spheres.device
    camera = camera.to(dev)
    p = width * height
    block = _trace_block(p, sc)
    pid = hash_pixel_ids(width, height, y_offset=y_offset, total_width=width,
                         row_stride=row_stride, device=dev).reshape(p)
    kw = dict(width=width, max_depth=1, t_min=t_min, t_max=t_max, mode=_GUIDES,
              russian_roulette_depth=0, sky_intensity=1.0, clamp=0.0, nee=False, mis=False,
              sampler_spec=sampler_spec, light_pick="sample", count_rays=return_ray_count)
    acc = torch.zeros((3, p, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros(p, dtype=torch.float32, device=dev) if return_ray_count else None
    for s in range(spp):
        s_u32 = (int(sample_index) + s) & 0xFFFFFFFF
        planes = torch.empty((3, p, 3), dtype=torch.float32, device=dev)
        for start in range(0, p, block):
            sl = slice(start, start + block)
            planes[:, sl], r = trace_pixels(sc, camera, pid[sl], s_u32, frame_seed, **kw)
            if r is not None:
                rays[sl] += r
        acc += planes
    img = acc / float(spp)
    return _guides_dict(img.reshape(3, height, width, 3),
                        None if rays is None else rays.reshape(height, width))


def adaptive_cluster(blocks: int | None = None) -> int:
    """The adaptive kernel's thread block cluster: the blocks (SMs) that
    share a tile.  `blocks` 1-16 fixes it for later launches and 0 returns
    the choice to the launcher (the fewest blocks a tile, in powers of two,
    with which the frame's tiles fill the card's resident blocks); both are
    for measurement, since every choice renders the same bits.  Returns the size the last adaptive
    launch used (0 before the first)."""
    if blocks is not None and not 0 <= blocks <= 16:
        raise ValueError(f"a tile's cluster has 1-16 blocks (0: the launcher's), got {blocks}")
    return build.load().grt_adaptive_cluster(-1 if blocks is None else int(blocks))


def hash_probe_reference(values: torch.Tensor, salts, sample_index: int,
                         frame_seed: int) -> dict[str, torch.Tensor]:
    """Plain version of hash_probe: the same hashes from ops/rng.py, as
    int64 tensors holding u32 values (uniforms as f32)."""
    v = rng_ops.as_u32(values)
    return {
        "wgsl_hash": rng_ops.wgsl_hash(v),
        "hash_pixel_seeds": rng_ops.hash_pixel_seeds(v, sample_index, frame_seed),
        "hash2": torch.stack([rng_ops.hash2(v, k) for k in salts]),
        "uniform_hash": torch.stack([rng_ops.uniform_hash(v, k) for k in salts]),
    }


def hash_probe(values: torch.Tensor, salts, sample_index: int,
               frame_seed: int) -> dict[str, torch.Tensor]:
    """The kernel's own hashes of a 1-D int32 CUDA tensor of u32 bit
    patterns, at each salt: for a bit-exactness check against ops/rng.py.
    Returns the same keys as hash_probe_reference."""
    dev = _require_cuda(values)
    if values.dtype != torch.int32 or values.dim() != 1:
        raise ValueError("hash_probe takes a 1-D int32 tensor of u32 bit patterns")
    lib = build.load()
    values = values.contiguous()
    n = values.numel()
    salt_t = torch.from_numpy(
        np.asarray([int(k) & 0xFFFFFFFF for k in salts], np.uint32).view(np.int32)
    ).to(dev)
    out = {
        "wgsl_hash": torch.empty(n, dtype=torch.int32, device=dev),
        "hash_pixel_seeds": torch.empty(n, dtype=torch.int32, device=dev),
        "hash2": torch.empty((len(salts), n), dtype=torch.int32, device=dev),
        "uniform_hash": torch.empty((len(salts), n), dtype=torch.float32, device=dev),
    }
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_hash_probe(
            values.data_ptr(), n, salt_t.data_ptr(), len(salts),
            int(sample_index) & 0xFFFFFFFF, int(frame_seed) & 0xFFFFFFFF,
            out["wgsl_hash"].data_ptr(), out["hash_pixel_seeds"].data_ptr(),
            out["hash2"].data_ptr(), out["uniform_hash"].data_ptr(), stream,
        )
    build.check(rc, "hash_probe")
    LAUNCHES["hash_probe"] += 1
    return {k: (t if t.dtype == torch.float32 else rng_ops.as_u32(t))
            for k, t in out.items()}


def sampler_probe_reference(pixel_ids: torch.Tensor, samples: torch.Tensor,
                            frame_seed: int, spec: tuple, salts) -> dict[str, torch.Tensor]:
    """Plain version of sampler_probe, from ops/rng.py: each pair id's
    remap of the (salt 1, salt 2) draws of (pixel id, sample, frame seed)."""
    pid, s = rng_ops.as_u32(pixel_ids), rng_ops.as_u32(samples)
    seeds = rng_ops.hash_pixel_seeds(pid, s, frame_seed)
    u1, u2 = rng_ops.uniform_hash(seeds, 1), rng_ops.uniform_hash(seeds, 2)
    pairs = [rng_ops.sampler_uniforms(u1, u2, pid, s, frame_seed, spec, rot_salt=k)
             for k in salts]
    return {"u1": torch.stack([p[0] for p in pairs]), "u2": torch.stack([p[1] for p in pairs])}


def sampler_probe(pixel_ids: torch.Tensor, samples: torch.Tensor, frame_seed: int,
                  spec: tuple, salts) -> dict[str, torch.Tensor]:
    """The kernel's own sampler remaps (its device `sampler_uniforms`) of 1-D
    int32 CUDA tensors of u32 pixel ids and sample indices, at each pair id:
    for a bit-exactness check against ops/rng.py.  Returns the same keys as
    sampler_probe_reference."""
    dev = _require_cuda(pixel_ids, samples)
    for t in (pixel_ids, samples):
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != pixel_ids.numel():
            raise ValueError("sampler_probe takes two 1-D int32 tensors of one length")
    kind, kx, ky, nbits = _sampler_args(spec)
    if kind == 0:
        raise ValueError("sampler_probe needs a stratified or sobol spec")
    lib = build.load()
    pixel_ids, samples = pixel_ids.contiguous(), samples.contiguous()
    n = pixel_ids.numel()
    salt_t = torch.tensor([int(k) for k in salts], dtype=torch.int32, device=dev)
    out = {k: torch.empty((len(salts), n), dtype=torch.float32, device=dev)
           for k in ("u1", "u2")}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_sampler_probe(
            pixel_ids.data_ptr(), samples.data_ptr(), n, salt_t.data_ptr(), len(salts),
            int(frame_seed) & 0xFFFFFFFF, kind, kx, ky, nbits,
            out["u1"].data_ptr(), out["u2"].data_ptr(), stream,
        )
    build.check(rc, "sampler_probe")
    LAUNCHES["sampler_probe"] += 1
    return out
