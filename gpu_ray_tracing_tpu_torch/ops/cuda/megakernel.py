"""Host side of the CUDA megakernel (port of gpu_ray_tracing_tpu/ops/pallas/megakernel.py).

`render_cuda` launches ops/cuda/megakernel.cu, one thread per pixel, for
the K1a-K1e slices of the Pallas `_kernel`: spheres by the brute scan or
through a sphere BVH, triangle meshes behind a BVH (flat or smooth),
next-event estimation toward sphere and triangle lights with MIS, the
independent, stratified and Sobol samplers, the fixed spp loop, the AOV
modes, Russian roulette and the clamp.  `render_reference` is its plain
PyTorch version with the same signature, composed of ops/rays,
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
render_pallas's XLA code does.
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
from gpu_ray_tracing_tpu_torch.ops.rays import generate_rays_hash, hash_pixel_ids

#: Kernel launches per wrapper and route ("megakernel:brute",
#: "megakernel:sphere_bvh", "megakernel:mesh_bvh", "hash_probe",
#: "sampler_probe"): each wrapper adds one where it launches, keyed by the
#: geometry the launch was given (a mesh, else a sphere BVH, else the brute
#: scan), suffixed "+nee" when the launch ran next-event estimation and
#: "+stratified" or "+sobol" when it ran that sampler (e.g.
#: "megakernel:mesh_bvh+nee", "megakernel:brute+sobol"), so a run can show
#: which paths it used.
LAUNCHES: collections.Counter = collections.Counter()

# Rows of the (16, N) scene planes (the Pallas layout, megakernel.py:84).
_CX, _CY, _CZ, _RAD, _C2R2, _ALR, _ALG, _ALB, _KIND, _PARAM, _ACTIVE = range(11)
_LIGHTID = 11
_SCENE_ROWS = 16

MODES = {"path": 0, "normal": 1, "albedo": 2, "depth": 3}
SAMPLERS = {None: 0, "stratified": 1, "sobol": 2}

# Mesh table: one row of 32 f32 slots per face (the Pallas table's
# per-triangle group, megakernel.py:153-159, without its 4-per-row VMEM
# layout): v0 0-2, e1 3-5, e2 6-8, corner normals 9-17 (the face normal
# three times when flat), albedo 18-20, kind 21, param 22, light id 23.
_TRI_SLOTS = 32

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
    light_pick: str = "sample",
) -> torch.Tensor:
    """The plain PyTorch version of render_cuda: the mean of spp hash-stream
    samples as a (height, width, 3) f32 image, on the scene's device.
    Sample s uses stream index sample_index + s.  `light_pick` ('sample',
    the kernel's, or 'lane', the 'jax' engine's) chooses the > 4-light
    pick (ops/integrators.trace_path)."""
    _check_args(width, height, spp, max_depth, mode, nee, mis, sampler_spec)
    sc = as_scene(scene_or_spheres)
    sc.nee_light_counts(nee)
    dev = sc.spheres.device
    camera = camera.to(dev)
    p = width * height
    block = _trace_block(p, sc)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    pid = hash_pixel_ids(width, height, y_offset=y_offset, total_width=width,
                         row_stride=row_stride, device=dev).reshape(p)
    for s in range(spp):
        s_u32 = (int(sample_index) + s) & 0xFFFFFFFF
        o, d, seeds = generate_rays_hash(
            camera, width, height, s_u32, frame_seed,
            y_offset=y_offset, total_width=width, row_stride=row_stride,
            sampler_spec=sampler_spec,
        )
        o, d, seeds = o.reshape(p, 3), d.reshape(p, 3), seeds.reshape(p)
        for start in range(0, p, block):
            sl = slice(start, start + block)
            if mode != "path":
                aov = {
                    "normal": integrators.shade_normals,
                    "albedo": integrators.shade_albedo,
                    "depth": integrators.shade_depth,
                }[mode]
                img = aov(o[sl], d[sl], sc, t_min, t_max)
            else:
                img = integrators.trace_path(
                    o[sl], d[sl], sc, max_depth, t_min, t_max,
                    pixel_seeds=seeds[sl],
                    russian_roulette_depth=russian_roulette_depth,
                    sky_intensity=sky_intensity, nee=nee, mis=mis,
                    pixel_ids=pid[sl], sample_index=s_u32,
                    frame_seed_u32=int(frame_seed) & 0xFFFFFFFF,
                    sampler_spec=sampler_spec, light_pick=light_pick,
                )
                if clamp > 0.0:
                    img = integrators.clamp_radiance(img, clamp)
            acc[sl] += img
    return (acc / float(spp)).reshape(height, width, 3)


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor of a scene or camera dataclass, depth first."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += _tensors(v)
    return out


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
                "the CUDA megakernel has no backward; render with "
                "backend='torch' to differentiate (ROADMAP Queue 1 item 11)"
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
) -> torch.Tensor:
    """Render spp samples in one launch of the CUDA megakernel; returns the
    (height, width, 3) f32 mean on the scene's CUDA device.  Same signature
    and stream as render_reference (whose default light_pick='sample' is
    the kernel's > 4-light pick).  A scene with a sphere BVH walks it; a
    mesh must have its BVH (make_scene builds one)."""
    _check_args(width, height, spp, max_depth, mode, nee, mis, sampler_spec)
    sc = as_scene(scene_or_spheres)
    s = sc.spheres
    dev = _require_cuda(*_tensors(sc), *_tensors(camera))
    if sc.mesh is not None and sc.bvh is None:
        raise ValueError("the CUDA megakernel renders a mesh through its BVH; "
                         "build the scene with make_scene(use_bvh=True)")
    n_sl, n_tl = sc.nee_light_counts(nee)
    lib = build.load()
    planes = scene_planes(s).contiguous()
    cam = camera_vector(camera).contiguous()
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
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_render(
            cam.data_ptr(), planes.data_ptr(), s.count,
            ptr(sbvh[0]), ptr(sbvh[1]), nodes(sbvh),
            ptr(table), n_tris, smooth, ptr(mbvh[0]), ptr(mbvh[1]), nodes(mbvh),
            ptr(lplanes), n_sl, ptr(tplanes), n_tl, int(nee), int(mis and nee),
            kind, kx, ky, nbits,
            width, height,
            int(sample_index) & 0xFFFFFFFF, int(frame_seed) & 0xFFFFFFFF,
            int(y_offset) & 0xFFFFFFFF, int(row_stride) & 0xFFFFFFFF,
            max_depth, float(t_min), float(t_max), MODES[mode],
            int(russian_roulette_depth), float(sky_intensity), float(clamp),
            spp, out.data_ptr(), stream,
        )
    build.check(rc, "megakernel")
    route = "mesh_bvh" if n_tris else "sphere_bvh" if nodes(sbvh) else "brute"
    route += ("+nee" if nee else "") + ("" if kind == 0 else "+" + sampler_spec[0])
    LAUNCHES["megakernel:" + route] += 1
    return out


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
