"""Integrators (port of gpu_ray_tracing_tpu/ops/integrators.py:35-127+ and
the scene closest hit of gpu_ray_tracing_tpu/models/scene.py:310-362).

`trace_path` is the reference's ray_color (wgsl:261-297) on the counter
stream: a bounce loop to max_depth with multiplicative throughput, sky on
a miss, emission ending the path, absorbed rays black, optional Russian
roulette.  Every ray runs the full trip count with a `live` mask, as in
the JAX package; dead rays add nothing.  Only the `pixel_seeds` stream
is ported (threefry, the WGSL chain and NEE/MIS are ROADMAP items).
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.models.spheres import EMISSIVE
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.intersect import (
    Hit,
    intersect_bvh,
    intersect_spheres,
    intersect_triangles,
)
from gpu_ray_tracing_tpu_torch.ops.materials import scatter

_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def sky_color(dirs: torch.Tensor) -> torch.Tensor:
    """Vertical white->blue gradient on the unit direction (wgsl:293-296)."""
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    unit = dirs / torch.clamp(norm, min=1e-20)
    a = 0.5 * (unit[..., 1:2] + 1.0)
    white = torch.tensor(_WHITE, dtype=torch.float32, device=dirs.device)
    blue = torch.tensor(_BLUE, dtype=torch.float32, device=dirs.device)
    return (1.0 - a) * white + a * blue


def intersect_scene(origins, dirs, scene, t_min: float, t_max: float):
    """Closest hit across spheres and mesh: (hit, albedo, kind, param) per
    ray, the material taken from whichever primitive won (the mesh where
    its t is strictly less).  A sphere BVH is not walked: the spheres,
    reordered or not, are all scanned."""
    sc = as_scene(scene)
    spheres = sc.spheres
    s_hit = intersect_spheres(origins, dirs, spheres, t_min, t_max)
    albedo = spheres.albedo[s_hit.idx]
    kind = spheres.mat_kind[s_hit.idx]
    param = spheres.mat_param[s_hit.idx]
    if sc.mesh is None:
        return s_hit, albedo, kind, param

    mesh = sc.mesh
    if sc.bvh is not None:
        m_hit = intersect_bvh(origins, dirs, mesh, sc.bvh, t_min, t_max)
    else:
        m_hit = intersect_triangles(origins, dirs, mesh, t_min, t_max)
    wins = m_hit.hit & (~s_hit.hit | (m_hit.t < s_hit.t))
    w = wins[..., None]
    hit = Hit(
        t=torch.where(wins, m_hit.t, s_hit.t),
        idx=torch.where(wins, m_hit.idx, s_hit.idx),
        hit=s_hit.hit | m_hit.hit,
        point=torch.where(w, m_hit.point, s_hit.point),
        normal=torch.where(w, m_hit.normal, s_hit.normal),
        front_face=torch.where(wins, m_hit.front_face, s_hit.front_face),
    )
    return (
        hit,
        torch.where(w, mesh.albedo[m_hit.idx], albedo),
        torch.where(wins, mesh.mat_kind[m_hit.idx], kind),
        torch.where(wins, mesh.mat_param[m_hit.idx], param),
    )


def shade_normals(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """Normal-shading integrator (BASELINE config 1): 0.5*(n+1) or sky."""
    hit, _, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    lit = 0.5 * (hit.normal + 1.0)
    return torch.where(hit.hit[..., None], lit, sky_color(dirs))


def shade_albedo(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """First-hit albedo AOV, sky color on a miss."""
    hit, albedo, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    return torch.where(hit.hit[..., None], albedo, sky_color(dirs))


def shade_depth(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """First-hit metric distance (t * |d|), 3 equal channels; 0 on a miss."""
    hit, _, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    dist = torch.where(
        hit.hit, hit.t * torch.sqrt(torch.sum(dirs * dirs, dim=-1)), 0.0
    )
    return dist[..., None].expand(*dist.shape, 3)


def clamp_radiance(rgb: torch.Tensor, clamp: float) -> torch.Tensor:
    """Per-sample max-component radiance clamp, hue-preserving."""
    m = torch.amax(rgb, dim=-1, keepdim=True)
    return rgb * torch.clamp(clamp / torch.clamp(m, min=1e-12), max=1.0)


def trace_path(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    scene,
    max_depth: int,
    t_min: float,
    t_max: float,
    *,
    pixel_seeds: torch.Tensor,
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
) -> torch.Tensor:
    """Path-trace a batch of rays on the counter stream; returns linear RGB
    of shape dirs.shape.  Draws are pure functions of (pixel seed, bounce,
    salt): salts 16+3i..18+3i scatter, 1000+i Russian roulette."""
    batch_shape = dirs.shape[:-1]
    dev = dirs.device
    o, d = origins, dirs
    throughput = torch.ones((*batch_shape, 3), dtype=torch.float32, device=dev)
    result = torch.zeros((*batch_shape, 3), dtype=torch.float32, device=dev)
    live = torch.ones(batch_shape, dtype=torch.bool, device=dev)

    for i in range(max_depth):
        hit, albedo, kind, param = intersect_scene(o, d, scene, t_min, t_max)
        base = 16 + 3 * i
        u1 = rng_ops.uniform_hash(pixel_seeds, base)
        u2 = rng_ops.uniform_hash(pixel_seeds, base + 1)
        unit_vec = rng_ops.unit_vector_from_uniforms(u1, u2)
        u_reflect = rng_ops.uniform_hash(pixel_seeds, base + 2)
        new_dir, attenuation, ok = scatter(
            d, hit.normal, hit.front_face, albedo, kind, param, unit_vec, u_reflect
        )

        missed = live & ~hit.hit
        result = torch.where(
            missed[..., None], result + throughput * sky_color(d) * sky_intensity,
            result,
        )
        emissive = live & hit.hit & (kind == EMISSIVE)
        result = torch.where(
            emissive[..., None], result + throughput * albedo * param[..., None],
            result,
        )

        scattered = live & hit.hit & ok & (kind != EMISSIVE)
        throughput = torch.where(scattered[..., None], throughput * attenuation, throughput)
        o = torch.where(scattered[..., None], hit.point, o)
        d = torch.where(scattered[..., None], new_dir, d)
        live = scattered

        if russian_roulette_depth > 0 and i >= russian_roulette_depth:
            # Survive with p = max channel throughput (clamped), divide by p.
            u_rr = rng_ops.uniform_hash(pixel_seeds, 1000 + i)
            p = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
            survive = u_rr < p
            throughput = torch.where(
                (live & survive)[..., None], throughput * (1.0 / p)[..., None],
                throughput,
            )
            live = live & survive
    # Exhausted rays contribute black (the parity quirk is not ported).
    return result
