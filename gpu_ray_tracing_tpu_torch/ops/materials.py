"""Lambertian / metal / dielectric scatter (port of
gpu_ray_tracing_tpu/ops/materials.py).

All three BSDFs are evaluated for every ray and selected by material kind,
draw for draw as in the JAX package (wgsl:84-141): the lambertian
direction is not normalized, metal absorbs a fuzzed reflection below the
surface, and the dielectric's attenuation is exactly 1.  Inner products,
reflections and the fuzz round as jitted XLA:CPU rounds them on the CPU
(fused multiply-adds) and as the kernel rounds them on the card
(ops/rounding.xla_fma).
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch.models.spheres import DIELECTRIC, LAMBERTIAN, METAL
from gpu_ray_tracing_tpu_torch.ops.rounding import powf, sqrt, xla_dot3, xla_fma


def _dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    d = xla_dot3(a, b)
    return d[..., None] if keepdim else d


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection: v - 2 dot(v, n) n."""
    return xla_fma(-2.0 * _dot(v, n, keepdim=True), n, v)


def refract(unit_v: torch.Tensor, n: torch.Tensor, eta_ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction of a unit direction about unit normal n (the caller
    excludes total internal reflection, wgsl:119)."""
    cos_theta = torch.clamp(_dot(-unit_v, n, keepdim=True), max=1.0)
    r_perp = eta_ratio * xla_fma(cos_theta, n, unit_v)
    k = 1.0 - _dot(r_perp, r_perp, keepdim=True)
    k_pos = k > 0.0
    sqrt_k = torch.where(k_pos, sqrt(torch.where(k_pos, k, 1.0)), 0.0)
    return xla_fma(-sqrt_k, n, r_perp)


def reflectance(cos_theta: torch.Tensor, refractive_index: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (wgsl:137-141)."""
    r0 = (1.0 - refractive_index) / (1.0 + refractive_index)
    r0 = r0 * r0
    return xla_fma(1.0 - r0, powf(1.0 - cos_theta, 5.0), r0)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    norm = sqrt(_dot(v, v, keepdim=True))
    return v / torch.clamp(norm, min=1e-20)


def scatter(
    ray_dir: torch.Tensor,  # (..., 3) incoming direction (not necessarily unit)
    normal: torch.Tensor,  # (..., 3) face normal, flipped toward the ray
    front_face: torch.Tensor,  # (...,) bool
    albedo: torch.Tensor,  # (..., 3)
    mat_kind: torch.Tensor,  # (...,) int
    mat_param: torch.Tensor,  # (...,) fuzz (metal) or ior (dielectric)
    unit_vec: torch.Tensor,  # (..., 3) random unit vector
    u_reflect: torch.Tensor,  # (...,) U[0,1) draw for the dielectric choice
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate all three BSDFs and select by mat_kind.  Returns
    (scattered_dir, attenuation, ok); ok=False means absorbed (wgsl:99)."""
    # lambertian (wgsl:84-93)
    lam_dir = normal + unit_vec
    degenerate = _dot(lam_dir, lam_dir, keepdim=True) < 1e-6
    lam_dir = torch.where(degenerate, normal, lam_dir)

    # metal (wgsl:95-100)
    fuzz = mat_param[..., None]
    reflected = xla_fma(fuzz, unit_vec, _normalize(reflect(ray_dir, normal)))
    metal_dir = _normalize(reflected)
    metal_ok = _dot(reflected, normal) > 0.0

    # dielectric (wgsl:102-135); ior sanitized on non-dielectric lanes
    ior = torch.where(mat_kind == DIELECTRIC, mat_param, 1.5)
    eta_ratio = torch.where(front_face, 1.0 / ior, ior)[..., None]
    unit_d = _normalize(ray_dir)
    cos_theta = torch.clamp(_dot(-unit_d, normal), max=1.0)
    sin2 = xla_fma(-cos_theta, cos_theta, torch.ones_like(cos_theta))
    sin2_pos = sin2 > 0.0
    sin_theta = torch.where(sin2_pos, sqrt(torch.where(sin2_pos, sin2, 1.0)), 0.0)
    cannot_refract = eta_ratio[..., 0] * sin_theta > 1.0
    should_reflect = cannot_refract | (
        reflectance(cos_theta, eta_ratio[..., 0]) > u_reflect
    )
    diel_dir = torch.where(
        should_reflect[..., None],
        reflect(unit_d, normal),
        refract(unit_d, normal, eta_ratio),
    )
    diel_dir = _normalize(diel_dir)

    kind = mat_kind[..., None]
    out_dir = torch.where(
        kind == LAMBERTIAN, lam_dir, torch.where(kind == METAL, metal_dir, diel_dir)
    )
    attenuation = torch.where(kind == DIELECTRIC, torch.ones_like(albedo), albedo)
    ok = torch.where(mat_kind == METAL, metal_ok, True)
    return out_dir, attenuation, ok
