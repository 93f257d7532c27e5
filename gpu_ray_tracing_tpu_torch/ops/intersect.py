"""Ray-sphere closest hit (port of gpu_ray_tracing_tpu/ops/intersect.py:56-165).

Every (ray, sphere) pair solves the reference's quadratic (wgsl:182-221)
at once on (P, N) planes: each sphere picks its near root, or its far
root when the near one is outside (t_min, t_max), and the closest hit is
the minimum over spheres.  That equals the reference's sequential
shrinking-window scan, ties going to the lower sphere index.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.spheres import Spheres
from gpu_ray_tracing_tpu_torch.ops.rounding import dot3, fma


@dataclasses.dataclass(frozen=True)
class Hit:
    """Vectorized HitRecord (wgsl:143-149); the material is looked up by idx."""

    t: torch.Tensor  # (...,) ray parameter of the closest hit (t_max if none)
    idx: torch.Tensor  # (...,) int64 index of the hit sphere (0 if none)
    hit: torch.Tensor  # (...,) bool
    point: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) face normal, flipped toward the ray
    front_face: torch.Tensor  # (...,) bool


def _sphere_roots(o, d, spheres: Spheres, t_min: float, t_max: float):
    """All-spheres quadratic for flat rays (P, 3): returns ((P, N) root,
    (P, N) valid) with the reference's near-then-far root pick.

    Its inner products and discriminant round as fused multiply-adds, as
    XLA:CPU rounds them (see ops/rounding.py): a ray leaving a surface
    starts with |o - c|^2 - r^2 near 0, where the last bit decides whether
    it hits its own sphere again.
    """
    c = spheres.centers
    r = spheres.radii
    active = r > 0.0

    dc = dot3(d[:, None, :], c[None])  # (P, N) d . c
    oc_dot_c = dot3(o[:, None, :], c[None])  # (P, N) o . c
    od = dot3(o, d)[:, None]
    oo = dot3(o, o)[:, None]
    a = dot3(d, d)[:, None]
    c2 = dot3(c, c)

    h = dc - od  # dot(center - origin, d)   (wgsl:185)
    cc = (c2 - r * r)[None, :] - 2.0 * oc_dot_c + oo  # |oc|^2 - r^2 (wgsl:186)
    disc = fma(h, h, -(a * cc))  # h^2 - a*cc (wgsl:187)

    disc_pos = disc > 0.0
    sqrt_disc = torch.where(
        disc_pos, torch.sqrt(torch.where(disc_pos, disc, 1.0)), 0.0
    )
    inv_a = 1.0 / a
    root_near = (h - sqrt_disc) * inv_a  # (wgsl:195)
    root_far = (h + sqrt_disc) * inv_a  # (wgsl:197)

    near_ok = (root_near > t_min) & (root_near < t_max)
    far_ok = (root_far > t_min) & (root_far < t_max)
    root = torch.where(near_ok, root_near, root_far)
    valid = (disc >= 0.0) & (near_ok | far_ok) & active[None, :]
    return root, valid


def intersect_spheres(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    spheres: Spheres,
    t_min: float,
    t_max: float,
) -> Hit:
    """Closest sphere hit for a batch of rays (..., 3); inactive pad
    spheres (radius <= 0) never hit."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)

    root, valid = _sphere_roots(o, d, spheres, t_min, t_max)
    t_cand = torch.where(valid, root, torch.inf)
    t_best, idx = torch.min(t_cand, dim=-1)
    hit = torch.isfinite(t_best)
    t_best = torch.where(hit, t_best, t_max)

    center_best = spheres.centers[idx]
    radius_best = spheres.radii[idx]
    # Misses keep t = t_max in the record but must not build a ~1e35 point.
    t_point = torch.where(hit, t_best, 0.0)
    point = o + t_point[:, None] * d
    # Outward normal = (p - center) / radius (wgsl:206); guard pad radius 0.
    safe_r = torch.where(radius_best != 0.0, radius_best, 1.0)
    outward = (point - center_best) / safe_r[:, None]
    front_face = torch.sum(d * outward, dim=-1) < 0.0  # (wgsl:159)
    normal = torch.where(front_face[:, None], outward, -outward)  # (wgsl:160)

    return Hit(
        t=t_best.reshape(batch_shape),
        idx=idx.reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        point=point.reshape(*batch_shape, 3),
        normal=normal.reshape(*batch_shape, 3),
        front_face=front_face.reshape(batch_shape),
    )
