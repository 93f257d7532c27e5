"""Sphere scene model (port of gpu_ray_tracing_tpu/models/spheres.py).

Struct-of-arrays spheres as a dataclass of tensors, the material kinds,
and the scene generators.  `one_weekend_scene(seed)` draws from an
explicitly seeded numpy generator, the only host randomness in the port;
its seed mix is the JAX package's, so `one_weekend_scene(k)` equals the
JAX `one_weekend_scene(jax.random.key(k))` sphere for sphere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
# Emissive surfaces radiate albedo * mat_param and end the path (an
# extension beyond the reference's three BSDFs).
EMISSIVE = 3


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Struct-of-arrays sphere scene.

    centers   (N, 3) f32   sphere centers
    radii     (N,)   f32   radii; radius <= 0 marks an inactive pad slot
    albedo    (N, 3) f32   surface color (dielectric ignores it; kept 1.0)
    mat_kind  (N,)   i32   LAMBERTIAN / METAL / DIELECTRIC / EMISSIVE
    mat_param (N,)   f32   metal fuzz, dielectric ior, or emission intensity
    """

    centers: torch.Tensor
    radii: torch.Tensor
    albedo: torch.Tensor
    mat_kind: torch.Tensor
    mat_param: torch.Tensor

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def to(self, device) -> "Spheres":
        return Spheres(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))


def make_spheres(entries, device=None) -> Spheres:
    """Build a Spheres SoA from (center, radius, kind, albedo, param) tuples."""
    if not entries:
        raise ValueError("make_spheres needs at least one sphere entry")

    def col(k, dtype, width=None):
        a = np.asarray([e[k] for e in entries], dtype)
        if width is not None:
            a = a.reshape(-1, width)
        return torch.from_numpy(a).to(device)

    return Spheres(
        centers=col(0, np.float32, 3),
        radii=col(1, np.float32),
        albedo=col(3, np.float32, 3),
        mat_kind=col(2, np.int32),
        mat_param=col(4, np.float32),
    )


def base_scene(device=None) -> Spheres:
    """BASELINE config-1 scene: two spheres on a ground sphere."""
    return make_spheres(
        [
            ((0.0, 0.0, -1.0), 0.5, LAMBERTIAN, (0.1, 0.2, 0.5), 0.0),
            ((-1.0, 0.0, -1.0), 0.5, METAL, (0.8, 0.8, 0.8), 0.1),
            ((0.0, -100.5, -1.0), 100.0, LAMBERTIAN, (0.8, 0.8, 0.0), 0.0),
        ],
        device=device,
    )


def _numpy_seed(seed: int) -> int:
    """The JAX package's FNV-style mix over the key words (0, seed): a JAX
    `key(k)` has key data [0, k], so this reproduces its scenes."""
    mixed = 0
    for w in (0, int(seed) & 0xFFFFFFFF):
        mixed = ((mixed * 0x100000001B3) ^ w) & 0xFFFFFFFFFFFFFFFF
    return mixed


def one_weekend_scene(seed: int, grid_min: int = -7, grid_max: int = 7,
                      device=None) -> Spheres:
    """The reference's default scene generator (sphere.rs:45-153): a grey
    ground sphere, a grid of small random spheres, three hero spheres.
    See the JAX package's one_weekend_scene for the distribution."""
    entries = [((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]
    rng = np.random.default_rng(_numpy_seed(seed))

    for a in range(grid_min, grid_max):
        for b in range(grid_min, grid_max):
            choose_mat = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                entries.append((tuple(center), 0.2, LAMBERTIAN, tuple(albedo), 0.0))
            elif choose_mat < 0.95:
                albedo = 0.5 * (1.0 + rng.random(3))
                fuzz = 0.5 * rng.random()
                entries.append((tuple(center), 0.2, METAL, tuple(albedo), float(fuzz)))
            else:
                entries.append((tuple(center), 0.2, DIELECTRIC, (1.0, 1.0, 1.0), 1.5))

    entries += [
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1), 0.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ]
    return make_spheres(entries, device=device)
