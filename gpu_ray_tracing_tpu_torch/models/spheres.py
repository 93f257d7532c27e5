"""Sphere scene model (port of gpu_ray_tracing_tpu/models/spheres.py).

Struct-of-arrays spheres as a dataclass of tensors, the material kinds,
the reference's packed albedo.w material codec (host numpy, for parity
tests) and the scene generators.  `one_weekend_scene(seed)` draws from an
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

    def pad_to(self, n: int) -> "Spheres":
        """Pad with inactive (radius 0) spheres up to n slots, on the
        spheres' device.  Every path masks an inactive slot, so a padded
        scene renders the same frame; the kernels need no padding (the
        JAX package pads to the TPU's lane width)."""
        k = n - self.count
        if k < 0:
            raise ValueError(f"cannot pad {self.count} spheres down to {n}")
        if k == 0:
            return self
        return Spheres(*(torch.cat([t, torch.zeros((k, *t.shape[1:]), dtype=t.dtype,
                                                   device=t.device)])
                         for t in (getattr(self, f.name) for f in dataclasses.fields(self))))

    def pad_to_multiple(self, m: int = 128) -> "Spheres":
        """Pad N up to a multiple of m (at least m slots)."""
        n = ((self.count + m - 1) // m) * m
        return self.pad_to(max(n, m))


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


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pack_materials(spheres: Spheres) -> np.ndarray:
    """Spheres -> (N, 4) f32 packed albedo.w materials (sphere.rs
    convention): lambertian (r, g, b, -2), metal (r, g, b, fuzz),
    dielectric (ior, 0, 0, 2).  EMISSIVE has no encoding and a metal fuzz
    outside [-1, 1] would decode as another kind: both are refused."""
    kind = _host(spheres.mat_kind)
    if bool(np.any(kind == EMISSIVE)):
        raise ValueError("the reference albedo.w codec cannot express EMISSIVE")
    albedo = _host(spheres.albedo)
    param = _host(spheres.mat_param)
    metal_fuzz = param[kind == METAL]
    if metal_fuzz.size and bool(np.any((metal_fuzz < -1.0) | (metal_fuzz > 1.0))):
        raise ValueError(
            "metal fuzz must be within [-1, 1] to round-trip the albedo.w "
            f"codec; got {metal_fuzz.min()}..{metal_fuzz.max()}"
        )
    out = np.zeros((albedo.shape[0], 4), np.float32)
    out[:, :3] = albedo
    out[kind == LAMBERTIAN, 3] = -2.0
    out[kind == METAL, 3] = param[kind == METAL]
    out[kind == DIELECTRIC, 0] = param[kind == DIELECTRIC]
    out[kind == DIELECTRIC, 1:3] = 0.0
    out[kind == DIELECTRIC, 3] = 2.0
    return out


def unpack_materials(centers, radii, packed, device=None) -> Spheres:
    """(N, 4) packed albedo.w -> Spheres (the decode of wgsl:77-79,
    272-284): w < -1 lambertian, -1 <= w <= 1 metal with fuzz w, w > 1
    dielectric with ior x and albedo 1."""
    packed = np.asarray(packed, np.float32)
    w = packed[:, 3]
    kind = np.where(w < -1.0, LAMBERTIAN, np.where(w <= 1.0, METAL, DIELECTRIC))
    param = np.where(kind == METAL, w, np.where(kind == DIELECTRIC, packed[:, 0], 0.0))
    albedo = packed[:, :3].copy()
    albedo[kind == DIELECTRIC] = 1.0

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    return Spheres(
        centers=f32(centers).reshape(-1, 3),
        radii=f32(radii).reshape(-1),
        albedo=f32(albedo),
        mat_kind=torch.from_numpy(kind.astype(np.int32)).to(device),
        mat_param=f32(param),
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
