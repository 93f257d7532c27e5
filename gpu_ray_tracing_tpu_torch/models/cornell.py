"""The Cornell box (port of gpu_ray_tracing_tpu/models/cornell.py).

The 555-unit box with a ceiling quad light, a glass and a mirror sphere.
It is meant for NEE/MIS with sky_intensity=0: the lamp's two faces are
triangle lights, area-sampled from every diffuse vertex.
"""

from __future__ import annotations

import numpy as np

from gpu_ray_tracing_tpu_torch.models.camera import CameraSettings
from gpu_ray_tracing_tpu_torch.models.mesh import make_mesh, merge_meshes
from gpu_ray_tracing_tpu_torch.models.scene import Scene, make_scene
from gpu_ray_tracing_tpu_torch.models.spheres import (
    DIELECTRIC,
    EMISSIVE,
    METAL,
    make_spheres,
)

#: Traditional wall albedos (Cornell's measured spectra, RGB-projected).
WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)


def _quad(a, b, c, d, **mat_kw):
    """Two-triangle quad through the corners a-b-c-d (in winding order)."""
    verts = np.asarray([a, b, c, d], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return make_mesh(verts, faces, **mat_kw)


def cornell_box_scene(light_intensity: float = 15.0, light_half: float = 65.0) -> Scene:
    """The Cornell box; `light_half` is the half-side of the square lamp."""
    s = 555.0
    lh, ly = float(light_half), s - 1.0
    walls = merge_meshes(
        _quad((0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s), albedo=WHITE),  # floor
        _quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), albedo=WHITE),  # ceiling
        _quad((0, 0, s), (s, 0, s), (s, s, s), (0, s, s), albedo=WHITE),  # back
        _quad((s, 0, 0), (s, s, 0), (s, s, s), (s, 0, s), albedo=GREEN),  # right
        _quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), albedo=RED),    # left
        _quad(  # the lamp, just below the ceiling
            (s / 2 - lh, ly, s / 2 - lh), (s / 2 + lh, ly, s / 2 - lh),
            (s / 2 + lh, ly, s / 2 + lh), (s / 2 - lh, ly, s / 2 + lh),
            albedo=(1.0, 1.0, 1.0), mat_kind=EMISSIVE,
            mat_param=float(light_intensity),
        ),
    )
    spheres = make_spheres(
        [
            ((185.0, 90.0, 170.0), 90.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
            ((370.0, 90.0, 350.0), 90.0, METAL, (0.8, 0.85, 0.88), 0.0),
        ]
    )
    return make_scene(spheres, walls)


def cornell_camera(device=None) -> CameraSettings:
    """The traditional Cornell viewpoint: centered, outside the open face."""
    return CameraSettings.make([278.0, 278.0, -800.0], [278.0, 278.0, 0.0],
                               [0.0, 1.0, 0.0], 40.0, 0.0, 10.0, device=device)
