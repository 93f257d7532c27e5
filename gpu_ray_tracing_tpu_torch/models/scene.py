"""Scene container (port of gpu_ray_tracing_tpu/models/scene.py:159-281).

Sphere-only for now: the mesh, BVH and light fields exist so that the
layout matches the JAX package, and stay None.  `make_scene` refuses what
it cannot build yet (a sphere BVH, a mesh) instead of rendering a
different scene.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.spheres import Spheres

#: Active sphere count above which the JAX make_scene builds a sphere BVH
#: (the megakernel then walks it instead of the brute scan).
SPHERE_BVH_THRESHOLD = 256


@dataclasses.dataclass(frozen=True)
class Scene:
    """Sphere geometry plus the (not yet ported) mesh, BVH and light lists."""

    spheres: Spheres
    mesh: object | None = None
    bvh: object | None = None
    sphere_bvh: object | None = None
    lights: object | None = None
    tri_lights: object | None = None
    bvh_leaf_size: int = 4

    def __post_init__(self):
        for name in ("mesh", "bvh", "sphere_bvh", "lights", "tri_lights"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"Scene.{name} is not ported yet (ROADMAP Queue 1 "
                    "items 3, 7 and 8)"
                )

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, spheres=self.spheres.to(device))


def make_scene(
    spheres: Spheres,
    mesh=None,
    *,
    bvh_leaf_size: int = 4,
    use_bvh: bool = True,
    sphere_bvh: bool | None = None,
) -> Scene:
    """Assemble a sphere scene.  Raises NotImplementedError where the JAX
    make_scene would build a sphere BVH (more than SPHERE_BVH_THRESHOLD
    active spheres, or sphere_bvh=True) or take a mesh."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP Queue 1 item 8, kernel K1d)"
        )
    if sphere_bvh is None:
        n_active = int((spheres.radii > 0).sum())
        sphere_bvh = use_bvh and n_active > SPHERE_BVH_THRESHOLD
    if sphere_bvh:
        raise NotImplementedError(
            "the sphere BVH is not ported yet (ROADMAP Queue 1 item 7, "
            f"kernel K1c); scenes above {SPHERE_BVH_THRESHOLD} active "
            "spheres need it"
        )
    return Scene(spheres=spheres, bvh_leaf_size=bvh_leaf_size)


def as_scene(scene_or_spheres) -> Scene:
    if isinstance(scene_or_spheres, Scene):
        return scene_or_spheres
    return Scene(spheres=scene_or_spheres)
