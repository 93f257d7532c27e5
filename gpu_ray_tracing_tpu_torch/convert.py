"""Carry scene and camera state over from the JAX package.

`from_reference(obj)` turns the JAX package's Spheres, Scene,
CameraSettings or Camera into the port's, field by field through
`np.asarray`.  It recognises the classes by name and module, so it never
imports jax itself.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera, CameraSettings
from gpu_ray_tracing_tpu_torch.models.scene import Scene
from gpu_ray_tracing_tpu_torch.models.spheres import Spheres

_REFERENCE_PACKAGE = "gpu_ray_tracing_tpu."


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def _fields(obj, cls, device):
    return cls(**{name: _tensor(getattr(obj, name), device)
                  for name in cls.__dataclass_fields__})


def from_reference(obj, device=None):
    """The port's counterpart of a JAX-package Spheres, Scene,
    CameraSettings or Camera."""
    cls = type(obj)
    if not cls.__module__.startswith(_REFERENCE_PACKAGE):
        raise TypeError(f"not a gpu_ray_tracing_tpu object: {cls.__module__}.{cls.__name__}")
    name = cls.__name__
    if name == "Spheres":
        return _fields(obj, Spheres, device)
    if name == "CameraSettings":
        return _fields(obj, CameraSettings, device)
    if name == "Camera":
        return _fields(obj, Camera, device)
    if name == "Scene":
        extra = [f for f in ("mesh", "bvh", "sphere_bvh", "lights", "tri_lights")
                 if getattr(obj, f) is not None]
        if extra:
            raise NotImplementedError(
                f"Scene fields {extra} are not ported yet (ROADMAP Queue 1 "
                "items 3, 6, 7 and 8)"
            )
        return Scene(spheres=from_reference(obj.spheres, device),
                     bvh_leaf_size=obj.bvh_leaf_size)
    raise TypeError(f"no port counterpart for {cls.__module__}.{name}")
