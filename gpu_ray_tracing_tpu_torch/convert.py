"""Carry scene and camera state over from the JAX package.

`from_reference(obj)` turns the JAX package's Spheres, TriangleMesh, BVH,
Lights, TriLights, Scene, CameraSettings, Camera, AccumState or
AdaptiveAccumState into the port's, field by field through `np.asarray`,
so a render started in JAX can be resumed in the port.  It recognises the
classes by name and module, so it never imports jax itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera, CameraSettings
from gpu_ray_tracing_tpu_torch.models.mesh import TriangleMesh
from gpu_ray_tracing_tpu_torch.models.scene import Lights, Scene, TriLights
from gpu_ray_tracing_tpu_torch.models.spheres import Spheres
from gpu_ray_tracing_tpu_torch.ops.accumulate import AccumState, AdaptiveAccumState
from gpu_ray_tracing_tpu_torch.ops.bvh import BVH

_REFERENCE_PACKAGE = "gpu_ray_tracing_tpu."
_ARRAY_CLASSES = {c.__name__: c for c in
                  (Spheres, TriangleMesh, Lights, TriLights, CameraSettings, Camera,
                   AdaptiveAccumState)}


def _tensor(x, device) -> torch.Tensor | None:
    return None if x is None else torch.from_numpy(np.array(x)).to(device)


def _fields(obj, cls, device):
    return cls(**{f.name: _tensor(getattr(obj, f.name), device)
                  for f in dataclasses.fields(cls)})


def from_reference(obj, device=None):
    """The port's counterpart of a JAX-package scene or camera object."""
    cls = type(obj)
    if not cls.__module__.startswith(_REFERENCE_PACKAGE):
        raise TypeError(f"not a gpu_ray_tracing_tpu object: {cls.__module__}.{cls.__name__}")
    name = cls.__name__
    if name in _ARRAY_CLASSES:
        return _fields(obj, _ARRAY_CLASSES[name], device)
    if name == "AccumState":
        # The count stays on the host (ops/accumulate.py).
        return AccumState(rgb=_tensor(obj.rgb, device), count=_tensor(obj.count, None))
    if name == "BVH":
        arrays = {f: _tensor(getattr(obj, f), device) for f in
                  ("bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count")}
        return BVH(**arrays, leaf_size=obj.leaf_size)
    if name == "Scene":
        part = lambda f: (None if getattr(obj, f) is None
                          else from_reference(getattr(obj, f), device))
        return Scene(
            spheres=part("spheres"), mesh=part("mesh"), bvh=part("bvh"),
            sphere_bvh=part("sphere_bvh"), lights=part("lights"),
            tri_lights=part("tri_lights"), bvh_leaf_size=obj.bvh_leaf_size,
            mesh_has_emissive=obj.mesh_has_emissive,
        )
    raise TypeError(f"no port counterpart for {cls.__module__}.{name}")
