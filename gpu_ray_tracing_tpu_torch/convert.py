"""Carry scene and camera state over from the JAX package.

`from_reference(obj)` turns the JAX package's Spheres, TriangleMesh, BVH,
Lights, TriLights, Scene, CameraSettings, Camera, AccumState or
AdaptiveAccumState into the port's, field by field through `np.asarray`,
so a render started in JAX can be resumed in the port.  It recognises the
classes by name and module, so it never imports jax itself.
`wavefront_state_from_reference` and `wavefront_state_to_reference` carry
the wavefront engine's ray state between the JAX engine's (rows, 128)
planes and the port's structure-of-arrays layout, so one state can go
through both engines' bounce.
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


# The JAX wavefront engine's state planes after the pixel-id plane, in its
# order (ops/pallas/wavefront.py `_wf_kernel`), as rows of the port's (16, N)
# f32 state: origin, direction, throughput, prev_diffuse, live, and under MIS
# prev_cos appended last.
_WAVEFRONT_ROWS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 14, 13)


def wavefront_state_from_reference(pid, planes, *, p: int, samples=None, bounces=None,
                                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX wavefront engine's ray state in the port's layout.

    `pid` is its (rows, 128) i32 pixel-id plane, `planes` its 11 f32 state
    planes (12 under MIS), `p` the count of real pixels: slot k of the
    row-major flattening holds local pixel k, the slots from p on are pads.
    `samples` and `bounces` are the per-lane i32 planes of a regenerating
    pool.  Returns the (16, N) f32 and (2 or 4, N) i32 planes of
    ops/cuda/wavefront.py with no radiance gathered and no rays counted."""
    planes = [np.asarray(v, np.float32).reshape(-1) for v in planes]
    if len(planes) not in (11, 12):
        raise ValueError(f"expected 11 state planes (12 under MIS), got {len(planes)}")
    n = planes[0].size
    state_f = np.zeros((16, n), np.float32)
    for row, v in zip(_WAVEFRONT_ROWS, planes):
        state_f[row] = v
    local = np.arange(n, dtype=np.int32)
    ints = [np.asarray(pid, np.int32).reshape(-1), np.where(local < p, local, -1)]
    if (samples is None) != (bounces is None):
        raise ValueError("samples= and bounces= go together")
    if samples is not None:
        ints += [np.asarray(samples, np.int32).reshape(-1),
                 np.asarray(bounces, np.int32).reshape(-1)]
    return (torch.from_numpy(state_f).to(device),
            torch.from_numpy(np.stack(ints).astype(np.int32)).to(device))


def wavefront_state_to_reference(state_f: torch.Tensor, *, mis: bool = False) -> tuple:
    """The port's (16, N) f32 ray state as the JAX engine's 11 state planes
    (12 under MIS), each (N / 128, 128) numpy; N is a multiple of 128."""
    arr = state_f.detach().cpu().numpy()
    if arr.shape[0] != 16 or arr.shape[1] % 128:
        raise ValueError(f"expected a (16, 128 k) state, got {arr.shape}")
    rows = _WAVEFRONT_ROWS if mis else _WAVEFRONT_ROWS[:11]
    return tuple(arr[r].reshape(-1, 128) for r in rows)
