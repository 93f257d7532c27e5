"""Scene generators of the benchmark: one module a scene kind, found by the
`scene` key of a configuration file (`rtbench/scenes/<scene>.py`).

Each module has `make(params: dict, seed: int) -> SceneData`.  The data are
plain NumPy arrays made by the benchmark from the seed; the harness hands
the same arrays to the program under test and to the reference, and each
side derives what it needs from them (edges, normals, light lists, BVHs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Material kinds, as the program and the reference number them.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


@dataclasses.dataclass(frozen=True)
class MeshGroup:
    """Triangles that share one material: (V, 3) vertices, (F, 3) indices;
    `smooth` shades them with normals averaged at the vertices."""

    vertices: np.ndarray
    faces: np.ndarray
    albedo: tuple
    kind: int
    param: float
    smooth: bool = False


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Spheres as (N, 3) centers, (N,) radii, (N, 3) albedo, (N,) kind and
    (N,) param (fuzz, ior or emission), optional mesh groups, and the
    camera as plain numbers (look_from, look_at, vup, fov, defocus, focus)."""

    centers: np.ndarray
    radii: np.ndarray
    albedo: np.ndarray
    kind: np.ndarray
    param: np.ndarray
    mesh: tuple = ()
    camera: dict = dataclasses.field(default_factory=dict)


def spheres_from_entries(entries, **kw) -> SceneData:
    """SceneData from (center, radius, kind, albedo, param) tuples."""
    return SceneData(
        centers=np.asarray([e[0] for e in entries], np.float32).reshape(-1, 3),
        radii=np.asarray([e[1] for e in entries], np.float32),
        albedo=np.asarray([e[3] for e in entries], np.float32).reshape(-1, 3),
        kind=np.asarray([e[2] for e in entries], np.int32),
        param=np.asarray([e[4] for e in entries], np.float32),
        **kw,
    )
