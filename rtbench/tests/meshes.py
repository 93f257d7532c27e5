"""Meshes for the reference's tests: an icosphere, smooth or flat, on a
ground under a quad light, as the benchmark's SceneData."""

from __future__ import annotations

import numpy as np

from rtbench.scenes import DIELECTRIC, EMISSIVE, LAMBERTIAN, MeshGroup, spheres_from_entries

QUAD = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """The unit icosphere's (V, 3) f64 vertices and (20 4^s, 3) faces, each
    edge split at its normalised midpoint."""
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                    [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]])
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.asarray([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                    [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                    [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                    [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        v = np.concatenate([v, mid / np.linalg.norm(mid, axis=-1, keepdims=True)])
        m = len(v) - len(uniq) + inv.reshape(3, -1)
        ab, bc, ca = m[0], m[1], m[2]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack(x, -1) for x in ((a, ab, ca), (b, bc, ab), (c, ca, bc),
                                                      (ab, bc, ca))])
    return v, f


def quad(corners, albedo, kind=LAMBERTIAN, param=0.0) -> MeshGroup:
    return MeshGroup(np.asarray(corners, np.float32), QUAD, tuple(albedo), kind, float(param))


def icosphere_scene(subdivisions: int, smooth: bool = True, lights: int = 1):
    """A unit icosphere at (0, 1, 0) on a 20 x 20 ground, a glass sphere
    beside it, `lights` quad lights (two triangle lights each) above."""
    v, f = icosphere(subdivisions)
    ball = MeshGroup((v + [0.0, 1.0, 0.0]).astype(np.float32), f, (0.75, 0.6, 0.45),
                     LAMBERTIAN, 0.0, smooth)
    ground = quad([[-10, 0, -10], [-10, 0, 10], [10, 0, 10], [10, 0, -10]], (0.5, 0.5, 0.5))
    lamps = [quad([[x - 0.5, 3.5, -0.5], [x + 0.5, 3.5, -0.5], [x + 0.5, 3.5, 0.5],
                   [x - 0.5, 3.5, 0.5]], (1.0, 1.0, 1.0), EMISSIVE, 8.0)
             for x in (-1.0, 1.5)[:lights]]
    camera = dict(look_from=[0.0, 1.6, 4.5], look_at=[0.0, 0.9, 0.0], vup=[0.0, 1.0, 0.0],
                  fov=40.0, defocus=0.0, focus=4.5)
    return spheres_from_entries([((1.6, 0.4, 0.9), 0.4, DIELECTRIC, (1.0, 1.0, 1.0), 1.5)],
                                mesh=(ball, ground, *lamps), camera=camera)


def config(width: int, height: int, max_depth: int = 8) -> dict:
    """The frame and integrator the icosphere scene is traced with."""
    return dict(width=width, height=height, max_depth=max_depth,
                integrator=dict(nee=True, mis=True, russian_roulette_depth=0,
                                sky_intensity=0.2))
