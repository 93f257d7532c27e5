"""A triangle mesh behind a BVH on a ground sphere, lit by the sky alone:
BASELINE config 4 (the Stanford bunny's scale), with a unit icosphere of
`subdivisions` edge-midpoint splits (20 * 4^s faces; 81,920 at 6) in the
bunny's place.  The mesh is scaled by `scale` and moved by `translate` in
f64, then rounded to f32 once; its material, the ground sphere and the
camera come from the configuration's params.  The geometry is fixed;
`seed` is not used.
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import MeshGroup, SceneData, spheres_from_entries

_PHI = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_VERTICES = np.asarray([[-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
                            [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
                            [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]])
_ICO_FACES = np.asarray([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                         [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                         [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                         [8, 6, 7], [9, 8, 1]], np.int64)


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """The unit icosphere's (V, 3) f64 vertices and (20 4^s, 3) faces: each
    face split in four at its edges' midpoints, pushed out to the sphere."""
    v = _ICO_VERTICES / np.linalg.norm(_ICO_VERTICES, axis=-1, keepdims=True)
    f = _ICO_FACES
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


def make(params: dict, seed: int) -> SceneData:  # noqa: ARG001 - fixed geometry
    v, f = icosphere(int(params["subdivisions"]))
    v = v * float(params["scale"]) + np.asarray(params["translate"], np.float64)
    mat, ground = params["material"], params["ground"]
    mesh = MeshGroup(v.astype(np.float32), f, tuple(mat["albedo"]), int(mat["kind"]),
                     float(mat["param"]), bool(params["smooth"]))
    return spheres_from_entries(
        [(tuple(ground["center"]), float(ground["radius"]), int(ground["kind"]),
          tuple(ground["albedo"]), float(ground["param"]))],
        mesh=(mesh,), camera=dict(params["camera"]))
