"""The Cornell box of Shirley's Ray Tracing: The Rest of Your Life: five
555-unit walls as two triangles each, a 130 x 105 lamp just below the
ceiling (two emissive triangles), a 165 x 330 x 165 box turned 15 degrees
about y and moved to (265, 0, 295) (twelve triangles), and a glass sphere
of radius 90 at (190, 90, 190).  The geometry is fixed; `seed` is not
used.  Lamp, box and sphere come from the configuration's params.
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import DIELECTRIC, EMISSIVE, LAMBERTIAN, MeshGroup, spheres_from_entries

WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)
_QUAD = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
# The box's 8 corners are numbered by bits (x, y, z); each side's four
# corners go round it, so every face winds outward.
_BOX = np.asarray([[0, 4, 6, 2], [1, 3, 7, 5], [0, 1, 5, 4], [2, 6, 7, 3], [0, 2, 3, 1],
                   [4, 5, 7, 6]], np.int64)


def _quad(corners, albedo, kind=LAMBERTIAN, param=0.0) -> MeshGroup:
    return MeshGroup(np.asarray(corners, np.float32), _QUAD, tuple(albedo), kind, float(param))


def _box(size, turn_deg, offset, material) -> MeshGroup:
    """A box [0, size] turned `turn_deg` about y, then moved by `offset`."""
    corners = np.asarray([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)], np.float64)
    p = corners[:, ::-1] * np.asarray(size, np.float64)  # bit 0 is x, bit 1 y, bit 2 z
    th = np.radians(turn_deg)
    x = np.cos(th) * p[:, 0] + np.sin(th) * p[:, 2]
    z = -np.sin(th) * p[:, 0] + np.cos(th) * p[:, 2]
    v = np.stack([x, p[:, 1], z], -1) + np.asarray(offset, np.float64)
    faces = np.concatenate([s[[0, 1, 2, 0, 2, 3]].reshape(2, 3) for s in _BOX])
    return MeshGroup(v.astype(np.float32), faces, tuple(material["albedo"]),
                     int(material["kind"]), float(material["param"]))


def make(params: dict, seed: int):  # noqa: ARG001 - fixed geometry
    s = 555.0
    (x0, x1), (z0, z1), ly = params["light_x"], params["light_z"], float(params["light_y"])
    box, glass = params["box"], params["sphere"]
    mesh = (
        _quad([(0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s)], WHITE),  # floor
        _quad([(0, s, 0), (s, s, 0), (s, s, s), (0, s, s)], WHITE),  # ceiling
        _quad([(0, 0, s), (s, 0, s), (s, s, s), (0, s, s)], WHITE),  # back
        _quad([(s, 0, 0), (s, s, 0), (s, s, s), (s, 0, s)], GREEN),  # right
        _quad([(0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s)], RED),  # left
        _quad([(x0, ly, z0), (x1, ly, z0), (x1, ly, z1), (x0, ly, z1)], (1.0, 1.0, 1.0),
              EMISSIVE, float(params["light_intensity"])),
        _box(box["size"], box["turn_deg"], box["offset"], box["material"]),
    )
    return spheres_from_entries(
        [(tuple(glass["center"]), float(glass["radius"]), DIELECTRIC, (1.0, 1.0, 1.0),
          float(glass["ior"]))],
        mesh=mesh, camera=dict(params["camera"]))
