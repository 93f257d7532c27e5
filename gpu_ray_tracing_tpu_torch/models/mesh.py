"""Triangle meshes (port of gpu_ray_tracing_tpu/models/mesh.py).

`TriangleMesh` is a struct-of-arrays triangle soup precomputed for
Moller-Trumbore, as a dataclass of tensors.  The generators (`icosphere`,
`torus`, `box`, `trefoil`, `bunny_stand_in`), `make_mesh`, `load_obj`,
`transform_mesh` and `merge_meshes` are host numpy code that ends in
tensors; each computes what its JAX counterpart computes, in the same
order and precision, so that the two packages' meshes are bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.spheres import LAMBERTIAN


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Flat triangle soup, precomputed for Moller-Trumbore intersection.

    v0       (F, 3) f32  first vertex of each face
    e1, e2   (F, 3) f32  edge vectors (v1-v0, v2-v0)
    normals  (F, 3) f32  unit geometric normals (cross(e1, e2) normalized)
    albedo   (F, 3) f32  per-face surface color
    mat_kind (F,)   i32  LAMBERTIAN / METAL / DIELECTRIC / EMISSIVE per face
    mat_param(F,)   f32  fuzz, ior, or emission intensity per face
    n0/n1/n2 (F, 3) f32  per-corner vertex normals for smooth shading, or
                         None for flat shading.  Shading normal =
                         normalize((1-u-v)*n0 + u*n1 + v*n2) at (u, v).
    """

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normals: torch.Tensor
    albedo: torch.Tensor
    mat_kind: torch.Tensor
    mat_param: torch.Tensor
    n0: torch.Tensor | None = None
    n1: torch.Tensor | None = None
    n2: torch.Tensor | None = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def smooth(self) -> bool:
        return self.n0 is not None

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def map(self, fn) -> "TriangleMesh":
        """Apply fn to every per-face tensor (None corner normals stay None)."""
        return TriangleMesh(*(None if (a := getattr(self, f.name)) is None else fn(a)
                              for f in dataclasses.fields(self)))

    def to(self, device) -> "TriangleMesh":
        return self.map(lambda a: a.to(device))


def make_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    albedo=(0.7, 0.7, 0.7),
    mat_kind: int = LAMBERTIAN,
    mat_param: float = 0.0,
    smooth: bool = False,
) -> TriangleMesh:
    """Build a TriangleMesh from (V, 3) vertices and (F, 3) vertex indices.

    smooth=True stores area-weighted per-vertex normals (the raw face
    cross products summed per vertex, then normalized) at each corner.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    cross = np.cross(e1, e2)
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    n = cross / np.maximum(norm, 1e-20)
    f = faces.shape[0]
    albedo = np.broadcast_to(np.asarray(albedo, np.float32), (f, 3))
    corner = {}
    if smooth:
        vn = np.zeros_like(vertices, np.float64)
        for c in range(3):
            np.add.at(vn, faces[:, c], cross)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
        vn = vn.astype(np.float32)
        corner = {f"n{c}": torch.from_numpy(vn[faces[:, c]]) for c in range(3)}
    return TriangleMesh(
        v0=torch.from_numpy(v0),
        e1=torch.from_numpy(e1),
        e2=torch.from_numpy(e2),
        normals=torch.from_numpy(np.asarray(n, np.float32)),
        albedo=torch.from_numpy(np.ascontiguousarray(albedo)),
        mat_kind=torch.full((f,), mat_kind, dtype=torch.int32),
        mat_param=torch.full((f,), mat_param, dtype=torch.float32),
        **corner,
    )


def transform_mesh(mesh: TriangleMesh, scale=1.0, translate=(0.0, 0.0, 0.0)) -> TriangleMesh:
    """Uniform positive scale + translation (normals are scale-invariant).
    Negative scale is rejected: mirroring would invert the stored normals."""
    if float(scale) <= 0.0:
        raise ValueError(
            f"transform_mesh requires scale > 0, got {scale} (mirroring "
            "would silently invert the stored normals)"
        )
    t = torch.as_tensor(np.asarray(translate, np.float32), device=mesh.device)
    s = torch.tensor(np.float32(scale), device=mesh.device)
    return dataclasses.replace(mesh, v0=mesh.v0 * s + t, e1=mesh.e1 * s, e2=mesh.e2 * s)


def load_obj(path: str, **mat_kw) -> TriangleMesh:
    """Minimal Wavefront OBJ reader: v / f records, fan-triangulated
    polygons; indices may be negative (relative) or 'v/vt/vn' tuples."""
    vertices: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices or not faces:
        raise ValueError(f"no geometry in OBJ file {path}")
    return make_mesh(np.asarray(vertices), np.asarray(faces), **mat_kw)


def icosphere(subdivisions: int = 3, **mat_kw) -> TriangleMesh:
    """Unit icosphere: 20 * 4^subdivisions triangles (1280 at 3, 5120 at 4)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                cache[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return make_mesh(verts, faces, **mat_kw)


def _grid_faces(nu: int, nv: int) -> np.ndarray:
    """Triangulated faces of a doubly wrapped (nu, nv) vertex grid (torus
    topology; vertex (i, j) at index i*nv + j), 2*nu*nv triangles."""

    def vid(i, j):
        return (i % nu) * nv + (j % nv)

    faces = []
    for i in range(nu):
        for j in range(nv):
            faces.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            faces.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    return np.asarray(faces, np.int64)


def torus(major: float = 1.0, minor: float = 0.35, nu: int = 48, nv: int = 24,
          **mat_kw) -> TriangleMesh:
    """Torus with 2*nu*nv triangles."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = minor * np.sin(vv)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return make_mesh(verts, _grid_faces(nu, nv), **mat_kw)


def box(size=(1.0, 1.0, 1.0), **mat_kw) -> TriangleMesh:
    """Axis-aligned box (12 triangles) centered at the origin."""
    sx, sy, sz = [s / 2.0 for s in size]
    verts = np.asarray(
        [
            [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
            [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
        ],
        np.float64,
    )
    faces = np.asarray(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 6, 2], [3, 7, 6],  # +y
            [1, 2, 6], [1, 6, 5],  # +x
            [0, 4, 7], [0, 7, 3],  # -x
        ],
        np.int64,
    )
    return make_mesh(verts, faces, **mat_kw)


def trefoil(nu: int = 256, nv: int = 32, tube_radius: float = 0.35,
            **mat_kw) -> TriangleMesh:
    """Trefoil-knot tube with 2*nu*nv triangles (16,384 at the defaults):
    p(t) = (sin t + 2 sin 2t, cos t - 2 cos 2t, -sin 3t), swept by a
    circle in a parallel-transported frame whose holonomy is unwound
    linearly along the curve."""
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    p = np.stack(
        [np.sin(t) + 2 * np.sin(2 * t), np.cos(t) - 2 * np.cos(2 * t), -np.sin(3 * t)],
        axis=-1,
    )
    dp = np.stack(
        [np.cos(t) + 4 * np.cos(2 * t), -np.sin(t) + 4 * np.sin(2 * t), -3 * np.cos(3 * t)],
        axis=-1,
    )
    tan = dp / np.linalg.norm(dp, axis=-1, keepdims=True)
    n = np.cross(tan[0], [0.0, 0.0, 1.0])
    n /= np.linalg.norm(n)
    normals = [n]
    for i in range(1, nu):
        n = normals[-1] - tan[i] * np.dot(tan[i], normals[-1])
        n /= np.linalg.norm(n)
        normals.append(n)
    nrm = np.asarray(normals)
    binrm = np.cross(tan, nrm)
    n_end = normals[-1] - tan[0] * np.dot(tan[0], normals[-1])
    n_end /= np.linalg.norm(n_end)
    mismatch = np.arctan2(np.dot(np.cross(n_end, normals[0]), tan[0]),
                          np.dot(n_end, normals[0]))
    theta = (np.arange(nu) / nu) * mismatch
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    nrm, binrm = c * nrm + s * binrm, -s * nrm + c * binrm

    phi = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    circ = (
        np.cos(phi)[None, :, None] * nrm[:, None, :]
        + np.sin(phi)[None, :, None] * binrm[:, None, :]
    )
    verts = (p[:, None, :] + tube_radius * circ).reshape(-1, 3)
    return make_mesh(verts, _grid_faces(nu, nv), **mat_kw)


def bunny_stand_in(**mat_kw) -> TriangleMesh:
    """Deterministic ~5.1k-triangle benchmark mesh (icosphere level 4), the
    Stanford bunny's scale of triangle count; `load_obj` reads a real one."""
    return icosphere(4, **mat_kw)


def merge_meshes(*meshes: TriangleMesh) -> TriangleMesh:
    """Concatenate meshes into one triangle soup (materials kept per face).
    Flat parts of a smooth merge get n0 = n1 = n2 = the face normal."""
    if not meshes:
        raise ValueError("merge_meshes needs at least one mesh")
    corner = {}
    if any(m.smooth for m in meshes):
        corner = {
            f"n{c}": torch.cat([getattr(m, f"n{c}") if m.smooth else m.normals
                                for m in meshes])
            for c in range(3)
        }
    cat = lambda name: torch.cat([getattr(m, name) for m in meshes])
    return TriangleMesh(
        v0=cat("v0"), e1=cat("e1"), e2=cat("e2"), normals=cat("normals"),
        albedo=cat("albedo"), mat_kind=cat("mat_kind"), mat_param=cat("mat_param"),
        **corner,
    )
