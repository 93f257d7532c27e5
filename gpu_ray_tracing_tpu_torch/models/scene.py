"""Scene: spheres plus an optional BVH-accelerated triangle mesh, and the
light lists (port of gpu_ray_tracing_tpu/models/scene.py:32-281).

`make_scene` builds the BVHs on the host as the JAX package does: a sphere
BVH above SPHERE_BVH_THRESHOLD active spheres (the spheres reordered into
leaf order) and a mesh BVH (the faces reordered), then extracts the light
lists.  The lights feed next-event estimation (nee=True): sphere lights
are cone-sampled and triangle lights area-sampled, in one ordinal space
(sphere lights first).  Without NEE, emission simply ends a path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.mesh import TriangleMesh
from gpu_ray_tracing_tpu_torch.models.spheres import EMISSIVE, Spheres
from gpu_ray_tracing_tpu_torch.ops.bvh import BVH, build_mesh_bvh, build_sphere_bvh

#: Active sphere count above which make_scene builds a sphere BVH (the
#: JAX package's value, measured on a TPU; the CUDA kernel then walks it
#: instead of the brute scan).
SPHERE_BVH_THRESHOLD = 256


def _move(obj, device):
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                       for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class Lights:
    """Emissive-sphere light list: emission = albedo * mat_param per light."""

    centers: torch.Tensor  # (L, 3)
    radii: torch.Tensor  # (L,)
    emission: torch.Tensor  # (L, 3)

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    def to(self, device) -> "Lights":
        return _move(self, device)


def extract_lights(spheres: Spheres) -> Lights | None:
    """Collect the active emissive spheres (None if there are none)."""
    kind = spheres.mat_kind.cpu().numpy()
    radii = spheres.radii.cpu().numpy()
    idx = np.flatnonzero((kind == EMISSIVE) & (radii > 0))
    if idx.size == 0:
        return None
    idx = torch.from_numpy(idx).to(spheres.device)
    return Lights(
        centers=spheres.centers[idx],
        radii=spheres.radii[idx],
        emission=spheres.albedo[idx] * spheres.mat_param[idx][:, None],
    )


@dataclasses.dataclass(frozen=True)
class TriLights:
    """Emissive mesh-triangle light list, extracted after BVH reordering so
    `face_ids` index the mesh the render traverses.  The j-th triangle
    light is global light ordinal (sphere light count + j).  `normal` is
    the unit geometric normal; emission is two-sided."""

    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3)
    e2: torch.Tensor  # (T, 3)
    normal: torch.Tensor  # (T, 3)
    area: torch.Tensor  # (T,)
    emission: torch.Tensor  # (T, 3)
    face_ids: torch.Tensor  # (T,) i32

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "TriLights":
        return _move(self, device)


def extract_tri_lights(mesh: TriangleMesh) -> TriLights | None:
    """Collect the emissive, non-degenerate mesh faces (None if none).
    Zero-area faces are left out: Moller-Trumbore never hits them."""
    kind = mesh.mat_kind.cpu().numpy()
    e1 = mesh.e1.cpu().numpy().astype(np.float64)
    e2 = mesh.e2.cpu().numpy().astype(np.float64)
    cross = np.cross(e1, e2)
    area2 = np.linalg.norm(cross, axis=-1)  # = 2 * area
    idx = np.flatnonzero((kind == EMISSIVE) & (area2 > 1e-12))
    if idx.size == 0:
        return None
    dev = mesh.device
    sel = torch.from_numpy(idx).to(dev)
    return TriLights(
        v0=mesh.v0[sel],
        e1=mesh.e1[sel],
        e2=mesh.e2[sel],
        normal=torch.from_numpy((cross[idx] / area2[idx][:, None]).astype(np.float32)).to(dev),
        area=torch.from_numpy((0.5 * area2[idx]).astype(np.float32)).to(dev),
        emission=mesh.albedo[sel] * mesh.mat_param[sel][:, None],
        face_ids=sel.to(torch.int32),
    )


def tri_light_id_per_face(mesh: TriangleMesh, tri_lights: TriLights | None) -> torch.Tensor:
    """(F,) i32 triangle-light ordinal per face, -1 for non-lights (the
    consumer adds the sphere light count to make it global)."""
    lid = torch.full((mesh.num_triangles,), -1, dtype=torch.int32, device=mesh.device)
    if tri_lights is not None:
        lid[tri_lights.face_ids.long()] = torch.arange(
            tri_lights.count, dtype=torch.int32, device=mesh.device)
    return lid


def sphere_light_ids(spheres: Spheres) -> torch.Tensor:
    """(N,) i64 NEE light ordinal per sphere: the l-th active emissive
    sphere is light l (the order of extract_lights), -1 for the others."""
    is_em = (spheres.mat_kind == EMISSIVE) & (spheres.radii > 0.0)
    return torch.where(is_em, torch.cumsum(is_em.to(torch.int64), 0) - 1, -1)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Sphere geometry plus an optional triangle mesh with its BVH.

    `sphere_bvh` (spheres reordered leaf-contiguously) lets the kernel walk
    the spheres instead of scanning them all; `lights`/`tri_lights` are the
    NEE light lists; `mesh_has_emissive` is derived from the mesh when not
    given.
    """

    spheres: Spheres
    mesh: TriangleMesh | None = None
    bvh: BVH | None = None
    sphere_bvh: BVH | None = None
    lights: Lights | None = None
    tri_lights: TriLights | None = None
    bvh_leaf_size: int = 4
    mesh_has_emissive: bool | None = None

    def __post_init__(self):
        if self.mesh is not None and self.mesh_has_emissive is None:
            object.__setattr__(self, "mesh_has_emissive",
                               bool((self.mesh.mat_kind == EMISSIVE).any()))

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def to(self, device) -> "Scene":
        moved = {name: (None if (v := getattr(self, name)) is None else v.to(device))
                 for name in ("spheres", "mesh", "bvh", "sphere_bvh", "lights", "tri_lights")}
        return dataclasses.replace(self, **moved)

    def nee_light_counts(self, nee: bool) -> tuple[int, int]:
        """(sphere lights, triangle lights) that NEE samples, (0, 0) without
        NEE.  Raises, as render_pallas does, when NEE has nothing to sample
        or an emissive mesh lacks its triangle light list."""
        if not nee:
            return 0, 0
        n_sl = 0 if self.lights is None else self.lights.count
        n_tl = 0 if self.tri_lights is None else self.tri_lights.count
        if n_sl + n_tl == 0:
            raise ValueError("nee=True needs a Scene with emissive lights; build it with "
                             "make_scene so the light list is extracted")
        if self.mesh_has_emissive and self.tri_lights is None:
            raise ValueError("nee=True with EMISSIVE mesh faces needs the triangle light "
                             "list; build the Scene via make_scene (it extracts tri_lights)")
        return n_sl, n_tl

    def global_tri_light_ids(self) -> torch.Tensor:
        """(F,) global NEE light ordinal per face: its triangle-light index
        plus the sphere light count, -1 for non-lights (render_pallas:1956)."""
        base = tri_light_id_per_face(self.mesh, self.tri_lights)
        n_sl = 0 if self.lights is None else self.lights.count
        return torch.where(base >= 0, base + n_sl, -1)


def make_scene(
    spheres: Spheres,
    mesh: TriangleMesh | None = None,
    *,
    bvh_leaf_size: int = 4,
    use_bvh: bool = True,
    sphere_bvh: bool | None = None,
) -> Scene:
    """Assemble a scene; builds the BVHs on the host (scene.py:221-277).

    sphere_bvh: True/False forces; None builds one when the active sphere
    count exceeds SPHERE_BVH_THRESHOLD (reordering the spheres).

    One deliberate departure from the JAX make_scene: the mesh BVH keeps
    `bvh_leaf_size` (4 by default) whatever its node count.  The JAX
    version doubles the leaf size until the tree fits the Pallas kernel's
    8,192-node SMEM budget; the CUDA kernel has no such budget, and no cap
    on triangles or nodes.  A mesh whose 4-leaf tree has more than 8,192
    nodes therefore gets a different tree (smaller leaves, more nodes) than
    JAX's; the hits are the same.
    """
    s_bvh = None
    if sphere_bvh is None:
        sphere_bvh = use_bvh and int((spheres.radii > 0).sum()) > SPHERE_BVH_THRESHOLD
    if sphere_bvh:
        spheres, s_bvh = build_sphere_bvh(spheres)
    lights = extract_lights(spheres)
    if mesh is None:
        return Scene(spheres=spheres, sphere_bvh=s_bvh, lights=lights)
    bvh = None
    if use_bvh:
        mesh, bvh = build_mesh_bvh(mesh, leaf_size=bvh_leaf_size)
    # Extracted after the reordering, so face ids index the traversed mesh.
    return Scene(spheres=spheres, mesh=mesh, bvh=bvh, sphere_bvh=s_bvh,
                 lights=lights, tri_lights=extract_tri_lights(mesh),
                 bvh_leaf_size=bvh_leaf_size if use_bvh else 4)


def as_scene(scene_or_spheres) -> Scene:
    if isinstance(scene_or_spheres, Scene):
        return scene_or_spheres
    return Scene(spheres=scene_or_spheres)
