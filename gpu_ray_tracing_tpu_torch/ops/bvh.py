"""Threaded (stackless) BVH (port of gpu_ray_tracing_tpu/ops/bvh.py).

Nodes are laid out depth-first, so the hit successor of an inner node is
node + 1, and every node stores a `miss_link`: the node to visit when its
box is missed or its leaf is done (-1 ends the walk).  One integer cursor
per ray walks it with no stack: the plain version in ops/intersect.py and
the CUDA megakernel's per-thread walk both read this layout.

The build is host code.  `method='native'` is the binned-SAH builder
(gpu_ray_tracing_tpu_torch/native/bvh_builder.cpp, the port's own copy,
compiled and bound with ctypes by gpu_ray_tracing_tpu_torch/native/);
`'numpy'` is the median split below; `'auto'` takes the native builder
when it compiled, as in the JAX package.  Both emit the same layout, and
each is bit-equal to the JAX package's build of the same method.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch import native
from gpu_ray_tracing_tpu_torch.models.mesh import TriangleMesh

SENTINEL = -1  # cursor value meaning "traversal finished"

#: BVH builds per method ("native", "numpy"): shows which builder a run used.
BUILDS: collections.Counter = collections.Counter()


def _round_out_f32(vals, up: bool) -> np.ndarray:
    """Narrow to float32 rounding OUTWARD (toward +-inf), so a float32 AABB
    never shrinks below the (possibly float64) extent it covers."""
    v64 = np.asarray(vals, np.float64)
    v32 = np.asarray(v64, np.float32)
    if up:
        return np.where(v32.astype(np.float64) < v64,
                        np.nextafter(v32, np.float32(np.inf)), v32)
    return np.where(v32.astype(np.float64) > v64,
                    np.nextafter(v32, np.float32(-np.inf)), v32)


@dataclasses.dataclass(frozen=True)
class BVH:
    """Threaded flat BVH over a reordered primitive array.

    bbox_min/max (M, 3) f32   node bounds
    miss_link    (M,)   i32   next node on a box miss / after a leaf; -1 ends
    leaf_start   (M,)   i32   first primitive of a leaf, -1 for inner nodes
    leaf_count   (M,)   i32   primitives in the leaf (0 for inner nodes)
    leaf_size    int          build-time cap on leaf_count
    """

    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    miss_link: torch.Tensor
    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    leaf_size: int = 4

    @property
    def num_nodes(self) -> int:
        return self.bbox_min.shape[0]

    @property
    def device(self) -> torch.device:
        return self.bbox_min.device

    def to(self, device) -> "BVH":
        return BVH(self.bbox_min.to(device), self.bbox_max.to(device),
                   self.miss_link.to(device), self.leaf_start.to(device),
                   self.leaf_count.to(device), self.leaf_size)


def _bvh(nb, nx, miss, ls, lc, leaf_size) -> BVH:
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt))
    return BVH(t(nb, np.float32), t(nx, np.float32), t(miss, np.int32),
               t(ls, np.int32), t(lc, np.int32), leaf_size)


def build_bvh(
    centroids: np.ndarray,
    bounds_min: np.ndarray,
    bounds_max: np.ndarray,
    leaf_size: int = 4,
    method: str = "auto",
) -> tuple[BVH, np.ndarray]:
    """BVH over arbitrary primitives, given (F, 3) centroids and bounds.
    Returns (bvh, order): `order` permutes the primitives into leaf-
    contiguous BVH order."""
    if method not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown BVH build method {method!r}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be >= 1, got {leaf_size}")
    if np.shape(centroids)[0] == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    # Outward rounding: a box rounded to nearest could shrink by half an
    # ulp and cull a genuine grazing hit in the f32 slab test.
    bounds_min = _round_out_f32(bounds_min, up=False)
    bounds_max = _round_out_f32(bounds_max, up=True)
    if method != "numpy":
        if native.available():
            *arrays, order = native.build_bvh_sah(
                np.asarray(centroids, np.float32), bounds_min, bounds_max, leaf_size)
            BUILDS["native"] += 1
            return _bvh(*arrays, leaf_size), order
        if method == "native":
            raise RuntimeError(f"native BVH builder unavailable: {native.build_error()}")
    centroids = np.asarray(centroids, np.float64)
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)

    order: list[int] = []
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    miss: list[int] = []
    leaf_start: list[int] = []
    leaf_count: list[int] = []

    def subtree_nodes(k: int) -> int:
        """Node count of a median-split subtree over k primitives."""
        return 1 if k <= leaf_size else 1 + subtree_nodes(k // 2) + subtree_nodes(k - k // 2)

    # Iterative DFS; each entry carries its escape target (the miss link).
    stack: list[tuple[np.ndarray, int]] = [(np.arange(centroids.shape[0]), SENTINEL)]
    while stack:
        indices, escape = stack.pop()
        nodes_min.append(bounds_min[indices].min(axis=0))
        nodes_max.append(bounds_max[indices].max(axis=0))
        miss.append(escape)
        if len(indices) <= leaf_size:
            leaf_start.append(len(order))
            leaf_count.append(len(indices))
            order.extend(int(i) for i in indices)
            continue
        leaf_start.append(SENTINEL)
        leaf_count.append(0)
        c = centroids[indices]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = indices[np.argsort(c[:, axis], kind="stable")]
        mid = len(indices) // 2
        left, right = part[:mid], part[mid:]
        # Left is emitted next (hit successor = this + 1); its escape is the
        # right subtree's root, known up front from the subtree sizes.
        right_root = len(nodes_min) + subtree_nodes(len(left))
        stack.append((right, escape))
        stack.append((left, right_root))

    BUILDS["numpy"] += 1
    return (_bvh(nodes_min, nodes_max, miss, leaf_start, leaf_count, leaf_size),
            np.asarray(order, np.int64))


def build_mesh_bvh(mesh: TriangleMesh, leaf_size: int = 4,
                   method: str = "auto") -> tuple[TriangleMesh, BVH]:
    """Build a BVH over a mesh; returns (reordered mesh, bvh).  The
    permutation is applied to every per-face tensor."""
    v0 = mesh.v0.cpu().numpy().astype(np.float64)
    v1 = v0 + mesh.e1.cpu().numpy().astype(np.float64)
    v2 = v0 + mesh.e2.cpu().numpy().astype(np.float64)
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    bvh, order = build_bvh((v0 + v1 + v2) / 3.0, bmin, bmax, leaf_size, method)
    perm = torch.from_numpy(order).to(mesh.device)
    return mesh.map(lambda a: a[perm]), bvh.to(mesh.device)


def build_sphere_bvh(spheres, leaf_size: int = 16, method: str = "auto"):
    """BVH over the active spheres of a Spheres SoA.  Returns (reordered
    spheres, bvh): active spheres in leaf order, inactive pad slots
    (radius <= 0) at the tail, outside every leaf."""
    radii = spheres.radii.cpu().numpy()
    active = np.flatnonzero(radii > 0.0)
    inactive = np.flatnonzero(radii <= 0.0)
    if active.size == 0:
        raise ValueError("no active spheres to build a BVH over")
    centers = spheres.centers.cpu().numpy().astype(np.float64)[active]
    r = radii[active][:, None].astype(np.float64)
    bvh, order = build_bvh(centers, centers - r, centers + r, leaf_size, method)
    perm = torch.from_numpy(np.concatenate([active[order], inactive])).to(spheres.device)
    reordered = type(spheres)(*(getattr(spheres, f.name)[perm]
                                for f in dataclasses.fields(spheres)))
    return reordered, bvh.to(spheres.device)


def validate_bvh(bvh: BVH, num_primitives: int) -> None:
    """Structural checks: links in range and forward, leaves disjoint and
    covering every primitive."""
    m = bvh.num_nodes
    miss = bvh.miss_link.cpu().numpy()
    start = bvh.leaf_start.cpu().numpy()
    count = bvh.leaf_count.cpu().numpy()
    assert np.all((miss >= -1) & (miss < m)), "miss link out of range"
    leaves = start >= 0
    assert np.all(count[leaves] > 0)
    assert np.all(count[~leaves] == 0)
    covered = np.zeros(num_primitives, bool)
    for s, c in zip(start[leaves], count[leaves]):
        assert not covered[s : s + c].any(), "leaf ranges overlap"
        covered[s : s + c] = True
    assert covered.all(), "leaves do not cover all primitives"
    assert np.all((miss == -1) | (miss > np.arange(m))), "miss links must go forward"
