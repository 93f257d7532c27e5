"""Closest hits: spheres, triangles and the threaded mesh BVH (port of
gpu_ray_tracing_tpu/ops/intersect.py).

Every (ray, sphere) pair solves the reference's quadratic (wgsl:182-221)
at once on (P, N) planes: each sphere picks its near root, or its far
root when the near one is outside (t_min, t_max), and the closest hit is
the minimum over spheres.  That equals the reference's sequential
shrinking-window scan, ties going to the lower sphere index.  Triangles
use Moller-Trumbore; `intersect_bvh` walks the threaded BVH of
ops/bvh.py with one cursor per ray.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.spheres import Spheres
from gpu_ray_tracing_tpu_torch.ops.rounding import cross, dot3, fma, sqrt

# While this is a dict, every all-spheres scan (`_sphere_roots`) adds its
# (ray, active sphere) tests under "tests" and those whose discriminant is
# not negative, the ones that need the roots, under "roots" (0-d tensors
# on the scan's device).  chip_smoke.py reads it to count the least work
# of a frame's closest hits; it is None otherwise.
SPHERE_TESTS: dict | None = None

# While this is a dict, the walks that are asked to count (`count=` of
# intersect_bvh and walk_sphere_bvh; `count_walks`) add what they did under
# BVH_VISITS[count]: "nodes" visited, "leaves" entered, "faces" and
# "spheres" tested, "roots" (sphere tests whose discriminant is not
# negative) and "rays" (ints).  The plain integrator asks for it on its
# live rays ("closest") and its shadow rays ("shadow"), so chip_smoke.py
# counts the walks a frame needs; it is None otherwise.
BVH_VISITS: dict | None = None


def _visit(count: str | None, **added) -> None:
    """Add `added` (ints or 0-d tensors) under BVH_VISITS[count]."""
    if BVH_VISITS is None or count is None:
        return
    slot = BVH_VISITS.setdefault(count, {})
    for k, v in added.items():
        slot[k] = slot.get(k, 0) + int(v)


@dataclasses.dataclass(frozen=True)
class Hit:
    """Vectorized HitRecord (wgsl:143-149); the material is looked up by idx."""

    t: torch.Tensor  # (...,) ray parameter of the closest hit (t_max if none)
    idx: torch.Tensor  # (...,) int64 index of the winning sphere or face (0 if none)
    hit: torch.Tensor  # (...,) bool
    point: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) face normal, flipped toward the ray
    front_face: torch.Tensor  # (...,) bool


def _roots(o, d, c, r, t_min: float, t_max: float, count: dict | None = None):
    """The reference's near-then-far root pick for rays o, d (P, 1, 3)
    against spheres c (..., 3), r (...) that broadcast with them: every
    sphere ((N, 3), (N,): (P, N) planes) or one sphere a ray ((P, 1, 3),
    (P, 1)).  Returns (root, valid).  Each element is the same arithmetic
    either way, so a ray's root against its own sphere equals that
    sphere's entry of the planes bit for bit.

    Its inner products and discriminant round as fused multiply-adds, as
    XLA:CPU rounds them (see ops/rounding.py): a ray leaving a surface
    starts with |o - c|^2 - r^2 near 0, where the last bit decides whether
    it hits its own sphere again.  With `count` (SPHERE_TESTS), adds the
    planes' tests and roots to it.
    """
    dc = dot3(d, c)  # d . c
    oc_dot_c = dot3(o, c)  # o . c
    od = dot3(o, d)
    oo = dot3(o, o)
    a = dot3(d, d)
    c2 = dot3(c, c)

    h = dc - od  # dot(center - origin, d)   (wgsl:185)
    cc = (c2 - r * r) - 2.0 * oc_dot_c + oo  # |oc|^2 - r^2 (wgsl:186)
    disc = fma(h, h, -(a * cc))  # h^2 - a*cc (wgsl:187)
    if count is not None:
        active = r > 0.0
        count["tests"] = count["tests"] + active.sum() * (disc.numel() // active.numel())
        count["roots"] = count["roots"] + ((disc >= 0.0) & active).sum()

    disc_pos = disc > 0.0
    sqrt_disc = torch.where(
        disc_pos, sqrt(torch.where(disc_pos, disc, 1.0)), 0.0
    )
    inv_a = 1.0 / a
    root_near = (h - sqrt_disc) * inv_a  # (wgsl:195)
    root_far = (h + sqrt_disc) * inv_a  # (wgsl:197)

    near_ok = (root_near > t_min) & (root_near < t_max)
    far_ok = (root_far > t_min) & (root_far < t_max)
    root = torch.where(near_ok, root_near, root_far)
    valid = (disc >= 0.0) & (near_ok | far_ok) & (r > 0.0)
    return root, valid


def _sphere_roots(o, d, spheres: Spheres, t_min: float, t_max: float):
    """All-spheres quadratic for flat rays (P, 3): ((P, N) root, (P, N)
    valid); inactive pad spheres (radius <= 0) are never valid."""
    return _roots(o[:, None, :], d[:, None, :], spheres.centers, spheres.radii, t_min, t_max,
                  SPHERE_TESTS)


def intersect_spheres(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    spheres: Spheres,
    t_min: float,
    t_max: float,
) -> Hit:
    """Closest sphere hit for a batch of rays (..., 3); inactive pad
    spheres (radius <= 0) never hit.

    Gradients are straight-through, as intersect_bvh's: the (P, N) scan
    runs without autograd and fixes the winning sphere, then the winner's
    root is recomputed differentiably from its own center and radius (the
    same value: `_roots`).  That is the gradient of the scan's minimum,
    and the graph autograd keeps is O(P), not O(P N).
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)

    with torch.no_grad():
        root, valid = _sphere_roots(o, d, spheres, t_min, t_max)
        t_cand = torch.where(valid, root, torch.inf)
        t_best, idx = torch.min(t_cand, dim=-1)
    hit = torch.isfinite(t_best)

    center_best = spheres.centers[idx]
    radius_best = spheres.radii[idx]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (o, d, center_best, radius_best)):
        t_best, _ = _roots(o[:, None, :], d[:, None, :], center_best[:, None, :],
                           radius_best[:, None], t_min, t_max)
        t_best = t_best[:, 0]
    t_best = torch.where(hit, t_best, t_max)
    # Misses keep t = t_max in the record but must not build a ~1e35 point.
    t_point = torch.where(hit, t_best, 0.0)
    # o + t d rounded once, as XLA:CPU fuses it: the point decides whether
    # the next ray leaves the surface (a metal sphere at ~400 units or the
    # Cornell ceiling flip on its last bit).
    point = fma(t_point[:, None], d, o)
    # Outward normal = (p - center) / radius (wgsl:206); guard pad radius 0.
    safe_r = torch.where(radius_best != 0.0, radius_best, 1.0)
    outward = (point - center_best) / safe_r[:, None]
    front_face = torch.sum(d * outward, dim=-1) < 0.0  # (wgsl:159)
    normal = torch.where(front_face[:, None], outward, -outward)  # (wgsl:160)

    return Hit(
        t=t_best.reshape(batch_shape),
        idx=idx.reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        point=point.reshape(*batch_shape, 3),
        normal=normal.reshape(*batch_shape, 3),
        front_face=front_face.reshape(batch_shape),
    )


def nearest_t_spheres(origins, dirs, spheres: Spheres, t_min: float,
                      t_max: float) -> torch.Tensor:
    """Shadow-ray variant of intersect_spheres: the nearest valid t only
    (t_max where nothing hits)."""
    batch_shape = origins.shape[:-1]
    root, valid = _sphere_roots(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                                spheres, t_min, t_max)
    t = torch.amin(torch.where(valid, root, t_max), dim=-1)
    return t.reshape(batch_shape)


# --- triangles ---------------------------------------------------------------


def _moller_trumbore(o, d, v0, e1, e2, t_min: float, t_max):
    """Moller-Trumbore for broadcast rays and triangles (..., 3): returns
    (t, u, v, hit) with the open (t_min, t_max) test; t_max may be a
    tensor (the shrinking window).  The cross and inner products round as
    XLA:CPU rounds them (ops/rounding.py): the mesh_ico golden carries it."""
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    near_parallel = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(near_parallel, 1.0, det)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (~near_parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return t, u, v, hit


def intersect_triangles(origins, dirs, mesh, t_min: float, t_max: float) -> Hit:
    """Brute-force closest hit over every triangle, on (P, F) planes (for
    tests and meshes without a BVH)."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    t, _, _, hit = _moller_trumbore(o[:, None, :], d[:, None, :], mesh.v0[None],
                                    mesh.e1[None], mesh.e2[None], t_min, t_max)
    t_best, idx = torch.min(torch.where(hit, t, torch.inf), dim=-1)
    any_hit = torch.isfinite(t_best)
    t_best = torch.where(any_hit, t_best, t_max)
    return _mesh_hit_record(o, d, mesh, t_best, idx, any_hit, batch_shape)


def _mesh_hit_record(o, d, mesh, t_best, idx, any_hit, batch_shape) -> Hit:
    """Hit record of the winning faces: the flat normal, or with smooth
    corner normals the barycentric blend of the winner (its u, v
    recomputed), renormalized; then flipped toward the ray."""
    point = fma(torch.where(any_hit, t_best, 0.0)[:, None], d, o)  # as spheres
    if mesh.smooth:
        _, u, v, _ = _moller_trumbore(o, d, mesh.v0[idx], mesh.e1[idx], mesh.e2[idx],
                                      0.0, 0.0)
        outward = ((1.0 - u - v)[:, None] * mesh.n0[idx] + u[:, None] * mesh.n1[idx]
                   + v[:, None] * mesh.n2[idx])
        norm = sqrt(torch.sum(outward * outward, dim=-1, keepdim=True))
        outward = outward / torch.clamp(norm, min=1e-20)
    else:
        outward = mesh.normals[idx]
    front_face = torch.sum(d * outward, dim=-1) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return Hit(
        t=t_best.reshape(batch_shape),
        idx=idx.reshape(batch_shape),
        hit=any_hit.reshape(batch_shape),
        point=point.reshape(*batch_shape, 3),
        normal=normal.reshape(*batch_shape, 3),
        front_face=front_face.reshape(batch_shape),
    )


def intersect_bvh(origins, dirs, mesh, bvh, t_min: float, t_max,
                  count: str | None = None) -> Hit:
    """Stackless threaded-BVH closest hit (ops/bvh.py layout).

    Every ray carries one cursor: a box whose slab interval overlaps the
    ray's window (t_min, t_best) descends to node + 1 (inner) or scans its
    leaf; otherwise the cursor follows the miss link, and -1 ends the
    walk.  Rays whose walk has ended leave the working set, so the loop
    costs the sum of the rays' visits, not their maximum times the ray
    count.  A leaf's faces are tested together: the winner is the first
    face of least t, which is what a sequential shrinking-window scan
    keeps.

    Gradients are straight-through, as in JAX's intersect_bvh: the walk
    runs on detached inputs and fixes which face wins, then the winner's t
    is recomputed with one differentiable Moller-Trumbore of that face
    (the same function of the same inputs, so the same value), and the hit
    record is built from it.

    `t_max` is a float, or one window a ray ((...,) tensor: the kernel's
    mesh walk starts from the spheres' closest hit).  With `count` it adds
    the nodes it visited, the leaves it entered and the faces it tested to
    BVH_VISITS[count] (while that is a dict): the kernel's walk, which
    visits the same nodes in the same order and tests every face of an
    entered leaf.
    """
    batch_shape = origins.shape[:-1]
    o_diff = origins.reshape(-1, 3)
    d_diff = dirs.reshape(-1, 3)
    mesh_diff = mesh
    o, d = o_diff.detach(), d_diff.detach()
    mesh = mesh.map(torch.Tensor.detach)
    p = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    if isinstance(t_max, torch.Tensor):
        t_max = t_max.detach().reshape(p).to(torch.float32)
        t_out = t_max.clone()
    else:
        t_out = torch.full((p,), t_max, dtype=torch.float32, device=dev)
    idx_out = torch.full((p,), -1, dtype=torch.int64, device=dev)
    counting = BVH_VISITS is not None and count is not None

    ids = torch.arange(p, device=dev)
    node = torch.zeros(p, dtype=torch.int64, device=dev)
    so, sd, sinv = o, d, inv_d
    tb, ib = t_out.clone(), idx_out.clone()
    miss = bvh.miss_link.long()
    lstart = bvh.leaf_start.long()
    lcount = bvh.leaf_count.long()
    ks = torch.arange(bvh.leaf_size, device=dev)
    while ids.numel():
        if counting:
            _visit(count, nodes=ids.numel())
        t0 = (bvh.bbox_min[node] - so) * sinv
        t1 = (bvh.bbox_max[node] - so) * sinv
        tn = torch.amax(torch.minimum(t0, t1), dim=-1)
        tf = torch.amin(torch.maximum(t0, t1), dim=-1)
        box_hit = (tf >= torch.clamp(tn, min=t_min)) & (tn < tb)
        ls = lstart[node]
        is_leaf = ls >= 0
        leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if leaf.numel():
            tri = ls[leaf, None] + ks  # (L, K)
            valid = ks < lcount[node[leaf], None]
            tri = torch.where(valid, tri, 0)
            if counting:
                _visit(count, leaves=leaf.numel(), faces=valid.sum())
            t, _, _, hit = _moller_trumbore(
                so[leaf, None], sd[leaf, None], mesh.v0[tri], mesh.e1[tri], mesh.e2[tri],
                t_min, tb[leaf, None])
            t_leaf, k = torch.min(torch.where(valid & hit, t, torch.inf), dim=-1)
            take = torch.isfinite(t_leaf)
            tb[leaf] = torch.where(take, t_leaf, tb[leaf])
            ib[leaf] = torch.where(take, tri.gather(1, k[:, None]).squeeze(1), ib[leaf])
        node = torch.where(box_hit & ~is_leaf, node + 1, miss[node])
        done = node < 0
        if bool(done.any()):
            t_out[ids[done]] = tb[done]
            idx_out[ids[done]] = ib[done]
            keep = ~done
            ids, node, so, sd, sinv, tb, ib = (
                x[keep] for x in (ids, node, so, sd, sinv, tb, ib))

    any_hit = idx_out >= 0
    idx = torch.where(any_hit, idx_out, 0)
    t_re, _, _, _ = _moller_trumbore(o_diff, d_diff, mesh_diff.v0[idx], mesh_diff.e1[idx],
                                     mesh_diff.e2[idx], t_min, t_max)
    t_best = torch.where(any_hit, t_re, t_max)
    return _mesh_hit_record(o_diff, d_diff, mesh_diff, t_best, idx, any_hit, batch_shape)


# --- counting the kernel's walks ---------------------------------------------


def walk_sphere_bvh(origins, dirs, spheres: Spheres, bvh, t_min: float, t_max,
                    count: str | None = None):
    """The CUDA kernel's closest hit through a sphere BVH, in plain
    PyTorch: one cursor a ray over the threaded tree (ops/bvh.py), a box
    entered when its slab interval overlaps (t_min, tb), and each entered
    leaf's spheres tested one after another against the shrinking window
    tb with the near-then-far root pick (`_roots`), strict `<` (the first
    of equal roots wins).  Leaves lie in index order along the walk, so a
    winner is the one of least t and least index among the spheres of the
    leaves entered.  `t_max` is a float or one window a ray.  Returns ((P,)
    t, (P,) int64 index or -1, (P,) hit) for flat rays (P, 3).  With
    `count` it adds its nodes, leaves, sphere tests (active spheres) and
    roots to BVH_VISITS[count].

    The plain integrator scans every sphere instead (intersect_spheres);
    this walk serves the counters and the tests."""
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    p, dev = o.shape[0], o.device
    if isinstance(t_max, torch.Tensor):
        tb = t_max.reshape(p).to(torch.float32).clone()
    else:
        tb = torch.full((p,), t_max, dtype=torch.float32, device=dev)
    t_out, best_out = tb.clone(), torch.full((p,), -1, dtype=torch.int64, device=dev)
    best = best_out.clone()
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    ids = torch.arange(p, device=dev)
    node = torch.zeros(p, dtype=torch.int64, device=dev)
    miss, lstart, lcount = (x.long() for x in (bvh.miss_link, bvh.leaf_start, bvh.leaf_count))
    centers, radii = spheres.centers, spheres.radii
    ks = torch.arange(bvh.leaf_size, device=dev)
    so, sd, sinv = o, d, inv
    while ids.numel():
        _visit(count, nodes=ids.numel())
        t0 = (bvh.bbox_min[node] - so) * sinv
        t1 = (bvh.bbox_max[node] - so) * sinv
        tn = torch.amax(torch.minimum(t0, t1), dim=-1)
        tf = torch.amin(torch.maximum(t0, t1), dim=-1)
        box_hit = (tf >= torch.clamp(tn, min=t_min)) & (tn < tb)
        ls = lstart[node]
        leaf = torch.nonzero(box_hit & (ls >= 0)).squeeze(1)
        if leaf.numel():
            # The leaf's spheres against the window at its entry: the
            # window only shrinks, so a sphere the one-by-one scan takes is
            # one whose root here is below the window so far, and the scan
            # ends on the first sphere of least root.
            j = ls[leaf, None] + ks
            real = ks < lcount[node[leaf], None]
            j = torch.where(real, j, 0)
            tally = {"tests": 0, "roots": 0}
            root, valid = _roots(so[leaf, None], sd[leaf, None], centers[j],
                                 torch.where(real, radii[j], 0.0), t_min, tb[leaf, None], tally)
            _visit(count, leaves=leaf.numel(), spheres=tally["tests"], roots=tally["roots"])
            t_leaf, k = torch.min(torch.where(valid, root, torch.inf), dim=-1)
            take = t_leaf < tb[leaf]
            tb[leaf] = torch.where(take, t_leaf, tb[leaf])
            best[leaf] = torch.where(take, j.gather(1, k[:, None]).squeeze(1), best[leaf])
        node = torch.where(box_hit & (ls < 0), node + 1, miss[node])
        done = node < 0
        if bool(done.any()):
            t_out[ids[done]] = tb[done]
            best_out[ids[done]] = best[done]
            keep = ~done
            ids, node, so, sd, sinv, tb, best = (
                x[keep] for x in (ids, node, so, sd, sinv, tb, best))
    return t_out, best_out, best_out >= 0


def count_walks(origins, dirs, sc, t_min: float, t_max, count: str) -> None:
    """Add to BVH_VISITS[count] the work of the CUDA kernel's closest-hit
    query for flat rays (P, 3) in the window (t_min, t_max) (a float or
    one a ray) on scene `sc`: the rays, then the spheres (the sphere-BVH
    walk, or every active sphere of the brute scan with its roots), then
    the mesh walk from the spheres' closest hit, as the kernel orders
    them.  A shadow ray's any-hit query ends at its first blocker, so for
    shadow rays this counts at least the kernel's work."""
    if BVH_VISITS is None:
        return
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    _visit(count, rays=o.shape[0])
    if o.shape[0] == 0:
        return
    with torch.no_grad():
        if sc.sphere_bvh is not None:
            t_s, _, _ = walk_sphere_bvh(o, d, sc.spheres, sc.sphere_bvh, t_min, t_max, count)
        elif sc.spheres.count == 0:
            t_s = t_max
        else:
            window = t_max.reshape(-1, 1) if isinstance(t_max, torch.Tensor) else t_max
            tally = {"tests": 0, "roots": 0}
            root, valid = _roots(o[:, None, :], d[:, None, :], sc.spheres.centers,
                                 sc.spheres.radii, t_min, window, tally)
            _visit(count, spheres=tally["tests"], roots=tally["roots"])
            far = (t_max.reshape(-1, 1) if isinstance(t_max, torch.Tensor)
                   else torch.full_like(root[:, :1], t_max))
            t_s = torch.amin(torch.where(valid, root, far), dim=-1)
        if sc.mesh is not None and sc.bvh is not None:
            intersect_bvh(o, d, sc.mesh, sc.bvh, t_min, t_s, count=count)
