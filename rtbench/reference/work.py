"""The work a traced ray needs: the roofline's operations, counted once a
configuration by the reference's own walk over a BVH the reference builds.

The BVH is a binary tree over every primitive (sphere and face) by the
surface-area heuristic, leaves of at most 4.  A query (a closest hit, or a
shadow ray up to its occluder or its light) needs the boxes and primitives
of every node whose box the ray enters before the query's answer: a walk
that visits nodes front to back tests the root's box, both children of
each interior node it visits, and every primitive of each leaf it visits.
That is counted, not the most a walk could do: what these inputs need.

Costs (f32 operations): 23 a box (slab test), 17 a sphere test and 6 more
for its roots where the discriminant is not negative, 45 a face
(Moller-Trumbore).  `python -m rtbench.reference.work <config>` prints the
count for a configuration file.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from rtbench.reference import tracer

BOX_FLOPS = 23
SPHERE_FLOPS = 17
ROOT_FLOPS = 6
FACE_FLOPS = 45
LEAF_SIZE = 4


@dataclasses.dataclass
class Tree:
    lo: np.ndarray  # (M, 3) node boxes
    hi: np.ndarray
    left: np.ndarray  # (M,) child ids, -1 at a leaf
    right: np.ndarray
    prims: list  # per node: the primitive ids of a leaf, [] inside


def primitive_boxes(sc: tracer.Scene) -> tuple[np.ndarray, np.ndarray, int]:
    """(lo, hi) of every sphere, then every face; and the sphere count."""
    c = sc.centers.cpu().double().numpy()
    r = sc.radii.cpu().double().numpy()[:, None]
    v0 = sc.v0.cpu().double().numpy()
    v1, v2 = v0 + sc.e1.cpu().double().numpy(), v0 + sc.e2.cpu().double().numpy()
    lo = np.concatenate([c - r, np.minimum(np.minimum(v0, v1), v2)])
    hi = np.concatenate([c + r, np.maximum(np.maximum(v0, v1), v2)])
    return lo, hi, len(c)


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def build(lo: np.ndarray, hi: np.ndarray) -> Tree:
    """SAH over primitive centroids, a full sweep of each axis."""
    nodes_lo, nodes_hi, left, right, prims = [], [], [], [], []
    cent = 0.5 * (lo + hi)

    def node(ids: np.ndarray) -> int:
        k = len(nodes_lo)
        nodes_lo.append(lo[ids].min(0))
        nodes_hi.append(hi[ids].max(0))
        left.append(-1)
        right.append(-1)
        prims.append([])
        if len(ids) <= LEAF_SIZE:
            prims[k] = [int(i) for i in ids]
            return k
        best = (np.inf, None)
        for ax in range(3):
            order = ids[np.argsort(cent[ids, ax], kind="stable")]
            l_lo = np.minimum.accumulate(lo[order], 0)
            l_hi = np.maximum.accumulate(hi[order], 0)
            r_lo = np.minimum.accumulate(lo[order][::-1], 0)[::-1]
            r_hi = np.maximum.accumulate(hi[order][::-1], 0)[::-1]
            n = np.arange(1, len(order))
            cost = (_area(l_lo[:-1], l_hi[:-1]) * n
                    + _area(r_lo[1:], r_hi[1:]) * (len(order) - n))
            j = int(np.argmin(cost))
            if cost[j] < best[0]:
                best = (cost[j], (order[:j + 1], order[j + 1:]))
        a, b = best[1]
        left[k], right[k] = node(a), node(b)
        return k

    node(np.arange(len(lo)))
    return Tree(np.asarray(nodes_lo), np.asarray(nodes_hi), np.asarray(left),
                np.asarray(right), prims)


class Counter:
    """Sums the operations of the queries `tracer.trace` records."""

    def __init__(self, sc: tracer.Scene, t_min: float):
        self.sc, self.t_min = sc, t_min
        lo, hi, self.n_spheres = primitive_boxes(sc)
        self.tree = build(lo, hi)
        dev = sc.centers.device
        self.lo = torch.as_tensor(self.tree.lo, dtype=torch.float64, device=dev)
        self.hi = torch.as_tensor(self.tree.hi, dtype=torch.float64, device=dev)
        leaf = self.tree.left < 0
        n_sph = [sum(p < self.n_spheres for p in ps) for ps in self.tree.prims]
        n_face = [sum(p >= self.n_spheres for p in ps) for ps in self.tree.prims]
        self.boxes = torch.as_tensor(np.where(leaf, 0, 2), dtype=torch.float64, device=dev)
        self.leaf_ops = torch.as_tensor(
            np.asarray(n_sph) * SPHERE_FLOPS + np.asarray(n_face) * FACE_FLOPS,
            dtype=torch.float64, device=dev)
        # (M, N): the spheres of each leaf, for the roots.
        member = np.zeros((len(leaf), self.n_spheres), bool)
        for k, ps in enumerate(self.tree.prims):
            for p in ps:
                if p < self.n_spheres:
                    member[k, p] = True
        self.member = torch.as_tensor(member, device=dev)
        self.queries = {"closest": 0, "shadow": 0}
        self.ops = 0.0

    def __call__(self, kind: str, o, d, t_end) -> None:
        if o.shape[0] == 0:
            return
        o64, d64, t64 = o.double(), d.double(), t_end.double()
        inv = 1.0 / torch.where(d64 == 0.0, 1e-30, d64)
        t0 = (self.lo[None] - o64[:, None]) * inv[:, None]
        t1 = (self.hi[None] - o64[:, None]) * inv[:, None]
        tn = torch.minimum(t0, t1).amax(-1).clamp(min=self.t_min)
        tf = torch.maximum(t0, t1).amin(-1)
        tf = torch.minimum(tf, t64[:, None])
        visited = (tn <= tf).double()  # (P, M)
        ops = BOX_FLOPS * (1.0 + visited @ self.boxes) + visited @ self.leaf_ops
        # Roots: sphere tests in visited leaves whose discriminant is >= 0.
        c, r = self.sc.centers.double(), self.sc.radii.double()
        oc = c[None] - o64[:, None]
        h = (oc * d64[:, None]).sum(-1)
        a = (d64 * d64).sum(-1, keepdim=True)
        disc = h * h - a * ((oc * oc).sum(-1) - r * r)
        tested = (visited @ self.member.double()) > 0  # (P, N)
        ops = ops + ROOT_FLOPS * ((disc >= 0.0) & tested).sum(-1)
        self.ops += float(ops.sum())
        self.queries[kind] += o.shape[0]

    @property
    def per_ray(self) -> float:
        return self.ops / max(1, sum(self.queries.values()))


def count(config: dict, n_pixels: int = 8192, seed: int = 0, device="cpu") -> dict:
    """Trace 1 sample of `n_pixels` pixels (drawn from `seed`) of the
    configuration's frame on scene seed `seed`, and return the operations
    a traced ray needs, with what they were counted from."""
    from rtbench import spec  # noqa: PLC0415 - the harness's config loading

    data = spec.scene_data(config, seed)
    sc = tracer.build_scene(data, device)
    w, h = config["width"], config["height"]
    cam = tracer.derive_camera(data.camera, w, h, device)
    opt = tracer.Options(**spec.trace_options(config))
    counter = Counter(sc, opt.t_min)
    rng = np.random.default_rng(seed)
    pid = torch.as_tensor(np.sort(rng.choice(w * h, n_pixels, replace=False)),
                          dtype=torch.int64, device=device)
    fs = torch.zeros_like(pid)
    tracer.render_pixels(sc, cam, pid, fs, width=w, spp=1, opt=opt, record=counter)
    return {"flops": counter.per_ray, "queries": dict(counter.queries),
            "nodes": len(counter.tree.prims), "pixels": n_pixels, "seed": seed}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count(json.load(f))))
