"""The work a traced ray needs: the roofline's operations, counted once a
configuration by the reference's own walk over a BVH the reference builds.

The BVH is bvh.py's binary tree over every primitive (sphere and face) by
the surface-area heuristic, leaves of at most 4.  A query (a closest hit, or a
shadow ray up to its occluder or its light) needs the boxes and primitives
of every node whose box the ray enters before the query's answer: a walk
that visits nodes front to back tests the root's box, both children of
each interior node it visits, and every primitive of each leaf it visits.
That is counted, not the most a walk could do: what these inputs need.

Costs (f32 operations): 23 a box (slab test), 17 a sphere test and 6 more
for its roots where the discriminant is not negative, 45 a face
(Moller-Trumbore).  `python -m rtbench.reference.work <config>` prints the
count for a configuration file.  Rays are counted in blocks, so that the
(rays, nodes) planes stay within BLOCK_BYTES whatever the scene's size.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from rtbench.reference import bvh, tracer

BOX_FLOPS = 23
SPHERE_FLOPS = 17
ROOT_FLOPS = 6
FACE_FLOPS = 45
LEAF_SIZE = 4
BLOCK_BYTES = 1 << 30  # a block of rays: (rays, nodes, 3) f64 planes, a few alive


def primitive_boxes(sc: tracer.Scene) -> tuple[np.ndarray, np.ndarray, int]:
    """(lo, hi) of every sphere, then every face; and the sphere count."""
    c = sc.centers.cpu().double().numpy()
    r = sc.radii.cpu().double().numpy()[:, None]
    v0 = sc.v0.cpu().double().numpy()
    v1, v2 = v0 + sc.e1.cpu().double().numpy(), v0 + sc.e2.cpu().double().numpy()
    lo = np.concatenate([c - r, np.minimum(np.minimum(v0, v1), v2)])
    hi = np.concatenate([c + r, np.maximum(np.maximum(v0, v1), v2)])
    return lo, hi, len(c)


class Counter:
    """Sums the operations of the queries `tracer.trace` records."""

    def __init__(self, sc: tracer.Scene, t_min: float):
        self.sc, self.t_min = sc, t_min
        lo, hi, self.n_spheres = primitive_boxes(sc)
        self.tree = bvh.build(lo, hi, LEAF_SIZE)
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
        block = max(1, BLOCK_BYTES // (8 * 3 * 8 * len(self.tree.prims)))
        for s in range(0, o.shape[0], block):
            self.ops += self._ops(o[s:s + block], d[s:s + block], t_end[s:s + block])
        self.queries[kind] += o.shape[0]

    def _ops(self, o, d, t_end) -> float:
        """The operations of one block of queries."""
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
        return float(ops.sum())

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
