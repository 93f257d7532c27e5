"""Which faces a ray has to test: the reference tracer's exact culling.

The faces are grouped by bvh.py's SAH tree (leaves of at most LEAF faces),
and the tree is cut into levels: the largest subtrees of at most
LEAF * BRANCH**j faces for j = J-1 .. 0, where LEAF * BRANCH**J is the
least that holds every face; the last level is the leaves.  A cluster of
one level is a union of clusters of the next.  Each cluster keeps a box,
a cone that holds its faces' unit normals (up to sign), the largest shape
factor K = |e1| |e2| / |e1 x e2| of its faces and the largest rounding pad
of its corners.  A ray descends from every cluster of the first level into
those whose box, widened by a pad that bounds Moller-Trumbore's rounding
(below), it enters inside (t_min, t_max); the faces of the leaves it
reaches are its candidates.  Rays are walked in chunks of at most
CHUNK_PAIRS (ray, cluster) pairs, so memory follows BUDGET_BYTES and not
the face count.

Why no face that tracer._tri_t accepts is culled.  Take a face (v0, e1,
e2) and a ray (o, d), all f32 values, read as exact reals; tvec = o - v0,
n = e1 x e2.  Cramer's rule gives the identity
    det tvec = -N_t d + N_u e1 + N_v e2,
with det = e1.(d x e2) = -d.n, N_u = tvec.(d x e2), N_v = d.(tvec x e1),
N_t = e2.(tvec x e1) = tvec.n.  _tri_t forms each of these with f32
products, f32 differences and fused multiply-adds rounded once (to f64 and
then to f32): each computed value is within 16 u |a| |b| |c| of the exact
one, u = 2^-24, |a| |b| |c| the norms of its three factors (tvec's own
rounding included; the worst case is under 7.5 u, so 16 u keeps a factor
of 2 for the f64 arithmetic of the bounds below).  Writing the computed
values with hats and t~ = N^_t / det^, u~, v~ likewise,
    o + t~ d + R = v0 + u~ e1 + v~ e2,
    |R| <= 64 u |tvec| |d| |e1| |e2| / |det^|.
Two lower bounds on |det^| give two bounds on |R|:
  A. |det^| >= |d| |n| s - 16 u |e1| |d| |e2|, s = |d.n| / (|d| |n|):
     |R| <= 4 e |tvec| / (s - e), e = 16 u K;
  B. |det^| = |N^_t| / t~ >= (|n| h - 16 u |tvec| |e1| |e2|) / t~,
     h = |tvec.n| / |n| the origin's height over the face's plane:
     |R| <= t~ |d| b, b = 4 e |tvec| / (h - e |tvec|).
A catches rays that cross the face's plane steeply, B origins that lie
off it; a ray that lies in the plane itself has neither and is never
culled.  An accepted face has t_min < t^ < t_max and u^, v^ >= 0,
u^ + v^ <= 1, with t^ = t~ (1 + 2.01 u) at most and u~, v~ as near to u^,
v^: so t~ lies in (t_min, t_max) widened by 8 u, and v0 + u~ e1 + v~ e2 in
the face's box widened by 8 u (|e1| + |e2|) ("tri_pad").  So the point
o + t~ d lies in the box widened by |R| + tri_pad.  Over a cluster: |tvec|
is at most the origin's distance to the box's farthest corner, K at most
the cluster's, s at least what the cone leaves between d and the plane of
any face, h at least the origin's distance from the plane of any face
(the cone again, from the box's centre, less the box's radius), and in B,
t~ |d| is at most that farthest distance + |R| + 2 tri_pad.  The slab test
then runs in f64 on the box widened by that pad, plus 1e-12 of the
coordinates for the test's own rounding; an axis along which d is 0 keeps
the ray where o lies inside the widened slab.  A bound that cannot be
formed (a degenerate face's K is infinite, a cone wider than a half
space, a bound that is not a number) leaves the pad infinite: the
cluster is kept.

Spheres are not culled: tracer.py tests every sphere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench.reference import bvh

LEAF = 8
BRANCH = 8
BUDGET_BYTES = 1 << 30
CHUNK_PAIRS = BUDGET_BYTES // 512  # a (ray, cluster) pair's f64 planes while it is tested
U = 2.0 ** -24
E = 16 * U  # the rounding of one of _tri_t's products, over its factors' norms
SLACK = 1e-9  # the rounding of the cones' cosines


# Columns of Level.data, a cluster a row.
CENTER, HALF, AXIS = slice(0, 3), slice(3, 6), slice(6, 9)
COS_A, SIN_A, RADIUS, EXTENT, ERR, TRI_PAD = 9, 10, 11, 12, 13, 14


@dataclasses.dataclass
class Level:
    """Clusters of one level.  `data` (C, 15) f64: the box's centre and
    half sides, the cone's axis, cosine and sine, the box's radius, its
    largest |coordinate|, E K and tri_pad.  [first, first + count) are the
    children's rows in the next level, or on the last level the faces'
    positions in `Clusters.order`."""

    data: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor


@dataclasses.dataclass
class Clusters:
    levels: list
    order: torch.Tensor  # face ids, each leaf's faces together


def _faces(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> dict:
    """Per face, in f64: box, oriented unit normal, K and tri_pad."""
    a, b, c = v0, v0 + e1, v0 + e2
    n = np.cross(e1, e2)  # a product of f32 values is exact in f64: n to 1 ulp
    nn = np.linalg.norm(n, axis=-1)
    l1, l2 = np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(nn > 0.0, l1 * l2 / nn * (1.0 + SLACK), np.inf)
        unit = np.where(nn[:, None] > 0.0, n / nn[:, None], 0.0)
    return dict(lo=np.minimum(np.minimum(a, b), c), hi=np.maximum(np.maximum(a, b), c),
                unit=unit, k=k, tri_pad=8 * U * (l1 + l2) + 1e-30)


def _level(f: dict, order: np.ndarray, start: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Level.data of the clusters whose faces are order[start : start + count]."""
    lo = np.minimum.reduceat(f["lo"][order], start)
    hi = np.maximum.reduceat(f["hi"][order], start)
    unit = f["unit"][order]
    ref = np.repeat(unit[start], count, axis=0)
    unit = unit * np.where((unit * ref).sum(-1) < 0.0, -1.0, 1.0)[:, None]
    axis = np.add.reduceat(unit, start)
    length = np.linalg.norm(axis, axis=-1)
    axis = np.where(length[:, None] > 0.0, axis / np.maximum(length, 1e-300)[:, None],
                    np.asarray([1.0, 0.0, 0.0]))
    dots = (unit * np.repeat(axis, count, axis=0)).sum(-1)
    dots = np.where(np.isfinite(f["k"][order]), dots, 1.0)  # degenerate faces: K says
    cos_a = np.minimum.reduceat(dots, start) - SLACK
    cos_a = np.where(length > 0.0, cos_a, -1.0)
    wide = cos_a <= 0.0  # no plane of the cluster is bounded away from any ray
    cos_a = np.where(wide, 0.0, cos_a)
    data = np.zeros((len(start), 15))
    data[:, CENTER], data[:, HALF], data[:, AXIS] = 0.5 * (lo + hi), 0.5 * (hi - lo), axis
    data[:, COS_A] = cos_a
    data[:, SIN_A] = np.where(wide, 1.0, np.sqrt(np.maximum(1.0 - cos_a * cos_a, 0.0)))
    data[:, RADIUS] = 0.5 * np.linalg.norm(hi - lo, axis=-1) * (1.0 + SLACK)
    data[:, EXTENT] = np.maximum(np.abs(lo), np.abs(hi)).max(-1)
    data[:, ERR] = E * np.maximum.reduceat(f["k"][order], start)
    data[:, TRI_PAD] = np.maximum.reduceat(f["tri_pad"][order], start)
    return data


def build(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> Clusters | None:
    """The cluster levels of the faces (v0, e1, e2), as the tracer holds
    them (F, 3) f32; None for no faces."""
    if v0.shape[0] == 0:
        return None
    dev = v0.device
    v0, e1, e2 = (x.cpu().double().numpy() for x in (v0, e1, e2))
    f = _faces(v0, e1, e2)
    tree = bvh.build(f["lo"], f["hi"], LEAF)
    m = len(tree.prims)
    leaf = tree.left < 0
    size = np.asarray([len(p) for p in tree.prims])
    order = np.asarray([i for p in tree.prims for i in p], np.int64)
    # Preorder numbering: children follow their parent, so a reverse sweep
    # sums subtrees; a node's faces start where its first leaf's do.
    start = np.zeros(m, np.int64)
    start[leaf] = np.cumsum(size[leaf]) - size[leaf]
    count, parent = size.copy(), np.full(m, -1)
    for k in range(m - 1, -1, -1):
        if not leaf[k]:
            count[k] = count[tree.left[k]] + count[tree.right[k]]
            start[k] = start[tree.left[k]]
            parent[tree.left[k]] = parent[tree.right[k]] = k
    top = 0
    while LEAF * BRANCH ** top < len(order):
        top += 1
    cuts = []
    for j in range(max(top - 1, 0), -1, -1):
        cap = LEAF * BRANCH ** j
        cut = np.flatnonzero((count <= cap) & ((parent < 0) | (count[np.maximum(parent, 0)] > cap)))
        cuts.append(cut[np.argsort(start[cut], kind="stable")])
    levels = []
    for j, cut in enumerate(cuts):
        if j + 1 < len(cuts):
            child = start[cuts[j + 1]]
            first = np.searchsorted(child, start[cut])
            n = np.searchsorted(child, start[cut] + count[cut]) - first
        else:
            first, n = start[cut], count[cut]
        levels.append(Level(*(torch.as_tensor(x, device=dev) for x in (
            _level(f, order, start[cut], count[cut]), first, n))))
    return Clusters(levels, torch.as_tensor(order, device=dev))


def _cone_min(c: torch.Tensor, cos_a: torch.Tensor, sin_a: torch.Tensor) -> torch.Tensor:
    """The least |cos| between a unit vector at cosine c to a cone's axis
    and any direction within the cone (0 where the cone reaches 90 degrees)."""
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    return torch.clamp(c.abs() * cos_a - s * sin_a - SLACK, min=0.0)


def _enters(lv: Level, o, d, unit, c, t_lo: float, t_hi: float) -> torch.Tensor:
    """Whether each ray (o, d, unit: rows of (N, 3) f64) may hold an accepted
    face of cluster c (N,) of level lv: the slab test on its padded box."""
    x = lv.data[c]
    g, half, axis = o - x[:, CENTER], x[:, HALF], x[:, AXIS]
    cos_a, sin_a, e, tri = x[:, COS_A], x[:, SIN_A], x[:, ERR], x[:, TRI_PAD]
    far = (g.abs() + half).square().sum(-1).sqrt() * (1.0 + SLACK)
    s = _cone_min((unit * axis).sum(-1), cos_a, sin_a)
    pad_a = torch.where(s > 2.0 * e, 4.0 * e * far / (s - e), torch.inf)
    gl = g.square().sum(-1).sqrt()
    h = gl * _cone_min((g * axis).sum(-1) / gl, cos_a, sin_a) - x[:, RADIUS]
    eb = e * far
    b = 4.0 * eb / (h - eb)
    pad_b = torch.where(h > 10.0 * eb, b * (far + 2.0 * tri) / (1.0 - b), torch.inf)
    pad = torch.minimum(pad_a, pad_b) + tri
    pad = pad + 1e-12 * (o.abs().amax(-1) + x[:, EXTENT] + pad)
    hp = half + pad[:, None]
    t0, t1 = (-g - hp) / d, (hp - g) / d
    flat, inside = d == 0.0, g.abs() <= hp
    t_near = torch.where(flat, torch.where(inside, -torch.inf, torch.inf), torch.minimum(t0, t1))
    t_far = torch.where(flat, torch.where(inside, torch.inf, -torch.inf), torch.maximum(t0, t1))
    t_near, t_far = t_near.amax(-1), t_far.amin(-1)
    return ~((t_near > t_far) | (t_far < t_lo) | (t_near > t_hi))


def _window(t_min: float, t_max: float) -> tuple[float, float]:
    """(t_min, t_max) as _tri_t compares them (in f32), widened by 8 u."""
    lo, hi = (float(torch.tensor(t, dtype=torch.float32)) for t in (t_min, t_max))
    return lo - 8 * U * abs(lo) - 1e-30, hi + 8 * U * abs(hi) + 1e-30


def _expand(r, first, count, limit: int):
    """Each pair (r, [first, first + count)) as (r, child) pairs, in
    chunks of about `limit` pairs; one read of the counts to the host."""
    ends = torch.cumsum(count, 0)
    ends_h = ends.cpu().numpy()
    a = 0
    while a < len(ends_h):
        lo = ends_h[a - 1] if a else 0
        b = max(int(np.searchsorted(ends_h, lo + limit, side="right")), a + 1)
        total = int(ends_h[b - 1] - lo)
        if total:
            n = count[a:b]
            offset = torch.arange(lo, lo + total, device=r.device) - torch.repeat_interleave(
                ends[a:b] - n, n, output_size=total)
            yield (torch.repeat_interleave(r[a:b], n, output_size=total),
                   torch.repeat_interleave(first[a:b], n, output_size=total) + offset)
        a = b


def _walk(cl: Clusters, j: int, r, c, rays):
    """The (ray, face) pairs under the (ray r, cluster c) pairs of level j."""
    lv = cl.levels[j]
    keep = torch.nonzero(_enters(lv, *(x[r] for x in rays[:3]), c, *rays[3:])).squeeze(1)
    r, c = r[keep], c[keep]
    for r2, c2 in _expand(r, lv.first[c], lv.count[c], CHUNK_PAIRS):
        if j + 1 < len(cl.levels):
            yield from _walk(cl, j + 1, r2, c2, rays)
        else:
            yield r2, cl.order[c2]


def candidates(cl: Clusters | None, o: torch.Tensor, d: torch.Tensor, t_min: float,
               t_max: float):
    """Yield (ray, face) index pairs, in chunks, that hold every pair
    whose face tracer._tri_t accepts for rays (o, d) (P, 3) f32."""
    if cl is None or o.shape[0] == 0:
        return
    o64, d64 = o.double(), d.double()
    rays = (o64, d64, d64 / d64.square().sum(-1, keepdim=True).sqrt(), *_window(t_min, t_max))
    n_top = cl.levels[0].data.shape[0]
    step = max(1, CHUNK_PAIRS // n_top)
    for s in range(0, o.shape[0], step):
        r = torch.arange(s, min(s + step, o.shape[0]), device=o.device)
        yield from _walk(cl, 0, r.repeat_interleave(n_top),
                         torch.arange(n_top, device=o.device).repeat(r.numel()), rays)
