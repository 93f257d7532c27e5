"""The reference's culled face tests against a brute-force oracle: the
reference's closest_hit and nearest_t as they were when they tested every
face against every ray (plus the smooth shading), which must give the same
bits on every output, for any mesh, ray or window."""

import json
import os

import numpy as np
import pytest
import torch

from rtbench import spec
from rtbench.entries import render as entry
from rtbench.reference import cull, tracer
from rtbench.reference.tracer import cross, dot3, fma, sum3
from rtbench.scenes import LAMBERTIAN, MeshGroup, SceneData, spheres_from_entries

import meshes

# --------------------------------------------------------------------------
# The oracle: every face against every ray, on (P, F) planes.


def _brute_tri_t(o, d, sc, t_min, t_max):
    """(P, F) Moller-Trumbore distances, barycentrics and hits."""
    o, d = o[:, None, :], d[:, None, :]
    v0, e1, e2 = sc.v0[None], sc.e1[None], sc.e2[None]
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    par = torch.abs(det) < 1e-12
    inv = 1.0 / torch.where(par, 1.0, det)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv
    t = dot3(e2, qvec) * inv
    ok = ~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return t, u, v, ok


def brute_closest_hit(o, d, sc, t_min, t_max):
    root, valid = tracer._sphere_roots(o, d, sc, t_min, t_max)
    ts, si = torch.min(torch.where(valid, root, torch.inf), dim=-1)
    hit_s = torch.isfinite(ts)
    face = torch.full_like(si, -1)
    if sc.n_faces:
        tt, uu, vv, tv = _brute_tri_t(o, d, sc, t_min, t_max)
        tf, fi = torch.min(torch.where(tv, tt, torch.inf), dim=-1)
        hit_f = torch.isfinite(tf)
        wins = hit_f & (~hit_s | (tf < ts))
        face = torch.where(wins, fi, face)
    else:
        wins = torch.zeros_like(hit_s)
        tf = ts
    hit = hit_s | wins
    t = torch.where(wins, tf, torch.where(hit_s, ts, t_max))
    point = fma(torch.where(hit, t, 0.0)[:, None], d, o)
    r = sc.radii[si]
    outward_s = (point - sc.centers[si]) / torch.where(r != 0.0, r, 1.0)[:, None]
    fidx = face.clamp(min=0)
    if sc.n_faces:
        face_n = sc.normals[fidx]
        if sc.n0 is not None:
            bu = uu.gather(1, fi[:, None])[:, 0]
            bv = vv.gather(1, fi[:, None])[:, 0]
            w0 = 1.0 - bu - bv
            face_n = tracer._normalize(w0[:, None] * sc.n0[fidx] + bu[:, None] * sc.n1[fidx]
                                       + bv[:, None] * sc.n2[fidx])
        outward = torch.where(wins[:, None], face_n, outward_s)
        albedo = torch.where(wins[:, None], sc.f_albedo[fidx], sc.s_albedo[si])
        kind = torch.where(wins, sc.f_kind[fidx], sc.s_kind[si])
        param = torch.where(wins, sc.f_param[fidx], sc.s_param[si])
    else:
        outward, albedo, kind, param = outward_s, sc.s_albedo[si], sc.s_kind[si], sc.s_param[si]
    front = sum3(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return t, hit, point, normal, front, albedo, kind, param, face


def brute_nearest_t(o, d, sc, t_min, t_max):
    root, valid = tracer._sphere_roots(o, d, sc, t_min, t_max)
    t = torch.amin(torch.where(valid, root, t_max), dim=-1)
    if sc.n_faces:
        tt, _, _, tv = _brute_tri_t(o, d, sc, t_min, t_max)
        t = torch.minimum(t, torch.amin(torch.where(tv, tt, t_max), dim=-1))
    return t


def assert_same(o, d, sc, t_min=1e-3, t_max=3.4e35):
    """Both queries, culled and brute, bit for bit: the (ray, face) pairs
    the culled walk tested, for the caller to check that it culled."""
    got = tracer.closest_hit(o, d, sc, t_min, t_max)
    want = brute_closest_hit(o, d, sc, t_min, t_max)
    for name, g, w in zip(("t", "hit", "point", "normal", "front", "albedo", "kind", "param",
                           "face"), got, want):
        assert torch.equal(g, w), name
    assert torch.equal(tracer.nearest_t(o, d, sc, t_min, t_max),
                       brute_nearest_t(o, d, sc, t_min, t_max))
    return sum(r.numel() for r, _ in cull.candidates(sc.clusters, o, d, t_min, t_max))


# --------------------------------------------------------------------------
# Meshes and rays.

FAR_SPHERE = [((0.0, -50.0, 0.0), 0.5, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]


def _scene(groups, precision=torch.float32):
    return tracer.build_scene(spheres_from_entries(FAR_SPHERE, mesh=tuple(groups)), "cpu",
                              precision)


def _noisy_ball(rng, subdivisions=3, noise=0.02, smooth=False):
    v, f = meshes.icosphere(subdivisions)
    v = v * (1.0 + noise * rng.standard_normal((len(v), 1)))
    return MeshGroup(v.astype(np.float32), f, (0.6, 0.5, 0.4), LAMBERTIAN, 0.0, smooth)


def _soup(rng, n=1000, size=0.15):
    v0 = rng.uniform(-1.5, 1.5, (n, 1, 3))
    v = (v0 + rng.normal(0.0, size, (n, 3, 3))).reshape(-1, 3)
    return MeshGroup(v.astype(np.float32), np.arange(3 * n).reshape(n, 3), (0.3, 0.6, 0.3),
                     LAMBERTIAN, 0.0)


def _rays_at(rng, targets, spread=3.0):
    """Rays from random origins around the mesh, each aimed at a target."""
    o = rng.normal(0.0, spread, targets.shape)
    return (torch.as_tensor(o, dtype=torch.float32),
            torch.as_tensor(targets - o, dtype=torch.float32))


def _on_faces(rng, sc, n):
    """Points on random faces (as f32 rounds them)."""
    f = rng.integers(0, sc.n_faces, n)
    a, b = rng.uniform(0, 1, (2, n, 1))
    a, b = np.where(a + b > 1, 1 - a, a), np.where(a + b > 1, 1 - b, b)
    return (sc.v0.numpy()[f] + a * sc.e1.numpy()[f] + b * sc.e2.numpy()[f]).astype(np.float64)


def _directions(rng, n):
    d = rng.standard_normal((n, 3))
    return torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)


def test_random_meshes_and_rays():
    """A noisy closed ball (narrow cones: culling works) and a triangle
    soup (wide cones), from outside and from points on their faces."""
    rng = np.random.default_rng(1)
    for groups in ([_noisy_ball(rng)], [_soup(rng)], [_noisy_ball(rng, 2), _soup(rng, 500)]):
        sc = _scene(groups)
        o, d = _rays_at(rng, _on_faces(rng, sc, 800))
        assert_same(o, d, sc)
        p = torch.as_tensor(_on_faces(rng, sc, 800), dtype=torch.float32)
        assert_same(p, _directions(rng, 800), sc)


def test_rays_along_shared_edges_and_through_shared_vertices():
    rng = np.random.default_rng(2)
    sc = _scene([_noisy_ball(rng, 2, noise=0.0)])
    v0, e1, e2 = (x.numpy().astype(np.float64) for x in (sc.v0, sc.e1, sc.e2))
    targets = np.concatenate([v0, v0 + e1, v0 + 0.5 * e1, v0 + 0.5 * (e1 + e2)])
    o, d = _rays_at(rng, targets)
    assert_same(o, d, sc)
    # Rays that run along an edge: from one corner, toward the next.
    o = torch.as_tensor(v0 - e1, dtype=torch.float32)
    assert_same(o, torch.as_tensor(e1, dtype=torch.float32), sc)


def test_duplicated_faces_tie_to_the_smallest_index():
    rng = np.random.default_rng(3)
    g = _noisy_ball(rng, 2)
    dup = MeshGroup(g.vertices, np.concatenate([g.faces, g.faces[::-1], g.faces]), g.albedo,
                    g.kind, g.param)
    sc = _scene([dup, g])
    o, d = _rays_at(rng, _on_faces(rng, sc, 1000))
    assert_same(o, d, sc)
    got = tracer.closest_hit(o, d, sc, 1e-3, 3.4e35)[-1]
    assert (got[got >= 0] < len(g.faces)).all()


def test_axis_parallel_rays_and_origins_on_and_inside_boxes():
    """Directions with zero components, from the clusters' box corners,
    face centres and centres, and from points on the faces."""
    rng = np.random.default_rng(4)
    grid = MeshGroup(*_grid(6), (0.5, 0.5, 0.5), LAMBERTIAN, 0.0)
    sc = _scene([_noisy_ball(rng), grid])
    pts = []
    for lv in sc.clusters.levels:
        box = lv.data.numpy()
        lo, hi = box[:, cull.CENTER] - box[:, cull.HALF], box[:, cull.CENTER] + box[:, cull.HALF]
        mid = 0.5 * (lo + hi)
        pts += [lo, hi, mid, np.stack([lo[:, 0], mid[:, 1], mid[:, 2]], -1),
                np.stack([mid[:, 0], hi[:, 1], mid[:, 2]], -1)]
    pts = np.concatenate(pts)
    pts = np.concatenate([pts[rng.choice(len(pts), 300, replace=False)],
                          _on_faces(rng, sc, 100)]).astype(np.float32)
    axes = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                       [1, 1, 0], [0, -1, 1], [1, 0, -1]], np.float32)
    o = torch.as_tensor(np.repeat(pts, len(axes), 0))
    d = torch.as_tensor(np.tile(axes, (len(pts), 1)))
    assert_same(o, d, sc)


def _grid(n):
    """A flat n x n grid of quads on y = 0.25, two faces each."""
    x = np.linspace(-2.0, 2.0, n + 1)
    xx, zz = np.meshgrid(x, x, indexing="ij")
    v = np.stack([xx.ravel(), np.full(xx.size, 0.25), zz.ravel()], -1).astype(np.float32)
    i = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).ravel()
    f = np.concatenate([np.stack([i, i + 1, i + n + 2], -1),
                        np.stack([i, i + n + 2, i + n + 1], -1)])
    return v, f


def test_rays_in_the_plane_of_coplanar_faces():
    """Origins on a flat grid, directions in its plane or grazing it: the
    rounding of a face test there is not bounded by any box, and the
    clusters are kept."""
    rng = np.random.default_rng(5)
    v, f = _grid(8)
    sc = _scene([MeshGroup(v, f, (0.5, 0.5, 0.5), LAMBERTIAN, 0.0)])
    n = 600
    o = np.stack([rng.uniform(-2.5, 2.5, n), np.full(n, 0.25), rng.uniform(-2.5, 2.5, n)], -1)
    d = np.stack([rng.standard_normal(n), rng.choice([0.0, 1e-9, -1e-7, 1e-4], n),
                  rng.standard_normal(n)], -1)
    assert_same(torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32),
                sc)


def test_narrow_windows():
    rng = np.random.default_rng(6)
    sc = _scene([_noisy_ball(rng)])
    o, d = _rays_at(rng, _on_faces(rng, sc, 400))
    t = brute_closest_hit(o, d, sc, 1e-3, 3.4e35)[0]
    t = float(t[torch.isfinite(t) & (t < 1e30)].median())
    for lo, hi in ((t * 0.999, t * 1.001), (t, t * (1 + 1e-6)), (t * 0.5, t), (2e-3, 3e-3)):
        assert_same(o, d, sc, lo, hi)


def test_degenerate_faces():
    """Collinear corners, repeated corners, slivers and a zero face among
    ordinary ones."""
    rng = np.random.default_rng(7)
    g = _noisy_ball(rng, 2)
    v = g.vertices
    bad = np.asarray([[0, 0, 1], [0, 1, 1], [2, 2, 2]], np.int64)
    col = np.stack([v[0], 0.5 * (v[0] + v[1]), v[1], v[2], v[2] + 1e-6 * (v[3] - v[2]), v[3]])
    sliver = MeshGroup(col.astype(np.float32), np.asarray([[0, 1, 2], [3, 4, 5]]), (0.2, 0.2, 0.2),
                       LAMBERTIAN, 0.0)
    sc = _scene([MeshGroup(v, np.concatenate([g.faces, bad]), g.albedo, g.kind, g.param), sliver])
    o, d = _rays_at(rng, _on_faces(rng, sc, 600))
    assert_same(o, d, sc)
    o = torch.as_tensor(np.repeat(col[[0, 3]], 200, 0), dtype=torch.float32)
    assert_same(o, _directions(rng, 400), sc)


def test_empty_mesh():
    sc = _scene([])
    assert sc.clusters is None
    rng = np.random.default_rng(8)
    o = torch.as_tensor(rng.normal(0.0, 3.0, (50, 3)), dtype=torch.float32)
    assert assert_same(o, _directions(rng, 50), sc) == 0


def test_bfloat16_control():
    rng = np.random.default_rng(9)
    sc = _scene([_noisy_ball(rng, smooth=True), _soup(rng, 300)], precision=torch.bfloat16)
    o, d = _rays_at(rng, _on_faces(rng, sc, 800))
    assert_same(o, d, sc)


def test_smooth_scene_queries():
    rng = np.random.default_rng(10)
    sc = tracer.build_scene(meshes.icosphere_scene(4, lights=2), "cpu")
    assert sc.n0 is not None and len(sc.light_faces) == 4
    o, d = _rays_at(rng, _on_faces(rng, sc, 800))
    assert assert_same(o, d, sc) < 0.05 * o.shape[0] * sc.n_faces


# --------------------------------------------------------------------------
# Whole frames: the culled reference and the oracle, bit for bit.

CONFIGS = ["one_weekend_720p", "cornell_box_600", "one_weekend_1080p"]


def _render(c, data, spp, monkeypatch=None):
    sc = tracer.build_scene(data, "cpu")
    cam = tracer.derive_camera(data.camera, c["width"], c["height"], "cpu")
    pid = torch.arange(c["width"] * c["height"])
    if monkeypatch is not None:
        monkeypatch.setattr(tracer, "closest_hit", brute_closest_hit)
        monkeypatch.setattr(tracer, "nearest_t", brute_nearest_t)
    return tracer.render_pixels(sc, cam, pid, torch.full_like(pid, 77), width=c["width"],
                                spp=spp, opt=tracer.Options(**spec.trace_options(c)))


@pytest.mark.parametrize("name", CONFIGS)
def test_frames_equal_the_oracle(name, monkeypatch):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        c = dict(json.load(f), width=48, height=36)
    data = spec.scene_data(c, 5)
    got = _render(c, data, 1)
    assert torch.equal(got, _render(c, data, 1, monkeypatch))


def test_smooth_frame_equals_the_oracle(monkeypatch):
    c = meshes.config(40, 30)
    data = meshes.icosphere_scene(2, lights=2)
    got = _render(c, data, 2)
    assert torch.equal(got, _render(c, data, 2, monkeypatch))


# --------------------------------------------------------------------------
# Smooth meshes: the program's make_mesh and the reference alike.


def test_corner_normals_are_the_programs():
    """The program's scene (its faces in its BVH's order) holds the
    reference's corner and face normals, face for face."""
    data = meshes.icosphere_scene(2)
    sc = tracer.build_scene(data, "cpu")
    mesh = entry.program_scene(data, torch.device("cpu")).mesh
    assert mesh.smooth
    rows = lambda m: torch.cat([m.v0, m.e1, m.e2], 1).tolist()
    where = {tuple(r): i for i, r in enumerate(rows(sc))}
    idx = torch.as_tensor([where[tuple(r)] for r in rows(mesh)])
    for c in ("n0", "n1", "n2", "normals"):
        assert torch.equal(getattr(sc, c)[idx], getattr(mesh, c)), c


def test_smooth_scene_matches_plain_integrator():
    """The reference against the program's plain integrator (backend
    'torch') on a smooth icosphere under two triangle lamps, with the
    tolerances the configurations' own comparison uses."""
    c = meshes.config(48, 36, max_depth=5)
    data = meshes.icosphere_scene(2, lights=2)
    cell = spec.Cell("smooth", 1, c, {"backend": "torch", "spp": 2}, (), ())
    img = entry.setup(cell, data, torch.device("cpu")).frame(123).numpy()
    sc = tracer.build_scene(data, "cpu")
    cam = tracer.derive_camera(data.camera, c["width"], c["height"], "cpu")
    pid = torch.arange(c["width"] * c["height"])
    ref = tracer.render_pixels(sc, cam, pid, torch.full_like(pid, 123), width=c["width"], spp=2,
                               opt=tracer.Options(**spec.trace_options(c))).numpy()
    ref = ref.reshape(img.shape)
    d = np.abs(img - ref)
    assert np.isfinite(img).all() and np.isfinite(ref).all()
    assert (d.max(-1) > 1e-3).mean() <= 0.03
    assert d.mean() <= 5e-4
    assert abs(img.mean() - ref.mean()) <= 2e-3
    flat = tracer.build_scene(SceneData(**{**data.__dict__, "mesh": tuple(
        MeshGroup(g.vertices, g.faces, g.albedo, g.kind, g.param) for g in data.mesh)}), "cpu")
    flat_ref = tracer.render_pixels(flat, cam, pid, torch.full_like(pid, 123), width=c["width"],
                                    spp=2, opt=tracer.Options(**spec.trace_options(c))).numpy()
    assert (np.abs(flat_ref.reshape(img.shape) - img).max(-1) > 1e-3).mean() > 0.1
