"""render_kernel's staged BVH route on the host, and the walk counters, on
the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds
it to the wavefront engine and to the global walk bit for bit); here:
the route decision from the scene (ops/cuda/megakernel.route_of) and its
cap against the kernel's; the counters of the kernel's walks
(ops/intersect.BVH_VISITS in intersect_bvh, the plain sphere-BVH walk
walk_sphere_bvh, count_walks) against per-ray loops over the same
threaded trees; the sphere-BVH walk's winners against the port's and
the JAX package's all-spheres scans; and chip_smoke's counted bounds and
timing copies of megakernel.cu.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke as C
import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.ops import intersect as jx
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

TMIN, TMAX = 1e-3, 3.4e35
KERNEL = os.path.join(os.path.dirname(mk.__file__), "megakernel.cu")


def _scenes():
    """The scenes of the route decision: the rows' frames and the edge cases
    of phase 34 (stage_scenes)."""
    out = {
        "one_weekend_brute": T.one_weekend_scene(0),
        "one_weekend_sphere_bvh": T.make_scene(T.one_weekend_scene(0), sphere_bvh=True),
        "config4_icosphere6": C.mesh_scene(T, 6),
        "icosphere4": C.mesh_scene(T, 4),
    }
    out.update({k: v[0] for k, v in C.stage_scenes(T, mk.STAGE_BYTES).items()})
    return out


def _counted(sc) -> int:
    """The stage's bytes from the scene's counts, as the kernel lays it out:
    16 a sphere, 32 a node, 48 a face; 0 without a BVH or above the cap."""
    ms = sc.sphere_bvh.num_nodes if sc.sphere_bvh is not None else 0
    f, mm = (sc.mesh.num_triangles, sc.bvh.num_nodes) if sc.mesh is not None else (0, 0)
    b = 16 * sc.spheres.count + 32 * ms + 48 * f + 32 * mm
    return b if (ms or f) and b <= 16384 else 0


# Bytes the rows' scenes stage (PERF.md): the Cornell box and config 3.
KNOWN = {"cornell_nee_mis": 832, "config3": 10448, "config4_icosphere6": 0,
         "one_weekend_brute": 0, "at_cap": 16384, "above_cap": 0}


@pytest.mark.parametrize("name", [
    "one_weekend_brute", "one_weekend_sphere_bvh", "config4_icosphere6", "icosphere4",
    "cornell_nee_mis", "config3", "at_cap", "above_cap", "mesh_and_sphere_bvh",
    "inactive_in_leaves", "degenerate_faces", "quad_diagonals", "many_lights"])
def test_the_stage_is_decided_from_the_scene(name):
    sc = T.as_scene(_scenes()[name])
    want = _counted(sc)
    route = mk.route_of(sc)
    assert route.bvh_stage == want
    if name in KNOWN:
        assert want == KNOWN[name]
    assert mk.pack_scene(sc, False, False, None).route == route
    # The path loop reads the BVH stage; a brute-route scene takes the
    # sphere stage instead, and no other loop reads either.
    brute = route.sphere_stage if route.geometry == "brute" else 0
    assert route.path_stage("path", False) == (want or brute)
    assert route.path_stage("path", True) == route.path_stage("normal", False) == 0
    # The launch key names the geometry, and "+staged" only when asked.
    assert "+staged" not in route.launch_key("megakernel", False, None)


def test_the_cap_is_the_kernels_and_fits_the_half_ring():
    src = open(KERNEL).read()
    cap = int(re.search(r"constexpr int kBvhStageBytes = (\d+);", src).group(1))
    rows = int(re.search(r"constexpr int kRingRows = (\d+);", src).group(1))
    staged_rows = int(re.search(r"constexpr int kStagedRingRows = (\d+);", src).group(1))
    warps = int(re.search(r"constexpr int kRegenWarps = (\d+);", src).group(1))
    assert cap == mk.STAGE_BYTES == mk._cu_constant("kBvhStageBytes")
    # A ring slot is a uint4: the half ring frees room for the whole stage.
    assert warps * (rows - staged_rows) * 32 * 16 >= cap
    assert mk.bvh_stage_bytes(2, 0, 12, 7) == 832


def _numpy_mesh_walk(o, d, mesh, bvh, window):
    """The kernel's mesh walk, one ray at a time over the threaded tree:
    (t, face or -1, nodes, leaves, faces).  Faces are tested in leaf order
    against the shrinking window with the plain version's Moller-Trumbore."""
    bmin, bmax = bvh.bbox_min.numpy(), bvh.bbox_max.numpy()
    miss, ls, lc = (x.numpy() for x in (bvh.miss_link, bvh.leaf_start, bvh.leaf_count))
    inv = (np.float32(1.0) / np.where(np.abs(d) < 1e-20, np.float32(1e-20), d)).astype(np.float32)
    tb, best, nodes, leaves, faces, node = np.float32(window), -1, 0, 0, 0, 0
    while node >= 0:
        nodes += 1
        t0 = (bmin[node] - o) * inv
        t1 = (bmax[node] - o) * inv
        tn, tf = np.max(np.minimum(t0, t1)), np.min(np.maximum(t0, t1))
        enter = tf >= max(tn, np.float32(TMIN)) and tn < tb
        if enter and ls[node] >= 0:
            leaves += 1
            for j in range(ls[node], ls[node] + lc[node]):
                faces += 1
                t, _, _, hit = tx._moller_trumbore(
                    torch.from_numpy(o), torch.from_numpy(d), mesh.v0[j], mesh.e1[j],
                    mesh.e2[j], TMIN, float(tb))
                if bool(hit):
                    tb, best = np.float32(float(t)), j
        node = node + 1 if enter and ls[node] < 0 else miss[node]
    return tb, best, nodes, leaves, faces


@pytest.mark.parametrize("leaf_size,windowed", [(1, False), (4, False), (4, True), (8, True)])
def test_bvh_visits_count_the_kernels_mesh_walk(leaf_size, windowed):
    mesh, bvh = T.build_mesh_bvh(T.icosphere(2, smooth=True), leaf_size)
    rng = np.random.default_rng(leaf_size)
    o = rng.uniform(-2.5, 2.5, (120, 3)).astype(np.float32)
    d = (rng.uniform(-0.8, 0.8, (120, 3)) - o).astype(np.float32)
    d[:10] = np.eye(3, dtype=np.float32).repeat(4, axis=0)[:10]
    window = (rng.uniform(0.5, 4.0, 120).astype(np.float32) if windowed
              else np.full(120, TMAX, np.float32))
    tx.BVH_VISITS = {}
    try:
        hit = tx.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), mesh, bvh, TMIN,
                               torch.from_numpy(window) if windowed else TMAX, count="closest")
        got = dict(tx.BVH_VISITS["closest"])
    finally:
        tx.BVH_VISITS = None
    want = {"nodes": 0, "leaves": 0, "faces": 0}
    for i in range(120):
        t, j, n, lv, f = _numpy_mesh_walk(o[i], d[i], mesh, bvh, window[i])
        want["nodes"] += n
        want["leaves"] += lv
        want["faces"] += f
        assert bool(hit.hit[i]) == (j >= 0)
        if j >= 0:
            assert int(hit.idx[i]) == j and float(hit.t[i]) == float(t)
    assert got == want
    # Without count= nothing is counted.
    tx.BVH_VISITS = {}
    try:
        tx.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), mesh, bvh, TMIN, TMAX)
        assert tx.BVH_VISITS == {}
    finally:
        tx.BVH_VISITS = None


def _sphere_scene(seed):
    """A 400-sphere BVH scene over chip_smoke's sphere cloud."""
    return T.make_scene(C.sphere_cloud(T, 400, "cpu", seed=seed), sphere_bvh=True)


def _rays_outside(sc, seed, n):
    """Seeded rays whose origins lie outside every sphere (no far-root
    fallback), most of them toward the cloud."""
    rng = np.random.default_rng(seed)
    o = np.column_stack([rng.uniform(-9, 9, 4 * n), rng.uniform(2.2, 4.0, 4 * n),
                         rng.uniform(-9, 9, 4 * n)]).astype(np.float32)
    c, r = sc.spheres.centers.numpy(), sc.spheres.radii.numpy()
    outside = (np.linalg.norm(o[:, None] - c[None], axis=-1) > np.abs(r)[None] + 1e-3).all(1)
    o = o[outside][:n]
    d = (rng.uniform(-8, 8, (n, 3)) * np.asarray([1, 0, 1]) + np.asarray([0, 0.5, 0])
         - o).astype(np.float32)
    d[::4, 1] = np.abs(d[::4, 1]) + 0.5  # upward: some miss everything
    return o, d


def _numpy_sphere_walk(o, d, spheres, bvh):
    """The kernel's sphere-BVH walk, one ray and one sphere at a time:
    (t, sphere or -1, nodes, leaves, sphere tests, roots)."""
    bmin, bmax = bvh.bbox_min.numpy(), bvh.bbox_max.numpy()
    miss, ls, lc = (x.numpy() for x in (bvh.miss_link, bvh.leaf_start, bvh.leaf_count))
    inv = (np.float32(1.0) / np.where(np.abs(d) < 1e-20, np.float32(1e-20), d)).astype(np.float32)
    ot, dt = torch.from_numpy(o)[None, None], torch.from_numpy(d)[None, None]
    tb, best, node = np.float32(TMAX), -1, 0
    n = {"nodes": 0, "leaves": 0, "spheres": 0, "roots": 0}
    while node >= 0:
        n["nodes"] += 1
        t0 = (bmin[node] - o) * inv
        t1 = (bmax[node] - o) * inv
        tn, tf = np.max(np.minimum(t0, t1)), np.min(np.maximum(t0, t1))
        enter = tf >= max(tn, np.float32(TMIN)) and tn < tb
        if enter and ls[node] >= 0:
            n["leaves"] += 1
            for j in range(ls[node], ls[node] + lc[node]):
                tally = {"tests": 0, "roots": 0}
                root, valid = tx._roots(ot, dt, spheres.centers[j][None, None],
                                        spheres.radii[j][None, None], TMIN,
                                        torch.full((1, 1), float(tb)), tally)
                n["spheres"] += int(tally["tests"])
                n["roots"] += int(tally["roots"])
                if bool(valid):
                    tb, best = np.float32(float(root)), j
        node = node + 1 if enter and ls[node] < 0 else miss[node]
    return tb, best, n


@pytest.mark.parametrize("seed,inactive", [(3, False), (4, True)])
def test_sphere_bvh_walk_counts_match_a_per_ray_loop(seed, inactive):
    sc = _sphere_scene(seed)
    if inactive:  # inactive spheres inside the leaves: never hit, not counted
        radii = sc.spheres.radii.clone()
        radii[1::5] = -radii[1::5]
        sc = dataclasses.replace(sc, spheres=dataclasses.replace(sc.spheres, radii=radii))
    o, d = _rays_outside(sc, seed, 80)
    tx.BVH_VISITS = {}
    try:
        t, idx, hit = tx.walk_sphere_bvh(torch.from_numpy(o), torch.from_numpy(d), sc.spheres,
                                         sc.sphere_bvh, TMIN, TMAX, count="closest")
        got = dict(tx.BVH_VISITS["closest"])
    finally:
        tx.BVH_VISITS = None
    want = {"nodes": 0, "leaves": 0, "spheres": 0, "roots": 0}
    for i in range(o.shape[0]):
        tb, best, n = _numpy_sphere_walk(o[i], d[i], sc.spheres, sc.sphere_bvh)
        want = {k: want[k] + n[k] for k in want}
        assert int(idx[i]) == best and bool(hit[i]) == (best >= 0)
        if best >= 0:
            assert float(t[i]) == float(tb)
    assert got == want
    assert got["roots"] > 0 and got["spheres"] > got["roots"]


@pytest.mark.parametrize("seed", [5, 6])
def test_sphere_bvh_walk_finds_the_scans_winners(seed):
    """On rays where no far-root fallback fires (origins outside every
    sphere), the walk's winners are the all-spheres scan's: the port's
    intersect_spheres bit for bit, and the JAX package's, jitted, on the
    same spheres: the same hits and winners, t to 1e-5 absolute and
    relative (the jitted quadratic rounds apart from the port's fused
    multiply-adds, which shows where h - sqrt(disc) cancels on grazing
    rays; tests/test_torch_bvh.py holds the mesh walk to JAX's at 1e-5)."""
    sc = _sphere_scene(seed)
    o, d = _rays_outside(sc, seed, 600)
    t, idx, hit = tx.walk_sphere_bvh(torch.from_numpy(o), torch.from_numpy(d), sc.spheres,
                                     sc.sphere_bvh, TMIN, TMAX)
    scan = tx.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d), sc.spheres, TMIN, TMAX)
    assert bool(hit.any()) and not bool(hit.all())
    assert torch.equal(hit, scan.hit)
    assert torch.equal(t[hit], scan.t[hit]) and torch.equal(idx[hit], scan.idx[hit])
    js = J.Spheres(*(jax.numpy.asarray(getattr(sc.spheres, f.name).numpy())
                     for f in dataclasses.fields(T.Spheres)))
    jh = jax.jit(lambda o, d: jx.intersect_spheres(o, d, js, TMIN, TMAX))(o, d)
    h = hit.numpy()
    assert np.array_equal(np.asarray(jh.hit), h)
    assert np.array_equal(np.asarray(jh.idx)[h], idx[hit].numpy())
    np.testing.assert_allclose(np.asarray(jh.t)[h], t[hit].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell_nee_mis", "mesh_and_sphere_bvh", "many_lights"])
def test_counted_walks_change_nothing_and_cover_every_ray(name):
    """A frame of the plain version with the walks counted equals it
    uncounted bit for bit, and its counted rays (closest hits and shadow
    rays) are its ray counter's."""
    scene, cam_s, kw = C.stage_scenes(T, mk.STAGE_BYTES)[name]
    sc = T.as_scene(scene)
    kw = dict(kw, width=24, height=16, t_min=1e-3, frame_seed=3)
    kw.pop("spp")
    cam = T.derive_camera(cam_s, 24, 16)
    want, rays = mk.render_reference(sc, cam, spp=1, return_ray_count=True, **kw)
    tx.BVH_VISITS = {}
    try:
        got = mk.render_reference(sc, cam, spp=1, **kw)
        walks = {q: dict(v) for q, v in tx.BVH_VISITS.items()}
    finally:
        tx.BVH_VISITS = None
    assert torch.equal(got, want)
    counted = sum(w["rays"] for w in walks.values())
    assert counted == int(rays.sum())
    assert walks["closest"]["nodes"] >= walks["closest"]["rays"]
    assert ("shadow" in walks) == bool(kw.get("nee"))


def test_counted_bound_charges_the_counted_walks():
    sc = T.as_scene(T.cornell_box_scene())
    walks = {"closest": {"rays": 10, "nodes": 60, "leaves": 12, "faces": 50, "spheres": 20,
                         "roots": 2},
             "shadow": {"rays": 5, "nodes": 40, "leaves": 6, "faces": 30, "spheres": 10,
                        "roots": 1}}
    w = C.walk_flops(sc, walks)
    leaf = float(sc.bvh.leaf_count[sc.bvh.leaf_start >= 0].double().mean())
    closest = 60 * C.BOX_FLOPS + 50 * C.TRI_FLOPS + 20 * C.SPHERE_TEST_FLOPS + 2 * C.SPHERE_ROOT_FLOPS
    assert w["flops"] == pytest.approx(closest + 5 * (C.BOX_FLOPS + leaf * C.TRI_FLOPS))
    assert w["rays"] == 15 and w["per_ray"]["closest"]["nodes"] == 6.0
    rays = 3e9  # enough that the operations, not the scene's bytes, bound it
    b = C.bound(T, mk, sc, rays, 0, None, walks)
    assert b["bound_ms"] == pytest.approx(rays * w["flops"] / 15 / C.FP32_PEAK * 1e3)
    assert b["bound_is_lower_bound"] and b["bound_by"] == "operations"
    nee_free = {"closest": walks["closest"]}
    assert not C.bound(T, mk, sc, rays, 0, None, nee_free)["bound_is_lower_bound"]
    assert C.bound(T, mk, sc, rays, 0, None)["bound_is_lower_bound"]


@pytest.mark.parametrize("name", sorted(C.ROUTE_VARIANTS))
def test_every_timing_copy_applies_to_the_kernel(name):
    """--route-variants builds each copy of megakernel.cu from edits that
    match its source exactly once."""
    src = open(KERNEL).read()
    for old, new in C.ROUTE_VARIANTS[name]:
        assert src.count(old) == 1, old[:80]
        src = src.replace(old, new)
