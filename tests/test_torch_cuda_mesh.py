"""The kernels' BVH walk counters and the benchmark's triangle-mesh
configuration, on an NVIDIA GPU (the CUDA kernels have no CPU mode; every
test skips without a card):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py -q

- count_traced_rays' `bvh_nodes` and `face_tests` on scenes whose counts
  are known: a one-leaf mesh, entered and missed; the staged and the global
  walk of one scene count the same; without NEE the counts are the plain
  version's walks (ops/intersect.BVH_VISITS) over the same paths;
- asking for the walk planes leaves the rays counted and the frame as they
  were, on every route;
- rtbench's mesh_bvh_480p at 160x120 and 4 spp against the benchmark's
  reference, within the configuration's calibrated limits.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu_torch as T
from chip_smoke import stage_scenes
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA megakernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _cube_scene(leaf_size: int = 16):
    """A 12-face cube about the origin (in one BVH leaf at the default
    leaf size), and a small sphere high above it, out of the cameras'
    view."""
    far = T.make_spheres([((0.0, 60.0, 0.0), 0.1, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    cube = T.transform_mesh(T.box(albedo=(0.8, 0.3, 0.2)), 1.0, (0.0, 0.0, 0.0))
    return T.make_scene(far, cube, bvh_leaf_size=leaf_size, sphere_bvh=False)


@functools.cache
def _stage_scenes() -> dict:
    """chip_smoke's edge cases of the BVH stage, built once."""
    return stage_scenes(T, mk.STAGE_BYTES)


def _counts(sc, settings, dev, **kw):
    """One counting launch of render_cuda for `kw` over RenderConfig's
    defaults: its frame, rays plane and (nodes, faces) walk planes."""
    cfg = T.RenderConfig(**{"width": 48, "height": 36, "spp": 4, "max_depth": 4, **kw})
    walks = torch.zeros((2, cfg.height, cfg.width), dtype=torch.int32, device=dev)
    cam = T.derive_camera(settings, cfg.width, cfg.height).to(dev)
    img, rays = mk.render_cuda(
        sc.to(dev), cam, width=cfg.width, height=cfg.height, frame_seed=5, spp=cfg.spp,
        max_depth=cfg.max_depth, t_min=cfg.t_min, nee=cfg.nee, mis=cfg.mis,
        sky_intensity=cfg.sky_intensity, adaptive_tol=cfg.adaptive_tol,
        return_ray_count=True, walk_counts=walks)
    return img, rays, walks.cpu().numpy().view(np.uint32).astype(np.int64)


def test_one_leaf_entered_counts_one_node_and_every_face(dev):
    """Depth 1: each sample walks the one-node tree once.  A ray that enters
    the root box tests the leaf's 12 faces, one that misses it tests none;
    every ray visits the root.  Through count_traced_rays, the sums."""
    sc = _cube_scene()
    assert sc.bvh.num_nodes == 1 and sc.mesh.num_triangles == 12
    look = T.CameraSettings.make([0.0, 0.0, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 40.0,
                                 0.0, 4.0)
    img, rays, (nodes, faces) = _counts(sc, look, dev, max_depth=1)
    rays = rays.cpu().numpy()
    assert (rays == 4).all() and (nodes == rays).all()
    assert (faces % 12 == 0).all() and faces.max() == 12 * 4
    assert faces[18, 24] == 48 and faces[0, 0] == 0 and faces[35, 47] == 0
    # At depth 1 a sample that hits the cube ends black, one that misses
    # sees the sky: a black pixel entered the box with every sample, and
    # one whose rays all missed the box is sky.
    img = img.cpu().numpy()
    black = (img == 0.0).all(-1)
    assert black.any() and (faces[black] == 48).all()
    assert (img[faces == 0] > 0.0).all()
    cfg = T.RenderConfig(width=48, height=36, spp=4, max_depth=1)
    got = T.count_traced_rays(sc.to(dev), look, cfg, frame_seed=5)
    assert got["rays_traced"] == float(rays.sum()) == got["bvh_nodes"]
    assert got["face_tests"] == float(faces.sum())


def test_one_leaf_missed_counts_one_node_and_no_face(dev):
    """The camera looks away from the cube: every ray visits the root and
    leaves; no face is tested."""
    sc = _cube_scene()
    assert sc.bvh.num_nodes == 1
    away = T.CameraSettings.make([0.0, 0.0, 4.0], [0.0, 0.0, 8.0], [0.0, 1.0, 0.0], 40.0,
                                 0.0, 4.0)
    _, rays, (nodes, faces) = _counts(sc, away, dev, max_depth=3)
    assert (rays.cpu().numpy() == 4).all() and (nodes == 4).all() and (faces == 0).all()


@pytest.mark.parametrize("name", ["cube_depth4", "cornell_nee_mis", "at_cap",
                                  "mesh_and_sphere_bvh", "inactive_in_leaves",
                                  "degenerate_faces", "quad_diagonals", "many_lights"])
def test_staged_and_global_walks_count_the_same(dev, monkeypatch, name):
    """render_kernel's shared-memory stage walks the global walk's tree in
    its order with its windows: the same frame, rays, nodes and faces per
    pixel, NEE shadow queries included."""
    if name == "cube_depth4":  # 9 nodes, leaves of 2 and 4 faces
        sc, settings, kw = _cube_scene(4), T.CameraSettings.make(
            [2.0, 1.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 40.0, 0.0, 4.0), {}
    else:
        sc, settings, kw = _stage_scenes()[name]
    kw = {k: v for k, v in kw.items() if k not in ("width", "height")}
    assert mk.route_of(sc).bvh_stage > 0
    staged = _counts(sc, settings, dev, **kw)
    monkeypatch.setattr(mk, "STAGE_BYTES", 0)
    assert mk.route_of(sc).bvh_stage == 0
    walked = _counts(sc, settings, dev, **kw)
    assert torch.equal(staged[0], walked[0]) and torch.equal(staged[1], walked[1])
    assert np.array_equal(staged[2], walked[2])
    assert staged[2][0].sum() > 0


@pytest.mark.parametrize("name", ["icosphere_ground", "mesh_and_sphere_bvh"])
def test_closest_hit_walks_are_the_plain_versions(dev, name):
    """Without NEE every walk is a closest hit: the kernel's nodes and faces
    are the plain version's counted walks (ops/intersect.BVH_VISITS) over
    its paths, which are the kernel's but where rounding flips one."""
    if name == "icosphere_ground":
        ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
        ico = T.transform_mesh(T.icosphere(4, albedo=(0.75, 0.6, 0.45), smooth=True), 0.8,
                               (0.0, 0.8, 0.0))
        sc = T.make_scene(ground, ico)
        settings = T.CameraSettings.make([0.0, 1.2, 3.0], [0.0, 0.7, 0.0], [0.0, 1.0, 0.0],
                                         50.0, 0.0, 3.0)
    else:
        sc, settings, _ = _stage_scenes()[name]
    w, h, spp, depth = 64, 48, 2, 6
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    got = T.count_traced_rays(sc.to(dev), settings, cfg, frame_seed=9)
    cam = T.derive_camera(settings, w, h).to(dev)
    tx.BVH_VISITS = visits = {}
    try:
        _, plain_rays = mk.render_reference(sc.to(dev), cam, width=w, height=h, frame_seed=9,
                                            spp=spp, max_depth=depth, t_min=cfg.t_min,
                                            return_ray_count=True)
    finally:
        tx.BVH_VISITS = None
    assert set(visits) == {"closest"}
    plain = {k: float(v) for k, v in visits["closest"].items()}
    for key, want in (("rays_traced", float(plain_rays.sum())), ("bvh_nodes", plain["nodes"]),
                      ("face_tests", plain["faces"])):
        assert got[key] == pytest.approx(want, rel=2e-3), (key, got[key], want)
    assert got["face_tests"] > 0 and got["bvh_nodes"] > got["rays_traced"]


ROUTES = {
    "brute": lambda: (T.one_weekend_scene(0), T.CameraSettings.default(), {}),
    "sphere_bvh": lambda: (T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11),
                                        sphere_bvh=True), T.CameraSettings.default(), {}),
    "mesh_staged_nee": lambda: (T.cornell_box_scene(), T.cornell_camera(),
                                dict(nee=True, mis=True, sky_intensity=0.0)),
    "adaptive": lambda: (T.cornell_box_scene(), T.cornell_camera(),
                         dict(nee=True, mis=True, sky_intensity=0.0, adaptive_tol=0.05,
                              spp=16)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_walk_planes_leave_rays_and_frame_as_they_were(dev, route):
    """The counting launch with the walk planes renders the frame and counts
    the rays of the launch without them, bit for bit, on every route."""
    sc, settings, kw = ROUTES[route]()
    cfg = T.RenderConfig(**{"width": 40, "height": 30, "spp": 4, "max_depth": 5, **kw})
    cam = T.derive_camera(settings, cfg.width, cfg.height).to(dev)
    args = dict(width=cfg.width, height=cfg.height, frame_seed=3, spp=cfg.spp,
                max_depth=cfg.max_depth, t_min=cfg.t_min, nee=cfg.nee, mis=cfg.mis,
                sky_intensity=cfg.sky_intensity, adaptive_tol=cfg.adaptive_tol,
                return_ray_count=True)
    sc = sc.to(dev)
    img0, rays0 = mk.render_cuda(sc, cam, **args)
    walks = torch.zeros((2, cfg.height, cfg.width), dtype=torch.int32, device=dev)
    img1, rays1 = mk.render_cuda(sc, cam, walk_counts=walks, **args)
    assert torch.equal(img0, img1) and torch.equal(rays0, rays1)
    plain = mk.render_cuda(sc, cam, **{k: v for k, v in args.items()
                                       if k != "return_ray_count"})
    assert torch.equal(plain, img0)
    got = T.count_traced_rays(sc, settings, cfg, frame_seed=3)
    assert got["rays_traced"] == float(rays0.sum().item())
    nodes = float(walks[0].sum().item())
    assert got["bvh_nodes"] == nodes and (nodes > 0) == (route != "brute")
    with pytest.raises(ValueError, match="walk_counts"):
        mk.render_cuda(sc, cam, walk_counts=walks, **dict(args, return_ray_count=False))


def test_mesh_bvh_480p_matches_the_benchmark_reference(dev):
    """The benchmark's configuration at 160x120 and 4 spp (the full scene,
    camera and integrator) through the benchmark's entry with
    backend='cuda', against its reference at every pixel, within the
    configuration's calibrated limits; the frame takes the global walk."""
    from rtbench import check, spec
    from rtbench.entries import render as entry

    c = json.loads((ROOT / "rtbench" / "configs" / "mesh_bvh_480p.json").read_text())
    c = dict(c, width=160, height=120)
    data = spec.scene_data(c, 201)
    cell = spec.Cell("mesh_bvh_480p.test", 1, c, {"backend": "cuda", "spp": 4}, (), ())
    prog = entry.setup(cell, data, dev)
    assert mk.route_of(prog.scene).bvh_stage == 0
    before = mk.LAUNCHES["megakernel:mesh_bvh"]
    frames = [prog.frame(check.frame_seed(201, k)) for k in range(2)]
    assert mk.LAUNCHES["megakernel:mesh_bvh"] == before + 2
    pixels = torch.arange(160 * 120, device=dev)
    got = torch.cat([f.reshape(-1, 3) for f in frames])
    ref = check.reference_values(c, data, 201, [0, 1], pixels, 4)
    read = check.readings(check.sums(got.reshape(2, -1, 3), ref.reshape(2, -1, 3)).sum(0))
    assert check.verdict(read, c["limits"]), (read, c["limits"])
    assert read["nonfinite"] == 0 and read["mean_abs"] > 0.0
