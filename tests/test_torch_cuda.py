"""The CUDA megakernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc: the kernel has no CPU mode, so
without a card they skip.  The file imports no jax, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Images of one RNG stream are held to the decision-flip contract
(utils/parity.images_match); per-pixel identities (row bands, the spp
mean) are exact, since the kernel computes each pixel the same way
whatever the launch covers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu_torch as T
from chip_smoke import sphere_cloud
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA megakernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _one_weekend(dev, w, h):
    return (T.one_weekend_scene(0, device=dev),
            T.derive_camera(T.CameraSettings.default(), w, h).to(dev))


def _assert_match(a, b, flip_frac=0.01, mean_tol=2e-4):
    m = T.images_match(a, b, flip_frac, mean_tol)
    assert m.ok, m


def test_render_cuda_matches_render_reference(dev):
    scene, cam = _one_weekend(dev, 160, 90)
    kw = dict(width=160, height=90, spp=2, max_depth=12, t_min=1e-3, frame_seed=3)
    before = mk.LAUNCHES["megakernel:brute"]
    got = mk.render_cuda(scene, cam, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["megakernel:brute"] == before + 1
    assert got.shape == (90, 160, 3) and bool(torch.isfinite(got).all())
    _assert_match(got, mk.render_reference(scene, cam, **kw))


@pytest.mark.parametrize("mode", ["normal", "albedo", "depth"])
def test_aov_modes_match_render_reference(dev, mode):
    scene, cam = _one_weekend(dev, 96, 54)
    kw = dict(width=96, height=54, spp=2, max_depth=1, t_min=1e-3, frame_seed=1, mode=mode)
    got = mk.render_cuda(scene, cam, **kw)
    # Bounce-free: the same closest hit, up to rounding of the normal and
    # the metric distance (relative; depth reaches ~1e2 on the ground).
    torch.testing.assert_close(got, mk.render_reference(scene, cam, **kw),
                               rtol=1e-5, atol=2e-5)


def test_roulette_and_clamp_match_render_reference(dev):
    scene, cam = _one_weekend(dev, 128, 72)
    kw = dict(width=128, height=72, spp=2, max_depth=16, t_min=1e-3, frame_seed=5,
              russian_roulette_depth=3, clamp=1.5, sky_intensity=0.7)
    _assert_match(mk.render_cuda(scene, cam, **kw), mk.render_reference(scene, cam, **kw))


def test_row_bands_and_spp_mean_are_exact(dev):
    scene, cam = _one_weekend(dev, 64, 36)
    kw = dict(width=64, max_depth=8, t_min=1e-3, frame_seed=9)
    full = mk.render_cuda(scene, cam, height=36, spp=4, **kw)
    band = mk.render_cuda(scene, cam, height=12, y_offset=2, row_stride=3, spp=4, **kw)
    assert torch.equal(band, full[2::3])
    singles = [mk.render_cuda(scene, cam, height=36, spp=1, sample_index=s, **kw)
               for s in range(4)]
    assert torch.equal(full, (singles[0] + singles[1] + singles[2] + singles[3]) / 4.0)


def _mesh_scene(dev, smooth):
    spheres = T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((-1.5, 0.5, -1.0), 0.5, T.METAL, (0.9, 0.9, 0.9), 0.05),
        ((1.2, 0.3, 0.4), 0.3, T.DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
    ])
    mesh = T.merge_meshes(
        T.transform_mesh(T.icosphere(2, albedo=(0.8, 0.4, 0.2), smooth=smooth), 0.7, (0, 0.7, 0)),
        T.transform_mesh(T.box(albedo=(0.2, 0.6, 0.3)), 0.5, (1.0, 0.25, -1.0)),
    )
    cam = T.CameraSettings.make([0.0, 1.0, 3.0], [0.0, 0.5, 0.0], [0, 1, 0], 45.0, 0.0, 3.0)
    return T.make_scene(spheres, mesh).to(dev), T.derive_camera(cam, 96, 72).to(dev)


def _sphere_bvh_scene(dev, w, h):
    scene = T.make_scene(T.one_weekend_scene(0), sphere_bvh=True)
    assert scene.sphere_bvh is not None
    return scene.to(dev), T.derive_camera(T.CameraSettings.default(), w, h).to(dev)


@pytest.mark.parametrize("mode", ["path", "normal", "albedo", "depth"])
@pytest.mark.parametrize("smooth", [False, True])
def test_mesh_scene_matches_render_reference(dev, smooth, mode):
    scene, cam = _mesh_scene(dev, smooth)
    kw = dict(width=96, height=72, spp=2, max_depth=8, t_min=1e-3, frame_seed=4, mode=mode)
    before = mk.LAUNCHES["megakernel:mesh_bvh"]
    got = mk.render_cuda(scene, cam, **kw)
    assert mk.LAUNCHES["megakernel:mesh_bvh"] == before + 1
    assert bool(torch.isfinite(got).all())
    want = mk.render_reference(scene, cam, **kw)
    if mode == "path":
        _assert_match(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["path", "normal", "albedo", "depth"])
def test_sphere_bvh_matches_brute_reference(dev, mode):
    """The walked sphere BVH against the plain version's scan of the same
    reordered spheres, at the sphere-BVH contract (flip <= 2%, mean <
    2e-3: which leaves a walk scans can flip far-root decisions), and
    against the brute kernel on the same spheres at the standard 1% / 2e-4."""
    scene, cam = _sphere_bvh_scene(dev, 128, 72)
    kw = dict(width=128, height=72, spp=2, max_depth=10, t_min=1e-3, frame_seed=6, mode=mode)
    before = mk.LAUNCHES["megakernel:sphere_bvh"]
    walk = mk.render_cuda(scene, cam, **kw)
    assert mk.LAUNCHES["megakernel:sphere_bvh"] == before + 1
    _assert_match(walk, mk.render_reference(scene, cam, **kw), 0.02, 2e-3)
    brute = mk.render_cuda(dataclasses.replace(scene, sphere_bvh=None), cam, **kw)
    _assert_match(walk, brute)


def test_mesh_needs_its_bvh(dev):
    scene, cam = _mesh_scene(dev, False)
    brute = T.Scene(spheres=scene.spheres, mesh=scene.mesh, bvh=None)
    with pytest.raises(ValueError, match="BVH"):
        mk.render_cuda(brute, cam, width=8, height=8, max_depth=2, t_min=1e-3)


def test_kernel_hashes_are_bit_exact(dev):
    v = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    v[:2] = (0, 2**32 - 1)
    vt = torch.from_numpy(v.view(np.int32).copy()).to(dev)
    salts = [1, 2, 3, 4, 16, 17, 18, 1000]
    got = mk.hash_probe(vt, salts, 5, 99)
    want = mk.hash_probe_reference(vt, salts, 5, 99)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_refuses_cpu_tensors_and_grad(dev):
    cam = T.derive_camera(T.CameraSettings.default(), 8, 8)
    kw = dict(width=8, height=8, max_depth=2, t_min=1e-3)
    with pytest.raises(ValueError, match="CUDA device"):
        mk.render_cuda(T.base_scene(), cam, **kw)
    scene = T.base_scene(device=dev)
    scene = T.Spheres(scene.centers.clone().requires_grad_(True), scene.radii,
                      scene.albedo, scene.mat_kind, scene.mat_param)
    with pytest.raises(RuntimeError, match="differentiate through render"):
        mk.render_cuda(scene, cam.to(dev), **kw)


# --- NEE/MIS (K1b) and the samplers (K1e) -------------------------------------

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
BASE_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                    60.0, 0.0, 2.0)


def _nee_scene():
    """benchmarks/parity_check.py::_nee_scene: one sphere light."""
    return T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.0, 2.0, -2.0), 0.3, T.EMISSIVE, (1.0, 0.9, 0.7), 20.0),
        ((0.8, 0.4, -1.5), 0.4, T.LAMBERTIAN, (0.3, 0.5, 0.8), 0.0),
    ]))


def _many_lights_scene():
    """benchmarks/parity_check.py::_many_lights_scene: 81 light ordinals."""
    spheres = T.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((2.0, 2.2, -2.0), 0.4, T.EMISSIVE, (1.0, 0.9, 0.7), 4.0),
    ])
    glow = T.transform_mesh(T.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=T.EMISSIVE,
                                        mat_param=3.0), 0.5, (-0.8, 1.8, -2.0))
    return T.make_scene(spheres, glow)


@pytest.mark.parametrize("scene,route,mis", [
    ("nee", "brute", False), ("nee", "brute", True),
    ("many", "mesh_bvh", False), ("many", "mesh_bvh", True),
])
def test_nee_kernel_matches_render_reference(dev, scene, route, mis):
    """The kernel's NEE against its plain version (light_pick='sample', the
    kernel's > 4-light pick) at the standard 1% / 2e-4, on its +nee key."""
    sc = (_nee_scene() if scene == "nee" else _many_lights_scene()).to(dev)
    cam = T.derive_camera(BASE_CAMERA, 96, 72).to(dev)
    kw = dict(width=96, height=72, spp=2, max_depth=6, t_min=1e-3, frame_seed=9,
              sky_intensity=0.0, nee=True, mis=mis, russian_roulette_depth=3)
    key = f"megakernel:{route}+nee"
    before = mk.LAUNCHES[key]
    got = mk.render_cuda(sc, cam, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    assert bool(torch.isfinite(got).all())
    _assert_match(got, mk.render_reference(sc, cam, light_pick="sample", **kw))


@pytest.mark.parametrize("spec", [("stratified", 4, 4), ("stratified", 3, 5), ("sobol", 5)])
def test_sampler_probe_is_bit_exact(dev, spec):
    rng = np.random.default_rng(2)
    pid, smp = (torch.from_numpy(rng.integers(0, 2**32, 65536, dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(dev) for _ in range(2))
    got = mk.sampler_probe(pid, smp, 99, spec, [5, 6, 7, 8, 9])
    want = mk.sampler_probe_reference(pid, smp, 99, spec, [5, 6, 7, 8, 9])
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("spec", [("stratified", 3, 5), ("sobol", 4)])
def test_sampler_kernel_matches_render_reference(dev, spec):
    """One-Weekend with its thin lens: the AA (5), lens (7) and scatter (6)
    pairs remapped, against the plain version at 1% / 2e-4."""
    scene, cam = _one_weekend(dev, 96, 54)
    kw = dict(width=96, height=54, spp=4, max_depth=8, t_min=1e-3, frame_seed=2,
              sampler_spec=spec)
    _assert_match(mk.render_cuda(scene, cam, **kw), mk.render_reference(scene, cam, **kw))


@pytest.mark.parametrize("golden,scene,cfg_kw,seed", [
    ("nee_light_48x36.npy", "nee", dict(width=48, height=36, spp=4, max_depth=6,
                                        sky_intensity=0.0, nee=True,
                                        russian_roulette_depth=3), 9),
    ("nee_mis_48x36.npy", "nee", dict(width=48, height=36, spp=4, max_depth=6,
                                      sky_intensity=0.0, nee=True, mis=True,
                                      russian_roulette_depth=3), 9),
    ("many_mis_48x36.npy", "many", dict(width=48, height=36, spp=4, max_depth=4,
                                        sky_intensity=0.0, nee=True, mis=True), 17),
    ("sobol_base_48x32.npy", "base", dict(width=48, height=32, spp=4, max_depth=6,
                                          sampler="sobol"), 5),
])
def test_lit_and_sampler_goldens_through_cuda(dev, golden, scene, cfg_kw, seed):
    sc = {"nee": _nee_scene, "many": _many_lights_scene, "base": T.base_scene}[scene]()
    img = T.render(sc, BASE_CAMERA, T.RenderConfig(backend="cuda", **cfg_kw), frame_seed=seed)
    _assert_match(img, np.load(os.path.join(GOLDEN_DIR, golden)), 0.005, 1e-4)


def test_cornell_matches_render_reference(dev):
    """cornell_48x48 is chaotic across platforms: held to the plain version
    on the same card at parity_check's contract (1.5% / 1e-3)."""
    sc = T.cornell_box_scene().to(dev)
    cam = T.derive_camera(T.cornell_camera(), 48, 48).to(dev)
    kw = dict(width=48, height=48, spp=4, max_depth=6, t_min=1e-3, sky_intensity=0.0,
              nee=True, mis=True, frame_seed=13)
    _assert_match(mk.render_cuda(sc, cam, **kw), mk.render_reference(sc, cam, **kw),
                  0.015, 1e-3)


# --- progressive and adaptive rendering, ray counters (K1f) ------------------


def _tile_mismatch(a, b):
    """Tiles whose spp-map counts differ: the map is constant within each
    (32 x 128) tile, so each tile is read at its first pixel."""
    return int((a[::32, ::128] != b[::32, ::128]).sum())


@pytest.mark.parametrize("case", ["base", "cornell"])
def test_adaptive_kernel_matches_render_reference(dev, case):
    """The adaptive kernel against its plain version on the card: the spp
    maps equal per tile (a tile whose test sits within rounding of its
    limit may flip with the order of the reduction: at most 1), the images
    over the pixels of equal-count tiles at the scene's contract."""
    if case == "base":
        sc, w, h = T.base_scene(device=dev), 160, 40
        cam = T.derive_camera(BASE_CAMERA, w, h).to(dev)
        kw = dict(spp=16, max_depth=6, frame_seed=3)
        contract = (0.01, 2e-4)
    else:  # chaotic: parity_check's contract for this scene
        sc, w, h = T.cornell_box_scene().to(dev), 128, 96
        cam = T.derive_camera(T.cornell_camera(), w, h).to(dev)
        kw = dict(spp=16, max_depth=8, frame_seed=3, nee=True, mis=True, sky_intensity=0.0)
        contract = (0.015, 1e-3)
    kw = dict(kw, width=w, height=h, t_min=1e-3, adaptive_tol=0.03, adaptive_min_spp=4,
              return_spp_map=True)
    img, smap = mk.render_cuda(sc, cam, **kw)
    pimg, pmap = mk.render_reference(sc, cam, **kw)
    assert _tile_mismatch(smap, pmap) <= 1
    same = smap == pmap
    _assert_match(img[same][None], pimg[same][None], *contract)
    assert smap.min() >= 4 and smap.max() <= 16


def test_adaptive_resume_is_bit_exact(dev):
    """Through the public entry points: four adaptive_progressive_step
    chunks of 4 equal the one-shot render() bit for bit, a fifth changes
    nothing, and with a huge tolerance the image is the fixed spp=4 render
    (the prefix property)."""
    scene = T.one_weekend_scene(0)
    cfg = T.RenderConfig(width=256, height=96, spp=16, max_depth=8, adaptive_tol=0.03,
                         adaptive_min_spp=4)
    cam = T.CameraSettings.default()
    one = T.render(scene, cam, cfg, frame_seed=1)
    st = T.init_adaptive_accum(cfg.height, cfg.width, device=dev)
    for _ in range(4):
        st = T.adaptive_progressive_step(st, scene, cam, cfg, frame_seed=1, spp_per_step=4)
    assert torch.equal(st.image, one)
    assert st.count.min() >= 4 and st.count.max() <= 16
    st5 = T.adaptive_progressive_step(st, scene, cam, cfg, frame_seed=1, spp_per_step=4)
    assert torch.equal(st5.count, st.count) and torch.equal(st5.image, one)
    wide = T.render(scene, cam, dataclasses.replace(cfg, adaptive_tol=1e6), frame_seed=1)
    fixed = T.render(scene, cam, dataclasses.replace(cfg, spp=4, adaptive_tol=0.0),
                     frame_seed=1)
    assert torch.equal(wide, fixed)


def _adaptive_oracle_case(dev, route):
    """(scene, camera, render_cuda keywords) of an adaptive frame whose
    tiles stop at several counts."""
    if route == "ragged_200x70":
        sc, cam, w, h = _one_weekend(dev, 200, 70) + (200, 70)
        kw = dict(spp=16, max_depth=30, sample_index=5, adaptive_tol=0.08,
                  adaptive_min_spp=3)
    else:  # ragged_150x45_nee: a sphere light, NEE+MIS, roulette, 2 x 2 ragged tiles
        sc = _nee_scene().to(dev)
        w, h = 150, 45
        cam = T.derive_camera(BASE_CAMERA, w, h).to(dev)
        kw = dict(spp=16, max_depth=8, russian_roulette_depth=3, adaptive_tol=0.3,
                  adaptive_min_spp=2, nee=True, mis=True, sky_intensity=0.0)
    return sc, cam, dict(kw, width=w, height=h, t_min=1e-3, frame_seed=3)


@pytest.mark.parametrize("route", ["ragged_200x70", "ragged_150x45_nee"])
def test_adaptive_tiles_equal_the_fixed_kernel_at_their_count(dev, route):
    """The oracle of chip_smoke's phase 25, which does not depend on the
    adaptive kernel's schedule: a tile whose spp map reads k holds samples
    0..k-1 summed in sample order and divided by k, so it equals
    render_cuda(spp=k) there bit for bit, ray counts included; two launches
    are identical, and so is a tile spread over 16 blocks or kept on one."""
    sc, cam, kw = _adaptive_oracle_case(dev, route)
    got = mk.render_cuda(sc, cam, return_spp_map=True, return_ray_count=True, **kw)
    img, smap, rays = got
    counts = sorted({int(v) for v in smap.unique().tolist()})
    assert len(counts) > 1, counts  # the tiles stop at several counts
    fixed_kw = {k: v for k, v in kw.items() if not k.startswith("adaptive") and k != "spp"}
    for k in counts:
        f_img, f_rays = mk.render_cuda(sc, cam, spp=k, return_ray_count=True, **fixed_kw)
        m = smap == k
        assert torch.equal(f_img[m], img[m]), k
        assert torch.equal(f_rays[m], rays[m]), k
    try:
        for blocks in (None, 1, 16):
            if blocks is not None:
                mk.adaptive_cluster(blocks)
            again = mk.render_cuda(sc, cam, return_spp_map=True, return_ray_count=True, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), blocks
    finally:
        mk.adaptive_cluster(0)


@pytest.mark.parametrize("chunk", [1, 5])
def test_adaptive_resume_in_chunks_equals_one_shot(dev, chunk):
    """The six state planes after resumed launches of `chunk` samples equal
    the one-shot render's (a resume from zero planes with chunk = budget)
    bit for bit, and its count plane is the one-shot spp map."""
    sc, cam, kw = _adaptive_oracle_case(dev, "ragged_200x70")
    zero = tuple(torch.zeros((kw["height"], kw["width"]), device=dev) for _ in range(6))
    one = mk.render_cuda(sc, cam, adaptive_state=zero, adaptive_chunk=kw["spp"], **kw)
    _, smap = mk.render_cuda(sc, cam, return_spp_map=True, **kw)
    assert torch.equal(one[3], smap)
    st = zero
    for _ in range(-(-kw["spp"] // chunk) + 1):
        st = mk.render_cuda(sc, cam, adaptive_state=st, adaptive_chunk=chunk, **kw)
    for a, b in zip(st, one):
        assert torch.equal(a, b)


def test_adaptive_frame_with_fewer_tiles_than_a_clusters_blocks(dev):
    """A 50 x 31 frame is one ragged tile: the launcher spreads it over a
    cluster of 16 blocks, and the frame is the fixed kernel's at its count
    and the same on one block."""
    sc, cam = _one_weekend(dev, 50, 31)
    kw = dict(width=50, height=31, spp=12, max_depth=12, t_min=1e-3, frame_seed=3,
              adaptive_tol=0.08, adaptive_min_spp=3)
    img, smap = mk.render_cuda(sc, cam, return_spp_map=True, **kw)
    assert mk.adaptive_cluster() == 16
    k = int(smap[0, 0])
    assert bool((smap == k).all())
    fixed_kw = {k2: v for k2, v in kw.items() if not k2.startswith("adaptive") and k2 != "spp"}
    assert torch.equal(mk.render_cuda(sc, cam, spp=k, **fixed_kw), img)
    try:
        mk.adaptive_cluster(1)
        assert torch.equal(mk.render_cuda(sc, cam, return_spp_map=True, **kw)[0], img)
        assert mk.adaptive_cluster() == 1
    finally:
        mk.adaptive_cluster(0)
    with pytest.raises(ValueError, match="1-16 blocks"):
        mk.adaptive_cluster(17)


def test_ray_counters_are_exact(dev):
    """The kernel's counters against the plain version's per pixel on the
    diffuse scene of tests/test_pallas.py:707-717 (48 x 32, 4 spp, depth
    3), the analytic cases through 'cuda', and the counter changes no
    pixel of the image."""
    scene = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, T.LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
    ]))
    cfg = T.RenderConfig(width=48, height=32, spp=4, max_depth=3)
    got = T.count_traced_rays(scene, BASE_CAMERA, cfg, frame_seed=7, return_map=True)
    cam = T.derive_camera(BASE_CAMERA, 48, 32).to(dev)
    kw = dict(width=48, height=32, spp=4, max_depth=3, t_min=1e-3, frame_seed=7)
    img, want = mk.render_reference(scene.to(dev), cam, return_ray_count=True, **kw)
    assert torch.equal(got["map"], want)
    assert got["rays_traced"] == float(want.double().sum())
    assert torch.equal(mk.render_cuda(scene.to(dev), cam, return_ray_count=True, **kw)[0],
                       mk.render_cuda(scene.to(dev), cam, **kw))
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    up = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 10.0, 0.0], [0.0, 0.0, 1.0],
                               20.0, 0.0, 10.0)
    down = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                 40.0, 0.0, 10.0)
    lit = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 50.0, 0.0), 5.0, T.EMISSIVE, (1.0, 1.0, 1.0), 4.0),
    ]))
    for sc, c, per, extra in ((ground, up, 1, dict(max_depth=6)),
                              (ground, down, 2, dict(max_depth=2)),
                              (lit, down, 3, dict(max_depth=2, nee=True, sky_intensity=0.0))):
        r = T.count_traced_rays(sc, c, T.RenderConfig(width=48, height=32, spp=4, **extra),
                                frame_seed=3)
        assert r["rays_traced"] == per * r["primary_rays"], (per, r)


@pytest.mark.parametrize("w, h, spp, depth, seed", [(160, 90, 4, 8, 5), (320, 180, 16, 30, 7)])
def test_progressive_matches_one_shot(dev, w, h, spp, depth, seed):
    """spp 1-spp progressive steps on the card, one launch each, equal
    render(spp) at atol 1e-5; reset restarts the count; steps of 2 give the
    same image at 2e-5."""
    scene, cam = T.one_weekend_scene(0), T.CameraSettings.default()
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    mk.LAUNCHES.clear()
    st = T.init_accum(cfg.height, cfg.width)
    for _ in range(spp):
        st = T.progressive_step(st, scene, cam, cfg, frame_seed=seed)
    assert dict(mk.LAUNCHES) == {"megakernel:brute": spp} and int(st.count) == spp
    assert st.rgb.device.type == "cuda" and st.count.device.type == "cpu"
    torch.testing.assert_close(st.rgb, T.render(scene, cam, cfg, frame_seed=seed),
                               atol=1e-5, rtol=0)
    assert int(T.progressive_step(st, scene, cam, cfg, frame_seed=seed, reset=True).count) == 1
    two = T.init_accum(cfg.height, cfg.width)
    for _ in range(spp // 2):
        two = T.progressive_step(two, scene, cam, cfg, frame_seed=seed, spp_per_step=2)
    torch.testing.assert_close(two.rgb, st.rgb, atol=2e-5, rtol=0)


# --- render_kernel's per-warp path regeneration ------------------------------


def _regen_routes():
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    ico4 = T.transform_mesh(T.icosphere(4, albedo=(0.75, 0.6, 0.45), smooth=True), 0.8,
                            (0.0, 0.8, 0.0))
    mesh_cam = T.CameraSettings.make([0.0, 1.2, 3.0], [0.0, 0.7, 0.0], [0.0, 1.0, 0.0], 60.0,
                                     0.0, 2.0)
    return {
        "one_weekend": (T.one_weekend_scene(0), T.CameraSettings.default(), 320, 180, {}),
        "odd_50x31": (T.one_weekend_scene(0), T.CameraSettings.default(), 50, 31, {}),
        "sphere_bvh": (T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11)),
                       T.CameraSettings.default(), 320, 180, {}),
        "icosphere4": (T.make_scene(ground, ico4), mesh_cam, 320, 180, {}),
        "cornell_nee_mis": (T.cornell_box_scene(), T.cornell_camera(), 320, 180,
                            dict(nee=True, mis=True, sky_intensity=0.0)),
    }


@pytest.mark.parametrize("spp", [1, 3, 16, 37])
@pytest.mark.parametrize("route", ["one_weekend", "odd_50x31", "sphere_bvh", "icosphere4",
                                   "cornell_nee_mis"])
def test_regenerating_kernel_equals_wavefront_without_regeneration(dev, route, spp):
    """render() through render_kernel, whose lanes take a new (pixel,
    sample) as soon as their path ends, equals render(backend='wavefront',
    regenerate='off'), which traces each sample's paths bounce by bounce,
    bit for bit at depth 30; so do the ray counts, and two launches are
    identical."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    scene, cam_s, w, h, extra = _regen_routes()[route]
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=30, **extra)
    got = T.render(scene, cam_s, cfg, frame_seed=7)
    want = T.render(scene, cam_s, dataclasses.replace(cfg, backend="wavefront"), frame_seed=7)
    assert torch.equal(got, want)
    sc, cam = T.as_scene(scene).to(dev), T.derive_camera(cam_s, w, h).to(dev)
    kw = dict(width=w, height=h, spp=spp, max_depth=30, t_min=cfg.t_min, frame_seed=7,
              nee=cfg.nee, mis=cfg.mis, sky_intensity=cfg.sky_intensity)
    a, rays_a = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    b, rays_b = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    _, want_rays = wf.render_wavefront(sc, cam, return_ray_count=True, **kw)
    assert torch.equal(a, got) and torch.equal(a, b)
    assert torch.equal(rays_a, want_rays) and torch.equal(rays_a, rays_b)


# --- the wavefront engine (K2) and the probes (K3, K4) ----------------------


def _wavefront_routes(dev):
    lit = dict(nee=True, mis=True, sky_intensity=0.0)
    final = T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11))
    return {
        "brute": (T.one_weekend_scene(0), T.CameraSettings.default(), 160, 90,
                  dict(spp=3, max_depth=12, sample_index=5)),
        "odd_size": (T.one_weekend_scene(0), T.CameraSettings.default(), 50, 31,
                     dict(spp=2, max_depth=8)),
        "sphere_bvh_rr": (final, T.CameraSettings.default(), 128, 72,
                          dict(spp=2, max_depth=20, russian_roulette_depth=3)),
        "mesh": (*_mesh_scene(dev, True), 96, 72, dict(spp=2, max_depth=6)),
        "cornell_two_lights": (T.cornell_box_scene(), T.cornell_camera(), 64, 48,
                               dict(spp=4, max_depth=6, **lit)),
        "many_lights": (_many_lights_scene(), T.CameraSettings.make(
            [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0], 60.0, 0.0, 2.0), 96, 72,
                        dict(spp=2, max_depth=4, **lit)),
        "sobol": (T.one_weekend_scene(0), T.CameraSettings.default(), 96, 54,
                  dict(spp=4, max_depth=8, sampler_spec=("sobol", 4))),
        "clamp": (T.cornell_box_scene(), T.cornell_camera(), 64, 48,
                  dict(spp=2, max_depth=6, clamp=0.5, **lit)),
    }


@pytest.mark.parametrize("route", ["brute", "odd_size", "sphere_bvh_rr", "mesh",
                                   "cornell_two_lights", "many_lights", "sobol", "clamp"])
def test_wavefront_equals_megakernel_bit_for_bit(dev, route):
    """backend='wavefront' with regeneration off: render_cuda's image and
    ray-count plane bit for bit, whatever the sort and compaction
    threshold; with regeneration on within 3e-5, and the same in two runs."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    scene, cam_s, w, h, kw = _wavefront_routes(dev)[route]
    scene = T.as_scene(scene).to(dev)
    cam = cam_s if isinstance(cam_s, T.Camera) else T.derive_camera(cam_s, w, h)
    cam = cam.to(dev)
    kw = dict(width=w, height=h, t_min=1e-3, frame_seed=3, **kw)
    want, want_rays = mk.render_cuda(scene, cam, return_ray_count=True, **kw)
    before = sum(v for k, v in mk.LAUNCHES.items() if k.startswith("wavefront:"))
    got, rays = wf.render_wavefront(scene, cam, return_ray_count=True, **kw)
    assert sum(v for k, v in mk.LAUNCHES.items() if k.startswith("wavefront:")) > before
    assert torch.equal(got, want) and torch.equal(rays, want_rays)
    assert torch.equal(wf.render_wavefront(scene, cam, sort="spatial", compact_threshold=0.5,
                                           **kw),
                       want)
    band = wf.render_wavefront(scene, cam, **{**kw, "height": h // 3}, y_offset=2,
                               row_stride=3, total_width=w)
    assert torch.equal(band, want[2::3][: h // 3])
    if not kw.get("clamp"):
        a = wf.render_wavefront(scene, cam, regenerate=True, **kw)
        b = wf.render_wavefront(scene, cam, regenerate=True, **kw)
        assert torch.equal(a, b)
        torch.testing.assert_close(a, want, atol=3e-5, rtol=1e-5)


def _partition_array(wf, dev, cap, n, regen, sort, live_p, seed):
    """A ray array on the card with random planes, a live share `live_p`
    of slots [0, n) and bounces -1 .. 8, its counts naming buffer 0."""
    rng = np.random.default_rng(seed)
    arr = wf.RayArray(cap, regen, sort, dev)
    arr.f.copy_(torch.from_numpy(rng.normal(size=arr.f.shape).astype(np.float32)))
    arr.f[:, wf.LIVE] = torch.from_numpy((rng.random((2, cap)) < live_p).astype(np.float32))
    arr.i.copy_(torch.from_numpy(rng.integers(-1, 9, arr.i.shape).astype(np.int32)))
    live = int((arr.f[0, wf.LIVE, :n] > 0.5).sum())
    arr.ctr.copy_(torch.tensor([n, live, 0, 0, 0, live, 0, 0], dtype=torch.int32))
    return arr, live


@pytest.mark.parametrize("case", ["random", "all_dead", "all_live", "one_ray"])
@pytest.mark.parametrize("sort", ["octant", "octant-flat", "spatial", "live"])
@pytest.mark.parametrize("regen", [False, True], ids=["samples", "regen"])
def test_partition_kernel_equals_permutation(dev, regen, sort, case):
    """The stable counting sort of ops/cuda/wavefront.cu (keys, block ranks,
    scan, permutation, gather) against `_permutation` (torch sort keys and
    a stable argsort) on the same state: the permutation of every slot and
    the gathered planes exactly, and the step's new slot count; under
    regeneration with the bounce bucket, and, when only a refill follows,
    the dead slots' order.  An all-dead, an all-live and a one-ray array
    included."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    cap, n, live_p = {"random": (300_000, 299_937, 0.4), "all_dead": (5000, 5000, 0.0),
                      "all_live": (5000, 5000, 1.0), "one_ray": (64, 1, 1.0)}[case]
    scene, cam = _one_weekend(dev, 16, 8)
    eng = wf.Engine(scene, cam, 3, 8, 1e-3, total_width=16)
    for threshold in (1.1, 0.0):
        arr, live = _partition_array(wf, dev, cap, n, regen, sort, live_p, seed=n)
        before_f, before_i = arr.f[0].clone(), arr.i[0].clone()
        live_mask = before_f[wf.LIVE, :n] > 0.5
        sched = wf.Schedule(threshold, 0.25, 3 * n, n, regen=regen)
        compact = (regen or live > 0) and threshold > 1.0
        rank = regen and not compact and live < n
        wf.wavefront_partition(eng, arr, sched)
        run = wf._Run(dev, 4)
        wf.wavefront_advance(eng, arr, sched, run, 0)
        torch.cuda.synchronize()
        if compact:
            want = wf._permutation(before_f, before_i, n, live_mask, sort, regen)
        elif rank:
            want = wf._partition_live(live_mask.to(torch.float32))
        if compact or rank:
            assert torch.equal(arr.perm[:n].long(), want)
        ctr = arr.ctr.tolist()
        assert int(run.stats[wf.STAT_COMPACT]) == int(compact)
        assert ctr[wf.CTR_CUR] == int(compact)
        assert ctr[wf.CTR_N] == (live if compact and not regen else n)
        if compact:
            m = n if regen else live
            assert torch.equal(arr.f[1, :, :m], before_f[:, want[:m]])
            assert torch.equal(arr.i[1, :, :m], before_i[:, want[:m]])


def test_wavefront_host_reads_and_sample_batches(dev, monkeypatch):
    """The loop reads the device once a frame without regeneration and at
    most once every POLL_EVERY iterations plus once with it; a batch of
    samples in one array renders the one-sample arrays' image and ray
    counts bit for bit."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    scene, cam = _one_weekend(dev, 320, 180)
    kw = dict(width=320, height=180, spp=16, max_depth=30, t_min=1e-3, frame_seed=7)
    img, rays = wf.render_wavefront(scene, cam, return_ray_count=True, **kw)
    assert wf.LAST_RUN["host_syncs"] == 1 and wf.LAST_RUN["sample_batch"] == 16
    monkeypatch.setattr(wf, "SAMPLE_SLOTS", 320 * 180)
    one, one_rays = wf.render_wavefront(scene, cam, return_ray_count=True, **kw)
    assert wf.LAST_RUN["sample_batch"] == 1
    monkeypatch.undo()
    assert torch.equal(img, one) and torch.equal(rays, one_rays)
    assert torch.equal(img, mk.render_cuda(scene, cam, **kw))
    regen = wf.render_wavefront(scene, cam, regenerate=True, **kw)
    iterations = wf.LAST_RUN["bounce_launches"]
    assert 0 < wf.LAST_RUN["host_syncs"] <= -(-iterations // wf.POLL_EVERY) + 1
    assert float((regen - img).abs().max()) <= 3e-5


def test_wavefront_bounce_matches_its_plain_version(dev):
    """One launch of wavefront_bounce_kernel against
    wavefront_bounce_reference on the same state: the live masks differ on
    at most 1% of the rays, and the state of agreeing rays by 2e-4 on
    average."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    w, h = 160, 90
    scene, cam = _one_weekend(dev, w, h)
    n = w * h
    engines = [wf.Engine(scene, cam, 3, 30, 1e-3, total_width=w, plain=plain)
               for plain in (False, True)]
    states = []
    for eng in engines:
        state_f, state_i = wf.new_state(n, False, dev)
        state_i[wf.PID] = torch.arange(n, dtype=torch.int32, device=dev)
        state_i[wf.PIX] = state_i[wf.PID]
        out = torch.zeros((n, 3), device=dev)
        wf.wavefront_raygen(eng, state_f, state_i, n, regen=False, sample=1)
        wf.wavefront_bounce(eng, state_f, state_i, n, regen=False, sample=1, bounce=0, out=out)
        states.append((state_f, out))
    (kf, kout), (pf, pout) = states
    live_k, live_p = kf[wf.LIVE] > 0.5, pf[wf.LIVE] > 0.5
    assert float((live_k != live_p).float().mean()) <= 0.01
    both = live_k & live_p
    assert float((kf[:, both] - pf[:, both]).abs().mean()) < 2e-4
    assert float((kout - pout).abs().mean()) < 2e-4


def test_wavefront_refuses_cpu_tensors(dev):
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    cam = T.derive_camera(T.CameraSettings.default(), 16, 8)
    with pytest.raises((ValueError, RuntimeError)):
        wf.render_wavefront(T.one_weekend_scene(0), cam, width=16, height=8, max_depth=2,
                            t_min=1e-3)


@pytest.mark.parametrize("mix", ["slab", "fma"])
@pytest.mark.parametrize("chains", [1, 2, 4])
def test_fma_peak_kernel_matches_its_plain_version(dev, mix, chains):
    """K3 at 32 rounds: the slab mix is built without contraction and the
    multiply-add mix calls fmaf where the plain version calls
    ops/rounding.fma, so both are exact."""
    from gpu_ray_tracing_tpu_torch.utils import roofline

    x = torch.linspace(0.5, 1.5, 4096, device=dev)
    before = mk.LAUNCHES["fma_peak"]
    got = roofline.fma_peak(x, 32, mix, chains)
    assert mk.LAUNCHES["fma_peak"] == before + 1
    assert torch.equal(got, roofline.fma_peak_reference(x, 32, mix, chains))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compare", [False, True])
def test_slab_dtype_kernel_matches_its_plain_version(dev, dtype, compare):
    """K4 at 32 rounds: exact in f32 and in packed bf16 (both round every
    operation)."""
    from gpu_ray_tracing_tpu_torch.utils import roofline

    x = torch.linspace(0.5, 1.5, 4096, device=dev)
    got = roofline.slab_dtype(x, 32, dtype, compare)
    assert torch.equal(got, roofline.slab_dtype_reference(x, 32, dtype, compare))
    with pytest.raises(ValueError, match="even"):
        roofline.slab_dtype(x[:5].contiguous(), 4, dtype, compare)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compare", [False, True])
def test_slab_kernel_tails_and_unaligned_arrays(dev, dtype, compare):
    """K4's groups of four elements: counts that end inside a group (2, 6,
    4,098), a card-filling count plus a ragged group, and arrays that start
    8 bytes past a 16-byte boundary (scalar loads), each exact at 32
    rounds."""
    from gpu_ray_tracing_tpu_torch.utils import roofline

    base = torch.linspace(0.5, 1.5, 270_346, device=dev)
    for n in (2, 6, 4098, 270_338):
        for offset in (0, 2):
            x = base[offset:offset + n]
            got = roofline.slab_dtype(x, 32, dtype, compare)
            assert torch.equal(got, roofline.slab_dtype_reference(x, 32, dtype, compare)), (
                n, offset)


# --- gradients through the kernels (ops/autograd.KernelFrame) -----------------


def _tri_light_scene(dev, grad: bool):
    """tests/test_gradients.py's tri-light NEE+MIS scene on the card; with
    `grad`, its sphere albedo and triangle-light emission as leaves."""
    spheres = T.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.3, 0.4, -2.0), 0.4, T.LAMBERTIAN, (0.4, 0.5, 0.8), 0.0),
    ])
    verts = np.float32([[-0.7, 1.8, -2.7], [0.7, 1.8, -2.7], [0.7, 1.8, -1.3],
                        [-0.7, 1.8, -1.3]])
    quad = T.make_mesh(verts, np.int64([[0, 1, 2], [0, 2, 3]]), albedo=(1.0, 0.9, 0.8),
                       mat_kind=T.EMISSIVE, mat_param=6.0)
    scene = T.make_scene(spheres, quad).to(dev)
    if not grad:
        return scene, ()
    albedo = scene.spheres.albedo.clone().requires_grad_(True)
    emission = scene.tri_lights.emission.clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, albedo=albedo),
        tri_lights=dataclasses.replace(scene.tri_lights, emission=emission))
    return scene, (albedo, emission)


@pytest.mark.parametrize("backend,regenerate", [("cuda", "off"), ("wavefront", "off"),
                                                ("wavefront", "on")])
def test_kernel_frame_gradient_matches_the_torch_backend(dev, backend, regenerate):
    """d sum(w * render) through a kernel backend (KernelFrame: the kernel
    forward, the replay backward) equals autograd through backend='torch'
    on the card, per leaf at rtol 1e-5 / atol 1e-7
    (test_pallas_vjp_matches_jax_grad's bound), both nonzero; the forward
    is the frame without gradients bit for bit."""
    cfg_kw = dict(width=24, height=16, spp=2, max_depth=3, sky_intensity=0.0, nee=True,
                  mis=True)
    kernel_cfg = T.RenderConfig(backend=backend, regenerate=regenerate, **cfg_kw)
    w = torch.from_numpy(np.random.default_rng(5).random((16, 24, 3), dtype=np.float32)).to(dev)
    grads = {}
    for cfg in (kernel_cfg, T.RenderConfig(backend="torch", **cfg_kw)):
        scene, leaves = _tri_light_scene(dev, grad=True)
        img = T.render(scene, BASE_CAMERA, cfg, frame_seed=3)
        (img * w).sum().backward()
        grads[cfg.backend] = [leaf.grad for leaf in leaves]
        if cfg is kernel_cfg:
            kernel_img = img.detach()
    for got, want in zip(grads[backend], grads["torch"]):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    plain_scene, _ = _tri_light_scene(dev, grad=False)
    assert torch.equal(kernel_img, T.render(plain_scene, BASE_CAMERA, kernel_cfg, frame_seed=3))


# --- render_aov_kernel: the staged brute scan and the guides launch ----------


def _guide_routes(dev):
    """route -> (scene, camera, render_guides keywords, launch-count route)."""
    ow, owc = _one_weekend(dev, 96, 54)
    base = dict(t_min=1e-3, frame_seed=3)
    mesh, mesh_cam = _mesh_scene(dev, smooth=True)
    bvh, bvh_cam = _sphere_bvh_scene(dev, 96, 54)
    odd_cam = T.derive_camera(T.CameraSettings.default(), 50, 31).to(dev)
    return {
        "brute": (ow, owc, dict(base, width=96, height=54, spp=3), "brute"),
        "ragged_50x31": (ow, odd_cam, dict(base, width=50, height=31, spp=5), "brute"),
        "row_band": (ow, owc, dict(base, width=96, height=20, spp=2, y_offset=1,
                                   row_stride=2), "brute"),
        "sobol": (ow, owc, dict(base, width=96, height=54, spp=4, sampler_spec=("sobol", 5)),
                  "brute+sobol"),
        "stratified": (ow, owc, dict(base, width=96, height=54, spp=4,
                                     sampler_spec=("stratified", 2, 2)), "brute+stratified"),
        "sphere_bvh": (bvh, bvh_cam, dict(base, width=96, height=54, spp=2), "sphere_bvh"),
        "mesh": (mesh, mesh_cam, dict(base, width=96, height=72, spp=2), "mesh_bvh"),
    }


@pytest.mark.parametrize("route", ["brute", "ragged_50x31", "row_band", "sobol", "stratified",
                                   "sphere_bvh", "mesh"])
def test_guides_launch_equals_the_single_mode_launches(dev, route):
    """render_guides' three planes and ray counts equal render_cuda(mode=)
    bit for bit on every route; two launches give identical planes; one
    launch counts once under megakernel:<route>+guides+rays."""
    scene, cam, kw, key = _guide_routes(dev)[route]
    before = mk.LAUNCHES[f"megakernel:{key}+guides+rays"]
    first = mk.render_guides(scene, cam, return_ray_count=True, **kw)
    assert mk.LAUNCHES[f"megakernel:{key}+guides+rays"] == before + 1
    second = mk.render_guides(scene, cam, return_ray_count=True, **kw)
    assert set(first) == {"albedo", "normal", "depth", "rays"}
    for mode in mk.GUIDES:
        img, rays = mk.render_cuda(scene, cam, mode=mode, max_depth=1, return_ray_count=True,
                                   **kw)
        assert torch.equal(first[mode], img), mode
        assert torch.equal(first[mode], second[mode]), mode
        assert torch.equal(first["rays"], rays)
    assert bool((first["rays"] == kw["spp"]).all())


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 1024, 1025, 2500])
def test_staged_brute_scan_at_every_sphere_count(dev, n):
    """The brute route stages at most 1024 spheres a chunk: at counts
    around the block size, the BVH threshold and the chunk size, the
    guides equal the single-mode launches bit for bit (each launched
    twice, identical) and the plain version at 1% / 2e-4; with no sphere
    every ray sees the sky (albedo == normal, depth 0)."""
    cam = T.derive_camera(T.CameraSettings.default(), 64, 40).to(dev)
    scene = T.as_scene(sphere_cloud(T, n, dev, seed=n))
    kw = dict(width=64, height=40, spp=2, t_min=1e-3, frame_seed=n)
    g = mk.render_guides(scene, cam, **kw)
    for mode in mk.GUIDES:
        single = mk.render_cuda(scene, cam, mode=mode, max_depth=1, **kw)
        assert torch.equal(g[mode], single), mode
        assert torch.equal(single, mk.render_cuda(scene, cam, mode=mode, max_depth=1, **kw))
        if n:
            _assert_match(g[mode], mk.render_reference(scene, cam, mode=mode, max_depth=1, **kw))
    if not n:
        assert torch.equal(g["albedo"], g["normal"]) and not bool(g["depth"].any())


def test_inactive_spheres_never_win(dev):
    """A scene with every third sphere inactive renders the same planes,
    bit for bit, as the scene of its active spheres alone (the staged
    table leaves inactive spheres out and keeps the scan order), and
    matches the plain version."""
    cam = T.derive_camera(T.CameraSettings.default(), 64, 40).to(dev)
    sp = sphere_cloud(T, 300, dev, seed=11, inactive_every=3)
    keep = sp.radii > 0
    active = T.Spheres(*(getattr(sp, f.name)[keep] for f in dataclasses.fields(T.Spheres)))
    kw = dict(width=64, height=40, spp=2, t_min=1e-3, frame_seed=2)
    with_inactive = mk.render_guides(sp, cam, **kw)
    only_active = mk.render_guides(active, cam, **kw)
    for mode in mk.GUIDES:
        assert torch.equal(with_inactive[mode], only_active[mode]), mode
        _assert_match(with_inactive[mode],
                      mk.render_reference(sp, cam, mode=mode, max_depth=1, **kw))


def test_render_denoised_launches_the_guides_once(dev):
    """render_denoised on the card: with no grad one beauty launch and one
    guides launch a frame, the guides bit-equal to three render() passes;
    with an albedo leaf that requires grad the three single-mode passes
    (KernelFrame's replay needs each mode's graph), and backward() runs."""
    scene, settings = T.one_weekend_scene(0, device=dev), T.CameraSettings.default()
    cfg = T.RenderConfig(width=64, height=48, spp=2, max_depth=6, backend="cuda")
    mk.LAUNCHES.clear()
    out, beauty, aovs = T.render_denoised(scene, settings, cfg, frame_seed=4, return_aovs=True)
    assert dict(mk.LAUNCHES) == {"megakernel:brute": 1, "megakernel:brute+guides": 1}
    for mode in mk.GUIDES:
        want = T.render(scene, settings, dataclasses.replace(cfg, integrator=mode), frame_seed=4)
        assert torch.equal(aovs[mode], want), mode
    albedo = scene.albedo.clone().requires_grad_(True)
    mk.LAUNCHES.clear()
    T.render_denoised(dataclasses.replace(scene, albedo=albedo), settings, cfg,
                      frame_seed=4).mean().backward()
    assert dict(mk.LAUNCHES) == {"megakernel:brute": 4}
    assert bool(torch.isfinite(albedo.grad).all()) and bool((albedo.grad != 0).any())


@pytest.mark.parametrize("flags,launches", [
    ([], {"megakernel:brute": 1}),
    (["--rng", "wgsl"], {}),
    (["--denoise", "2"], {"megakernel:brute": 1, "megakernel:brute+guides": 1}),
])
def test_cli_render_png_equals_the_api_frame(dev, tmp_path, flags, launches):
    """`render` through cli.main on the card (its default --device cuda
    and --backend auto) writes the PNG of the API's frame at the same
    arguments, byte for byte, through the launches its route needs (none
    on the WGSL stream, which the plain integrator draws on the card)."""
    from PIL import Image

    from gpu_ray_tracing_tpu_torch import cli
    from gpu_ray_tracing_tpu_torch.utils.image import to_uint8, tonemap

    out = str(tmp_path / "cli.png")
    mk.LAUNCHES.clear()
    assert cli.main(["render", "--width", "96", "--height", "54", "--spp", "4", "--depth", "8",
                     "--seed", "3", "--out", out] + flags) == 0
    assert dict(mk.LAUNCHES) == launches
    rng = "wgsl" if "wgsl" in flags else "hash"
    cfg = T.RenderConfig(width=96, height=54, spp=4, max_depth=8, rng=rng,
                         backend="torch" if rng == "wgsl" else "cuda")
    scene, settings = T.one_weekend_scene(0, device=dev), T.CameraSettings.default()
    if "--denoise" in flags:
        img = T.render_denoised(scene, settings, cfg, frame_seed=3, iterations=2)
    else:
        img = T.render(scene, settings, cfg, frame_seed=3)
    assert img.device.type == "cuda"
    assert np.array_equal(np.asarray(Image.open(out)), to_uint8(tonemap(img)))


@pytest.mark.parametrize("size", [(96, 54), (1280, 720), (48, 27), (1283, 717)])
def test_derive_camera_on_the_card_equals_the_cpu(dev, size):
    """A camera derived from settings on the card is the one derived on the
    CPU, bit for bit: the CLI builds its settings on --device."""
    settings = T.CameraSettings.default()
    on_card = T.derive_camera(settings.to(dev), *size)
    on_cpu = T.derive_camera(settings, *size)
    for f in dataclasses.fields(T.Camera):
        assert torch.equal(getattr(on_card, f.name).cpu(), getattr(on_cpu, f.name)), f.name
