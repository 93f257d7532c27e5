"""The denoiser's guide planes from one closest hit (render_guides and its
plain version render_guides_reference) and render_denoised's use of them,
on the CPU.

render_guides_reference traces each sample once and shades the albedo,
normal and depth planes of that one intersection, so each plane must equal
render_reference(mode=<plane>) bit for bit, on every route and sampler;
against the JAX package's AOV integrators (what render(integrator=...)
runs on backend='jax'), jitted, the planes are held to the AOV goldens'
thresholds (tests/test_goldens.py: flip <= 0.2%, mean |diff| < 1e-5).
The kernel, render_guides, runs only on the card: its
tests are in tests/test_torch_cuda.py; here it must refuse a CPU tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import rays as jr
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

W, H = 48, 36
# The JAX tests' BASE_CAMERA (tests/test_api.py:22-29) and test_pallas.py's
# mesh camera.
BASE_CAMERA = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0], vup=[0.0, 1.0, 0.0],
                   field_of_view=60.0, defocus_angle=0.0, focus_distance=2.0)
MESH_CAMERA = dict(BASE_CAMERA, look_from=[0.0, 1.0, 3.0], look_at=[0.0, 0.5, 0.0],
                   field_of_view=45.0, focus_distance=3.0)


def _jax_scene(case: str):
    if case == "base":
        return J.base_scene()
    if case == "sphere_bvh":
        # 487 spheres: above SPHERE_BVH_THRESHOLD, so make_scene builds the walk.
        return J.make_scene(J.one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    if case == "mesh":
        ground = J.make_spheres([((0.0, -1000.0, 0.0), 1000.0, J.LAMBERTIAN,
                                  (0.5, 0.5, 0.5), 0.0)])
        ico = J.transform_mesh(J.icosphere(2, albedo=(0.8, 0.4, 0.2), smooth=True), 0.7,
                               (0.0, 0.7, 0.0))
        return J.make_scene(ground, ico)
    return J.one_weekend_scene(jax.random.key(0))


def _settings(case: str) -> dict:
    """CameraSettings fields: One-Weekend's default (defocus 0.6) unless
    the case has its own."""
    if case == "base":
        return BASE_CAMERA
    if case == "mesh":
        return MESH_CAMERA
    return dict(look_from=[13.0, 2.0, 3.0], look_at=[0.0, 0.0, 0.0], vup=[0.0, 1.0, 0.0],
                field_of_view=20.0, defocus_angle=0.6, focus_distance=10.0)


# case -> (scene and camera, sampler, spp)
CASES = {
    "one_weekend": ("one_weekend", "independent", 3),
    "one_weekend_stratified": ("one_weekend", "stratified", 4),
    "one_weekend_sobol": ("one_weekend", "sobol", 4),
    "base": ("base", "independent", 2),
    "sphere_bvh": ("sphere_bvh", "independent", 2),
    "mesh": ("mesh", "independent", 2),
}


def _port_case(case: str):
    scene_name, sampler, spp = CASES[case]
    scene = T.from_reference(_jax_scene(scene_name))
    settings = T.CameraSettings.make(**_settings(scene_name))
    cfg = T.RenderConfig(width=W, height=H, spp=spp, sampler=sampler, backend="torch")
    kw = dict(width=W, height=H, spp=spp, t_min=cfg.t_min, t_max=cfg.t_max,
              sampler_spec=cfg.sampler_spec, frame_seed=5)
    return scene, T.derive_camera(settings, W, H), kw


@pytest.mark.parametrize("case", list(CASES))
def test_guides_reference_equals_three_single_mode_renders(case):
    """One intersection per sample gives each plane of render_reference's
    own pass bit for bit."""
    scene, cam, kw = _port_case(case)
    guides = mk.render_guides_reference(scene, cam, **kw)
    assert set(guides) == {"albedo", "normal", "depth"}
    for mode in mk.GUIDES:
        want = mk.render_reference(scene, cam, mode=mode, max_depth=1, **kw)
        assert torch.equal(guides[mode], want), mode


def test_guides_reference_row_band_and_ray_count():
    """A row band (y_offset 1, row_stride 2) with the ray counter: planes
    and counts bit-equal to the single-mode passes, one ray a sample."""
    scene, cam, kw = _port_case("one_weekend")
    kw = dict(kw, height=H // 2, y_offset=1, row_stride=2)
    guides = mk.render_guides_reference(scene, cam, return_ray_count=True, **kw)
    for mode in mk.GUIDES:
        img, rays = mk.render_reference(scene, cam, mode=mode, max_depth=1,
                                        return_ray_count=True, **kw)
        assert torch.equal(guides[mode], img), mode
        assert torch.equal(guides["rays"], rays)
    assert bool((guides["rays"] == kw["spp"]).all())
    full = mk.render_guides_reference(scene, cam, **dict(kw, height=H, y_offset=0,
                                                         row_stride=1))
    assert torch.equal(guides["depth"], full["depth"][1::2])


@pytest.mark.parametrize("case", list(CASES))
def test_guide_planes_match_jax(case):
    """The three planes against the JAX package's AOV integrators on the
    same stream: its hash ray generation and shade_albedo, shade_normals
    and shade_depth (what render(integrator=...) runs on backend='jax'),
    all under one jit a case, the samples summed in order and divided by
    spp; at the AOV goldens' thresholds.  The jitted pieces, not the fused
    render: XLA's whole-frame fusion rounds a few pixels differently from
    its own pieces (ROADMAP.md, standing gaps)."""
    scene_name, sampler, spp = CASES[case]
    cfg = J.RenderConfig(width=W, height=H, spp=spp, sampler=sampler, backend="jax")
    js = _jax_scene(scene_name)
    jcam = J.derive_camera(J.CameraSettings(**{k: jnp.asarray(v, jnp.float32)
                                                for k, v in _settings(scene_name).items()}),
                           W, H)

    @jax.jit
    def sample(sc, cam, s):
        o, d, _ = jr.generate_rays_hash(cam, W, H, s, jnp.uint32(5),
                                        sampler_spec=cfg.sampler_spec)
        return [shade(o, d, sc, cfg.t_min, cfg.t_max)
                for shade in (ji.shade_albedo, ji.shade_normals, ji.shade_depth)]

    acc = [np.zeros((H, W, 3), np.float32) for _ in mk.GUIDES]
    for s in range(spp):
        acc = [a + np.asarray(p) for a, p in zip(acc, sample(js, jcam, jnp.uint32(s)))]
    scene, cam, kw = _port_case(case)
    got = mk.render_guides_reference(scene, cam, **kw)
    for mode, a in zip(mk.GUIDES, acc):
        m = T.images_match(got[mode], a / np.float32(spp), 0.002, 1e-5)
        assert m.ok, (mode, m)


def test_render_denoised_is_three_renders_and_the_filter():
    """render_denoised(backend='torch') equals the composition it stands
    for, bit for bit: the beauty render(), three single-mode render()
    passes and atrous_denoise."""
    scene, settings = T.base_scene(), T.CameraSettings.make(**BASE_CAMERA)
    cfg = T.RenderConfig(width=W, height=H, spp=2, max_depth=4, backend="torch")
    out, beauty, aovs = T.render_denoised(scene, settings, cfg, frame_seed=9,
                                          return_aovs=True)
    assert torch.equal(beauty, T.render(scene, settings, cfg, frame_seed=9))
    for mode in mk.GUIDES:
        want = T.render(scene, settings, dataclasses.replace(cfg, integrator=mode),
                        frame_seed=9)
        assert torch.equal(aovs[mode], want), mode
    want = T.atrous_denoise(beauty, albedo=aovs["albedo"],
                            normal=T.decode_normal_aov(aovs["normal"]),
                            depth=aovs["depth"][..., 0])
    assert torch.equal(out, want)


def _count_calls(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(api, name)

    def counted(*args, **kwargs):
        calls.append(kwargs.get("config", args[2] if len(args) > 2 else None))
        return real(*args, **kwargs)

    monkeypatch.setattr(api, name, counted)
    return calls


def test_render_denoised_routes_the_guides(monkeypatch):
    """No input requires grad: one beauty render() and one
    render_guides_reference.  An albedo leaf that requires grad: the three
    single-mode render() passes (a kernel backend replays each mode's
    graph), and backward() reaches the leaf."""
    renders = _count_calls(monkeypatch, "render")
    guides = _count_calls(monkeypatch, "render_guides_reference")
    scene, settings = T.base_scene(), T.CameraSettings.make(**BASE_CAMERA)
    cfg = T.RenderConfig(width=24, height=18, spp=1, max_depth=3, backend="torch")
    T.render_denoised(scene, settings, cfg, frame_seed=2)
    assert [c.integrator for c in renders] == ["path"] and len(guides) == 1
    renders.clear()
    guides.clear()
    albedo = scene.albedo.clone().requires_grad_(True)
    out = T.render_denoised(dataclasses.replace(scene, albedo=albedo), settings, cfg,
                            frame_seed=2)
    assert [c.integrator for c in renders] == ["path", "albedo", "normal", "depth"]
    assert not guides
    out.mean().backward()
    assert bool(torch.isfinite(albedo.grad).all()) and bool((albedo.grad != 0).any())


@pytest.mark.parametrize("backend", ["cuda", "wavefront"])
def test_guides_refuse_the_cpu(backend):
    """render_guides takes CUDA tensors only, and render_denoised on a
    kernel backend without a card raises _cuda_device's error: no
    fallback to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the kernel runs")
    scene, cam, kw = _port_case("base")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        mk.render_guides(scene, cam, **kw)
    cfg = T.RenderConfig(width=8, height=8, spp=1, max_depth=2, backend=backend)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        T.render_denoised(T.base_scene(), T.CameraSettings.make(**BASE_CAMERA), cfg)


def test_guides_take_only_the_fixed_loops_keywords():
    """The guides take no `mode` and none of the adaptive loop's keywords
    (it would stop each plane's tiles at its own count), in both
    versions."""
    scene, cam, kw = _port_case("base")
    for fn in (mk.render_guides_reference, mk.render_guides):
        for extra in (dict(mode="albedo"), dict(adaptive_tol=0.05), dict(return_spp_map=True)):
            with pytest.raises(TypeError):
                fn(scene, cam, **kw, **extra)


def test_sphere_test_count(monkeypatch):
    """ops/intersect.SPHERE_TESTS, from which chip_smoke.py counts the
    least work of a frame's closest hits: each (ray, active sphere) test
    counts once, its roots are the tests whose discriminant (here in
    float64, on rays that keep it away from 0) is not negative, and
    counting leaves the planes bit-equal."""
    from gpu_ray_tracing_tpu_torch.ops import intersect

    rng = np.random.default_rng(7)
    n, p = 40, 500
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    centers = f32(rng.uniform(-4.0, 4.0, (n, 3)))
    radii = f32(rng.uniform(0.2, 1.0, n))
    radii[::5] = 0.0
    origins = f32(rng.uniform(-0.5, 0.5, (p, 3)))
    dirs = f32(rng.normal(size=(p, 3)))
    oc = centers[None] - origins[:, None]
    h = np.einsum("pk,pnk->pn", dirs, oc)
    disc = h * h - np.einsum("pk,pk->p", dirs, dirs)[:, None] * (
        np.einsum("pnk,pnk->pn", oc, oc) - radii ** 2)
    active = radii > 0
    assert np.abs(disc[:, active]).min() > 1e-4
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    spheres = T.Spheres(t(centers), t(radii), t(rng.uniform(0.1, 0.9, (n, 3))),
                        torch.zeros(n, dtype=torch.int32), torch.zeros(n))
    counts = {"tests": 0, "roots": 0}
    monkeypatch.setattr(intersect, "SPHERE_TESTS", counts)
    hit = intersect.intersect_spheres(t(origins), t(dirs), spheres, 1e-3, 3.4e35)
    assert int(counts["tests"]) == p * int(active.sum())
    assert int(counts["roots"]) == int((disc[:, active] >= 0).sum())
    monkeypatch.setattr(intersect, "SPHERE_TESTS", None)
    plain = intersect.intersect_spheres(t(origins), t(dirs), spheres, 1e-3, 3.4e35)
    assert torch.equal(hit.t, plain.t) and torch.equal(hit.idx, plain.idx)

    scene, cam, kw = _port_case("one_weekend")
    want = mk.render_guides_reference(scene, cam, **kw)
    counts = {"tests": 0, "roots": 0}
    monkeypatch.setattr(intersect, "SPHERE_TESTS", counts)
    got = mk.render_guides_reference(scene, cam, **kw)
    assert all(torch.equal(got[m], want[m]) for m in mk.GUIDES)
    active = int((T.as_scene(scene).spheres.radii > 0).sum())
    assert int(counts["tests"]) == W * H * kw["spp"] * active
    assert 0 < int(counts["roots"]) < int(counts["tests"])
