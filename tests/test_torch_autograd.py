"""Gradients of the kernel backends: the replay (ops/autograd.py) against
jax.grad, finite differences and autograd through backend='torch'.

`render()` on 'cuda' and 'wavefront' differentiates through KernelFrame,
whose backward is `render_vjp`'s replay of the plain integrator on the
same hash stream.  Here, without a card:
- render_vjp against jax.grad of JAX's jitted pieces (derive_camera, hash
  ray generation, trace_path, the mean over samples), every float leaf of
  the scene and the derived camera, on the tri-light NEE+MIS scene of
  tests/test_gradients.py (24x16, 2 spp, depth 3, sky 0) and on
  base_scene (16x12, 1 spp, depth 4), look_from through derive_camera;
- the replay's block budget does not change the gradient;
- tests/test_gradients.py's central finite differences, through
  backend='torch' autograd and through render_vjp;
- KernelFrame's wiring, with the plain version as its forward;
- the refusals: a kernel backend without a card, the progressive steps.
The JAX side compiles each loss once per module.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.models import camera as jcam
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu_torch.ops import autograd as ag
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
BASE_CAMERA = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0], vup=[0.0, 1.0, 0.0],
                   field_of_view=60.0, defocus_angle=0.0, focus_distance=2.0)
# (width, height, spp, depth, trace_path options) of each case.
TRI = (24, 16, 2, 3, dict(sky_intensity=0.0, nee=True, mis=True))
BASE = (16, 12, 1, 4, {})


def _jax_settings(look_from=None):
    kw = {k: jnp.asarray(v, jnp.float32) for k, v in BASE_CAMERA.items()}
    if look_from is not None:
        kw["look_from"] = look_from
    return J.CameraSettings(**kw)


def _quad_light(mod, y, half, le):
    verts = np.array([[-half, y, -2.0 - half], [half, y, -2.0 - half],
                      [half, y, -2.0 + half], [-half, y, -2.0 + half]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return mod.make_mesh(verts, faces, albedo=(1.0, 0.9, 0.8), mat_kind=mod.EMISSIVE,
                         mat_param=le)


def _tri_light_scene(mod):
    """tests/test_gradients.py::_tri_light_scene, built by either package."""
    spheres = mod.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, mod.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.3, 0.4, -2.0), 0.4, mod.LAMBERTIAN, (0.4, 0.5, 0.8), 0.0),
    ])
    return mod.make_scene(spheres, _quad_light(mod, 1.8, 0.7, 6.0))


def _many_lights_scene():
    """benchmarks/parity_check.py::_many_lights_scene, built by the port:
    81 light ordinals (1 emissive sphere + an 80-face emissive icosphere)."""
    spheres = T.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((2.0, 2.2, -2.0), 0.4, T.EMISSIVE, (1.0, 0.9, 0.7), 4.0),
    ])
    glow = T.transform_mesh(T.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=T.EMISSIVE,
                                        mat_param=3.0), 0.5, (-0.8, 1.8, -2.0))
    return T.make_scene(spheres, glow)


def _weights(w, h):
    return np.random.default_rng(5).random((h, w, 3)).astype(np.float32)


def _cfg(case, **kw):
    w, h, spp, depth, opts = case
    return T.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, backend="torch",
                          **opts, **kw)


def _jax_image(scene, cam, case):
    w, h, spp, depth, opts = case
    acc = jnp.zeros((h * w, 3), jnp.float32)
    for k in range(spp):
        o, d, seeds = jr.generate_rays_hash(cam, w, h, jnp.uint32(k), jnp.uint32(SEED))
        acc = acc + ji.trace_path(o.reshape(-1, 3), d.reshape(-1, 3), scene, depth, 1e-3,
                                  3.4e35, pixel_seeds=seeds.reshape(-1), **opts)
    return (acc / spp).reshape(h, w, 3)


def _leaves(obj, prefix=""):
    """{path: tensor or array} of a dataclass tree's array fields."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, prefix + f.name + "."))
        elif v is not None and hasattr(v, "shape"):
            out[prefix + f.name] = v
    return out


def _pull_back(obj, d_obj):
    """Carry render_vjp's gradients `d_obj` of the dataclass `obj` back to
    the tensors `obj` was computed from (torch.autograd.backward)."""
    d = _leaves(d_obj)
    pairs = [(t, d[k]) for k, t in _leaves(obj).items() if t.requires_grad]
    torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])


@functools.cache
def _jax_grads(name):
    """jax.grad of sum(weights * image) over JAX's jitted pieces, with
    respect to the scene and the derived camera: ({path: grad}, camera)."""
    scene = _tri_light_scene(J) if name == "tri" else J.make_scene(J.base_scene())
    case = TRI if name == "tri" else BASE
    cam = jcam.derive_camera(_jax_settings(), case[0], case[1])
    wts = _weights(case[0], case[1])
    loss = lambda sc, c: jnp.sum(_jax_image(sc, c, case) * wts)
    gs, gc = jax.jit(jax.grad(loss, argnums=(0, 1), allow_int=True))(scene, cam)
    grads = {"scene." + k: np.asarray(v) for k, v in _leaves(gs).items()}
    grads.update({"camera." + k: np.asarray(v) for k, v in _leaves(gc).items()})
    return scene, cam, grads


@pytest.mark.parametrize("name", ["tri", "base"])
def test_render_vjp_matches_jax_grad(name):
    """render_vjp's d(sum w * image) for every float leaf of the scene and
    the derived camera against jax.grad of JAX's jitted pieces, each leaf
    within 2e-5 of its largest entry (measured: at most 4.7e-6, the
    camera's pixel_delta_v; 1.6e-6 for the shading leaves; the stream's
    hit decisions agree here, so only rounding differs); a leaf JAX gives
    zero (the BVH's bounds) is zero; the albedo and the tri-light emission
    are nonzero."""
    jscene, jcamera, want = _jax_grads(name)
    case = TRI if name == "tri" else BASE
    d_scene, d_camera = T.render_vjp(T.from_reference(jscene), T.from_reference(jcamera),
                                     _cfg(case), torch.from_numpy(_weights(case[0], case[1])),
                                     frame_seed=SEED)
    got = {"scene." + k: v for k, v in _leaves(d_scene).items()}
    got.update({"camera." + k: v for k, v in _leaves(d_camera).items()})
    floats = {k for k, v in want.items() if v.dtype != jax.dtypes.float0}
    assert floats == set(got), (floats ^ set(got))
    for k in floats:
        g, w = got[k].numpy(), want[k]
        scale = np.abs(w).max()
        if scale == 0.0:
            assert not g.any(), k
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * scale, err_msg=k)
    assert np.abs(want["scene.spheres.albedo"]).max() > 0
    if name == "tri":
        assert np.abs(want["scene.tri_lights.emission"]).max() > 0


@functools.cache
def _jax_look_from_grad():
    case = BASE
    scene = J.make_scene(J.base_scene())
    wts = _weights(case[0], case[1])

    def loss(lf):
        cam = jcam.derive_camera(_jax_settings(lf), case[0], case[1])
        return jnp.sum(_jax_image(scene, cam, case) * wts)

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(BASE_CAMERA["look_from"],
                                                          jnp.float32)))


def test_render_vjp_look_from_through_derive_camera_matches_jax_grad():
    """d/d look_from: render_vjp's camera gradient taken back through the
    port's derive_camera equals jax.grad through JAX's, within 2e-5 of its
    largest entry (measured 4.3e-7), and equals autograd through
    backend='torch' within rtol 1e-5."""
    w, h = BASE[0], BASE[1]
    settings = T.CameraSettings.make(**BASE_CAMERA)
    lf = settings.look_from.clone().requires_grad_(True)
    cam = T.derive_camera(settings.replace(look_from=lf), w, h)
    wts = torch.from_numpy(_weights(w, h))
    scene = T.as_scene(T.base_scene())
    _pull_back(cam, T.render_vjp(scene, cam, _cfg(BASE), wts, frame_seed=SEED)[1])
    want = _jax_look_from_grad()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(lf.grad.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    lf2 = settings.look_from.clone().requires_grad_(True)
    img = T.render(scene, settings.replace(look_from=lf2), _cfg(BASE), frame_seed=SEED)
    (img * wts).sum().backward()
    np.testing.assert_allclose(lf.grad.numpy(), lf2.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_block_budget_does_not_change_the_gradient(monkeypatch):
    """The replay at a block budget forced small (6 blocks a sample) equals
    it at one block a sample within 1e-6 of each leaf's largest entry:
    only the order in which the blocks' gradients are summed differs (an
    entry that sums terms of either sign moves by up to 6.5e-8 of that
    scale; 2e-6 of itself)."""
    jscene, jcamera, _ = _jax_grads("tri")
    scene, cam = T.from_reference(jscene), T.from_reference(jcamera)
    w, h, _, depth, _ = TRI
    wts = torch.from_numpy(_weights(w, h))
    one = mk.dataclass_tensors(T.render_vjp(scene, cam, _cfg(TRI), wts, SEED)[0])
    monkeypatch.setattr(ag, "REPLAY_BLOCK_CPU", depth * w * h // 6)
    assert ag.replay_block(w * h, scene, _cfg(TRI), torch.device("cpu")) == w * h // 6
    many = mk.dataclass_tensors(T.render_vjp(scene, cam, _cfg(TRI), wts, SEED)[0])
    assert any(bool(a.abs().max() > 0) for a in one if a is not None)
    for a, b in zip(one, many):
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-6 * float(a.abs().max()))


# --- finite differences (tests/test_gradients.py) ----------------------------


def _scaled_scene(scene, s, a):
    """tests/test_gradients.py::_scaled_scene: every emission source scaled
    by `s` (the BSDF-hit side's mat_param and the NEE light lists alike),
    and the floor albedo's red channel set to `a`."""
    sp = scene.spheres
    floor = torch.cat([a.reshape(1), sp.albedo[0, 1:]])
    albedo = torch.cat([floor[None], sp.albedo[1:]])
    emis_sp = sp.mat_kind == T.EMISSIVE
    sp = dataclasses.replace(sp, albedo=albedo,
                             mat_param=torch.where(emis_sp, sp.mat_param * s, sp.mat_param))
    out = dataclasses.replace(scene, spheres=sp)
    if scene.lights is not None:
        out = dataclasses.replace(out, lights=dataclasses.replace(
            scene.lights, emission=scene.lights.emission * s))
    if scene.mesh is not None:
        emis_f = scene.mesh.mat_kind == T.EMISSIVE
        out = dataclasses.replace(out, mesh=dataclasses.replace(
            scene.mesh, mat_param=torch.where(emis_f, scene.mesh.mat_param * s,
                                              scene.mesh.mat_param)))
    if scene.tri_lights is not None:
        out = dataclasses.replace(out, tri_lights=dataclasses.replace(
            scene.tri_lights, emission=scene.tri_lights.emission * s))
    return out


def _fd_check(scene, mis=True, s0=1.0, a0=0.7, eps=2e-2, rtol=0.05):
    """d loss/d(emission scale s, floor albedo a) of loss = sum(w * image)
    (24x16, 2 spp, depth 3, sky 0, NEE) through backend='torch' autograd
    and through render_vjp, each against central differences of the loss
    on the same stream, at test_gradients.py's eps and rtol."""
    assert scene.sphere_bvh is None  # sphere 0 stays the floor
    case = (24, 16, 2, 3, dict(sky_intensity=0.0, nee=True, mis=mis))
    cfg = _cfg(case)
    settings = T.CameraSettings.make(**BASE_CAMERA)
    cam = T.derive_camera(settings, case[0], case[1])
    wts = torch.from_numpy(_weights(case[0], case[1]))

    def loss(s, a):
        img = T.render(_scaled_scene(scene, s, a), cam, cfg, frame_seed=SEED)
        return (img.double() * wts).sum()

    f = lambda s, a: float(loss(torch.tensor(s), torch.tensor(a)))
    fd = ((f(s0 + eps, a0) - f(s0 - eps, a0)) / (2 * eps),
          (f(s0, a0 + eps) - f(s0, a0 - eps)) / (2 * eps))
    s, a = torch.tensor(s0, requires_grad=True), torch.tensor(a0, requires_grad=True)
    loss(s, a).backward()
    autograd = (float(s.grad), float(a.grad))
    s2, a2 = torch.tensor(s0, requires_grad=True), torch.tensor(a0, requires_grad=True)
    scaled = _scaled_scene(scene, s2, a2)
    _pull_back(scaled, T.render_vjp(scaled, cam, cfg, wts, SEED)[0])
    replay = (float(s2.grad), float(a2.grad))
    for g in (autograd, replay):
        assert abs(g[0]) > 1e-6 and abs(g[1]) > 1e-6, g
        for got, want, what in zip(g, fd, ("emission", "albedo")):
            assert abs(got - want) <= rtol * abs(want), (what, got, want)
    np.testing.assert_allclose(replay, autograd, rtol=1e-5)


def test_fd_tri_light_nee_mis():
    """Triangle-light NEE+MIS (the tri-light pdf terms)."""
    scene = _tri_light_scene(T)
    assert scene.tri_lights is not None and scene.tri_lights.count == 2
    _fd_check(scene)


def test_fd_tri_light_nee_only():
    """The same scene without MIS (plain tri-light area sampling)."""
    _fd_check(_tri_light_scene(T), mis=False)


def test_fd_combined_pick_mis():
    """The > 4-light combined pick (81 ordinals: sphere and triangle
    lights, pick-pdf-scaled MIS weights): the pick index is
    parameter-independent, so the estimator is differentiable through the
    picked terms."""
    scene = _many_lights_scene()
    assert scene.lights.count + scene.tri_lights.count > 4
    _fd_check(scene)


# --- tests/test_api.py:343-371 ------------------------------------------------


def test_render_differentiable_wrt_albedo():
    """d mean(image)/d albedo exists and is nonzero (16x12, 1 spp, depth 4),
    through backend='torch' and through render_vjp, which agree."""
    scene = T.base_scene()
    albedo = scene.albedo.clone().requires_grad_(True)
    cfg = T.RenderConfig(width=16, height=12, spp=1, max_depth=4, backend="torch")
    settings = T.CameraSettings.make(**BASE_CAMERA)
    T.render(dataclasses.replace(scene, albedo=albedo), settings, cfg).mean().backward()
    g = albedo.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
    d_scene, _ = T.render_vjp(scene, T.derive_camera(settings, 16, 12), cfg,
                              torch.full((12, 16, 3), 1.0 / (12 * 16 * 3)))
    np.testing.assert_allclose(d_scene.spheres.albedo.numpy(), g, rtol=1e-5, atol=1e-9)


def test_render_differentiable_wrt_camera():
    """d mean(image)/d look_from is finite (16x12, 1 spp, depth 2)."""
    settings = T.CameraSettings.make(**BASE_CAMERA)
    lf = settings.look_from.clone().requires_grad_(True)
    cfg = T.RenderConfig(width=16, height=12, spp=1, max_depth=2, backend="torch")
    T.render(T.base_scene(), settings.replace(look_from=lf), cfg).mean().backward()
    assert np.all(np.isfinite(lf.grad.numpy()))


# --- KernelFrame ----------------------------------------------------------------


@pytest.mark.parametrize("sphere_light", [False, True])
def test_kernel_frame_wiring_with_the_plain_forward(sphere_light):
    """KernelFrame with the plain version standing in for the kernel (the
    card's forward cannot run here): the forward is render_fn's image, and
    the gradients of a loss of it equal autograd through backend='torch'
    within rtol 1e-5: down to the CameraSettings' look_from on the
    tri-light scene; with a sphere light, whose light list make_scene
    derives from the spheres, the spheres' albedo reaches the Function
    through both.  (look_from is not asked there: through the sphere
    light's cone sample its gradient is NaN in JAX's jitted pieces and in
    the port alike, sqrt at 0 under a select.)"""
    w, h, spp, depth, opts = TRI
    cfg = _cfg(TRI)
    wts = torch.from_numpy(_weights(w, h))

    def inputs():
        spheres = T.make_spheres([
            ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
            ((0.3, 0.4, -2.0), 0.4, T.LAMBERTIAN, (0.4, 0.5, 0.8), 0.0),
        ] + [((-0.5, 1.2, -2.2), 0.2, T.EMISSIVE, (1.0, 0.8, 0.6), 5.0)] * sphere_light)
        albedo = spheres.albedo.clone().requires_grad_(True)
        scene = T.make_scene(dataclasses.replace(spheres, albedo=albedo),
                             _quad_light(T, 1.8, 0.7, 6.0))
        lf = torch.tensor(BASE_CAMERA["look_from"], requires_grad=not sphere_light)
        return scene, T.CameraSettings.make(**BASE_CAMERA).replace(look_from=lf), albedo, lf

    scene, settings, albedo, lf = inputs()
    if sphere_light:
        assert scene.lights.emission.requires_grad
    cam = T.derive_camera(settings, w, h)

    def plain(sc, c):
        assert not any(t.requires_grad for t in mk.dataclass_tensors(sc))
        return mk.render_reference(sc, c, width=w, height=h, spp=spp, max_depth=depth,
                                   t_min=cfg.t_min, frame_seed=SEED, light_pick="lane",
                                   **opts)

    img = ag.kernel_frame(plain, scene, cam, cfg, SEED)
    (img * wts).sum().backward()
    scene2, settings2, albedo2, lf2 = inputs()
    want = T.render(scene2, settings2, cfg, frame_seed=SEED)
    (want * wts).sum().backward()
    assert torch.equal(img.detach(), want.detach())
    assert albedo.grad.abs().max() > 0
    np.testing.assert_allclose(albedo.grad.numpy(), albedo2.grad.numpy(), rtol=1e-5, atol=1e-8)
    if not sphere_light:
        assert lf.grad.abs().max() > 0
        np.testing.assert_allclose(lf.grad.numpy(), lf2.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_needs_grad_routes_only_recorded_grads():
    """The kernel backends take the Function only when autograd records
    and an input requires grad: no Function node on the no-grad path."""
    scene = T.as_scene(T.base_scene())
    cam = T.derive_camera(T.CameraSettings.make(**BASE_CAMERA), 8, 8)
    assert not ag.needs_grad(scene, cam)
    lf = cam.center.clone().requires_grad_(True)
    cam_g = dataclasses.replace(cam, center=lf)
    assert ag.needs_grad(scene, cam_g)
    with torch.no_grad():
        assert not ag.needs_grad(scene, cam_g)


@pytest.mark.parametrize("backend", ["cuda", "wavefront"])
def test_kernel_backend_with_grad_refuses_without_a_card(backend):
    """A kernel backend asked for a gradient with no card raises
    _cuda_device's error: no fallback to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the kernel runs")
    scene = T.base_scene()
    albedo = scene.albedo.clone().requires_grad_(True)
    cfg = T.RenderConfig(width=8, height=8, spp=1, max_depth=2, backend=backend)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        T.render(dataclasses.replace(scene, albedo=albedo), T.CameraSettings.make(**BASE_CAMERA),
                 cfg)


@pytest.mark.parametrize("backend", ["cuda", "wavefront"])
def test_progressive_step_with_grad_names_render(backend):
    """The progressive steps of the kernel backends have no backward (nor
    have JAX's): their refusal names render() as the differentiable entry
    point, before any device is needed."""
    scene = T.base_scene()
    albedo = scene.albedo.clone().requires_grad_(True)
    scene = dataclasses.replace(scene, albedo=albedo)
    settings = T.CameraSettings.make(**BASE_CAMERA)
    cfg = T.RenderConfig(width=8, height=8, spp=2, max_depth=2, backend=backend)
    with pytest.raises(RuntimeError, match=r"differentiate through render\(\)"):
        T.progressive_step(T.init_accum(8, 8), scene, settings, cfg)
    if backend == "cuda":
        acfg = dataclasses.replace(cfg, adaptive_tol=0.1)
        with pytest.raises(RuntimeError, match=r"differentiate through render\(\)"):
            T.adaptive_progressive_step(T.init_adaptive_accum(8, 8), scene, settings, acfg)


def test_inverse_rendering_example_runs_on_the_cpu():
    """examples/torch_inverse_rendering.py, 3 Adam steps at 16x12 through
    backend='torch', exits 0."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_inverse_rendering.py"),
         "--backend", "torch", "--steps", "3", "--width", "16", "--height", "12",
         "--max-error", "1.0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final max albedo error" in out.stdout
