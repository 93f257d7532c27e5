"""The port's scene, camera, config and packers against the JAX package."""

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
from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
from tests.test_api import BASE_CAMERA

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

SPHERE_FIELDS = ("centers", "radii", "albedo", "mat_kind", "mat_param")
MESH_FIELDS = ("v0", "e1", "e2", "normals", "albedo", "mat_kind", "mat_param",
               "n0", "n1", "n2")
BVH_FIELDS = ("bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count")
LIGHT_FIELDS = ("centers", "radii", "emission")
TRI_LIGHT_FIELDS = ("v0", "e1", "e2", "normal", "area", "emission", "face_ids")
EMISSIVE = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_spheres_equal(a, b):
    for f in SPHERE_FIELDS:
        want, got = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert want.dtype == got.dtype, f
        assert np.array_equal(want, got), f


@pytest.mark.parametrize("k", [0, 1])
def test_one_weekend_scene_matches_jax(k):
    _assert_spheres_equal(J.one_weekend_scene(jax.random.key(k)), T.one_weekend_scene(k))


def test_base_scene_matches_jax():
    _assert_spheres_equal(J.base_scene(), T.base_scene())


@pytest.mark.parametrize("which,size", [("default", (48, 27)), ("base", (64, 48))])
def test_derive_camera_matches_jax(which, size):
    jcs = J.CameraSettings.default() if which == "default" else BASE_CAMERA
    tcs = T.CameraSettings.default() if which == "default" else T.CameraSettings.make(
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0], 60.0, 0.0, 2.0)
    jc, tc = J.derive_camera(jcs, *size), T.derive_camera(tcs, *size)
    for f in jc.__dataclass_fields__:
        got = getattr(tc, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jc, f)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["base", "one_weekend"])
def test_scene_planes_match_jax(which):
    js = J.base_scene() if which == "base" else J.one_weekend_scene(jax.random.key(0))
    ts = T.base_scene() if which == "base" else T.one_weekend_scene(0)
    want, got = np.asarray(jmk.scene_planes(js)), tmk.scene_planes(ts).numpy()
    assert got.shape == want.shape == (16, js.count)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("which", ["default", "base"])
def test_camera_vector_matches_jax(which):
    jcs = J.CameraSettings.default() if which == "default" else BASE_CAMERA
    jc = J.derive_camera(jcs, 64, 48)
    want = np.asarray(jmk.camera_vector(jc))
    got = tmk.camera_vector(T.from_reference(jc)).numpy()
    assert got.shape == (1, 24)
    assert np.array_equal(want, got)


def test_from_reference_round_trip():
    js = J.one_weekend_scene(jax.random.key(1))
    _assert_spheres_equal(js, T.from_reference(js))
    sc = T.from_reference(J.make_scene(js))
    assert isinstance(sc, T.Scene) and sc.mesh is None and sc.sphere_bvh is None
    _assert_spheres_equal(js, sc.spheres)
    for jobj in (BASE_CAMERA, J.derive_camera(BASE_CAMERA, 64, 48)):
        tobj = T.from_reference(jobj)
        for f in jobj.__dataclass_fields__:
            assert np.array_equal(np.asarray(getattr(jobj, f)), getattr(tobj, f).numpy()), f
    with pytest.raises(TypeError):
        T.from_reference(object())


def _many_lights_scene(mod, mesh_mod):
    """benchmarks/parity_check.py::_many_lights_scene: an emissive sphere
    and an emissive icosphere."""
    spheres = mod.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, 0, (0.7, 0.7, 0.7), 0.0),
        ((2.0, 2.2, -2.0), 0.4, EMISSIVE, (1.0, 0.9, 0.7), 4.0),
    ])
    glow = mesh_mod.transform_mesh(
        mesh_mod.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=EMISSIVE, mat_param=3.0),
        scale=0.5, translate=(-0.8, 1.8, -2.0))
    return mod.make_scene(spheres, glow)


@pytest.mark.parametrize("part", ["mesh", "bvh", "lights", "tri_lights", "scene"])
def test_from_reference_carries_mesh_bvh_and_lights(part):
    from gpu_ray_tracing_tpu.models import mesh as jmesh

    js = _many_lights_scene(J, jmesh)
    if part == "scene":
        _assert_scenes_equal(js, T.from_reference(js))
        _assert_scenes_equal(js, _many_lights_scene(T, T))
        return
    fields = {"mesh": MESH_FIELDS, "bvh": BVH_FIELDS, "lights": LIGHT_FIELDS,
              "tri_lights": TRI_LIGHT_FIELDS}[part]
    tobj = T.from_reference(getattr(js, part))
    _assert_tensors_equal(getattr(js, part), tobj, fields)
    if part == "bvh":
        assert tobj.leaf_size == js.bvh.leaf_size


def _nee_scene(mod):
    """benchmarks/parity_check.py::_nee_scene: one emissive sphere."""
    return mod.make_scene(mod.make_spheres([
        ((0, -1000.0, 0), 1000.0, 0, (0.7, 0.7, 0.7), 0.0),
        ((0.0, 2.0, -2.0), 0.3, EMISSIVE, (1.0, 0.9, 0.7), 20.0),
        ((0.8, 0.4, -1.5), 0.4, 0, (0.3, 0.5, 0.8), 0.0),
    ]))


@pytest.mark.parametrize("which", ["nee", "emissive_mesh"])
def test_emissive_scenes_convert_and_render_without_nee(which):
    """A JAX scene with emissive spheres or faces carries its light lists
    over and renders with nee=False, where emission ends a path, under a
    dark sky, within the contract tests/test_pallas.py holds emissive
    scenes to across backends (flip <= 2%, mean |diff| < 2e-3)."""
    from gpu_ray_tracing_tpu.models import mesh as jmesh

    js = _nee_scene(J) if which == "nee" else _many_lights_scene(J, jmesh)
    ts = T.from_reference(js)
    _assert_scenes_equal(js, ts)
    assert ts.lights is not None
    assert (ts.tri_lights is not None) == (which == "emissive_mesh")
    kw = dict(width=48, height=36, spp=2, max_depth=5, sky_intensity=0.0)
    want = np.asarray(J.render(js, BASE_CAMERA, J.RenderConfig(**kw), frame_seed=jnp.uint32(9)))
    got = T.render(ts, T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                                             [0.0, 1.0, 0.0], 60.0, 0.0, 2.0),
                   T.RenderConfig(backend="torch", **kw), frame_seed=9)
    assert got.max() > 1.0  # a light is seen
    m = T.images_match(got, want, 0.02, 2e-3)
    assert m.ok, m


def test_tri_light_id_per_face_matches_jax():
    from gpu_ray_tracing_tpu.models import mesh as jmesh
    from gpu_ray_tracing_tpu.models.scene import tri_light_id_per_face

    js = _many_lights_scene(J, jmesh)
    ts = T.from_reference(js)
    want = np.asarray(tri_light_id_per_face(js.mesh, js.tri_lights))
    got = T.tri_light_id_per_face(ts.mesh, ts.tri_lights).numpy()
    assert got.dtype == np.int32 and np.array_equal(want, got)
    assert np.array_equal(T.tri_light_id_per_face(ts.mesh, None).numpy(),
                          np.full(ts.mesh.num_triangles, -1, np.int32))


def _assert_tensors_equal(jobj, tobj, fields):
    for f in fields:
        want, got = getattr(jobj, f), getattr(tobj, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f


def _assert_scenes_equal(js, ts):
    """Every array of two scenes equal, field by field."""
    _assert_spheres_equal(js.spheres, ts.spheres)
    assert (ts.bvh_leaf_size, ts.mesh_has_emissive) == (js.bvh_leaf_size, js.mesh_has_emissive)
    groups = {"mesh": MESH_FIELDS, "bvh": BVH_FIELDS, "sphere_bvh": BVH_FIELDS,
              "lights": LIGHT_FIELDS, "tri_lights": TRI_LIGHT_FIELDS}
    for name, fields in groups.items():
        jpart, tpart = getattr(js, name), getattr(ts, name)
        assert (jpart is None) == (tpart is None), name
        if jpart is not None:
            _assert_tensors_equal(jpart, tpart, fields)


def test_make_scene_matches_jax():
    """make_scene builds the sphere BVH above 256 active spheres and the mesh
    BVH, reorders, and extracts the light lists, as the JAX make_scene does."""
    big = T.one_weekend_scene(0, grid_min=-11, grid_max=11)
    assert int((big.radii > 0).sum()) > T.SPHERE_BVH_THRESHOLD
    jbig = J.make_scene(J.one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    tbig = T.make_scene(big)
    assert tbig.sphere_bvh is not None and tbig.sphere_bvh.leaf_size == 16
    _assert_scenes_equal(jbig, tbig)
    # The default scene stays on the brute scan; both switches force.
    assert T.make_scene(T.one_weekend_scene(0)).sphere_bvh is None
    assert T.make_scene(big, sphere_bvh=False).spheres.count == big.count
    _assert_scenes_equal(J.make_scene(J.base_scene(), sphere_bvh=True),
                         T.make_scene(T.base_scene(), sphere_bvh=True))
    # A mesh with emissive faces: reordered by its BVH, tri-lights after.
    glow = lambda m: m.transform_mesh(
        m.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=EMISSIVE, mat_param=3.0), 0.5,
        (-0.8, 1.8, -2.0))
    from gpu_ray_tracing_tpu.models import mesh as jmesh

    _assert_scenes_equal(J.make_scene(J.base_scene(), glow(jmesh)),
                         T.make_scene(T.base_scene(), glow(T)))
    _assert_scenes_equal(J.make_scene(J.base_scene(), glow(jmesh), use_bvh=False),
                         T.make_scene(T.base_scene(), glow(T), use_bvh=False))


def test_degenerate_camera_raises():
    with pytest.raises(ValueError, match="look_from == look_at"):
        T.derive_camera(T.CameraSettings.make([1, 2, 3], [1, 2, 3], [0, 1, 0], 40, 0, 1), 8, 8)
    with pytest.raises(ValueError, match="parallel"):
        T.derive_camera(T.CameraSettings.make([0, 5, 0], [0, 0, 0], [0, 1, 0], 40, 0, 1), 8, 8)


@pytest.mark.parametrize("kw,item", [
    (dict(backend="wavefront", regenerate="on"), None),
    (dict(nee=True), None),
    (dict(rng="threefry", backend="torch"), None),
    (dict(rng="wgsl", parity=True, backend="torch"), None),
    (dict(sampler="sobol"), None),
    (dict(backend="cuda", adaptive_tol=0.05), None),
])
def test_config_names_the_roadmap_item_of_unported_modes(kw, item):
    """Unported modes raise naming their item; ported ones (item None: NEE
    since K1b, the samplers since K1e, adaptive sampling since K1f, the
    wavefront engine with its ray regeneration since K2, the WGSL parity
    stream through 'torch' since the command line's slice, the threefry
    stream through 'torch' since the multi-GPU slice) are accepted."""
    if item is None:
        cfg = T.RenderConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        return
    with pytest.raises(NotImplementedError, match=item):
        T.RenderConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(width=0), dict(spp=0), dict(max_depth=0), dict(parity=True),
    dict(mis=True), dict(clamp=-1.0), dict(clamp=1.0, integrator="normal"),
    dict(adaptive_tol=0.1, backend="torch"), dict(regenerate="on"), dict(backend="pallas"),
    dict(backend="cuda", rng="threefry"),
])
def test_config_cross_field_checks(kw):
    with pytest.raises(ValueError):
        T.RenderConfig(**kw)


def test_clamp_with_regeneration_is_refused_with_the_references_contract():
    """Both packages refuse clamp > 0 with ray regeneration; the port's
    message gives the reference's contract, not a reason about its own pool
    (which writes each finished sample's clamped total once)."""
    kw = dict(clamp=1.0, regenerate="on")
    with pytest.raises(ValueError):
        J.RenderConfig(backend="wavefront", **kw)
    for backend in ("wavefront", "wavefront_torch"):
        with pytest.raises(ValueError, match="as the reference's RenderConfig refuses it") as e:
            T.RenderConfig(backend=backend, **kw)
        assert "per-bounce" not in str(e.value)
    assert T.RenderConfig(backend="wavefront", clamp=1.0).clamp == 1.0


@pytest.mark.parametrize("kw", [dict(), dict(width=50, height=31), dict(width=1920, height=1080)])
def test_resolution_num_pixels_and_reference_config_match_jax(kw):
    t, j = T.RenderConfig(**kw), J.RenderConfig(**kw)
    assert t.resolution == j.resolution and t.num_pixels == j.num_pixels
    assert isinstance(t.num_pixels, int)
    from gpu_ray_tracing_tpu.utils.config import REFERENCE_CONFIG as JREF
    for f in ("width", "height", "spp", "max_depth", "integrator", "rng", "sampler", "nee",
              "clamp", "t_min", "t_max", "sky_intensity", "russian_roulette_depth"):
        assert getattr(T.REFERENCE_CONFIG, f) == getattr(JREF, f), f
    assert T.REFERENCE_CONFIG.resolution == (1280, 720) and "REFERENCE_CONFIG" in T.__all__


def test_port_imports_no_jax():
    """The package and its multi-GPU modules import where jax cannot be
    imported, and no source file under it names jax in an import."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import gpu_ray_tracing_tpu_torch as t; "
            "import gpu_ray_tracing_tpu_torch.parallel.sharding; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'gpu_ray_tracing_tpu.')) "
            "for m in sys.modules if sys.modules[m] is not None); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pkg = os.path.join(REPO, "gpu_ray_tracing_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        words = line.split()
                        assert not (words[:2] in (["import", "jax"], ["from", "jax"])
                                    or (words[:1] in (["import"], ["from"]) and len(words) > 1
                                        and words[1].startswith(("jax.", "gpu_ray_tracing_tpu.")))), (
                            name, line)


def test_port_opens_no_file_of_the_jax_package():
    """The port keeps its own copy of what it needs: building a BVH scene
    (the native builder compiles from the port's own bvh_builder.cpp),
    rendering, and rendering sharded on a world-1 gloo mesh of the CPU open
    no file inside gpu_ray_tracing_tpu/, and no compiler is handed a path
    there."""
    code = """
import os, sys
ref = os.path.join(os.getcwd(), 'gpu_ray_tracing_tpu') + os.sep
bad = []
def hook(event, args):
    if event == 'open' and isinstance(args[0], str) and os.path.abspath(args[0]).startswith(ref):
        bad.append(args[0])
    if event == 'subprocess.Popen' and any(ref in str(a) for a in args[1]):
        bad.append(list(args[1]))
sys.addaudithook(hook)
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch import native
port = os.path.join(os.getcwd(), 'gpu_ray_tracing_tpu_torch') + os.sep
assert native.SOURCE.startswith(port) and os.path.exists(native.SOURCE), native.SOURCE
scene = T.make_scene(T.one_weekend_scene(0), sphere_bvh=True)
cfg = T.RenderConfig(width=8, height=8, spp=1, max_depth=2, backend='wavefront_torch')
T.render(scene, T.CameraSettings.default(), cfg)
import socket
import torch.distributed as dist
from gpu_ray_tracing_tpu_torch.parallel import mesh, sharding
with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', rank=0, world_size=1)
sharding.render_sharded(scene, T.CameraSettings.default(), cfg,
                        mesh.make_mesh(1, 1, device_type='cpu'))
dist.destroy_process_group()
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
