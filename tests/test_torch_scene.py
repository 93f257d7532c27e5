"""The port's scene, camera, config and packers against the JAX package."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
from tests.test_api import BASE_CAMERA

SPHERE_FIELDS = ("centers", "radii", "albedo", "mat_kind", "mat_param")
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


def test_make_scene_refuses_what_needs_a_bvh():
    big = T.one_weekend_scene(0, grid_min=-11, grid_max=11)
    assert int((big.radii > 0).sum()) > T.SPHERE_BVH_THRESHOLD
    with pytest.raises(NotImplementedError, match="sphere BVH"):
        T.make_scene(big)
    with pytest.raises(NotImplementedError, match="sphere BVH"):
        T.make_scene(T.base_scene(), sphere_bvh=True)
    with pytest.raises(NotImplementedError, match="meshes"):
        T.make_scene(T.base_scene(), mesh=object())
    # The default scene stays on the brute scan, as in the JAX package.
    assert T.make_scene(T.one_weekend_scene(0)).sphere_bvh is None
    assert J.make_scene(J.one_weekend_scene(jax.random.key(0))).sphere_bvh is None
    assert T.make_scene(big, sphere_bvh=False).spheres.count == big.count


def test_degenerate_camera_raises():
    with pytest.raises(ValueError, match="look_from == look_at"):
        T.derive_camera(T.CameraSettings.make([1, 2, 3], [1, 2, 3], [0, 1, 0], 40, 0, 1), 8, 8)
    with pytest.raises(ValueError, match="parallel"):
        T.derive_camera(T.CameraSettings.make([0, 5, 0], [0, 0, 0], [0, 1, 0], 40, 0, 1), 8, 8)


@pytest.mark.parametrize("kw,item", [
    (dict(backend="wavefront"), "item 13"),
    (dict(nee=True), "K1b"),
    (dict(rng="threefry"), "item 2"),
    (dict(rng="wgsl", parity=True), "item 2"),
    (dict(sampler="sobol"), "K1e"),
    (dict(backend="cuda", adaptive_tol=0.05), "K1f"),
])
def test_config_names_the_roadmap_item_of_unported_modes(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        T.RenderConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(width=0), dict(spp=0), dict(max_depth=0), dict(parity=True),
    dict(mis=True), dict(clamp=-1.0), dict(clamp=1.0, integrator="normal"),
    dict(adaptive_tol=0.1), dict(regenerate="on"), dict(backend="pallas"),
    dict(backend="cuda", rng="threefry"),
])
def test_config_cross_field_checks(kw):
    with pytest.raises(ValueError):
        T.RenderConfig(**kw)


def test_port_imports_no_jax():
    """The package imports where jax cannot be imported, and no source file
    under it names jax in an import."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import gpu_ray_tracing_tpu_torch as t; "
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
