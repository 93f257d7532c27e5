"""The port's meshes, triangle intersection and mesh renders against the JAX
package, on the CPU.

Mesh generators are host numpy code in both packages, so their meshes are
held bit-equal.  Intersections of seeded random rays agree to 1e-5
relative in t and exactly in which face won, except where two faces' t
lie within that tolerance.  Path-traced images are held to the
decision-flip contract (utils/parity.images_match).  The CUDA kernel's
mesh tests are in tests/test_torch_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.models import mesh as jmesh
from gpu_ray_tracing_tpu.ops import intersect as jx
from gpu_ray_tracing_tpu_torch.models import mesh as tmesh
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MESH_FIELDS = ("v0", "e1", "e2", "normals", "albedo", "mat_kind", "mat_param",
               "n0", "n1", "n2")
TMIN, TMAX = 1e-3, 3.4e35


def assert_meshes_equal(jm, tm):
    for f in MESH_FIELDS:
        want, got = getattr(jm, f), getattr(tm, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, f
        assert np.array_equal(want, got), f


# --- generators: bit-equal ----------------------------------------------------

GENERATORS = {
    "icosphere0": lambda m: m.icosphere(0),
    "icosphere2_smooth": lambda m: m.icosphere(2, smooth=True, albedo=(0.2, 0.4, 0.6)),
    "torus": lambda m: m.torus(nu=12, nv=6, mat_kind=1, mat_param=0.3),
    "torus_smooth": lambda m: m.torus(0.8, 0.2, nu=10, nv=5, smooth=True),
    "box": lambda m: m.box((1.0, 2.0, 0.5), mat_kind=2, mat_param=1.5),
    "trefoil_smooth": lambda m: m.trefoil(nu=24, nv=6, smooth=True),
    "bunny_stand_in": lambda m: m.bunny_stand_in(),
    "grid_faces": lambda m: m.make_mesh(
        np.random.default_rng(2).normal(size=(20, 3)), m._grid_faces(5, 4), smooth=True),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_jax(name):
    assert_meshes_equal(GENERATORS[name](jmesh), GENERATORS[name](tmesh))


def test_make_mesh_smooth_on_random_vertices_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, size=(60, 3))
    kw = dict(albedo=(0.3, 0.2, 0.1), mat_kind=3, mat_param=4.0, smooth=True)
    assert_meshes_equal(jmesh.make_mesh(verts, faces, **kw), tmesh.make_mesh(verts, faces, **kw))


@pytest.mark.parametrize("scale,translate", [(0.8, (0.0, 0.8, 0.0)), (3.7, (-1.25, 2.0, 9.5))])
def test_transform_mesh_matches_jax(scale, translate):
    j = jmesh.transform_mesh(jmesh.icosphere(1, smooth=True), scale, translate)
    t = tmesh.transform_mesh(tmesh.icosphere(1, smooth=True), scale, translate)
    assert_meshes_equal(j, t)
    with pytest.raises(ValueError, match="scale > 0"):
        tmesh.transform_mesh(tmesh.box(), -1.0)


@pytest.mark.parametrize("smooth", [False, True])
def test_merge_meshes_matches_jax(smooth):
    parts = lambda m: (m.box(), m.transform_mesh(m.icosphere(1, smooth=smooth), 0.5, (1, 0, 0)),
                       m.torus(nu=6, nv=4, mat_kind=3, mat_param=2.0))
    assert_meshes_equal(jmesh.merge_meshes(*parts(jmesh)), tmesh.merge_meshes(*parts(tmesh)))


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv 2 2 2\n"
                    "f 1/1/1 2/2/2 3/3/3 4/4/4\nf -1 -2 -3\n")
    assert_meshes_equal(jmesh.load_obj(str(path), smooth=True), tmesh.load_obj(str(path), smooth=True))


def test_cornell_box_matches_jax():
    from gpu_ray_tracing_tpu.models.cornell import cornell_box_scene, cornell_camera

    js, ts = cornell_box_scene(), T.cornell_box_scene()
    assert_meshes_equal(js.mesh, ts.mesh)
    for f in ("bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count"):
        assert np.array_equal(np.asarray(getattr(js.bvh, f)), getattr(ts.bvh, f).numpy()), f
    assert ts.tri_lights.count == js.tri_lights.count == 2 and ts.mesh_has_emissive
    jc, tc = cornell_camera(), T.cornell_camera()
    for f in jc.__dataclass_fields__:
        assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy()), f


# --- triangle intersection ----------------------------------------------------


def _random_rays(seed, n, center=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-2.5, 2.5, (n, 3)) + np.asarray(center)).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) + np.float32(center)
    d = (target - o + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    return o, d


def assert_hits_agree(jh, th, t_rtol=1e-5):
    """Equal hit flags; t within t_rtol relative; equal winning face except
    where the two winners' t lie within the tolerance; normals and front
    faces equal where the same face won."""
    hit = np.asarray(jh.hit)
    assert hit.any() and (~hit).any()
    assert np.array_equal(hit, th.hit.numpy())
    jt, tt = np.asarray(jh.t)[hit], th.t.numpy()[hit]
    np.testing.assert_allclose(tt, jt, rtol=t_rtol)
    same = np.asarray(jh.idx)[hit] == th.idx.numpy()[hit]
    assert same.mean() > 0.99
    np.testing.assert_allclose(np.asarray(jh.normal)[hit][same], th.normal.numpy()[hit][same],
                               atol=1e-5)
    assert np.array_equal(np.asarray(jh.front_face)[hit][same],
                          th.front_face.numpy()[hit][same])


@pytest.mark.parametrize("smooth", [False, True])
def test_intersect_triangles_matches_jax(smooth):
    jm = jmesh.icosphere(1, smooth=smooth)
    o, d = _random_rays(7, 3000)
    jh = jax.jit(lambda o, d: jx.intersect_triangles(o, d, jm, TMIN, TMAX))(o, d)
    th = tx.intersect_triangles(torch.from_numpy(o), torch.from_numpy(d),
                                T.from_reference(jm), TMIN, TMAX)
    assert_hits_agree(jh, th)


def test_moller_trumbore_rounds_like_xla():
    """The triangle test's t, u, v are bit-equal to the jitted JAX ones: the
    cross and inner products round as XLA:CPU's fused multiply-adds."""
    rng = np.random.default_rng(11)
    o, d, v0, e1, e2 = (rng.normal(size=(5000, 3)).astype(np.float32) for _ in range(5))
    jt, _ = jax.jit(lambda *a: jx._moller_trumbore(*a, TMIN, TMAX))(o, d, v0, e1, e2)
    tt, _, _, _ = tx._moller_trumbore(*(torch.from_numpy(a) for a in (o, d, v0, e1, e2)),
                                      TMIN, TMAX)
    assert np.array_equal(np.asarray(jt), tt.numpy())


# --- renders ------------------------------------------------------------------


def _pallas_test_scene(mod, mesh_mod, smooth=False):
    """tests/test_pallas.py::test_pallas_mesh_scene_matches_jax's scene."""
    spheres = mod.make_spheres([
        ((0, -1000.0, 0), 1000.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((-1.5, 0.5, -1.0), 0.5, 1, (0.9, 0.9, 0.9), 0.05),
    ])
    mesh = mesh_mod.transform_mesh(
        mesh_mod.icosphere(2, albedo=(0.8, 0.4, 0.2), smooth=smooth), 0.7, (0.0, 0.7, 0.0))
    return mod.make_scene(spheres, mesh)


PALLAS_TEST_CAMERA = dict(look_from=[0.0, 1.0, 3.0], look_at=[0.0, 0.5, 0.0],
                          vup=[0.0, 1.0, 0.0], field_of_view=45.0, defocus_angle=0.0,
                          focus_distance=3.0)


def _cameras():
    jcs = J.CameraSettings(**{k: jnp.asarray(v, jnp.float32)
                              for k, v in PALLAS_TEST_CAMERA.items()})
    return jcs, T.from_reference(jcs)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("integrator", ["normal", "path"])
def test_mesh_render_matches_jax(integrator, smooth):
    """backend='torch' against backend='jax' on test_pallas.py's mesh scene,
    at its contract (flip <= 2%, mean |diff| < 2e-3)."""
    js = _pallas_test_scene(J, jmesh, smooth)
    ts = T.from_reference(js)
    jcs, tcs = _cameras()
    kw = dict(width=64, height=48, max_depth=5, integrator=integrator)
    want = np.asarray(J.render(js, jcs, J.RenderConfig(**kw), frame_seed=jnp.uint32(1)))
    got = T.render(ts, tcs, T.RenderConfig(backend="torch", **kw), frame_seed=1)
    assert np.isfinite(got.numpy()).all()
    m = T.images_match(got, want, 0.02, 2e-3)
    assert m.ok, m


def test_make_scene_mesh_renders_like_the_converted_scene():
    """The port's own make_scene builds the same scene as JAX's: the
    render of each is the same image."""
    jcs, tcs = _cameras()
    cfg = T.RenderConfig(width=32, height=24, spp=1, max_depth=4, backend="torch")
    a = T.render(_pallas_test_scene(T, tmesh, True), tcs, cfg, frame_seed=3)
    b = T.render(T.from_reference(_pallas_test_scene(J, jmesh, True)), tcs, cfg, frame_seed=3)
    assert torch.equal(a, b)


def _mesh_ico_scene():
    """benchmarks/parity_check.py::_mesh_scene, from the port's generators."""
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    ico = T.transform_mesh(T.icosphere(2, albedo=(0.75, 0.6, 0.45), smooth=True),
                           scale=0.8, translate=(0.0, 0.8, 0.0))
    return T.make_scene(ground, ico)


MESH_CAMERA = T.CameraSettings.make([0.0, 1.2, 3.0], [0.0, 0.7, 0.0], [0.0, 1.0, 0.0],
                                    60.0, 0.0, 2.0)


def test_golden_mesh_ico():
    """The mesh_ico_48x36 golden through backend='torch', at
    test_goldens.py's thresholds for it."""
    img = T.render(_mesh_ico_scene(), MESH_CAMERA,
                   T.RenderConfig(width=48, height=36, spp=2, max_depth=4,
                                  backend="torch"), frame_seed=11)
    m = T.images_match(img, np.load(os.path.join(GOLDEN_DIR, "mesh_ico_48x36.npy")),
                       0.005, 1e-4)
    assert m.ok, m


def test_mesh_without_bvh_matches_bvh_render():
    """A mesh scene without a BVH (brute triangle scan) renders the same
    image as through its BVH: the walk finds every closest hit."""
    sc = _mesh_ico_scene()
    cam = T.derive_camera(MESH_CAMERA, 24, 18)
    kw = dict(width=24, height=18, max_depth=3, t_min=TMIN, spp=1, frame_seed=5)
    brute = T.Scene(spheres=sc.spheres, mesh=sc.mesh, bvh=None)
    assert torch.equal(tmk.render_reference(sc, cam, **kw), tmk.render_reference(brute, cam, **kw))


def test_mesh_packers_match_jax():
    from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk

    jm = jmesh.merge_meshes(jmesh.icosphere(1, smooth=True),
                            jmesh.box(mat_kind=3, mat_param=2.0))
    want = np.asarray(jmk.mesh_table(jm, None))
    got = tmk.mesh_table(T.from_reference(jm)).numpy()
    assert got.shape == (jm.num_triangles, 32)
    assert np.array_equal(want.reshape(-1, 32)[: jm.num_triangles], got)
    assert (got[:, 23] == -1.0).all()
