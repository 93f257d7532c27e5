"""The port's BVH builders, BVH walk and sphere-BVH scenes against the JAX
package, on the CPU.

Both builders ('numpy' median split, 'native' binned SAH from the one
bvh_builder.cpp) are held bit-equal to the JAX package's, array by array.
The plain walk (`intersect_bvh`) is held to the JAX walk on seeded random
rays: equal hits, t to 1e-5 relative, equal winners except near ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.models import mesh as jmesh
from gpu_ray_tracing_tpu.ops import bvh as jbvh
from gpu_ray_tracing_tpu.ops import intersect as jx
from gpu_ray_tracing_tpu_torch import native
from gpu_ray_tracing_tpu_torch.ops import bvh as tbvh
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
from tests.test_torch_mesh import _random_rays, assert_hits_agree, assert_meshes_equal

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

BVH_FIELDS = ("bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count")
SPHERE_FIELDS = ("centers", "radii", "albedo", "mat_kind", "mat_param")
TMIN, TMAX = 1e-3, 3.4e35


def assert_bvhs_equal(jb, tb):
    assert jb.leaf_size == tb.leaf_size
    for f in BVH_FIELDS:
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f


def assert_spheres_equal(js, ts):
    for f in SPHERE_FIELDS:
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy()), f


def _random_boxes(seed, n):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=3.0, size=(n, 3))
    half = rng.uniform(0.01, 0.5, (n, 3))
    return c, c - half, c + half


def test_native_builder_compiles_into_the_port():
    assert native.available(), native.build_error()
    assert native.LIBRARY.startswith(native.BUILD_DIR)


@pytest.mark.parametrize("method", ["numpy", "native"])
@pytest.mark.parametrize("n,leaf_size", [(1, 4), (37, 1), (500, 4), (300, 16)])
def test_build_bvh_matches_jax(method, n, leaf_size):
    c, lo, hi = _random_boxes(n, n)
    jb, jorder = jbvh.build_bvh(c, lo, hi, leaf_size, method)
    before = tbvh.BUILDS[method]
    tb, torder = tbvh.build_bvh(c, lo, hi, leaf_size, method)
    assert tbvh.BUILDS[method] == before + 1
    assert_bvhs_equal(jb, tb)
    assert np.array_equal(jorder, torder)
    tbvh.validate_bvh(tb, n)


def test_build_bvh_auto_takes_the_native_builder():
    c, lo, hi = _random_boxes(3, 64)
    before = tbvh.BUILDS["native"]
    tb, _ = tbvh.build_bvh(c, lo, hi)
    assert tbvh.BUILDS["native"] == before + 1
    assert_bvhs_equal(jbvh.build_bvh(c, lo, hi, method="native")[0], tb)


def test_build_bvh_validates_inputs():
    c, lo, hi = _random_boxes(1, 8)
    with pytest.raises(ValueError, match="method"):
        tbvh.build_bvh(c, lo, hi, method="sah")
    with pytest.raises(ValueError, match="leaf_size"):
        tbvh.build_bvh(c, lo, hi, leaf_size=0)
    with pytest.raises(ValueError, match="zero primitives"):
        tbvh.build_bvh(c[:0], lo[:0], hi[:0])


def test_round_out_f32_matches_jax():
    v = np.random.default_rng(5).normal(size=1000) * 10.0
    for up in (False, True):
        assert np.array_equal(jbvh._round_out_f32(v, up), tbvh._round_out_f32(v, up))


@pytest.mark.parametrize("method", ["numpy", "native"])
@pytest.mark.parametrize("smooth", [False, True])
def test_build_mesh_bvh_matches_jax(method, smooth):
    jm, jb = jbvh.build_mesh_bvh(jmesh.torus(nu=16, nv=8, smooth=smooth), 4, method)
    tm, tb = tbvh.build_mesh_bvh(T.torus(nu=16, nv=8, smooth=smooth), 4, method)
    assert_meshes_equal(jm, tm)
    assert_bvhs_equal(jb, tb)
    tbvh.validate_bvh(tb, tm.num_triangles)


@pytest.mark.parametrize("method", ["numpy", "native"])
def test_build_sphere_bvh_matches_jax(method):
    js = J.one_weekend_scene(jax.random.key(1)).pad_to_multiple(128)
    ts = T.from_reference(js)
    jr, jb = jbvh.build_sphere_bvh(js, method=method)
    tr, tb = tbvh.build_sphere_bvh(ts, method=method)
    assert_spheres_equal(jr, tr)
    assert_bvhs_equal(jb, tb)
    n_active = int((ts.radii > 0).sum())
    tbvh.validate_bvh(tb, n_active)
    r = tr.radii.numpy()
    assert np.all(r[:n_active] > 0) and np.all(r[n_active:] == 0)


def test_validate_bvh_rejects_broken_trees():
    c, lo, hi = _random_boxes(2, 40)
    tb, _ = tbvh.build_bvh(c, lo, hi, 4, "numpy")
    with pytest.raises(AssertionError, match="cover"):
        tbvh.validate_bvh(tb, 41)
    back = tb.miss_link.clone()
    back[-1] = 0
    with pytest.raises(AssertionError, match="forward"):
        tbvh.validate_bvh(tbvh.BVH(tb.bbox_min, tb.bbox_max, back, tb.leaf_start,
                                   tb.leaf_count, tb.leaf_size), 40)


def test_bvh_planes_match_jax():
    """The kernels' node records (tmk.bvh_nodes: bmin, bmax x / bmax y, z,
    miss link, start << LEAF_COUNT_BITS | count) hold what JAX's
    bvh_planes packs, bit for bit."""
    from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk

    _, jb = jbvh.build_mesh_bvh(jmesh.icosphere(2))
    jf, ji = (np.asarray(a) for a in jmk.bvh_planes(jb))
    rec = tmk.bvh_nodes(T.from_reference(jb), 320).numpy()
    words = rec.view(np.int32)
    assert rec.dtype == np.float32 and rec.shape == (jf.shape[1], 8)
    assert np.array_equal(rec[:, 0:6].T.view(np.int32), jf[0:6].view(np.int32))
    assert not jf[6:].any() and not ji[3].any()
    assert np.array_equal(words[:, 6], ji[0])
    link, bits = words[:, 7], tmk.LEAF_COUNT_BITS
    leaf = ji[1] >= 0
    assert np.array_equal(link >= 0, leaf)
    assert np.array_equal(link[leaf] >> bits, ji[1][leaf])
    assert np.array_equal(link[leaf] & ((1 << bits) - 1), ji[2][leaf])


# --- the walk -----------------------------------------------------------------


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("leaf_size", [1, 4])
def test_intersect_bvh_matches_jax(smooth, leaf_size):
    jm, jb = jbvh.build_mesh_bvh(jmesh.icosphere(2, smooth=smooth), leaf_size)
    o, d = _random_rays(13, 3000)
    # Rays from inside the sphere and along the axes too.
    o[:200] *= 0.1
    d[200:230] = np.eye(3, dtype=np.float32).repeat(10, axis=0)
    jh = jax.jit(lambda o, d: jx.intersect_bvh(o, d, jm, jb, TMIN, TMAX))(o, d)
    th = tx.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), T.from_reference(jm),
                          T.from_reference(jb), TMIN, TMAX)
    assert_hits_agree(jh, th)


def test_intersect_bvh_equals_brute_force():
    tm, tb = tbvh.build_mesh_bvh(T.trefoil(nu=32, nv=8, smooth=True))
    o, d = (torch.from_numpy(a) for a in _random_rays(17, 2000))
    o = o * 2.0
    walk = tx.intersect_bvh(o, d, tm, tb, TMIN, TMAX)
    brute = tx.intersect_triangles(o, d, tm, TMIN, TMAX)
    assert torch.equal(walk.hit, brute.hit)
    assert torch.equal(walk.t, brute.t)
    assert torch.equal(walk.idx[walk.hit], brute.idx[brute.hit])


# --- sphere-BVH scenes --------------------------------------------------------


def _sphere_bvh_scenes():
    js = J.make_scene(J.one_weekend_scene(jax.random.key(0)), sphere_bvh=True)
    assert js.sphere_bvh is not None
    return js, T.from_reference(js)


def test_sphere_bvh_scene_matches_jax():
    """A forced sphere BVH at 64x40: backend='torch' scans the reordered
    spheres, as backend='jax' does, at the sphere-BVH contract of
    tests/test_pallas.py (flip <= 2%, mean |diff| < 2e-3)."""
    js, ts = _sphere_bvh_scenes()
    kw = dict(width=64, height=40, max_depth=6)
    want = np.asarray(J.render(js, J.CameraSettings.default(), J.RenderConfig(**kw),
                               frame_seed=jnp.uint32(2)))
    got = T.render(ts, T.CameraSettings.default(), T.RenderConfig(backend="torch", **kw), frame_seed=2)
    m = T.images_match(got, want, 0.02, 2e-3)
    assert m.ok, m


def test_sphere_bvh_trace_matches_jax_pieces():
    """The same frame from JAX's jitted raygen + trace_path, which the fully
    fused render departs from by a few flipped pixels: the port matches
    these pieces at the tighter contract (flip <= 1%, mean < 2e-4)."""
    from gpu_ray_tracing_tpu.ops import integrators as ji
    from gpu_ray_tracing_tpu.ops import rays as jr
    from gpu_ray_tracing_tpu_torch.ops import integrators as ti
    from gpu_ray_tracing_tpu_torch.ops import rays as tr

    js, ts = _sphere_bvh_scenes()
    w, h = 64, 40
    jc = J.derive_camera(J.CameraSettings.default(), w, h)
    jo, jd, jseeds = jax.jit(lambda s, f: jr.generate_rays_hash(jc, w, h, s, f))(
        jnp.uint32(0), jnp.uint32(2))
    want = jax.jit(lambda o, d, s: ji.trace_path(o, d, js, 6, TMIN, TMAX, pixel_seeds=s))(
        jo.reshape(-1, 3), jd.reshape(-1, 3), jseeds.reshape(-1))
    to, td, tseeds = tr.generate_rays_hash(T.from_reference(jc), w, h, 0, 2)
    got = ti.trace_path(to.reshape(-1, 3), td.reshape(-1, 3), ts, 6, TMIN, TMAX,
                        pixel_seeds=tseeds.reshape(-1))
    m = T.images_match(got.reshape(h, w, 3), np.asarray(want).reshape(h, w, 3), 0.01, 2e-4)
    assert m.ok, m
