"""The wavefront engine of the port on the CPU: its plain version
(render_wavefront_reference, backend='wavefront_torch') against the plain
megakernel version and against the JAX package.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here the host loop they share with the plain version is
held to its contract: with regeneration off the image equals
render_reference(light_pick='sample') bit for bit on every route;
compact_threshold, sort and refill_threshold are invisible;
regeneration stays within 3e-5 (it measures 0: finished samples fold in
sample order).  Against JAX: the compaction helpers exactly, one bounce of
`_wf_kernel` (Pallas, interpret mode) against wavefront_bounce_reference on
the same numpy-seeded state, and the whole engine at the goldens' base_path
thresholds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from benchmarks import parity_check as pc
from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk
from gpu_ray_tracing_tpu.ops.pallas import wavefront as jwf
from gpu_ray_tracing_tpu_torch import convert
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as twf

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)
MESH_CAMERA = T.CameraSettings.make([0.0, 1.0, 3.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0],
                                    45.0, 0.0, 3.0)
LIGHTS_CAMERA = T.CameraSettings.make([0.0, 2.0, 6.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0],
                                      50.0, 0.0, 6.0)


def _sphere_bvh_scene():
    return T.make_scene(T.one_weekend_scene(0), sphere_bvh=True)


def _mesh_scene(subdivisions=2, albedo=(0.8, 0.4, 0.2), scale=0.7):
    """A smooth icosphere of `scale` resting on a ground sphere (at
    subdivisions=6, albedo (0.75, 0.6, 0.45), scale 0.8: BASELINE config 4's
    81,920 faces)."""
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    ico = T.icosphere(subdivisions, albedo=albedo, smooth=True)
    return T.make_scene(ground, T.transform_mesh(ico, scale, (0.0, scale, 0.0)))


def _one_light_scene():
    return T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.6, 0.6, 0.6), 0.0),
        ((0.0, 2.0, 0.0), 0.4, T.EMISSIVE, (1.0, 0.9, 0.8), 5.0)]))


def _lights_scene(count):
    """tests/test_integrators.py::_many_lights_fixture: a floor and the first
    `count` of 6 sphere lights (3: the all-lights loop; 6: the pick)."""
    lights = [((0.0, 3.0, 0.0), 0.3, 4.0), ((2.5, 2.5, 0.0), 0.2, 6.0),
              ((-2.5, 2.5, 0.0), 0.25, 3.0), ((0.0, 2.5, 2.5), 0.2, 5.0),
              ((0.0, 2.5, -2.5), 0.3, 2.0), ((1.8, 2.8, 1.8), 0.15, 8.0)]
    rows = [((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0)]
    rows += [(c, r, T.EMISSIVE, (1.0, 1.0, 1.0), le) for c, r, le in lights[:count]]
    return T.make_scene(T.make_spheres(rows))


def _tri_lights_scene():
    """parity_check._many_lights_scene: 1 sphere light and an 80-face
    emissive icosphere (81 light ordinals, sphere and triangle candidates)."""
    spheres = T.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((2.0, 2.2, -2.0), 0.4, T.EMISSIVE, (1.0, 0.9, 0.7), 4.0)])
    glow = T.transform_mesh(T.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=T.EMISSIVE,
                                        mat_param=3.0), 0.5, (-0.8, 1.8, -2.0))
    return T.make_scene(spheres, glow)


LIT = dict(nee=True, sky_intensity=0.0)
# name -> (scene, camera settings, width, height, keywords)
ROUTES = {
    "base": (T.base_scene, T_CAMERA, 64, 48, dict(spp=2, max_depth=6, frame_seed=7)),
    "odd_size": (T.base_scene, T_CAMERA, 50, 31,
                 dict(spp=3, max_depth=6, frame_seed=2, sample_index=5)),
    "sphere_bvh_rr": (_sphere_bvh_scene, None, 64, 40,
                      dict(spp=1, max_depth=8, russian_roulette_depth=3, frame_seed=3)),
    "mesh": (_mesh_scene, MESH_CAMERA, 64, 48, dict(spp=1, max_depth=5, frame_seed=1)),
    "nee_one_light": (_one_light_scene, LIGHTS_CAMERA, 64, 32,
                      dict(spp=2, max_depth=4, frame_seed=5, **LIT)),
    "nee_mis_three_lights": (lambda: _lights_scene(3), LIGHTS_CAMERA, 64, 32,
                             dict(spp=2, max_depth=4, frame_seed=5, mis=True, **LIT)),
    "six_lights_pick": (lambda: _lights_scene(6), LIGHTS_CAMERA, 64, 32,
                        dict(spp=2, max_depth=3, frame_seed=5, **LIT)),
    "tri_lights_pick_mis": (_tri_lights_scene, T_CAMERA, 48, 36,
                            dict(spp=2, max_depth=4, frame_seed=17, mis=True, **LIT)),
    "sobol": (T.base_scene, None, 64, 48,
              dict(spp=4, max_depth=6, frame_seed=9, sampler_spec=("sobol", 3))),
    "stratified": (T.base_scene, T_CAMERA, 48, 32,
                   dict(spp=4, max_depth=6, frame_seed=9, sampler_spec=("stratified", 2, 2))),
    "clamp": (lambda: _lights_scene(3), LIGHTS_CAMERA, 48, 32,
              dict(spp=2, max_depth=4, frame_seed=5, clamp=0.25, mis=True, **LIT)),
}


def _route(name):
    scene, cam, w, h, kw = ROUTES[name]
    cam = T.derive_camera(T.CameraSettings.default() if cam is None else cam, w, h)
    return scene(), cam, dict(width=w, height=h, t_min=1e-3, **kw)


@pytest.mark.parametrize("name", list(ROUTES))
def test_plain_engine_equals_plain_megakernel_bit_for_bit(name):
    """Regeneration off: the same stream, the same arithmetic in the same
    order, so the image equals render_reference's and the ray counts its
    plane, on every route."""
    scene, cam, kw = _route(name)
    want, want_rays = tmk.render_reference(scene, cam, return_ray_count=True, **kw)
    got, rays = T.render_wavefront_reference(scene, cam, return_ray_count=True, **kw)
    assert got.shape == (kw["height"], kw["width"], 3)
    assert torch.isfinite(got).all() and got.mean() > 1e-3
    assert torch.equal(got, want)
    assert torch.equal(rays, want_rays)
    assert torch.equal(T.render_wavefront_reference(scene, cam, **kw), want)
    assert twf.LAST_RUN["live_ray_bounces"] <= int(want_rays.sum())


@pytest.mark.parametrize("name", [n for n in ROUTES if n != "clamp"])
def test_regeneration_is_invisible(name):
    """One persistent pool refilled with the next samples' primary rays:
    within JAX's 3e-5 of the sample-major loop (tests/test_wavefront.py:236);
    it measures 0, since finished samples fold in sample order."""
    scene, cam, kw = _route(name)
    want = T.render_wavefront_reference(scene, cam, **kw)
    live = twf.LAST_RUN["live_ray_bounces"]
    got = T.render_wavefront_reference(scene, cam, regenerate=True, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-5)
    assert twf.LAST_RUN["regenerate"] and twf.LAST_RUN["live_ray_bounces"] == live
    if kw["spp"] > 1:
        assert twf.LAST_RUN["raygen_launches"] > 1


@pytest.mark.parametrize("extra", [
    dict(compact_threshold=1.1), dict(compact_threshold=0.0), dict(sort="live"),
    dict(sort="spatial"), dict(sort="octant-flat"),
    dict(sort="live", compact_threshold=1.1),
    dict(sort="spatial", compact_threshold=1.1),
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_scheduling_options_are_invisible(extra):
    """compact_threshold (always / never / gated), the sort keys and the
    compaction granularity only schedule: bit-equal images, regeneration
    off and on (test_wavefront_compact_threshold_is_invisible,
    test_wavefront_sort_modes_are_invisible)."""
    scene = _sphere_bvh_scene()
    w, h = 64, 36
    cam = T.derive_camera(T.CameraSettings.default(), w, h)
    kw = dict(width=w, height=h, max_depth=8, t_min=1e-3, spp=2, russian_roulette_depth=4,
              frame_seed=3)
    want = T.render_wavefront_reference(scene, cam, **kw)
    assert torch.equal(T.render_wavefront_reference(scene, cam, **kw, **extra), want)
    if extra.get("compact_threshold") == 0.0:
        assert twf.LAST_RUN["compactions"] == 0
    regen = T.render_wavefront_reference(scene, cam, regenerate=True, **kw, **extra)
    assert torch.equal(regen, want)


@pytest.mark.parametrize("refill", [0.0, 0.25, 0.9, 1.0])
def test_refill_threshold_is_invisible(refill):
    scene, cam, kw = _route("base")
    kw = dict(kw, spp=3)
    want = T.render_wavefront_reference(scene, cam, **kw)
    got = T.render_wavefront_reference(scene, cam, regenerate=True, refill_threshold=refill, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("regenerate", [False, True])
def test_row_bands_equal_the_full_frame(regenerate):
    """y_offset, row_stride and total_width address a band of a larger
    frame; pixel ids, and so the stream, are global."""
    scene = T.base_scene()
    w, h = 50, 32
    cam = T.derive_camera(T_CAMERA, w, h)
    kw = dict(max_depth=5, t_min=1e-3, spp=2, frame_seed=9, regenerate=regenerate)
    full = T.render_wavefront_reference(scene, cam, width=w, height=h, **kw)
    top = T.render_wavefront_reference(scene, cam, width=w, height=16, y_offset=0,
                                       total_width=w, **kw)
    bot = T.render_wavefront_reference(scene, cam, width=w, height=16, y_offset=16,
                                       total_width=w, **kw)
    assert torch.equal(torch.cat([top, bot]), full)
    odd = T.render_wavefront_reference(scene, cam, width=w, height=16, y_offset=1,
                                       row_stride=2, total_width=w, **kw)
    assert torch.equal(odd, full[1::2])


def test_regeneration_degenerate_cases():
    """spp 1 is one pool fill; max_depth 0 renders black without tracing a
    bounce; a spp above the pool's sample batch runs one pool per batch."""
    scene, cam, kw = _route("base")
    one = dict(kw, spp=1)
    assert torch.equal(T.render_wavefront_reference(scene, cam, regenerate=True, **one),
                       T.render_wavefront_reference(scene, cam, **one))
    assert twf.LAST_RUN["raygen_launches"] == 1
    for regenerate in (False, True):
        black = T.render_wavefront_reference(scene, cam, regenerate=regenerate,
                                             **dict(kw, max_depth=0))
        assert torch.equal(black, torch.zeros(48, 64, 3))
        assert twf.LAST_RUN["bounce_launches"] == 0
    small = dict(kw, width=16, height=8, spp=5, max_depth=3)
    cam = T.derive_camera(T_CAMERA, 16, 8)
    want = T.render_wavefront_reference(scene, cam, **small)
    batch = twf.REGEN_BATCH
    try:
        twf.REGEN_BATCH = 2
        got = T.render_wavefront_reference(scene, cam, regenerate=True, **small)
    finally:
        twf.REGEN_BATCH = batch
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-5)


def test_argument_errors():
    """The checks of the JAX engine (wavefront.py:349-374), with their
    messages, and the port's own."""
    scene, cam, kw = _route("base")
    render = functools.partial(T.render_wavefront_reference, scene, cam)
    with pytest.raises(ValueError, match="sort="):
        render(sort="bogus", **kw)
    with pytest.raises(ValueError, match="refill_threshold"):
        render(regenerate=True, refill_threshold=1.1, **kw)
    with pytest.raises(ValueError, match="spp must be >= 1"):
        render(**dict(kw, spp=0))
    with pytest.raises(ValueError, match="requires nee=True"):
        render(mis=True, **kw)
    with pytest.raises(ValueError, match="clamp > 0 is unsupported with ray regeneration"):
        render(regenerate=True, clamp=1.0, **kw)
    with pytest.raises(ValueError, match="return_ray_count is unsupported"):
        render(regenerate=True, return_ray_count=True, **kw)
    mesh_no_bvh = T.make_scene(T.as_scene(scene).spheres, _mesh_scene(1).mesh, use_bvh=False)
    with pytest.raises(ValueError, match="requires a BVH"):
        T.render_wavefront_reference(mesh_no_bvh, cam, **kw)
    # The card's engine takes CUDA tensors only and never falls back.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            T.render_wavefront(scene, cam, **kw)


def test_backends_through_the_entry_points():
    """render() and progressive_step() route 'wavefront_torch' to the plain
    engine (regenerate 'off', 'on', and 'auto' = on when spp > 1), the AOV
    integrators to the megakernel's plain version; 'wavefront' needs a card;
    count_traced_rays counts through the megakernel path."""
    scene = T.base_scene()
    cfg = T.RenderConfig(width=64, height=48, spp=2, max_depth=6, backend="wavefront_torch")
    want = T.render(scene, T_CAMERA, T.RenderConfig(width=64, height=48, spp=2, max_depth=6,
                                                    backend="torch"), frame_seed=7)
    off = T.render(scene, T_CAMERA, cfg, frame_seed=7)
    assert torch.equal(off, want) and not twf.LAST_RUN["regenerate"]
    for mode in ("on", "auto"):
        img = T.render(scene, T_CAMERA, dataclasses.replace(cfg, regenerate=mode), frame_seed=7)
        assert twf.LAST_RUN["regenerate"]
        np.testing.assert_allclose(img.numpy(), want.numpy(), atol=3e-5, rtol=1e-5)
    # 'auto' with one sample a step stays off; two steps of one equal spp=2.
    state = T.init_accum(48, 64)
    for _ in range(2):
        state = T.progressive_step(state, scene, T_CAMERA,
                                   dataclasses.replace(cfg, regenerate="auto"), frame_seed=7)
        assert not twf.LAST_RUN["regenerate"]
    assert int(state.count) == 2
    np.testing.assert_allclose(state.rgb.numpy(), want.numpy(), atol=1e-6)
    one = T.progressive_step(T.init_accum(48, 64), scene, T_CAMERA, cfg, frame_seed=7,
                             spp_per_step=2)
    np.testing.assert_allclose(one.rgb.numpy(), want.numpy(), atol=1e-6)
    normal = dict(width=64, height=48, spp=1, integrator="normal")
    assert torch.equal(
        T.render(scene, T_CAMERA, T.RenderConfig(backend="wavefront_torch", **normal)),
        T.render(scene, T_CAMERA, T.RenderConfig(backend="torch", **normal)))
    rays = T.count_traced_rays(scene, T_CAMERA, dataclasses.replace(cfg, regenerate="on"),
                               frame_seed=7)
    assert rays == T.count_traced_rays(scene, T_CAMERA, dataclasses.replace(
        cfg, backend="torch"), frame_seed=7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="backend='wavefront' needs an NVIDIA GPU"):
            T.render(scene, T_CAMERA, dataclasses.replace(cfg, backend="wavefront"))
    with pytest.raises(ValueError, match="megakernel mode"):
        T.adaptive_progressive_step(T.init_adaptive_accum(48, 64), scene, T_CAMERA,
                                    dataclasses.replace(cfg, adaptive_tol=0.05,
                                                        backend="wavefront_torch"))


# --- against the JAX package -------------------------------------------------


def test_compaction_helpers_equal_jax_exactly():
    """_global_pids, _partition_live and _sort_rows_octant (with the bounce
    bucket and the origin grid) on random inputs."""
    rng = np.random.default_rng(20261016)
    local = np.arange(4096, dtype=np.int32)
    for kw in (dict(p=3072, width=64, height=48, y_offset=0, total_width=64, row_stride=1),
               dict(p=1550, width=50, height=31, y_offset=7, total_width=50, row_stride=3)):
        want = np.asarray(jwf._global_pids(jnp.asarray(local), **kw))
        got = twf._global_pids(torch.from_numpy(local).long(), **kw)
        assert np.array_equal(got.numpy(), want)
    live = (rng.random(517) < 0.4).astype(np.float32)
    assert np.array_equal(twf._partition_live(torch.from_numpy(live)).numpy(),
                          np.asarray(jwf._partition_live(jnp.asarray(live))))
    rows = 96
    planes = [rng.normal(size=(rows, 128)).astype(np.float32) for _ in range(6)]
    live_rows = (rng.random(rows) < 0.7).astype(np.float32)
    bounce = rng.integers(0, 7, rows).astype(np.int32)
    for use_bounce in (False, True):
        for use_origins in (False, True):
            want = np.asarray(jwf._sort_rows_octant(
                jnp.asarray(live_rows), *map(jnp.asarray, planes[:3]),
                bounce_rows=jnp.asarray(bounce) if use_bounce else None,
                origins=tuple(map(jnp.asarray, planes[3:])) if use_origins else None))
            got = twf._sort_rows_octant(
                torch.from_numpy(live_rows), *map(torch.from_numpy, planes[:3]),
                bounce_rows=torch.from_numpy(bounce) if use_bounce else None,
                origins=tuple(map(torch.from_numpy, planes[3:])) if use_origins else None)
            assert np.array_equal(got.numpy(), want), (use_bounce, use_origins)


@pytest.mark.parametrize("n", [2047, 2048, 2049, 3 * 2048 + 1])
@pytest.mark.parametrize("sort", twf.SORTS)
@pytest.mark.parametrize("regen", [False, True], ids=["samples", "regen"])
def test_partition_reference_equals_jax_at_tile_edges(regen, sort, n):
    """The partition's plain version on a RayArray (wavefront_partition_reference:
    `_permutation` and the gathers) against JAX's `_sort_rows_octant` /
    `_partition_live` on the same one-ray rows, at slot counts around the
    kernels' 2,048-slot tile: every sort, with the bounce bucket under
    regeneration ('spatial': 2,049 keys) and without it, the permutation
    and the gathered planes exactly; and, when a pool only refills, the
    dead slots' order.  The card tests hold the kernels to this plain
    version."""
    rng = np.random.default_rng(n + 7 * twf.SORTS.index(sort) + 100 * regen)
    cap = n + 5
    arr = twf.RayArray(cap, regen, sort, "cpu")
    arr.f.copy_(torch.from_numpy(rng.normal(size=arr.f.shape).astype(np.float32)))
    arr.f[:, twf.LIVE] = torch.from_numpy((rng.random((2, cap)) < 0.4).astype(np.float32))
    arr.i.copy_(torch.from_numpy(rng.integers(-1, 9, arr.i.shape).astype(np.int32)))
    f, i = arr.f[0].numpy().copy(), arr.i[0].numpy().copy()
    live_rows = f[twf.LIVE, :n]
    live = int((live_rows > 0.5).sum())
    col = lambda r: jnp.asarray(f[r, :n, None])
    if sort == "live":
        want = np.asarray(jwf._partition_live(jnp.asarray(live_rows)))
    else:
        want = np.asarray(jwf._sort_rows_octant(
            jnp.asarray(live_rows), col(twf.DX), col(twf.DY), col(twf.DZ),
            bounce_rows=jnp.asarray(i[twf.BNC, :n]) if regen and sort != "octant-flat" else None,
            origins=(col(twf.OX), col(twf.OY), col(twf.OZ)) if sort == "spatial" else None))
    for threshold in (1.1, 0.0):
        arr.ctr.copy_(torch.tensor([n, live, 0, 0, 0, live, 0, 0], dtype=torch.int32))
        arr.perm.fill_(-1)
        sched = twf.Schedule(threshold, 0.25, 3 * n, n, regen=regen)
        twf.wavefront_partition_reference(arr, sched)
        if threshold > 1.0:
            m = n if regen else live
            assert np.array_equal(arr.perm[:n].numpy(), want)
            assert np.array_equal(arr.f[1, :, :m].numpy(), f[:, want[:m]])
            assert np.array_equal(arr.i[1, :, :m].numpy(), i[:, want[:m]])
        elif regen:
            assert np.array_equal(arr.perm[:n].numpy(),
                                  np.asarray(jwf._partition_live(jnp.asarray(live_rows))))
        else:
            assert bool((arr.perm == -1).all())


def _jax_bounce(js, ints, ids, planes, *, regen, max_depth):
    """One launch of JAX's `_wf_kernel` in interpret mode over (rows, 128)
    planes, as render_wavefront builds it for a brute-scan scene."""
    spheres = js.spheres
    n = spheres.count
    rows = planes[0].shape[0]
    smem = lambda shape: pl.BlockSpec(shape, lambda i: (0, 0), memory_space=pltpu.SMEM)
    tile = pl.BlockSpec((jwf.WF_ROWS, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)
    kernel = functools.partial(
        jwf._wf_kernel, n_spheres=n, has_mesh=False, has_sphere_bvh=False, t_min=1e-3,
        t_max=3.4e35, rr_depth=0, sky_intensity=1.0, num_lights=0, mesh_smooth=False,
        regen=regen, max_depth=max_depth)
    plane = jax.ShapeDtypeStruct((rows, 128), jnp.float32)
    call = pl.pallas_call(
        kernel, grid=(rows // jwf.WF_ROWS,),
        in_specs=[smem((1, 4)), smem((jmk._SCENE_ROWS, n))] + [tile] * (11 + len(ids)),
        out_specs=tuple([tile] * 14), out_shape=tuple([plane] * 14), interpret=True)
    out = call(jnp.asarray(ints, jnp.int32).reshape(1, 4), jmk.scene_planes(spheres),
               *map(jnp.asarray, ids), *map(jnp.asarray, planes))
    return [np.asarray(o) for o in out]


def _bounce_scene(case: str):
    """One-Weekend as a JAX scene; 'inactive': every third sphere after the
    ground has radius 0; 'ties': its ten largest spheres appended again in
    scene order with albedo 1 - albedo, exact ties that the first index
    must win."""
    js = J.models.scene.as_scene(J.one_weekend_scene(jax.random.key(0)))
    if case == "one_weekend":
        return js
    fields = [f.name for f in dataclasses.fields(J.Spheres)]
    sp = {f: np.array(getattr(js.spheres, f)) for f in fields}
    if case == "inactive":
        sp["radii"][1::3] = 0.0
    else:
        dup = np.sort(np.argsort(-sp["radii"], kind="stable")[:10])
        extra = {f: v[dup] for f, v in sp.items()}
        extra["albedo"] = 1.0 - extra["albedo"]
        sp = {f: np.concatenate([sp[f], extra[f]]) for f in fields}
    return J.models.scene.as_scene(J.Spheres(**{f: jnp.asarray(v) for f, v in sp.items()}))


@pytest.mark.parametrize("regen,case", [
    pytest.param(False, "one_weekend", id="scalar"),
    pytest.param(True, "one_weekend", id="per_lane"),
    pytest.param(False, "inactive", id="scalar-inactive"),
    pytest.param(True, "inactive", id="per_lane-inactive"),
    pytest.param(False, "ties", id="scalar-ties"),
    pytest.param(True, "ties", id="per_lane-ties"),
])
def test_one_bounce_against_wf_kernel(regen, case):
    """The same numpy-seeded ray state through JAX's `_wf_kernel` (Pallas,
    interpret mode) and through wavefront_bounce_reference, one bounce of
    One-Weekend 64 x 48 with the (sample, bounce) scalar or per lane; also
    with every third sphere inactive and with ten spheres duplicated (ties
    go to the first in scene order): the rules the kernel's staged scan
    keeps (tests/test_torch_cuda.py holds it to render_cuda).  The
    live masks are equal and the bounce's radiance agrees within 1e-5 on
    every ray.  Of the rays that go on, at most 0.2% take another hit
    (interpret-mode Pallas departs from JAX's jitted pieces there, which
    the port follows: tests/test_torch_adaptive.py; measured 1 ray of 1,968
    and none of 2,001).  The rest agree in throughput and prev_diffuse
    exactly; their next origin and direction differ by 3e-5 on average
    (held to 1e-4) and 7e-3 at most (held to 1e-2): the hit point on the radius-1,000 ground
    sphere carries the two versions' rounding of the sphere root (23% of
    the rays are beyond 2e-5, 2% beyond 1e-3)."""
    w, h, p, n = 64, 48, 64 * 48, 4096
    seed, depth = 11, 30
    rng = np.random.default_rng(5 + regen)
    js = _bounce_scene(case)
    ts = T.from_reference(js)
    cam = T.derive_camera(T.CameraSettings.default(), w, h)
    local = np.arange(n, dtype=np.int32)
    pid = np.asarray(jwf._global_pids(jnp.asarray(local), p=p, width=w, height=h,
                                      y_offset=0, total_width=w)).astype(np.int32)
    samples = rng.integers(0, 4, n).astype(np.int32) if regen else np.full(n, 2, np.int32)
    bounces = rng.integers(0, 5, n).astype(np.int32) if regen else np.full(n, 1, np.int32)
    # Primary rays of each slot's sample from the port's generator, then a
    # random throughput, prev_diffuse flag and a quarter of the rays dead.
    from gpu_ray_tracing_tpu_torch.ops.rays import generate_rays_for_ids
    o, d, _ = generate_rays_for_ids(cam, torch.from_numpy(pid).long(),
                                    torch.from_numpy(samples).long(), seed, total_width=w)
    real = local < p
    live = (real & (rng.random(n) < 0.75)).astype(np.float32)
    thr = rng.uniform(0.2, 1.0, (3, n)).astype(np.float32)
    pd = (rng.random(n) < 0.5).astype(np.float32)
    planes = [np.where(real, v, 0.0).astype(np.float32).reshape(-1, 128)
              for v in (*o.numpy().T, *d.numpy().T, *thr)] + [pd.reshape(-1, 128),
                                                              live.reshape(-1, 128)]
    shape = lambda v: v.reshape(-1, 128)
    ids = (shape(pid), shape(samples), shape(bounces)) if regen else (shape(pid),)
    out = _jax_bounce(js, [2, seed, 1, 0], ids, planes, regen=regen, max_depth=depth)

    state_f, state_i = convert.wavefront_state_from_reference(
        pid, planes, p=p, samples=samples if regen else None,
        bounces=bounces if regen else None)
    eng = twf.Engine(ts, cam, seed, depth, 1e-3, total_width=w)
    done = torch.zeros((4 * p if regen else p, 3))
    twf.wavefront_bounce(eng, state_f, state_i, n, regen=regen, sample=2, bounce=1,
                         sample_base=0, n_pixels=p, out=done)
    got = convert.wavefront_state_to_reference(state_f)
    want_live = out[10] > 0.5
    assert np.array_equal(got[10] > 0.5, want_live)
    if regen:
        assert np.array_equal(state_i[twf.BNC].numpy()[live > 0.5], bounces[live > 0.5] + 1)
    # The bounce's radiance: carried in the state while the path lives,
    # written to the sample's slot when it ends.
    slot = np.where(real, local, 0) + (samples * p if regen else 0)
    rad = np.where(want_live.reshape(-1)[:, None], state_f[twf.RR:twf.PD].numpy().T,
                   done.numpy()[slot])
    rad = np.where((live > 0.5)[:, None], rad, 0.0)
    want_rad = np.stack([o.reshape(-1) for o in out[11:14]], 1)
    assert np.abs(rad - want_rad).max() < 1e-5
    cont = want_live.reshape(-1)
    gap = np.stack([np.abs(got[k] - out[k]).reshape(-1)[cont] for k in range(10)])
    flipped = gap.max(0) >= 1e-2
    assert flipped.mean() <= 0.002, flipped.sum()
    rest = gap[:, ~flipped]
    assert rest[:6].mean() < 1e-4 and rest[:6].max() < 1e-2, (rest[:6].mean(), rest[:6].max())
    assert rest[6:9].max() < 1e-6 and rest[9].max() == 0.0, rest[6:].max(1)


def _spheres(n: int):
    return T.Spheres(torch.zeros((n, 3)), torch.ones(n), torch.full((n, 3), 0.5),
                     torch.zeros(n, dtype=torch.int32), torch.zeros(n))


@pytest.mark.parametrize("case,want", [
    ("none", "staged"), ("one_weekend", "staged"), ("stage_full", "staged"),
    ("stage_over", "global"), ("sphere_bvh", "sphere_bvh"), ("mesh", "staged")])
def test_sphere_scan_is_decided_from_the_scene(case, want):
    """How the bounce kernel scans spheres (the scene's Route.sphere_scan,
    and its reader Route.bounce_staged) follows from the scene alone: a
    brute scan of at most STAGE_SPHERES spheres (a mesh beside them or
    not, inactive ones counted) from the stage, a larger one from device
    memory, a sphere BVH by its walk.  The engine packs that Route.  A
    plain render reports 'plain' in LAST_RUN."""
    scene = {"none": lambda: _spheres(0), "one_weekend": lambda: T.one_weekend_scene(0),
             "stage_full": lambda: _spheres(twf.STAGE_SPHERES),
             "stage_over": lambda: _spheres(twf.STAGE_SPHERES + 1),
             "sphere_bvh": _sphere_bvh_scene, "mesh": _mesh_scene}[case]()
    cam = T.derive_camera(T.CameraSettings.default(), 8, 6)
    route = tmk.route_of(T.as_scene(scene))
    assert route.sphere_scan == want
    assert route.bounce_staged == (want == "staged")
    assert twf.Engine(scene, cam, 0, 2, 1e-3, total_width=8).packed().route == route
    if case != "none":  # the plain scan's reduction needs a sphere
        T.render_wavefront_reference(scene, cam, width=8, height=6, max_depth=2, t_min=1e-3)
        assert twf.LAST_RUN["sphere_scan"] == "plain"


def _every_third_inactive(n: int):
    sp = _spheres(n)
    radii = sp.radii.clone()
    radii[::3] = 0.0
    return dataclasses.replace(sp, radii=radii)


def _route_scene(case: str):
    """The scenes of the route decision of render_kernel's path loop."""
    return {"none": lambda: _spheres(0), "one": lambda: _spheres(1),
            "one_weekend": lambda: T.one_weekend_scene(0),
            "bvh_threshold": lambda: _spheres(256),
            "stage_full": lambda: T.make_scene(_spheres(1024), sphere_bvh=False),
            "stage_over": lambda: T.make_scene(_spheres(1025), sphere_bvh=False),
            "every_third_inactive": lambda: _every_third_inactive(197),
            "sphere_bvh": _sphere_bvh_scene, "small_mesh": lambda: _mesh_scene(1),
            "config4_mesh": lambda: _mesh_scene(6, (0.75, 0.6, 0.45), 0.8)}[case]()


# (scene, mode, adaptive) -> (route, stage kind) of render_kernel's launch.
_ROUTES = [
    ("none", "path", False, "brute", "spheres"),
    ("one", "path", False, "brute", "spheres"),
    ("one_weekend", "path", False, "brute", "spheres"),
    ("bvh_threshold", "path", False, "brute", "spheres"),
    ("stage_full", "path", False, "brute", "spheres"),
    ("stage_over", "path", False, "brute", None),
    ("every_third_inactive", "path", False, "brute", "spheres"),
    ("sphere_bvh", "path", False, "sphere_bvh", "bvh"),
    ("small_mesh", "path", False, "mesh_bvh", "bvh"),
    ("config4_mesh", "path", False, "mesh_bvh", None),
    ("one_weekend", "path", True, "brute", None),
    ("one_weekend", "normal", False, "brute", None),
    ("one_weekend", "albedo", False, "brute", None),
]


@pytest.mark.parametrize("case,mode,adaptive,route,stage", _ROUTES,
                         ids=[f"{c}-{m}{'-adaptive' if a else ''}" for c, m, a, _, _ in _ROUTES])
def test_megakernel_stage_is_decided_from_the_scene(case, mode, adaptive, route, stage):
    """Where render_kernel's path loop reads the scene follows from the
    scene alone, as the bounce kernel's scan does: the brute route (no
    sphere BVH, no mesh) of at most STAGE_SPHERES spheres, inactive ones
    counted, from the sphere stage (16 + 20 n bytes), a small BVH scene
    from the BVH stage, anything else from device memory; the adaptive
    loop and the AOV modes take no stage (Route.path_stage).  The launch
    key (Route.launch_key) ends in "+staged" exactly when the loop reads a
    stage."""
    sc = T.as_scene(_route_scene(case))
    n = sc.spheres.count
    assert tmk.sphere_stage_bytes(n) == 16 + 20 * n
    r = tmk.route_of(sc)
    assert tmk.pack_scene(sc, False, False, None).route == r
    assert r.geometry == route
    fits = n <= tmk.STAGE_SPHERES and sc.sphere_bvh is None
    assert r.sphere_stage == (tmk.sphere_stage_bytes(n) if fits else 0)
    want = {"spheres": tmk.sphere_stage_bytes(n), "bvh": r.bvh_stage, None: 0}
    got_stage = r.path_stage(mode, adaptive)
    assert got_stage == want[stage] and (got_stage > 0) == (stage is not None)
    key = r.launch_key("megakernel", False, None, staged=got_stage > 0, adaptive=adaptive)
    assert key == ("megakernel:" + route + ("+staged" if stage else "")
                   + ("+adaptive" if adaptive else ""))
    assert r.launch_key("megakernel", False, None, staged=got_stage > 0, adaptive=adaptive,
                        rays=True) == key + "+rays"


def test_engine_against_jax_render_wavefront():
    """JAX's render_wavefront (interpret mode) against the port's plain
    engine on base_scene 64 x 48, 4 spp, depth 8, at the goldens' base_path
    thresholds (flip 0.5%, mean 1e-4), regeneration off and on."""
    w, h = 64, 48
    jcam = J.derive_camera(pc.BASE_CAMERA, w, h)
    want = np.asarray(jwf.render_wavefront(
        J.base_scene(), jcam, width=w, height=h, sample_index=jnp.uint32(0),
        frame_seed=jnp.uint32(42), max_depth=8, t_min=1e-3, spp=4, interpret=True))
    cam = T.derive_camera(T_CAMERA, w, h)
    for regenerate in (False, True):
        got = T.render_wavefront_reference(T.base_scene(), cam, width=w, height=h,
                                           frame_seed=42, max_depth=8, t_min=1e-3, spp=4,
                                           regenerate=regenerate)
        m = T.images_match(got, want, 0.005, 1e-4)
        assert m.ok, m
