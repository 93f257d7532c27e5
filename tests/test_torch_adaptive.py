"""Adaptive sampling and the ray counters of the port against the JAX
package, on the CPU.

The kernel's adaptive loop (K1f) has a plain version in render_reference,
which the card tests and chip_smoke.py hold the kernel to.  Here that plain
version is held to JAX's render_pallas in interpret mode (as JAX's own
tests run it): the spp maps equal, tile for tile; the images at the flip
contract where JAX's own engines meet it.  The prefix property and the
chunked resume are exact.  The counters of trace_path(count_rays=True) are
held to JAX's trace_path counters per pixel, and count_traced_rays to the
analytic cases of tests/test_pallas.py:625-668.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from benchmarks import parity_check as pc
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu.ops.pallas import megakernel as jmk
from gpu_ray_tracing_tpu_torch.ops import integrators as ti
from gpu_ray_tracing_tpu_torch.ops import rays as tr
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)
# Four tiles of 32 x 128 across 160 x 40, three of them partial.
BASE_KW = dict(width=160, height=40, max_depth=6, t_min=1e-3, spp=16, frame_seed=3,
               adaptive_tol=0.05, adaptive_min_spp=4)


def _base_camera(w, h):
    return T.derive_camera(T_CAMERA, w, h)


def _jax_adaptive(js, jcam, w, h, seed, **kw):
    img, smap = jmk.render_pallas(js, J.derive_camera(jcam, w, h), width=w, height=h,
                                  sample_index=jnp.uint32(0), frame_seed=jnp.uint32(seed),
                                  t_min=1e-3, return_spp_map=True, interpret=True, **kw)
    return np.asarray(img), np.asarray(smap)


def test_adaptive_matches_render_pallas_on_partial_tiles():
    """160 x 40 on base_scene, budget 16: the spp maps equal JAX's, tile
    for tile, and so do the images (1% / 2e-4; flip 0.03% measured).  Each
    tile's image is the fixed render at its tile's count, bit for bit:
    adaptive samples are a prefix of the fixed stream."""
    kw = {k: v for k, v in BASE_KW.items() if k not in ("t_min", "frame_seed")}
    w, h = kw.pop("width"), kw.pop("height")
    want_img, want_map = _jax_adaptive(J.base_scene(), pc.BASE_CAMERA, w, h, 3, **kw)
    img, smap = tmk.render_reference(T.base_scene(), _base_camera(w, h),
                                     return_spp_map=True, **BASE_KW)
    assert np.array_equal(smap.numpy(), want_map)
    counts = torch.unique(smap).tolist()
    assert min(counts) >= 4 and max(counts) <= 16 and len(counts) > 1
    assert torch.equal(smap[:32, :128], torch.full((32, 128), smap[0, 0].item()))
    m = T.images_match(img, want_img, 0.01, 2e-4)
    assert m.ok, m
    fixed_kw = {k: v for k, v in BASE_KW.items() if not k.startswith("adaptive")}
    for c in counts:
        fixed = tmk.render_reference(T.base_scene(), _base_camera(w, h),
                                     **{**fixed_kw, "spp": int(c)})
        sel = smap == c
        assert torch.equal(img[sel], fixed[sel]), c


def test_adaptive_matches_render_pallas_on_one_weekend():
    """128 x 96 One-Weekend, budget 32, tol 0.03, min 4, depth 6: the spp
    maps equal JAX's.  The images flip 6.5% / mean 3.4e-4 against
    render_pallas, as the fixed 32-spp frames do (6.47% / 3.39e-4): the
    adaptive loop adds nothing.  The gap is render_pallas's own, in interpret
    mode, against JAX's jitted trace_path, which the port follows (next
    test); a pixel flips when any of its 32 samples does.  Held just above
    the reading."""
    w, h = 128, 96
    js = J.one_weekend_scene(jax.random.key(0))
    kw = dict(max_depth=6, spp=32, adaptive_tol=0.03, adaptive_min_spp=4)
    want_img, want_map = _jax_adaptive(js, J.CameraSettings.default(), w, h, 1, **kw)
    img, smap = tmk.render_reference(
        T.from_reference(js), T.derive_camera(T.CameraSettings.default(), w, h), width=w,
        height=h, t_min=1e-3, frame_seed=1, return_spp_map=True, **kw)
    assert np.array_equal(smap.numpy(), want_map)
    assert smap.min() >= 4 and smap.max() <= 32 and smap.min() < smap.max()
    m = T.images_match(img, want_img, 0.07, 4e-4)
    assert m.ok, m


def test_one_weekend_gap_is_render_pallas_against_jitted_pieces():
    """Where the One-Weekend gap above comes from, one sample at depth 2 (the
    first scatter bounce): the port's plain version equals JAX's jitted
    raygen + trace_path with no flip, while render_pallas in interpret mode
    departs from those same pieces by 0.07% flipped pixels (9 of 12,288),
    as it departs from the port.  At depth 1 all three agree to an ulp."""
    w, h, seed = 128, 96, 1
    js = J.one_weekend_scene(jax.random.key(0))
    jc = J.derive_camera(J.CameraSettings.default(), w, h)
    o, d, s = jax.jit(lambda: jr.generate_rays_hash(jc, w, h, jnp.uint32(0),
                                                    jnp.uint32(seed)))()
    pieces = np.asarray(jax.jit(lambda o, d, s: ji.trace_path(
        o, d, js, 2, 1e-3, 3.4e35, pixel_seeds=s))(o.reshape(-1, 3), d.reshape(-1, 3),
                                                   s.reshape(-1))).reshape(h, w, 3)
    pallas = np.asarray(jmk.render_pallas(js, jc, width=w, height=h, sample_index=jnp.uint32(0),
                                          frame_seed=jnp.uint32(seed), t_min=1e-3, max_depth=2,
                                          spp=1, interpret=True))
    port = tmk.render_reference(T.from_reference(js), T.derive_camera(
        T.CameraSettings.default(), w, h), width=w, height=h, frame_seed=seed, t_min=1e-3,
        max_depth=2, spp=1)
    assert T.images_match(port, pieces, 0.0, 1e-6).ok
    jax_gap = T.images_match(pallas, pieces, 0.0, 1.0).flip_frac
    assert 0.0005 < jax_gap < 0.001, jax_gap
    assert T.images_match(port, pallas, 0.0, 1.0).flip_frac == jax_gap


def test_adaptive_prefix_property_and_chunked_resume_are_exact():
    """With a huge tolerance every tile stops at adaptive_min_spp, and the
    image equals the fixed render at that spp bit for bit.  Four resumed
    chunks of 4 equal the one-shot render bit for bit, and a fifth changes
    nothing."""
    cam = _base_camera(160, 40)
    kw = {**BASE_KW, "adaptive_tol": 1e6}
    fixed = tmk.render_reference(T.base_scene(), cam,
                                 **{k: v for k, v in kw.items() if not k.startswith("adaptive")
                                    and k != "spp"}, spp=4)
    assert torch.equal(tmk.render_reference(T.base_scene(), cam, **kw), fixed)

    one = tmk.render_reference(T.base_scene(), cam, **BASE_KW)
    st = tuple(torch.zeros(40, 160) for _ in range(6))
    for _ in range(4):
        st = tmk.render_reference(T.base_scene(), cam, adaptive_state=st, adaptive_chunk=4,
                                  **BASE_KW)
    state = T.AdaptiveAccumState(rgb_sum=torch.stack(st[:3], -1), count=st[3], mlum=st[4],
                                 m2=st[5])
    assert torch.equal(state.image, one)
    st5 = tmk.render_reference(T.base_scene(), cam, adaptive_state=st, adaptive_chunk=4,
                               **BASE_KW)
    for a, b in zip(st5, st):
        assert torch.equal(a, b)


def test_adaptive_state_matches_render_pallas_resume():
    """One resumed chunk of 6 from zero planes against render_pallas's
    adaptive_state branch: the same per-tile counts, and the same image
    from the returned sums at the flip contract."""
    w, h = 160, 40
    kw = dict(max_depth=6, spp=16, adaptive_tol=0.05, adaptive_min_spp=4)
    z = jnp.zeros((h, w), jnp.float32)
    want = jmk.render_pallas(J.base_scene(), J.derive_camera(pc.BASE_CAMERA, w, h), width=w,
                             height=h, sample_index=jnp.uint32(0), frame_seed=jnp.uint32(3),
                             t_min=1e-3, adaptive_state=(z,) * 6, adaptive_chunk=6,
                             interpret=True, **kw)
    got = tmk.render_reference(T.base_scene(), _base_camera(w, h), width=w, height=h,
                               t_min=1e-3, frame_seed=3, adaptive_state=(torch.zeros(h, w),) * 6,
                               adaptive_chunk=6, **kw)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    img = np.stack([np.asarray(p) for p in want[:3]], -1) / np.asarray(want[3])[..., None]
    m = T.images_match(torch.stack(got[:3], -1) / got[3][..., None], img, 0.01, 2e-4)
    assert m.ok, m


def test_adaptive_validation_errors():
    """tests/test_pallas.py:455-530 on the port: the config's checks, the
    progressive guards and render_pallas's adaptive_state checks."""
    with pytest.raises(ValueError, match="adaptive_tol"):
        T.RenderConfig(adaptive_tol=-0.1)
    with pytest.raises(ValueError, match="megakernel"):
        T.RenderConfig(adaptive_tol=0.05, backend="torch")
    with pytest.raises(ValueError, match="adaptive_min_spp"):
        T.RenderConfig(adaptive_tol=0.05, adaptive_min_spp=1)
    cfg = T.RenderConfig(width=64, height=48, spp=8, adaptive_tol=0.05)
    with pytest.raises(ValueError, match="adaptive"):
        T.progressive_step(T.init_accum(48, 64), T.base_scene(), T_CAMERA, cfg)
    st = T.init_adaptive_accum(48, 64)
    with pytest.raises(ValueError, match="adaptive_tol"):
        T.adaptive_progressive_step(st, T.base_scene(), T_CAMERA,
                                    T.RenderConfig(width=64, height=48, spp=8))
    with pytest.raises(ValueError, match="path integrator"):
        T.adaptive_progressive_step(st, T.base_scene(), T_CAMERA, T.RenderConfig(
            width=64, height=48, spp=8, adaptive_tol=0.05, integrator="normal"))
    with pytest.raises(ValueError, match="spp_per_step"):
        T.adaptive_progressive_step(st, T.base_scene(), T_CAMERA, cfg, spp_per_step=0)
    cam = _base_camera(16, 8)
    kw = dict(width=16, height=8, max_depth=2, t_min=1e-3, spp=4)
    planes = (torch.zeros(8, 16),) * 6
    for bad, match in (
        (dict(adaptive_state=planes, adaptive_chunk=2), "adaptive_tol > 0"),
        (dict(adaptive_state=planes, adaptive_tol=0.1), "adaptive_chunk > 0"),
        (dict(adaptive_state=planes, adaptive_tol=0.1, adaptive_chunk=2, mode="normal"),
         "mode='path'"),
        (dict(adaptive_state=planes, adaptive_tol=0.1, adaptive_chunk=2,
              return_spp_map=True), "do not compose"),
        (dict(adaptive_state=planes[:5], adaptive_tol=0.1, adaptive_chunk=2), "6-tuple"),
        (dict(adaptive_state=(torch.zeros(4, 4),) * 6, adaptive_tol=0.1, adaptive_chunk=2),
         r"\(8, 16\)"),
    ):
        with pytest.raises(ValueError, match=match):
            tmk.render_reference(T.base_scene(), cam, **kw, **bad)


# --- ray counters ----------------------------------------------------------------


def _diffuse_scene(mod):
    """tests/test_pallas.py:707-717: diffuse only, no decision flips."""
    return mod.make_scene(mod.make_spheres([
        ((0, -1000.0, 0), 1000.0, mod.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, mod.LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
    ]))


def _jax_ray_map(js, jcam, w, h, spp, depth, seed, **kw):
    """JAX's independent trace_path counters summed over the samples."""
    jc = J.derive_camera(jcam, w, h)
    raygen = jax.jit(lambda s: jr.generate_rays_hash(jc, w, h, s, jnp.uint32(seed)))
    trace = jax.jit(lambda o, d, s: ji.trace_path(o, d, js, depth, 1e-3, 3.4e35,
                                                  pixel_seeds=s, count_rays=True, **kw))
    total = np.zeros(h * w, np.float32)
    for s in range(spp):
        o, d, seeds = raygen(jnp.uint32(s))
        total += np.asarray(trace(o.reshape(-1, 3), d.reshape(-1, 3), seeds.reshape(-1))[1])
    return total.reshape(h, w)


def _lit_ground(mod):
    """tests/test_pallas.py:659-662: a ground lit by one sphere light high
    above it, so no light sample grazes."""
    return mod.make_scene(mod.make_spheres([
        ((0, -1000.0, 0), 1000.0, mod.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 50.0, 0.0), 5.0, mod.EMISSIVE, (1.0, 1.0, 1.0), 4.0),
    ]))


DOWN = dict(look_from=[0.0, 2.0, 0.0], look_at=[0.0, 0.0, 0.0], vup=[0.0, 0.0, 1.0],
            field_of_view=40.0, defocus_angle=0.0, focus_distance=10.0)


@pytest.mark.parametrize("scene,kw", [
    ("diffuse", {}),
    # A shadow ray per valid light sample.  (On parity_check's _nee_scene the
    # far ground sees its light at grazing angles, where cos_i > 0 flips
    # with the last bit: 102 of 1,536 pixels differ at depth 1 between JAX
    # and the port, as between JAX's own engines.)
    ("lit", dict(nee=True, sky_intensity=0.0)),
])
def test_ray_counters_match_jax_trace_path(scene, kw):
    """48 x 32, 4 spp, depth 3: the port's trace_path counters equal JAX's
    per pixel, and render_reference(return_ray_count=True) sums them."""
    w, h, spp, depth = 48, 32, 4, 3
    if scene == "diffuse":
        js, jcam, tc = _diffuse_scene(J), pc.BASE_CAMERA, _base_camera(w, h)
    else:
        jcam = J.CameraSettings(**{k: jnp.asarray(v, jnp.float32) for k, v in DOWN.items()})
        js, tc = _lit_ground(J), T.derive_camera(T.CameraSettings.make(**DOWN), w, h)
    want = _jax_ray_map(js, jcam, w, h, spp, depth, 7, **kw)
    ts = T.from_reference(js)
    got = torch.zeros(h * w)
    for s in range(spp):
        o, d, seeds = tr.generate_rays_hash(tc, w, h, s, 7)
        rgb, rays = ti.trace_path(o.reshape(-1, 3), d.reshape(-1, 3), ts, depth, 1e-3,
                                  3.4e35, pixel_seeds=seeds.reshape(-1), count_rays=True, **kw)
        assert rgb.shape == (h * w, 3)
        got += rays
    assert np.array_equal(got.reshape(h, w).numpy(), want)
    img, ray_map = tmk.render_reference(ts, tc, width=w, height=h, spp=spp, max_depth=depth,
                                        t_min=1e-3, frame_seed=7, return_ray_count=True, **kw)
    assert torch.equal(ray_map, got.reshape(h, w))
    assert torch.equal(img, tmk.render_reference(ts, tc, width=w, height=h, spp=spp,
                                                 max_depth=depth, t_min=1e-3, frame_seed=7,
                                                 **kw))


def test_ray_counters_analytic():
    """tests/test_pallas.py:625-668 through count_traced_rays(backend='torch'):
    all-sky rays trace spp per pixel; a camera staring at an infinite
    diffuse ground traces 2 per sample at depth 2, and 3 with one light."""
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    up = T.CameraSettings.default().replace(
        look_from=torch.tensor([0.0, 2.0, 0.0]), look_at=torch.tensor([0.0, 10.0, 0.0]),
        vup=torch.tensor([0.0, 0.0, 1.0]), defocus_angle=torch.tensor(0.0))
    cfg = T.RenderConfig(width=48, height=32, spp=4, max_depth=6, backend="torch")
    r = T.count_traced_rays(ground, up, cfg, frame_seed=3)
    assert r["rays_traced"] == r["primary_rays"] == 48 * 32 * 4

    down = T.CameraSettings.default().replace(
        look_from=torch.tensor([0.0, 2.0, 0.0]), look_at=torch.tensor([0.0, 0.0, 0.0]),
        vup=torch.tensor([0.0, 0.0, 1.0]), field_of_view=torch.tensor(40.0),
        defocus_angle=torch.tensor(0.0))
    cfg2 = T.RenderConfig(width=48, height=32, spp=4, max_depth=2, backend="torch")
    r2 = T.count_traced_rays(ground, down, cfg2, frame_seed=3, return_map=True)
    assert r2["rays_traced"] == 2 * r2["primary_rays"], r2
    assert r2["map"].shape == (32, 48) and bool((r2["map"] == 8.0).all())

    lit = _lit_ground(T)
    cfg3 = T.RenderConfig(width=48, height=32, spp=4, max_depth=2, backend="torch",
                          nee=True, sky_intensity=0.0)
    r3 = T.count_traced_rays(lit, down, cfg3, frame_seed=3)
    assert r3["rays_traced"] == 3 * r3["primary_rays"], r3
    # AOV integrators trace one ray per sample.
    cfg4 = T.RenderConfig(width=48, height=32, spp=2, integrator="normal", backend="torch")
    assert T.count_traced_rays(ground, down, cfg4)["rays_traced"] == 48 * 32 * 2
