"""The WGSL parity stream, the packed-material codec and sphere padding in
the port against the JAX package, on the CPU.

The stream's functions are held bit for bit to jitted JAX on numpy inputs
from a seed; its rays within one ulp; trace_path on it to JAX's jitted
trace_path, render() to the committed base_parity golden and three
progressive steps to JAX's, all at the goldens' decision-flip contract
(0.5% / 1e-4, tests/test_goldens.py:56).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from benchmarks import parity_check as pc
from gpu_ray_tracing_tpu.models import spheres as jspheres
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu.ops import rng as jrng
from gpu_ray_tracing_tpu_torch.models import spheres as tspheres
from gpu_ray_tracing_tpu_torch.ops import integrators as ti
from gpu_ray_tracing_tpu_torch.ops import rays as tr
from gpu_ray_tracing_tpu_torch.ops import rng as trng

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "base_parity_48x32.npy")
TMIN, TMAX = 1e-3, 3.4e35
J_CAMERA = pc.BASE_CAMERA
T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)


@pytest.fixture(scope="module")
def values():
    v = np.random.default_rng(20261017).integers(0, 2**32, 10_000, dtype=np.uint64)
    v = v.astype(np.uint32)
    v[0], v[1] = 0, 2**32 - 1
    return v


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _assert_match(a, b, flip_frac=0.005, mean_tol=1e-4):
    m = T.images_match(a, b, flip_frac, mean_tol)
    assert m.ok, m


# --- the stream's functions, bit for bit -----------------------------------


def test_wgsl_random_float_bit_exact(values):
    want = np.asarray(jax.jit(jrng.wgsl_random_float)(values))
    got = trng.wgsl_random_float(_t(values)).numpy()
    assert got.dtype == np.float32 and np.array_equal(want, got)


def test_seed_from_f32_bit_exact_with_saturation_and_nan():
    one_less = np.nextafter(np.float32(1.0), np.float32(0.0))
    edges = np.array([0.0, 1.0, one_less, 1.5, np.nan, -0.25, np.inf, -np.inf, 1e-30],
                     np.float32)
    seeds = np.concatenate([edges, np.random.default_rng(3).random(10_000).astype(np.float32)])
    want = np.asarray(jax.jit(jrng.seed_from_f32)(seeds))
    got = trng.seed_from_f32(torch.from_numpy(seeds))
    assert np.array_equal(want, _u32(got))
    # u32::MAX at 1 and above, the largest f32 below 2**32 one ulp under
    # 1, 0 for NaN and below 0.
    assert _u32(got)[[1, 2, 3, 4, 5, 6]].tolist() == [2**32 - 1, 4294967040, 2**32 - 1, 0, 0,
                                                      2**32 - 1]


@pytest.mark.parametrize("sample,frame,y_offset", [(0, 0, 0), (5, 99, 0), (7, 2**32 - 1, 13)])
def test_pixel_seeds_bit_exact(sample, frame, y_offset):
    fn = jax.jit(lambda s, f: jrng.pixel_seeds(48, 36, s, f, y_offset))
    want = np.asarray(fn(jnp.uint32(sample), jnp.uint32(frame)))
    got = trng.pixel_seeds(48, 36, sample, frame, y_offset)
    assert got.shape == (36, 48) and np.array_equal(want, _u32(got))


@pytest.mark.parametrize("seed", [0, 8, 123456789, 2**32 - 1])
def test_make_bounce_seeds_bit_exact(seed):
    want = np.asarray(jax.jit(ji.make_bounce_seeds, static_argnums=1)(jnp.uint32(seed), 30))
    assert np.array_equal(want, _u32(ti.make_bounce_seeds(seed, 30)))


def test_random_unit_vector_bit_exact(values):
    want = np.asarray(jax.jit(jrng.random_unit_vector)(values))
    got = trng.random_unit_vector(_t(values)).numpy()
    assert got.shape == (values.size, 3) and np.array_equal(want, got)


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("defocus", [0.0, 0.6])
def test_generate_rays_wgsl_within_one_ulp(parity, defocus):
    js = J.CameraSettings(look_from=jnp.asarray([13.0, 2.0, 3.0]), look_at=jnp.zeros(3),
                          vup=jnp.asarray([0.0, 1.0, 0.0]), field_of_view=jnp.float32(20.0),
                          defocus_angle=jnp.float32(defocus),
                          focus_distance=jnp.float32(10.0))
    jc = J.derive_camera(js, 48, 36)
    raygen = jax.jit(lambda s, f: jr.generate_rays_wgsl(jc, 48, 36, s, f, parity, y_offset=3))
    jo, jd = raygen(jnp.uint32(9), jnp.uint32(7))
    to, td = tr.generate_rays_wgsl(T.from_reference(jc), 48, 36, 9, 7, parity, y_offset=3)
    for want, got in ((jo, to), (jd, td)):
        want = np.asarray(want)
        ulps = np.abs(want.view(np.int32).astype(np.int64)
                      - got.numpy().view(np.int32).astype(np.int64))
        assert got.shape == (36, 48, 3) and ulps.max() <= 1


# --- trace_path, render and progressive_step on the stream -----------------


def _lit_base():
    """base_scene with an emissive sphere above it: NEE has a light."""
    return J.make_scene(J.make_spheres([
        ((0.0, 0.0, -1.0), 0.5, J.LAMBERTIAN, (0.1, 0.2, 0.5), 0.0),
        ((-1.0, 0.0, -1.0), 0.5, J.METAL, (0.8, 0.8, 0.8), 0.1),
        ((0.0, -100.5, -1.0), 100.0, J.LAMBERTIAN, (0.8, 0.8, 0.0), 0.0),
        ((0.6, 1.2, -0.6), 0.3, J.EMISSIVE, (1.0, 0.9, 0.7), 6.0),
    ]))


@pytest.mark.parametrize("case,kw", [
    ("parity", dict(parity=True)),
    ("plain", dict(parity=False)),
    ("roulette", dict(parity=True, russian_roulette_depth=2)),
    ("nee", dict(parity=False, nee=True, mis=True, sky_intensity=0.2)),
    # 81 lights: one picked a lane from the stream's first NEE draw.
    ("many_lights", dict(parity=False, nee=True, mis=True, sky_intensity=0.0)),
])
def test_trace_path_bounce_seeds_matches_jax(case, kw):
    """Two samples of the WGSL stream through JAX's jitted raygen and
    trace_path and through the port's pieces, 48x32, depth 6."""
    js = {"nee": _lit_base, "many_lights": pc._many_lights_scene}.get(case, J.base_scene)()
    w, h, depth, frame = 48, 32, 6, 7
    jc = J.derive_camera(J_CAMERA, w, h)
    parity = kw["parity"]
    raygen = jax.jit(lambda s, f: jr.generate_rays_wgsl(jc, w, h, s, f, parity))
    trace = jax.jit(lambda o, d, b: ji.trace_path(o, d, js, depth, TMIN, TMAX,
                                                  bounce_seeds=b, **kw))
    tc, ts = T.from_reference(jc), T.from_reference(js)
    for sample in range(2):
        seed = 1 + sample + frame
        jo, jd = raygen(jnp.uint32(seed), jnp.uint32(frame))
        want = np.asarray(trace(jo.reshape(-1, 3), jd.reshape(-1, 3),
                                ji.make_bounce_seeds(jnp.uint32(seed + 1), depth)))
        to, td = tr.generate_rays_wgsl(tc, w, h, seed, frame, parity)
        got = ti.trace_path(to.reshape(-1, 3), td.reshape(-1, 3), ts, depth, TMIN, TMAX,
                            bounce_seeds=ti.make_bounce_seeds(seed + 1, depth), **kw)
        _assert_match(got.reshape(h, w, 3), want.reshape(h, w, 3))


def test_trace_path_takes_exactly_one_stream():
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    seeds = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="exactly one"):
        ti.trace_path(o, d, T.base_scene(), 2, TMIN, TMAX)
    with pytest.raises(ValueError, match="exactly one"):
        ti.trace_path(o, d, T.base_scene(), 2, TMIN, TMAX, pixel_seeds=seeds,
                      bounce_seeds=ti.make_bounce_seeds(1, 2))


def test_render_wgsl_parity_matches_golden():
    """test_goldens.py::test_golden_wgsl_parity through backend='torch'."""
    cfg = T.RenderConfig(width=48, height=32, spp=2, max_depth=6, rng="wgsl", parity=True,
                         backend="torch")
    img = T.render(T.base_scene(), T_CAMERA, cfg, frame_seed=7)
    assert img.shape == (32, 48, 3)
    _assert_match(img, np.load(GOLDEN))


def test_progressive_steps_on_the_wgsl_stream_match_jax():
    """Three progressive steps (one single, then a batch of two) of JAX's
    'jax' backend and of the port's 'torch', at JAX's progressive bound."""
    kw = dict(width=48, height=32, spp=8, max_depth=4, rng="wgsl")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(backend="torch", **kw)
    jst, tst = J.init_accum(32, 48), T.init_accum(32, 48)
    for k in (1, 1, 2):
        jst = J.progressive_step(jst, J.base_scene(), J_CAMERA, jcfg,
                                 frame_seed=jnp.uint32(3), spp_per_step=k)
        tst = T.progressive_step(tst, T.base_scene(), T_CAMERA, tcfg, frame_seed=3,
                                 spp_per_step=k)
        assert int(tst.count) == int(jst.count)
        np.testing.assert_allclose(tst.rgb.numpy(), np.asarray(jst.rgb), atol=1e-5)


def test_wgsl_is_refused_where_jax_refuses_it():
    """The kernels draw the hash stream; the adaptive loop (a kernel mode),
    the ray count and the samplers need it too, as in the JAX package."""
    for backend in ("cuda", "wavefront", "wavefront_torch"):
        with pytest.raises(ValueError, match="requires rng='hash'"):
            T.RenderConfig(backend=backend, rng="wgsl")
    with pytest.raises(ValueError, match="requires rng='hash'"):
        T.RenderConfig(backend="torch", rng="wgsl", sampler="sobol")
    cfg = T.RenderConfig(width=8, height=8, backend="torch", rng="wgsl")
    with pytest.raises(ValueError, match="requires rng='hash'"):
        T.count_traced_rays(T.base_scene(), T_CAMERA, cfg)
    with pytest.raises(ValueError, match="megakernel mode"):
        T.RenderConfig(backend="torch", rng="wgsl", adaptive_tol=0.05)


@pytest.mark.parametrize("kw", [dict(sampler_spec=("sobol", 1)), dict(adaptive_tol=0.05),
                                dict(return_ray_count=True), dict(y_offset=1),
                                dict(row_stride=2)])
def test_render_reference_wgsl_takes_no_hash_stream_option(kw):
    """The WGSL stream is drawn a whole frame at a time: the plain renderer
    refuses the options that address pixels or samples of the hash stream."""
    from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_reference

    cam = T.derive_camera(T_CAMERA, 8, 4)
    with pytest.raises(ValueError, match="rng='wgsl' takes no"):
        render_reference(T.base_scene(), cam, width=8, height=4, spp=2, max_depth=2,
                         t_min=TMIN, rng="wgsl", **kw)


@pytest.mark.parametrize("integrator", ["normal", "albedo", "depth"])
def test_render_wgsl_aov_matches_jax(integrator):
    """The AOV integrators on the WGSL stream's rays (their first hit only)
    against JAX's 'jax' backend, at the goldens' contract."""
    kw = dict(width=48, height=32, spp=2, max_depth=4, rng="wgsl", parity=True,
              integrator=integrator)
    jimg = J.render(J.base_scene(), J_CAMERA, J.RenderConfig(**kw), frame_seed=jnp.uint32(5))
    timg = T.render(T.base_scene(), T_CAMERA, T.RenderConfig(backend="torch", **kw),
                    frame_seed=5)
    _assert_match(timg, np.asarray(jimg))


def test_threefry_refusal_names_its_roadmap_item():
    """The refusal names the ROADMAP.md item of the threefry stream, and
    that item is about threefry."""
    with pytest.raises(NotImplementedError) as e:
        T.RenderConfig(backend="torch", rng="threefry")
    msg = str(e.value)
    assert "rng='threefry'" in msg
    item = int(msg.split("ROADMAP Queue 1 item ")[1].split(",")[0])
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        queue1 = f.read().split("### Queue 1")[1].split("### Queue 2")[0]
    entry = queue1.split(f"\n{item}. ")[1].split(f"\n{item + 1}. ")[0]
    assert "threefry" in entry.split("\n")[0]


# --- the packed-material codec and padding ---------------------------------


def test_pack_materials_byte_equal_and_round_trips():
    jsph = J.one_weekend_scene(jax.random.key(0))
    tsph = T.one_weekend_scene(0)
    want = jspheres.pack_materials(jsph)
    got = tspheres.pack_materials(tsph)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    back = tspheres.unpack_materials(tsph.centers, tsph.radii, got)
    jback = jspheres.unpack_materials(jsph.centers, jsph.radii, want)
    for name in ("centers", "radii", "albedo", "mat_kind", "mat_param"):
        assert np.array_equal(getattr(back, name).numpy(), np.asarray(getattr(jback, name)))
    assert np.array_equal(tspheres.pack_materials(back), got)
    with pytest.raises(ValueError, match="EMISSIVE"):
        tspheres.pack_materials(T.from_reference(_lit_base()).spheres)


def test_pad_to_multiple_renders_the_same_frame():
    sph = T.one_weekend_scene(0)
    padded = sph.pad_to_multiple(128)
    assert padded.count == 256 and float(padded.radii[sph.count:].abs().max()) == 0.0
    assert sph.pad_to(sph.count) is sph
    with pytest.raises(ValueError, match="cannot pad"):
        sph.pad_to(10)
    cfg = T.RenderConfig(width=48, height=27, spp=2, max_depth=6, backend="torch")
    assert torch.equal(T.render(padded, T.CameraSettings.default(), cfg, frame_seed=3),
                       T.render(sph, T.CameraSettings.default(), cfg, frame_seed=3))
