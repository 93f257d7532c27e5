"""The port's threefry mode (rng='threefry') on the CPU.

The port draws jax.random's own stream (ops/rng.py: threefry2x32 under
JAX's partitionable counters, keys as JAX's two u32 words), so it is held
to the JAX package bit for bit: PRNGKey, split, fold_in and uniform on the
same keys, generate_rays_threefry, and frames against JAX's jitted pieces
(ray generation, then _trace_chunked: one block, two equal blocks, and
three lit scenes through NEE, MIS and Russian roulette) at the goldens'
decision-flip thresholds.  It is also held to JAX in
distribution (ray generation by moments over 10^5 draws, frames to the
hash stream's mean within Monte Carlo error, samples to independence),
and for a given key it is deterministic.  The refusals are JAX's: no key,
spp_per_step > 1, sharding, a kernel backend.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch import cli
from gpu_ray_tracing_tpu_torch.ops import integrators as ti
from gpu_ray_tracing_tpu_torch.ops import rays as tr
from gpu_ray_tracing_tpu_torch.ops import rng as trng
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import render_reference
from gpu_ray_tracing_tpu_torch.parallel import sharding
from gpu_ray_tracing_tpu_torch.utils.checkpoint import render_fingerprint
from gpu_ray_tracing_tpu_torch.utils.image import write_image

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

# A thin lens, so that frames draw the disk as well as the jitter.
LENS = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0], vup=[0.0, 1.0, 0.0],
            field_of_view=60.0, defocus_angle=3.0, focus_distance=2.0)
T_CAMERA = T.CameraSettings.make(*LENS.values())
W, H, SPP, DEPTH = 48, 36, 256, 4


def _cfg(**kw):
    return T.RenderConfig(**{**dict(width=W, height=H, spp=2, max_depth=DEPTH,
                                    rng="threefry", backend="torch"), **kw})


def _draws(camera, origins, dirs, width, height):
    """(jitter x, jitter y, lens x, lens y) that generated the rays, solved
    back from the camera's orthogonal pixel and disk vectors: 1-D numpy."""
    c = {k: np.asarray(getattr(camera, k), np.float64) for k in
         ("center", "viewport_upper_left", "pixel_delta_u", "pixel_delta_v",
          "defocus_disk_u", "defocus_disk_v")}
    o, d = np.asarray(origins, np.float64), np.asarray(dirs, np.float64)
    rel = o + d - c["viewport_upper_left"]
    proj = lambda v, a: (v @ a) / (a @ a)
    x = np.arange(width)[None, :] + 0.5
    y = np.arange(height)[:, None] + 0.5
    jx = proj(rel, c["pixel_delta_u"]) - x
    jy = proj(rel, c["pixel_delta_v"]) - y
    lens = o - c["center"]
    return (jx.ravel(), jy.ravel(), proj(lens, c["defocus_disk_u"]).ravel(),
            proj(lens, c["defocus_disk_v"]).ravel())


def _assert_uniform_draws(jx, jy, px, py):
    """Jitter uniform on [-0.5, 0.5), lens points uniform on the unit disk,
    by moments within 5 standard errors, and their ranges."""
    n = jx.size
    for j in (jx, jy):
        assert j.min() >= -0.5 - 1e-4 and j.max() < 0.5 + 1e-4
        assert abs(j.mean()) < 5 * np.sqrt(1 / 12 / n)
        assert abs(j.var() - 1 / 12) < 5 * np.sqrt((1 / 80 - 1 / 144) / n)
    r2 = px * px + py * py
    assert r2.max() <= 1.0 + 1e-4
    # r^2 of a uniform disk point is U[0, 1); each coordinate has mean 0
    # and second moment 1/4.
    assert abs(r2.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    for p in (px, py):
        assert abs(p.mean()) < 5 * np.sqrt(0.25 / n)
        assert abs((p * p).mean() - 0.25) < 5 * np.sqrt(1 / 16 / n)  # E p^4 = 1/8
    assert abs((px * py).mean()) < 5 * np.sqrt(1 / 24 / n)


def test_generate_rays_threefry_has_jaxs_distribution():
    """10^5 draws of the port's generate_rays_threefry and of JAX's: both
    uniform jitter in [-0.5, 0.5) and uniform-disk lens points."""
    import gpu_ray_tracing_tpu as J
    import jax
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu.ops import rays as jr

    w, h = 400, 250
    js = J.CameraSettings(**{k: jnp.asarray(v, jnp.float32) for k, v in LENS.items()})
    jc = J.derive_camera(js, w, h)
    jo, jd = jax.jit(lambda k: jr.generate_rays_threefry(jc, w, h, k))(jax.random.key(3))
    _assert_uniform_draws(*_draws(jc, jo, jd, w, h))
    tc = T.from_reference(jc)
    to, td = tr.generate_rays_threefry(tc, w, h, key=3)
    assert to.shape == td.shape == (h, w, 3) and to.dtype == torch.float32
    _assert_uniform_draws(*_draws(tc, to.numpy(), td.numpy(), w, h))


def test_threefry_is_deterministic_for_a_key():
    """The same key renders the same bits; another key another frame; an
    int key is jax.random.PRNGKey(k), which keeps the seed's low 32 bits,
    so key 11 + 2^32 and the words (0, 11) render key 11's frame."""
    scene = T.base_scene()
    a = T.render(scene, T_CAMERA, _cfg(), key=11)
    assert torch.equal(a, T.render(scene, T_CAMERA, _cfg(), key=11))
    b = T.render(scene, T_CAMERA, _cfg(), key=12)
    assert not torch.equal(a, b)
    assert torch.equal(a, T.render(scene, T_CAMERA, _cfg(), key=11 + (1 << 32)))
    assert torch.equal(a, T.render(scene, T_CAMERA, _cfg(), key=np.array([0, 11], np.uint32)))
    assert not torch.equal(a, T.render(scene, T_CAMERA, _cfg(), key=(1, 11)))
    rays = tr.generate_rays_threefry(T.derive_camera(T_CAMERA, W, H), W, H, key=5)
    assert all(torch.equal(x, y) for x, y in
               zip(rays, tr.generate_rays_threefry(T.derive_camera(T_CAMERA, W, H), W, H,
                                                   key=5)))


def _words(jkey) -> tuple[int, int]:
    import jax

    return tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("seed", [0, 42, 11 + (1 << 32), -3])
def test_prng_key_equals_jax(seed):
    """PRNGKey(k) with 32-bit ints is (0, k mod 2^32), a seed above 2^32
    and a negative one included."""
    import jax
    assert trng.prng_key(seed) == _words(jax.random.PRNGKey(seed))
    assert trng.as_key(seed) == trng.as_key(_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("shape", [(2, 3, 5), (2, 6144)])
def test_split_fold_in_uniform_equal_jax(shape):
    """split, fold_in and uniform bit for bit on the same keys: a chain of
    both, then uniform over `shape` from each key of it."""
    import jax
    import jax.numpy as jnp

    jk, tk = jax.random.PRNGKey(42), trng.prng_key(42)
    ja, jb = jax.random.split(jk)
    ta, tb = trng.split(tk)
    assert (_words(ja), _words(jb)) == (ta, tb)
    for d in (0, 7, 2000 + 22, (1 << 32) - 1):
        assert _words(jax.random.fold_in(jb, d)) == trng.fold_in(tb, d)
    for j, t in ((jk, tk), (jb, tb), (jax.random.fold_in(ja, 1000), trng.fold_in(ta, 1000))):
        want = np.asarray(jax.random.uniform(j, shape, jnp.float32))
        got = trng.uniform(t, shape).numpy()
        assert got.shape == shape and got.dtype == np.float32
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("defocus", [3.0, 0.0])
def test_generate_rays_threefry_equals_jax(defocus):
    """The port's generate_rays_threefry against JAX's, jitted with the
    camera an argument (as render passes it), bit for bit: the lens and the
    pinhole."""
    import jax
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu.ops import rays as jr

    w, h = 64, 48
    lens = dict(LENS, defocus_angle=defocus)
    jc = J.derive_camera(J.CameraSettings(**{k: jnp.asarray(v, jnp.float32)
                                             for k, v in lens.items()}), w, h)
    for seed in (3, 11 + (1 << 32)):
        jo, jd = jax.jit(lambda c, k: jr.generate_rays_threefry(c, w, h, k))(
            jc, jax.random.PRNGKey(seed))
        to, td = tr.generate_rays_threefry(T.from_reference(jc), w, h, seed)
        assert np.array_equal(np.asarray(jo), to.numpy())
        assert np.array_equal(np.asarray(jd), td.numpy())


def _jax_threefry_frame(jscene, jcam, cfg, seed: int) -> np.ndarray:
    """JAX's threefry render from its jitted pieces (_render_spp_jax's
    folds, api.py:244, :333): sample s under fold_in(key, s), split into
    generate_rays_threefry and _trace_chunked, summed in order."""
    import jax
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu import api as japi
    from gpu_ray_tracing_tpu.ops import rays as jr

    jcfg = J.RenderConfig(width=cfg.width, height=cfg.height, spp=cfg.spp,
                          max_depth=cfg.max_depth, rng="threefry", nee=cfg.nee, mis=cfg.mis,
                          russian_roulette_depth=cfg.russian_roulette_depth,
                          sky_intensity=cfg.sky_intensity)
    raygen = jax.jit(lambda c, k: jr.generate_rays_threefry(c, cfg.width, cfg.height, k))
    trace = jax.jit(lambda o, d, sc, k: japi._trace_chunked(o, d, sc, jcfg, key=k))
    key = jax.random.PRNGKey(seed)
    acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for s in range(cfg.spp):
        k_ray, k_trace = jax.random.split(jax.random.fold_in(key, s))
        o, d = raygen(jcam, k_ray)
        acc = acc + trace(o, d, jscene, k_trace)
    return np.asarray(acc / jnp.float32(cfg.spp))


# The lit cases draw every NEE and roulette key of the stream: one sphere
# light and the Cornell box's two triangle lights loop over their lights
# (two draws a light at salt offset 7g + 1); the 81 ordinals of an emissive
# icosphere pick one light (three draws at offset 0).
LIT = dict(nee=True, mis=True, russian_roulette_depth=1, sky_intensity=0.0)


@pytest.mark.parametrize("case", ["one_block", "two_blocks", "sphere_light", "tri_lights",
                                  "picked_light"])
def test_render_threefry_equals_jax_pieces(case):
    """render(rng='threefry', backend='torch') against JAX's threefry
    render from its jitted pieces at the goldens' thresholds (flip <= 0.5%,
    mean |diff| < 1e-4): base_scene at 48x36 through the lens (one block);
    the 487 spheres of One-Weekend's full grid at 128x96, which the CPU
    budget traces as two equal blocks of 6,144 pixels, each under
    fold_in(key, b); and three lit scenes through NEE, MIS and Russian
    roulette from the first bounce."""
    import jax
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu import api as japi
    from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
    from benchmarks import parity_check as pc

    kw, settings = {}, None
    if case == "one_block":
        jscene, w, h, settings = J.base_scene(), W, H, LENS
    elif case == "two_blocks":
        jscene = J.one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11)
        w, h = 128, 96
    elif case == "tri_lights":
        jscene, w, h, kw = J.cornell_box_scene(), 48, 48, LIT
    else:
        jscene = pc._nee_scene() if case == "sphere_light" else pc._many_lights_scene()
        w, h, settings, kw = W, H, LENS, LIT
    cfg = _cfg(width=w, height=h, spp=2, **kw)
    if case == "tri_lights":
        js, ts = J.cornell_camera(), T.cornell_camera()
    elif settings is None:
        js, ts = J.CameraSettings.default(), T.CameraSettings.default()
    else:
        js = J.CameraSettings(**{k: jnp.asarray(v, jnp.float32) for k, v in settings.items()})
        ts = T_CAMERA
    tscene = T.from_reference(jscene)
    blocks = w * h // tmk._trace_block_size(w * h, T.as_scene(tscene))
    assert blocks == w * h // japi._trace_block_size(w * h, japi._scene_width(jscene))
    assert blocks == (2 if case == "two_blocks" else 1)
    want = _jax_threefry_frame(jscene, J.derive_camera(js, w, h), cfg, 9)
    got = T.render(tscene, ts, cfg, key=9)
    if kw:
        assert float(got.mean()) > 0
    m = T.images_match(got, want, 0.005, 1e-4)
    assert m.ok, m


def _per_sample(scene, rng: str, n: int, **kw) -> np.ndarray:
    """(n, H, W, 3) f64: sample s of render(spp=n) alone, for s < n."""
    cam = T.derive_camera(T_CAMERA, W, H)
    return np.stack([render_reference(
        scene, cam, width=W, height=H, sample_index=s, spp=1, max_depth=DEPTH, t_min=1e-3,
        rng=rng, light_pick="lane", **kw).numpy() for s in range(n)]).astype(np.float64)


@pytest.fixture(scope="module")
def samples():
    """256 threefry and 256 hash samples of base_scene through the lens."""
    scene = T.base_scene()
    return (_per_sample(scene, "threefry", SPP, key=7),
            _per_sample(scene, "hash", SPP, frame_seed=7))


def test_threefry_frame_is_the_mean_of_its_samples(samples):
    """render(spp=n, key=k) sums sample s, drawn under fold_in(k, s), for
    s < n in order: the per-sample frames reproduce it bit for bit."""
    got = T.render(T.base_scene(), T_CAMERA, _cfg(spp=SPP), key=7)
    acc = torch.zeros(H * W, 3)
    for s in samples[0]:
        acc += torch.from_numpy(s.astype(np.float32)).reshape(-1, 3)
    assert torch.equal(got, (acc / float(SPP)).reshape(H, W, 3))


def test_threefry_mean_matches_the_hash_stream(samples):
    """At 48x36 and 256 spp, per pixel and channel |mean difference| <= 4
    standard errors (from the two streams' per-sample variances) for >=
    99% of them, and the frame means within 4 standard errors."""
    tf, hs = samples
    n = SPP
    delta = tf.mean(0) - hs.mean(0)
    se = np.sqrt(tf.var(0, ddof=1) / n + hs.var(0, ddof=1) / n)
    # 1e-6 is the f32 rounding of a mean of values <= 1.
    within = np.abs(delta) <= 4 * se + 1e-6
    assert within.mean() >= 0.99, within.mean()
    m_tf, m_hs = tf.mean(axis=(1, 2, 3)), hs.mean(axis=(1, 2, 3))
    se_frame = np.sqrt(m_tf.var(ddof=1) / n + m_hs.var(ddof=1) / n)
    assert abs(m_tf.mean() - m_hs.mean()) <= 4 * se_frame


def _independence(x: np.ndarray) -> tuple[float, float, float, float]:
    """For (n, H, W, 3) samples: |mean per-pixel lag-1 correlation + 1/n|
    and its 3-standard-error bound, |mean correlation of neighbouring
    pixels| and its bound (test_threefry_samples_are_independent)."""
    n = x.shape[0]
    lum = x.sum(-1)
    x = lum - lum.mean(0)
    a = x[:, x.std(0) > 0]
    r = (a[:-1] * a[1:]).sum(0) / (a * a).sum(0)
    u, v = x[:, :, :-1], x[:, :, 1:]
    live = (u.std(0) > 0) & (v.std(0) > 0)
    c = (u * v).sum(0)[live] / np.sqrt((u * u).sum(0)[live] * (v * v).sum(0)[live])
    return (abs(r.mean() + 1 / n), 3 / np.sqrt(n * r.size),
            abs(c.mean()), 3 / np.sqrt((n - 1) * c.size))


def test_threefry_samples_are_independent(samples):
    """Per pixel, the lag-1 correlation of its 256 samples (the sum of its
    channels, its mean removed) has mean -1/n and standard error 1/sqrt(n)
    for independent samples: their mean over the P live pixels is within 3
    standard errors, 3 / sqrt(n P), of -1/n.  Per neighbouring pair of
    pixels, the correlation of their samples has mean 0 and standard error
    1/sqrt(n - 1): their mean over the pairs is within 3 / sqrt((n - 1)
    pairs) of 0.  Pixels weigh equally: pooled over pixels and channels,
    the few bright pixels of a frame and its three correlated channels
    would carry the correlation, whose spread 1/sqrt(pooled count) then
    understates several times."""
    lag, lag_bound, pair, pair_bound = _independence(samples[0])
    assert lag < lag_bound, (lag, lag_bound)
    assert pair < pair_bound, (pair, pair_bound)


def test_the_independence_test_catches_a_reused_sample_key(samples):
    """The same samples with every odd sample a copy of the one before it
    (sample 2k + 1 drawn under sample 2k's key) fail the lag-1 bound
    many times over."""
    reused = samples[0][[2 * (s // 2) for s in range(SPP)]]
    lag, lag_bound, _, _ = _independence(reused)
    assert lag > 50 * lag_bound, (lag, lag_bound)


def test_progressive_and_animation_fold_the_key():
    """progressive_step(key=k) from zero is render(spp=1, key=k);
    render_progressive draws frame f from fold_in(key, f), and
    render_animation renders frame f with that key (api.py:512, :551)."""
    scene, cfg = T.base_scene(), _cfg(spp=3, width=16, height=12)
    st = T.progressive_step(T.init_accum(12, 16), scene, T_CAMERA, cfg, key=4)
    one = T.render(scene, T_CAMERA, T.RenderConfig(**{**cfg.__dict__, "spp": 1}), key=4)
    assert torch.equal(st.rgb, one)
    prog = T.render_progressive(scene, T_CAMERA, cfg, key=4)
    want = T.init_accum(12, 16)
    for f in range(3):
        want = T.progressive_step(want, scene, T_CAMERA, cfg,
                                  key=trng.fold_in(trng.prng_key(4), f))
    assert int(prog.count) == 3 and torch.equal(prog.rgb, want.rgb)
    track = T.stack_camera_track([T_CAMERA, T.orbit_yaw(T_CAMERA, 0.1)])
    frames = T.render_animation(scene, track, cfg, key=4)
    assert torch.equal(frames[1], T.render(scene, T.orbit_yaw(T_CAMERA, 0.1), cfg,
                                           key=trng.fold_in(trng.prng_key(4), 1)))


def test_threefry_refusals():
    """No key; spp_per_step > 1; sharding; a kernel backend."""
    scene = T.base_scene()
    with pytest.raises(ValueError, match="requires key="):
        T.render(scene, T_CAMERA, _cfg())
    with pytest.raises(ValueError, match="spp_per_step > 1 requires a counter-based rng"):
        T.progressive_step(T.init_accum(H, W), scene, T_CAMERA, _cfg(spp=4), key=1,
                           spp_per_step=2)
    with pytest.raises(ValueError, match="position-equivariant"):
        sharding._check(_cfg(), mesh=None)
    for backend in ("cuda", "wavefront", "wavefront_torch"):
        with pytest.raises(ValueError, match="requires rng='hash'"):
            T.RenderConfig(rng="threefry", backend=backend)
    with pytest.raises(ValueError, match="exactly one"):
        ti.trace_path(torch.zeros(4, 3), torch.ones(4, 3), scene, 2, 1e-3, 3.4e35,
                      pixel_seeds=torch.zeros(4, dtype=torch.int64), generator_key=3)


def test_threefry_through_nee_mis_and_roulette_is_finite_and_keyed():
    """trace_path(generator_key=) through the NEE, MIS and roulette draws,
    and the AOV integrators on the stream's rays."""
    lit = T.make_scene(T.make_spheres([
        ((0.0, 0.0, -1.0), 0.5, T.LAMBERTIAN, (0.1, 0.2, 0.5), 0.0),
        ((0.0, -100.5, -1.0), 100.0, T.LAMBERTIAN, (0.8, 0.8, 0.0), 0.0),
        ((0.6, 1.2, -0.6), 0.3, T.EMISSIVE, (1.0, 0.9, 0.7), 6.0),
    ]))
    cfg = _cfg(nee=True, mis=True, russian_roulette_depth=1, sky_intensity=0.2)
    a = T.render(lit, T_CAMERA, cfg, key=2)
    assert torch.isfinite(a).all() and float(a.mean()) > 0
    assert torch.equal(a, T.render(lit, T_CAMERA, cfg, key=2))
    den = T.render_denoised(lit, T_CAMERA, cfg, key=2, iterations=2)
    assert den.shape == (H, W, 3) and torch.isfinite(den).all()


def test_a_key_seeds_the_counter_streams_by_its_low_word():
    """The JAX package's _resolve_rng: a key given to the hash or wgsl
    stream becomes the frame seed key & 0xFFFFFFFF."""
    for rng in ("hash", "wgsl"):
        cfg = _cfg(rng=rng, width=16, height=12)
        want = T.render(T.base_scene(), T_CAMERA, cfg, frame_seed=9)
        assert torch.equal(T.render(T.base_scene(), T_CAMERA, cfg, key=9 + (3 << 32)), want)


def test_render_fingerprint_takes_the_key():
    cfg = _cfg()
    fp = render_fingerprint(T.base_scene(), cfg, key=5)
    assert fp == render_fingerprint(T.base_scene(), cfg, key=5)
    assert fp != render_fingerprint(T.base_scene(), cfg, key=6)
    assert fp != render_fingerprint(T.base_scene(), cfg)
    assert fp == render_fingerprint(T.base_scene(), cfg, key=(0, 5))


def test_cli_rng_threefry_writes_the_keyed_frame(tmp_path, capsys):
    """`render --rng threefry --device cpu --seed 9` writes
    write_image(render(key=9)); --backend auto resolves to 'torch'."""
    out = os.path.join(tmp_path, "tf.png")
    rc = cli.main(["render", "--scene", "base", "--width", "40", "--height", "30", "--spp",
                   "2", "--depth", "5", "--seed", "9", "--rng", "threefry", "--out", out,
                   "--device", "cpu"])
    assert rc == 0 and "backend=torch" in capsys.readouterr().out
    ns = argparse.Namespace(scene="base", scene_seed=0, obj=None, look_from=None,
                            look_at=None, fov=None, defocus_angle=None, focus_distance=None)
    dev = torch.device("cpu")
    cfg = T.RenderConfig(width=40, height=30, spp=2, max_depth=5, backend="torch",
                         rng="threefry")
    img = T.render(cli._build_scene(ns, dev), cli._build_camera(ns, dev), cfg, key=9)
    ref = os.path.join(tmp_path, "api.png")
    write_image(ref, img)
    assert np.array_equal(np.asarray(Image.open(out)), np.asarray(Image.open(ref)))
    ap = argparse.ArgumentParser()
    cli._add_common(ap)
    assert cli._backend(ap.parse_args(["--device", "cuda", "--rng", "threefry"])) == "torch"
