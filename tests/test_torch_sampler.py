"""The port's stratified and Sobol samplers against the JAX package, on the CPU.

The sampler remaps are u32 arithmetic and a few f32 operations on the hash
stream, so they are held bit-exact (np.array_equal) to JAX's jitted
functions on 100k random (pixel id, sample, frame seed) triples.  The
rendered paths through them are held to JAX's jitted raygen + trace_path
pieces and to the sobol_base golden.
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
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu.ops import rng as jrng
from gpu_ray_tracing_tpu_torch.ops import integrators as ti
from gpu_ray_tracing_tpu_torch.ops import rays as tr
from gpu_ray_tracing_tpu_torch.ops import rng as trng
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# Pair ids: AA jitter 5, first-bounce scatter 6, lens 7, NEE lights 8-12.
SALTS = [5, 6, 7, 8, 9, 10, 11, 12]


@pytest.fixture(scope="module")
def triples():
    """100k random (pixel id, sample, frame seed) u32 triples and the
    (salt 1, salt 2) draws of each, as numpy and as the port's tensors."""
    rng = np.random.default_rng(20261016)
    pid, s, fs = (rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
                  for _ in range(3))
    pid[:2], s[:2] = (0, 2**32 - 1), (0, 2**32 - 1)
    seeds = jrng.hash_pixel_seeds(pid, s, fs)
    u1 = np.asarray(jrng.uniform_hash(seeds, np.uint32(1)))
    u2 = np.asarray(jrng.uniform_hash(seeds, np.uint32(2)))
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    return (pid, s, fs, u1, u2), (t(pid), t(s), t(fs), torch.from_numpy(u1.copy()),
                                  torch.from_numpy(u2.copy()))


def _assert_pairs_equal(jpair, tpair):
    for want, got in zip(jpair, tpair):
        assert got.dtype == torch.float32
        assert np.array_equal(np.asarray(want), got.numpy())


def test_strata_shape_and_sobol_nbits_match_jax():
    for spp in range(1, 1025):
        assert T.RenderConfig(spp=spp, sampler="stratified").sampler_spec == (
            "stratified", *jrng.strata_shape(spp))
        assert trng.strata_shape(spp) == jrng.strata_shape(spp)
        assert trng.sobol_nbits(spp) == jrng.sobol_nbits(spp)
    assert T.RenderConfig(spp=16, sampler="sobol").sampler_spec == ("sobol", 5)
    assert T.RenderConfig().sampler_spec is None
    for bad in (trng.strata_shape, trng.sobol_nbits):
        with pytest.raises(ValueError):
            bad(0)


@pytest.mark.parametrize("spp", [1, 2, 7, 16, 64])
def test_stratified_uniforms_bit_exact(triples, spp):
    """Every pair id, per-lane and scalar sample index.  (Jitted XLA divides
    by a constant as a multiply by its f32 reciprocal; the port does too.)"""
    (pid, s, fs, u1, u2), (tpid, ts, tfs, tu1, tu2) = triples
    strata = jrng.strata_shape(spp)
    # The pair id only keys a hash, so one compile serves every salt.
    f = jax.jit(lambda a, b, p, ss, f, salt: jrng.stratified_uniforms(
        a, b, p, ss, f, strata, rot_salt=salt))
    for salt in SALTS:
        _assert_pairs_equal(f(u1, u2, pid, s, fs, np.uint32(salt)),
                            trng.stratified_uniforms(tu1, tu2, tpid, ts, tfs, strata,
                                                     rot_salt=salt))
        _assert_pairs_equal(f(u1, u2, pid, jnp.uint32(3), fs, np.uint32(salt)),
                            trng.stratified_uniforms(tu1, tu2, tpid, 3, tfs, strata,
                                                     rot_salt=salt))


@pytest.mark.parametrize("nbits", [1, 5, 11, 32])
def test_sobol02_uniforms_bit_exact(triples, nbits):
    (pid, s, fs, _, _), (tpid, ts, tfs, _, _) = triples
    f = jax.jit(lambda p, ss, f, salt: jrng.sobol02_uniforms(p, ss, f, nbits, rot_salt=salt))
    for salt in SALTS:
        _assert_pairs_equal(f(pid, s, fs, np.uint32(salt)),
                            trng.sobol02_uniforms(tpid, ts, tfs, nbits, rot_salt=salt))


@pytest.mark.parametrize("spec", [None, ("stratified", 4, 4), ("stratified", 3, 5),
                                  ("sobol", 5)])
def test_sampler_uniforms_and_jitter_bit_exact(triples, spec):
    (pid, s, fs, u1, u2), (tpid, ts, tfs, tu1, tu2) = triples
    f = jax.jit(lambda a, b, p, ss, f, salt: jrng.sampler_uniforms(
        a, b, p, ss, f, spec, rot_salt=salt))
    for salt in SALTS:
        _assert_pairs_equal(f(u1, u2, pid, s, fs, np.uint32(salt)),
                            trng.sampler_uniforms(tu1, tu2, tpid, ts, tfs, spec,
                                                  rot_salt=salt))
    jit = jax.jit(lambda a, b, p, ss, f: jrng.sampler_jitter(a, b, p, ss, f, spec))
    _assert_pairs_equal(jit(u1, u2, pid, s, fs),
                        trng.sampler_jitter(tu1, tu2, tpid, ts, tfs, spec))


def test_sampler_probe_reference_is_ops_rng(triples):
    """The probe's plain version (what chip_smoke holds the kernel to) is
    the remap of the (salt 1, salt 2) draws by ops/rng.py."""
    (pid, s, fs, u1, u2), (tpid, ts, _, _, _) = triples
    ref = tmk.sampler_probe_reference(tpid[:1000], ts[:1000], 99, ("sobol", 5), [5, 8])
    for k, salt in enumerate([5, 8]):
        want = jrng.sampler_uniforms(u1, u2, pid[:1000], s[:1000], np.uint32(99),
                                     ("sobol", 5), rot_salt=np.uint32(salt))
        assert np.array_equal(np.asarray(want[0]), ref["u1"][k].numpy())
        assert np.array_equal(np.asarray(want[1]), ref["u2"][k].numpy())
    zeros = torch.zeros(2)
    with pytest.raises(ValueError, match="unknown sampler"):
        trng.sampler_uniforms(zeros, zeros, tpid[:2], 0, 0, ("halton", 2))


@pytest.mark.parametrize("spec", [("stratified", 4, 4), ("stratified", 3, 5), ("sobol", 5)])
def test_lens_pair_matches_jax(spec):
    """A thin-lens camera draws its lens point on pair id 7, not the AA
    pair's 5: origins, directions and seeds bit-equal to JAX's jitted
    generate_rays_for_ids on 4,096 pixel ids."""
    jc = J.derive_camera(J.CameraSettings.default(), 64, 64)
    assert float(jc.defocus_angle) > 0.0
    ids = np.random.default_rng(3).integers(0, 64 * 64, 4096).astype(np.uint32)
    gen = jax.jit(lambda p, s, f: jr.generate_rays_for_ids(
        jc, p, s, f, total_width=64, sampler_spec=spec))
    jo, jd, js = gen(ids, jnp.uint32(3), jnp.uint32(11))
    to, td, ts = tr.generate_rays_for_ids(T.from_reference(jc),
                                          torch.from_numpy(ids.astype(np.int64)), 3, 11,
                                          total_width=64, sampler_spec=spec)
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy().astype(np.uint32))


@pytest.mark.parametrize("spec,sample", [(("sobol", 3), 1), (("stratified", 2, 2), 3)])
def test_trace_with_sampler_matches_jax_pieces(spec, sample):
    """Sampler raygen + trace_path (the salt-6 first-bounce remap) against
    JAX's jitted pieces on One-Weekend, 48x27, depth 6: flip 0 measured;
    held to the standard 1% / 2e-4."""
    w, h = 48, 27
    js = J.one_weekend_scene(jax.random.key(0))
    jc = J.derive_camera(J.CameraSettings.default(), w, h)
    jo, jd, jseeds = jax.jit(lambda s, f: jr.generate_rays_hash(
        jc, w, h, s, f, sampler_spec=spec))(jnp.uint32(sample), jnp.uint32(11))
    ids = np.arange(w * h, dtype=np.uint32)
    want = jax.jit(lambda o, d, s, p: ji.trace_path(
        o, d, js, 6, 1e-3, 3.4e35, pixel_seeds=s, pixel_ids=p,
        sample_index=jnp.uint32(sample), frame_seed_u32=jnp.uint32(11),
        sampler_spec=spec))(jo.reshape(-1, 3), jd.reshape(-1, 3), jseeds.reshape(-1), ids)
    to, td, tseeds = tr.generate_rays_hash(T.from_reference(jc), w, h, sample, 11,
                                           sampler_spec=spec)
    got = ti.trace_path(to.reshape(-1, 3), td.reshape(-1, 3), T.one_weekend_scene(0), 6,
                        1e-3, 3.4e35, pixel_seeds=tseeds.reshape(-1),
                        pixel_ids=torch.arange(w * h), sample_index=sample,
                        frame_seed_u32=11, sampler_spec=spec)
    m = T.images_match(got.reshape(h, w, 3), np.asarray(want).reshape(h, w, 3), 0.01, 2e-4)
    assert m.ok, m


def test_sampler_spec_needs_the_sample_address():
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="pixel_ids"):
        ti.trace_path(o, o + 1.0, T.base_scene(), 2, 1e-3, 3.4e35,
                      pixel_seeds=torch.zeros(4, dtype=torch.int64),
                      sampler_spec=("sobol", 3))


def test_sobol_base_golden():
    """benchmarks/parity_check.py's sobol_base_48x32 through backend='torch'
    at tests/test_goldens.py's thresholds (0.5% / 1e-4)."""
    cam = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                60.0, 0.0, 2.0)
    cfg = T.RenderConfig(width=48, height=32, spp=4, max_depth=6, sampler="sobol",
                         backend="torch")
    img = T.render(T.base_scene(), cam, cfg, frame_seed=5)
    m = T.images_match(img, np.load(os.path.join(GOLDEN_DIR, "sobol_base_48x32.npy")),
                       0.005, 1e-4)
    assert m.ok, m


def _jax_and_port_bounces(js, spec, depth, **kw):
    """48 x 36 frames of samples 0 and 4 through JAX's jitted raygen +
    trace_path and through the port's: [(sample, port, jax)], (P, 3) each.
    The scene is an argument of the jitted trace, as JAX's `render` jits
    it: closed over, it would be a constant that XLA folds in plain f32
    (each sphere's |c|^2 - r^2), which no call of the library does."""
    w, h, seed = 48, 36, 9
    jc = J.derive_camera(pc.BASE_CAMERA, w, h)
    raygen = jax.jit(lambda s: jr.generate_rays_hash(jc, w, h, s, jnp.uint32(seed),
                                                     sampler_spec=spec))
    trace = jax.jit(lambda sc, o, d, s, p, si: ji.trace_path(
        o, d, sc, depth, 1e-3, 3.4e35, pixel_seeds=s, pixel_ids=p, sample_index=si,
        frame_seed_u32=jnp.uint32(seed), sampler_spec=spec, **kw))
    ids = np.arange(w * h, dtype=np.uint32)
    ts, tc = T.from_reference(js), T.from_reference(jc)
    out = []
    for sample in (0, 4):
        jo, jd, jseeds = raygen(jnp.uint32(sample))
        want = np.asarray(trace(js, jo.reshape(-1, 3), jd.reshape(-1, 3), jseeds.reshape(-1),
                                ids, jnp.uint32(sample)))
        to, td, tseeds = tr.generate_rays_hash(tc, w, h, sample, seed, sampler_spec=spec)
        got = ti.trace_path(to.reshape(-1, 3), td.reshape(-1, 3), ts, depth, 1e-3, 3.4e35,
                            pixel_seeds=tseeds.reshape(-1), pixel_ids=torch.arange(w * h),
                            sample_index=sample, frame_seed_u32=seed, sampler_spec=spec, **kw)
        out.append((sample, got.numpy(), want))
    return out


@pytest.mark.parametrize("spec", [("stratified", 3, 5), ("stratified", 2, 3)])
def test_stratified_first_bounce_matches_jax_pieces_bit_for_bit(spec):
    """spp 15 (3 x 5) and spp 6 (2 x 3): sides that are not powers of two.
    The first-bounce scatter angle is the remapped u2 times 2 pi, as jitted
    trace_path computes it: its bounces run in a while loop and XLA folds no
    2 pi into the remap's 1/ky there (the optimized HLO keeps the constants
    0.2 and 6.2831855 apart; folding them moved 44-56 more pixels of a
    48 x 36 base_scene frame off JAX's image at depths 2-3).  On
    parity_check's _nee_scene, lit through BSDF rays only (nee off, sky 0,
    so no sky gradient or light sample rounds apart), the image is
    bit-equal to JAX's jitted raygen + trace_path at depth 3, samples 0
    and 4."""
    for sample, got, want in _jax_and_port_bounces(pc._nee_scene(), spec, 3,
                                                   sky_intensity=0.0):
        assert want.max() > 0.5  # the light is reached
        assert np.array_equal(got, want), sample


@pytest.mark.parametrize("scene", ["nee", "base"])
@pytest.mark.parametrize("spec", [None, ("stratified", 3, 5), ("stratified", 2, 3)])
def test_nee_and_sky_stay_within_one_ulp_of_jax_for_every_sampler(spec, scene):
    """Depth 2, samples 0 and 4: the bounce-0 NEE estimate (its cone angle
    is the stratified u2 times 2 pi) on _nee_scene with nee+mis and sky 0,
    and the sky gradient on base_scene, against JAX's jitted pieces.  The
    port rounds the pieces as XLA:CPU does (glibc cosf/sinf and powf, a
    correctly rounded sqrt, the fused multiply-adds of the sky, the unit
    vector, the BSDFs and the radiance sums, XLA's r2 / (d2 (1 + s)) in the
    cone's 1 - cos_max; test_torch_rounding.py holds each piece bit for
    bit).  What is left is a last-bit residue inside the fused bounce:
    measured NEE up to 2.68e-7 in at most 8.0% of pixels (1.41e-5 in 15%
    before), sky 5.96e-8 in at most 0.29% (1.19e-7 in 15% before), never a
    flip; each is held just above its reading."""
    if scene == "nee":
        js, kw = pc._nee_scene(), dict(nee=True, mis=True, sky_intensity=0.0)
        limit, share = 3e-7, 0.085
    else:
        js, kw, limit, share = J.base_scene(), {}, 6e-8, 0.004
    for sample, got, want in _jax_and_port_bounces(js, spec, 2, **kw):
        diff = np.abs(got - want).max(-1)
        assert diff.max() <= limit, (sample, diff.max())
        assert (diff > 0).mean() <= share, (sample, (diff > 0).mean())
