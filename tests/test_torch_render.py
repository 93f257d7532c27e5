"""The port's render path against the JAX package, on the CPU.

Each module that the slice runs is compared with its JAX counterpart on
the same inputs (made with numpy from a seed), then the whole render:
backend='torch' against backend='jax', against the Pallas megakernel in
interpret mode (as tests/test_pallas.py runs it), and against the
committed goldens at tests/test_goldens.py's thresholds.  Two images of
one RNG stream agree except where rounding flips a hit or scatter
decision, so path-traced images are held to the decision-flip contract
(utils/parity.images_match); bounce-free AOV images to an absolute
tolerance.  The CUDA kernel has no CPU mode: its tests are in
tests/test_torch_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import intersect as jx
from gpu_ray_tracing_tpu.ops import materials as jm
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu_torch.ops import integrators as ti
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops import materials as tm
from gpu_ray_tracing_tpu_torch.ops import rays as tr
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as tmk
from tests.test_api import BASE_CAMERA

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
T_BASE_CAMERA = T.CameraSettings.make(
    [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0], 60.0, 0.0, 2.0)


def _jax_render(cfg_kw, seed, backend="jax", scene=None, camera=BASE_CAMERA):
    scene = J.base_scene() if scene is None else scene
    cfg = J.RenderConfig(backend=backend, **cfg_kw)
    return np.asarray(J.render(scene, camera, cfg, frame_seed=jnp.uint32(seed)))


def _torch_render(cfg_kw, seed, scene=None, camera=T_BASE_CAMERA):
    scene = T.base_scene() if scene is None else scene
    return T.render(scene, camera, T.RenderConfig(**{"backend": "torch", **cfg_kw}),
                    frame_seed=seed)


def _assert_match(a, b, flip_frac, mean_tol):
    m = T.images_match(a, b, flip_frac, mean_tol)
    assert m.ok, m


# --- modules ---------------------------------------------------------------


def test_generate_rays_hash_matches_jax():
    jc = J.derive_camera(J.CameraSettings.default(), 40, 24)
    gen = jax.jit(lambda s, f: jr.generate_rays_hash(jc, 40, 24, s, f, y_offset=5,
                                                     total_width=40, row_stride=2))
    jo, jd, js = gen(jnp.uint32(3), jnp.uint32(11))
    to, td, ts = tr.generate_rays_hash(T.from_reference(jc), 40, 24, 3, 11,
                                       y_offset=5, total_width=40, row_stride=2)
    assert np.array_equal(np.asarray(js), ts.numpy().astype(np.uint32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def test_intersect_spheres_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (2000, 3)).astype(np.float32) + np.float32([0, 1.5, 6])
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    js, ts = J.one_weekend_scene(jax.random.key(0)), T.one_weekend_scene(0)
    # Jitted, as the render runs it: XLA then fuses the quadratic.
    jh = jax.jit(lambda o, d: jx.intersect_spheres(o, d, js, 1e-3, 3.4e35))(o, d)
    th = tx.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d), ts, 1e-3, 3.4e35)
    hit = np.asarray(jh.hit)
    assert hit.any() and (~hit).any()
    # Grazing rays may flip a hit decision (the flip contract): at most 0.5%.
    same = (hit == th.hit.numpy()) & (~hit | (np.asarray(jh.idx) == th.idx.numpy()))
    assert same.mean() >= 0.995, same.mean()
    both = same & hit
    # The ground sphere (r = 1000) makes |o - c|^2 - r^2 a difference of
    # ~1e6-sized terms, so its roots carry ~1e-4 relative rounding, and its
    # normals (p - c) / r inherit that of a point ~1000 from the center.
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same], rtol=2e-4)
    np.testing.assert_allclose(th.normal.numpy()[both], np.asarray(jh.normal)[both], atol=1e-3)
    assert np.array_equal(np.asarray(jh.front_face)[both], th.front_face.numpy()[both])


def test_scatter_matches_jax():
    rng = np.random.default_rng(9)
    n = 3000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where((d * nrm).sum(-1, keepdims=True) > 0, -nrm, nrm).astype(np.float32)
    front = rng.random(n) < 0.7
    albedo = rng.random((n, 3)).astype(np.float32)
    kind = rng.integers(0, 3, n).astype(np.int32)
    param = np.where(kind == 2, 1.5, 0.5 * rng.random(n)).astype(np.float32)
    uv = rng.normal(size=(n, 3)).astype(np.float32)
    uv /= np.linalg.norm(uv, axis=-1, keepdims=True)
    ur = rng.random(n).astype(np.float32)
    args = (d, nrm, front, albedo, kind, param, uv, ur)
    jout = jm.scatter(*(jnp.asarray(a) for a in args))
    tout = tm.scatter(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=1e-5)
    assert np.array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert np.array_equal(tout[2].numpy(), np.asarray(jout[2]))


# --- the render path ---------------------------------------------------------


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_base_normal_matches_jax_and_pallas(backend):
    kw = dict(width=64, height=48, spp=1, integrator="normal")
    want = _jax_render(kw, 0, backend=backend)
    got = _torch_render(kw, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_base_path_matches_jax_and_pallas(backend):
    kw = dict(width=64, height=48, spp=1, max_depth=6)
    _assert_match(_torch_render(kw, 7), _jax_render(kw, 7, backend=backend), 0.01, 2e-4)


@pytest.mark.parametrize("mode,rtol,atol", [("albedo", 0, 2e-5), ("depth", 1e-5, 0)])
def test_aov_modes_match_jax(mode, rtol, atol):
    """Albedo to 2e-5 absolute; depth, a metric distance up to ~100 on the
    ground sphere, to 1e-5 relative."""
    kw = dict(width=64, height=48, spp=2, integrator=mode)
    np.testing.assert_allclose(_torch_render(kw, 4).numpy(), _jax_render(kw, 4),
                               rtol=rtol, atol=atol)


def test_russian_roulette_and_clamp_match_jax():
    kw = dict(width=64, height=48, spp=2, max_depth=8, russian_roulette_depth=2, clamp=2.0)
    _assert_match(_torch_render(kw, 5), _jax_render(kw, 5), 0.01, 2e-4)


def test_one_weekend_trace_matches_jax():
    """Hash raygen and trace_path, each jitted as the JAX package runs them,
    against the port's on One-Weekend.  (The fully fused jitted render can
    round differently from these same pieces: at this seed XLA's whole-frame
    fusion moves five pixels by up to 0.33 against its own pieces, so the
    frame-level comparison is the golden test below.)"""
    w, h = 48, 27
    js = J.one_weekend_scene(jax.random.key(0))
    jc = J.derive_camera(J.CameraSettings.default(), w, h)
    gen = jax.jit(lambda s, f: jr.generate_rays_hash(jc, w, h, s, f))
    trace = jax.jit(lambda o, d, s: ji.trace_path(
        o, d, js, 6, 1e-3, 3.4e35, pixel_seeds=s))
    jo, jd, jseeds = gen(jnp.uint32(0), jnp.uint32(11))
    want = np.asarray(trace(jo.reshape(-1, 3), jd.reshape(-1, 3), jseeds.reshape(-1)))
    to, td, tseeds = tr.generate_rays_hash(T.from_reference(jc), w, h, 0, 11)
    got = ti.trace_path(
        to.reshape(-1, 3), td.reshape(-1, 3), T.one_weekend_scene(0), 6, 1e-3, 3.4e35,
        pixel_seeds=tseeds.reshape(-1))
    _assert_match(got.reshape(h, w, 3), want.reshape(h, w, 3), 0.01, 2e-4)


@pytest.mark.parametrize("golden,scene,cfg_kw,seed,flip,mean", [
    ("base_normal_64x48.npy", "base", dict(width=64, height=48, spp=1, integrator="normal"),
     0, 0.002, 1e-5),
    ("base_path_64x48.npy", "base", dict(width=64, height=48, spp=4, max_depth=8),
     42, 0.005, 1e-4),
    ("one_weekend_48x27.npy", "one_weekend", dict(width=48, height=27, spp=2, max_depth=6),
     3, 0.01, 2e-4),
])
def test_goldens(golden, scene, cfg_kw, seed, flip, mean):
    if scene == "base":
        img = _torch_render(cfg_kw, seed)
    else:
        img = _torch_render(cfg_kw, seed, scene=T.one_weekend_scene(0),
                            camera=T.CameraSettings.default())
    assert img.shape == (cfg_kw["height"], cfg_kw["width"], 3)
    _assert_match(img, np.load(os.path.join(GOLDEN_DIR, golden)), flip, mean)


def test_spp_mean_is_the_mean_of_single_samples():
    """spp=4 from sample_index 2 equals the mean of four 1-spp renders of
    stream indices 2..5."""
    cam = T.derive_camera(T_BASE_CAMERA, 32, 24)
    kw = dict(width=32, height=24, frame_seed=9, max_depth=5, t_min=1e-3)
    img = tmk.render_reference(T.base_scene(), cam, sample_index=2, spp=4, **kw)
    singles = [tmk.render_reference(T.base_scene(), cam, sample_index=s, spp=1, **kw)
               for s in range(2, 6)]
    total = singles[0] + singles[1] + singles[2] + singles[3]
    assert torch.equal(img, total / 4.0)


def test_row_bands_compose_to_the_frame():
    """Rows rendered through y_offset/row_stride equal those rows of the full
    frame: every draw keys on the global pixel id."""
    cam = T.derive_camera(T_BASE_CAMERA, 32, 24)
    kw = dict(width=32, frame_seed=3, max_depth=4, t_min=1e-3, spp=2)
    full = tmk.render_reference(T.base_scene(), cam, height=24, **kw)
    odd = tmk.render_reference(T.base_scene(), cam, height=12, y_offset=1, row_stride=2, **kw)
    assert torch.equal(odd, full[1::2])


# --- no fallback -------------------------------------------------------------


def test_ctypes_signatures_match_the_c_interface():
    """Every extern "C" function of the CUDA sources takes as many
    arguments as build.py declares for it (ctypes would pass a missing
    pointer as garbage, and there is no compiler here to say so)."""
    import re

    from gpu_ray_tracing_tpu_torch.ops.cuda import build

    for target in build.TARGETS.values():
        src = open(target.source).read()
        found = dict(re.findall(r'extern "C" [\w\s\*]+?\b(grt_\w+)\(([^)]*)\)', src))
        assert set(found) == set(target.signatures), target.source
        for name, params in found.items():
            assert len(params.split(",")) == len(target.signatures[name][1]), name


def test_launch_decisions_live_in_the_launch_helper():
    """The SM count and the occupancy calculator are asked in one place,
    ops/cuda/launch.cuh, which every CUDA source includes and every target
    rebuilds on; no source keeps its own instance ladder macro."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import build

    helper = os.path.join(os.path.dirname(build.__file__), "launch.cuh")
    queries = ("cudaOccupancyMaxActiveBlocksPerMultiprocessor", "cudaDevAttrMultiProcessorCount")
    assert all(q in open(helper).read() for q in queries)
    for target in build.TARGETS.values():
        src = open(target.source).read()
        assert '#include "launch.cuh"' in src and helper in target.headers, target.source
        assert not any(q in src for q in queries), target.source
        assert "GRT_WF_LAUNCH" not in src


def test_cuda_backend_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        _torch_render(dict(width=8, height=8, backend="cuda"), 0)
    cam = T.derive_camera(T_BASE_CAMERA, 8, 8)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        tmk.render_cuda(T.base_scene(), cam, width=8, height=8, max_depth=2, t_min=1e-3)
