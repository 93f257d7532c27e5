"""The port's AOV-guided a-trous denoiser (ops/denoise.py) and
render_denoised, modelled on tests/test_denoise.py, and against the JAX
package's on the same numpy inputs.

The filter is plain arithmetic in both packages.  On the CPU the port
rounds as jitted XLA:CPU does where it has the piece (glibc powf for the
normal stop, the fused multiply-adds XLA contracts); jnp.exp is XLA's own
polynomial, so the two agree to f32 rounding, not bit for bit.  The JAX
filter with every guide is compiled once; the other guide sets run it op
by op.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.api import render_denoised as jax_render_denoised
from gpu_ray_tracing_tpu.ops import denoise as jd

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _noisy_step_image(seed, h=48, w=64, noise=0.25):
    """A two-region step image plus per-pixel noise, with clean guides."""
    left = np.float32([0.9, 0.2, 0.1])
    right = np.float32([0.1, 0.3, 0.9])
    mask = (np.arange(w) >= w // 2).astype(np.float32)[None, :, None]
    clean = np.broadcast_to(left * (1.0 - mask) + right * mask, (h, w, 3)).astype(np.float32)
    noisy = clean + noise * np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)
    normal = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (h, w, 3))
    depth = (1.0 + 4.0 * mask[..., 0] * np.ones((h, w))).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t(clean), t(noisy), t(clean), t(normal), t(depth)


def test_identity_at_zero_iterations():
    _, noisy, albedo, normal, depth = _noisy_step_image(0)
    out = T.atrous_denoise(noisy, albedo=albedo, normal=normal, depth=depth, iterations=0)
    np.testing.assert_allclose(out.numpy(), noisy.numpy(), atol=1e-6)


def test_constant_image_is_fixed_point():
    """The weights are a partition of unity over valid taps: a constant
    passes every iteration unchanged, with or without guides."""
    img = torch.full((40, 56, 3), 0.37)
    np.testing.assert_allclose(T.atrous_denoise(img, iterations=4).numpy(), 0.37, atol=1e-5)
    out = T.atrous_denoise(img, albedo=torch.full_like(img, 0.5),
                           normal=torch.tensor([0.0, 1.0, 0.0]).expand(img.shape),
                           depth=torch.ones(img.shape[:2]), iterations=4)
    np.testing.assert_allclose(out.numpy(), 0.37, atol=1e-5)


def test_reduces_noise_and_preserves_guide_edges():
    clean, noisy, albedo, normal, depth = _noisy_step_image(3)
    out = T.atrous_denoise(noisy, albedo=albedo, normal=normal, depth=depth, iterations=4)
    mse_before = float(((noisy - clean) ** 2).mean())
    mse_after = float(((out - clean) ** 2).mean())
    assert mse_after < 0.25 * mse_before, (mse_before, mse_after)
    o, c = out.numpy(), clean.numpy()
    w = o.shape[1]
    for side in (slice(None, w // 2), slice(w // 2, None)):
        assert abs(o[:, side].mean() - c[:, side].mean()) < 0.02
    edge_gap = np.abs(o[:, w // 2] - o[:, w // 2 - 1]).mean()
    clean_gap = np.abs(c[:, w // 2] - c[:, w // 2 - 1]).mean()
    assert edge_gap > 0.6 * clean_gap, (edge_gap, clean_gap)


def test_unguided_filter_smooths():
    clean, noisy, *_ = _noisy_step_image(5, noise=0.1)
    out = T.atrous_denoise(noisy, iterations=3, sigma_color=1.0)
    assert float(((out - clean) ** 2).mean()) < float(((noisy - clean) ** 2).mean())


def test_backward_runs():
    clean, noisy, albedo, normal, depth = _noisy_step_image(7)
    img = noisy.clone().requires_grad_(True)
    out = T.atrous_denoise(img, albedo=albedo, normal=normal, depth=depth, iterations=2)
    ((out - clean) ** 2).mean().backward()
    g = img.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_decode_normal_aov_roundtrip():
    n = torch.tensor([[[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]])
    np.testing.assert_allclose(T.decode_normal_aov(0.5 * (n + 1.0)).numpy(), n.numpy(),
                               atol=1e-6)


def test_render_denoised_end_to_end_beats_noisy_render():
    """backend='torch', base_scene, 64x48, 1 spp, depth 6: the beauty pass
    is render()'s frame, and the denoised frame is nearer a 256-spp render
    than the 1-spp one is (tests/test_denoise.py's bound, 0.75)."""
    scene, settings = T.base_scene(), T.CameraSettings.default()
    lo = T.RenderConfig(width=64, height=48, spp=1, max_depth=6, backend="torch")
    ref = T.render(scene, settings, dataclasses.replace(lo, spp=256), frame_seed=9)
    noisy = T.render(scene, settings, lo, frame_seed=9)
    out, beauty, aovs = T.render_denoised(scene, settings, lo, frame_seed=9, return_aovs=True)
    assert out.shape == (48, 64, 3)
    assert torch.equal(beauty, noisy)
    assert set(aovs) == {"albedo", "normal", "depth"}
    mse_noisy = float(((noisy - ref) ** 2).mean())
    mse_out = float(((out - ref) ** 2).mean())
    assert mse_out < 0.75 * mse_noisy, (mse_noisy, mse_out)


def test_render_denoised_rejects_aov_integrators():
    cfg = T.RenderConfig(width=16, height=16, spp=1, integrator="albedo", backend="torch")
    with pytest.raises(ValueError, match="beauty pass"):
        T.render_denoised(T.base_scene(), T.CameraSettings.default(), cfg)


def test_invalid_inputs_rejected():
    img = torch.zeros((8, 8, 3))
    with pytest.raises(ValueError):
        T.atrous_denoise(torch.zeros((8, 8)), iterations=1)
    with pytest.raises(ValueError):
        T.atrous_denoise(img, iterations=-1)
    for kw in (dict(sigma_color=0.0), dict(sigma_depth=0.0), dict(sigma_normal=-1.0)):
        with pytest.raises(ValueError):
            T.atrous_denoise(img, **kw)


# --- against the JAX package -------------------------------------------------

H, W = 36, 48


def _inputs():
    """Random color, albedo, normal and depth planes (a few miss pixels of
    depth 0 and one zero normal), 48x36."""
    rng = np.random.default_rng(0)
    color = (rng.random((H, W, 3)) * 2.0).astype(np.float32)
    albedo = rng.random((H, W, 3)).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal[7, 9] = 0.0
    depth = (1.0 + rng.random((H, W)) * 4.0).astype(np.float32)
    depth[:5, :5] = 0.0
    return dict(color=color, albedo=albedo, normal=normal, depth=depth)


@functools.cache
def _jax_all_guides():
    x = _inputs()
    f = jax.jit(lambda c, a, n, d: jd.atrous_denoise(c, albedo=a, normal=n, depth=d,
                                                     iterations=4))
    return np.asarray(f(x["color"], x["albedo"], x["normal"], x["depth"]))


@pytest.mark.parametrize("guides", [("albedo", "normal", "depth"), (), ("albedo",),
                                    ("normal",), ("depth",)])
def test_atrous_denoise_matches_jax(guides):
    """The filter at 4 iterations, 48x36, with every guide, none and each
    alone, against JAX's atrous_denoise on the same numpy inputs.  With
    every guide against jitted JAX, whose roundings the port follows:
    within rtol 1e-6 (measured 3.6e-7; 1.4% of values differ, from
    jnp.exp).  The other sets against JAX op by op, which rounds each
    product that jitted XLA fuses: within rtol 1e-5 (measured 4.9e-6)."""
    x = _inputs()
    kw = {k: x[k] for k in guides}
    if len(guides) == 3:
        want, rtol = _jax_all_guides(), 1e-6
    else:
        want = np.asarray(jd.atrous_denoise(jnp.asarray(x["color"]), iterations=4,
                                            **{k: jnp.asarray(v) for k, v in kw.items()}))
        rtol = 1e-5
    got = T.atrous_denoise(torch.from_numpy(x["color"]), iterations=4,
                           **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_zero_normal_gradient_mirrors_jax():
    """At a zero normal the filter's gradient with respect to the normal
    is NaN in JAX (jnp.linalg.norm's sqrt at 0) and in the port, which
    takes the norm through sqrt for that reason (torch.linalg.vector_norm
    gives a finite subgradient); elsewhere the gradients agree."""
    rng = np.random.default_rng(4)
    color = rng.random((6, 7, 3)).astype(np.float32)
    normal = rng.normal(size=(6, 7, 3)).astype(np.float32)
    normal[2, 3] = 0.0
    want = np.asarray(jax.jit(jax.grad(lambda n: jnp.sum(jd.atrous_denoise(
        jnp.asarray(color), normal=n, iterations=1))))(jnp.asarray(normal)))
    n = torch.from_numpy(normal).requires_grad_(True)
    T.atrous_denoise(torch.from_numpy(color), normal=n, iterations=1).sum().backward()
    got = n.grad.numpy()
    assert np.isnan(want[2, 3]).all() and np.isnan(got[2, 3]).all()
    ok = ~np.isnan(want)
    assert ok.sum() == want.size - 3 and np.array_equal(ok, ~np.isnan(got))
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-6)


# Each input pass at its golden's flip thresholds (tests/test_goldens.py).
_PASS_LIMITS = {"beauty": (0.005, 1e-4), "albedo": (0.002, 1e-5), "normal": (0.002, 1e-5),
                "depth": (0.002, 1e-5)}


def test_render_denoised_matches_jax():
    """render_denoised(backend='torch') against JAX's
    render_denoised(backend='jax') on the same stream (base_scene,
    CameraSettings.default(), 48x36, 2 spp, depth 4, frame seed 9): each
    input pass at its golden's flip thresholds (measured: no flip; mean
    |diff| 3.8e-8 beauty, 2.4e-10 albedo, 2.9e-7 normal, 1.2e-6 depth), and
    the denoised frame within 2e-6 mean |diff| (measured 1.6e-7, max
    4.5e-5: the filter spreads each pixel's difference over its footprint,
    and a flipped pixel would move its neighbours too)."""
    cfg_kw = dict(width=W, height=H, spp=2, max_depth=4)
    jout, jbeauty, jaovs = jax_render_denoised(
        J.base_scene(), J.CameraSettings.default(), J.RenderConfig(backend="jax", **cfg_kw),
        frame_seed=jnp.uint32(9), return_aovs=True)
    out, beauty, aovs = T.render_denoised(T.base_scene(), T.CameraSettings.default(),
                                          T.RenderConfig(backend="torch", **cfg_kw),
                                          frame_seed=9, return_aovs=True)
    passes = {"beauty": (beauty, jbeauty), **{k: (aovs[k], jaovs[k]) for k in aovs}}
    for k, (got, want) in passes.items():
        m = T.images_match(got, np.asarray(want), *_PASS_LIMITS[k])
        assert m.ok, (k, m)
    diff = np.abs(out.numpy() - np.asarray(jout))
    assert diff.mean() < 2e-6, diff.mean()
