"""Progressive accumulation, animation, the camera motion ops and checkpoints
in the port against the JAX package, on the CPU.

fold_sample and the motion ops are held bit-exact to JAX's functions on
numpy inputs from a seed; progressive_step and render_progressive
(backend='torch') to JAX's 'jax' backend at JAX's own progressive bound
(atol 1e-5, tests/test_api.py:93); render_animation to JAX's at the flip
contract.  A checkpoint round-trips, and one the JAX package wrote loads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.models import camera as jcam
from gpu_ray_tracing_tpu.ops import accumulate as jacc
from gpu_ray_tracing_tpu.utils import checkpoint as jckpt

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

J_CAMERA = J.CameraSettings(
    look_from=jnp.asarray([0.0, 0.0, 1.0]), look_at=jnp.asarray([0.0, 0.0, -1.0]),
    vup=jnp.asarray([0.0, 1.0, 0.0]), field_of_view=jnp.float32(60.0),
    defocus_angle=jnp.float32(0.0), focus_distance=jnp.float32(2.0))
T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)
KW = dict(width=64, height=48, spp=4, max_depth=8)


# --- fold_sample ---------------------------------------------------------------


@pytest.mark.parametrize("count,num_samples,target,reset", [
    (0, 1, 16, False),   # the reference's single-sample divide
    (5, 1, 16, False),
    (4, 4, 16, False),   # a batch
    (14, 4, 16, False),  # a batch straddling the target folds 2 of 4
    (9, 4, 16, True),    # reset clears first
    (16, 1, 16, False),  # frozen at the target
    (16, 4, 16, False),
])
def test_fold_sample_bit_exact(count, num_samples, target, reset):
    rng = np.random.default_rng(count * 7 + num_samples)
    rgb = rng.random((6, 5, 3), dtype=np.float32)
    sample = rng.random((6, 5, 3), dtype=np.float32) * 3.0
    want = jacc.fold_sample(jacc.AccumState(rgb=jnp.asarray(rgb), count=jnp.int32(count)),
                            jnp.asarray(sample), target, reset, num_samples=num_samples)
    got = T.fold_sample(T.AccumState(rgb=torch.from_numpy(rgb),
                                     count=torch.tensor(count, dtype=torch.int32)),
                        torch.from_numpy(sample), target, reset, num_samples=num_samples)
    assert np.array_equal(np.asarray(want.rgb), got.rgb.numpy())
    assert int(want.count) == int(got.count) and got.count.dtype == torch.int32
    assert got.count.device.type == "cpu"


def test_from_reference_converts_accumulation_states():
    rng = np.random.default_rng(2)
    planes = [rng.random((4, 6), dtype=np.float32) for _ in range(3)]
    jst = jacc.AdaptiveAccumState(rgb_sum=jnp.asarray(rng.random((4, 6, 3), dtype=np.float32)),
                                  count=jnp.asarray(planes[0]), mlum=jnp.asarray(planes[1]),
                                  m2=jnp.asarray(planes[2]))
    tst = T.from_reference(jst)
    assert isinstance(tst, T.AdaptiveAccumState)
    for f in ("rgb_sum", "count", "mlum", "m2"):
        assert np.array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f))), f
    np.testing.assert_array_equal(tst.image.numpy(), np.asarray(jst.image))
    acc = T.from_reference(jacc.AccumState(rgb=jnp.asarray(planes[0])[..., None],
                                           count=jnp.int32(7)))
    assert int(acc.count) == 7 and acc.count.device.type == "cpu"


# --- progressive_step / render_progressive --------------------------------------


def _jax_progressive(steps, seed, **kw):
    cfg = J.RenderConfig(**{**KW, **kw})
    st = J.init_accum(cfg.height, cfg.width)
    for _ in range(steps):
        st = J.progressive_step(st, J.base_scene(), J_CAMERA, cfg, frame_seed=jnp.uint32(seed))
    return st


def test_progressive_steps_match_jax():
    """Four 1-spp steps through backend='torch' against JAX's 'jax' steps,
    and against the port's own render(spp=4) (the progressive stream is the
    batch stream), at JAX's bound, atol 1e-5."""
    cfg = T.RenderConfig(backend="torch", **KW)
    st = T.init_accum(cfg.height, cfg.width)
    for _ in range(4):
        st = T.progressive_step(st, T.base_scene(), T_CAMERA, cfg, frame_seed=77)
    assert int(st.count) == 4
    want = _jax_progressive(4, 77)
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
    batch = T.render(T.base_scene(), T_CAMERA, cfg, frame_seed=77)
    np.testing.assert_allclose(st.rgb.numpy(), batch.numpy(), atol=1e-5)
    # Frozen at the target: a fifth step changes nothing.
    st5 = T.progressive_step(st, T.base_scene(), T_CAMERA, cfg, frame_seed=77)
    assert int(st5.count) == 4 and torch.equal(st5.rgb, st.rgb)
    # Reset restarts the count at 1.
    st_r = T.progressive_step(st, T.base_scene(), T_CAMERA, cfg, frame_seed=77, reset=True)
    assert int(st_r.count) == 1


def test_render_progressive_and_batched_steps_match_jax():
    cfg = T.RenderConfig(backend="torch", **KW)
    st = T.render_progressive(T.base_scene(), T_CAMERA, cfg, frame_seed=5)
    want = _jax_progressive(4, 5)
    assert int(st.count) == 4
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
    # Two steps of 2 draw the same absolute samples (JAX's batched bound).
    two = T.init_accum(cfg.height, cfg.width)
    for _ in range(2):
        two = T.progressive_step(two, T.base_scene(), T_CAMERA, cfg, frame_seed=5,
                                 spp_per_step=2)
    assert int(two.count) == 4
    np.testing.assert_allclose(two.rgb.numpy(), st.rgb.numpy(), atol=2e-5, rtol=1e-5)


def test_progressive_resumes_a_state_converted_from_jax():
    """A render started in JAX (2 of 4 steps), converted by from_reference
    and finished in the port, ends where JAX's own 4 steps end."""
    half = _jax_progressive(2, 9)
    st = T.from_reference(half)
    assert isinstance(st, T.AccumState) and int(st.count) == 2
    cfg = T.RenderConfig(backend="torch", **KW)
    for _ in range(2):
        st = T.progressive_step(st, T.base_scene(), T_CAMERA, cfg, frame_seed=9)
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(_jax_progressive(4, 9).rgb),
                               atol=1e-5)


def test_progressive_step_guards():
    st = T.init_accum(48, 64)
    with pytest.raises(ValueError, match="spp_per_step must be >= 1"):
        T.progressive_step(st, T.base_scene(), T_CAMERA, T.RenderConfig(backend="torch"),
                           spp_per_step=0)
    with pytest.raises(ValueError, match="must divide"):
        T.progressive_step(st, T.base_scene(), T_CAMERA,
                           T.RenderConfig(backend="torch", spp=6), spp_per_step=4)
    with pytest.raises(ValueError, match="adaptive_tol > 0 does not compose"):
        T.progressive_step(st, T.base_scene(), T_CAMERA,
                           T.RenderConfig(spp=8, adaptive_tol=0.05))


# --- motion ops and animation ---------------------------------------------------


def _settings_pair(seed):
    rng = np.random.default_rng(seed)
    look_from = rng.normal(size=3).astype(np.float32) * 4.0
    look_at = rng.normal(size=3).astype(np.float32)
    fov = np.float32(rng.uniform(20.0, 90.0))
    js = J.CameraSettings(look_from=jnp.asarray(look_from), look_at=jnp.asarray(look_at),
                          vup=jnp.asarray([0.0, 1.0, 0.0]), field_of_view=jnp.float32(fov),
                          defocus_angle=jnp.float32(0.5), focus_distance=jnp.float32(3.0))
    return js, T.CameraSettings.make(look_from, look_at, [0.0, 1.0, 0.0], fov, 0.5, 3.0)


@pytest.mark.parametrize("op,amount", [
    ("dolly", 0.7), ("strafe", -1.3), ("elevate", 0.25), ("zoom", 15.0), ("zoom", -200.0),
    ("orbit_yaw", 0.3), ("orbit_pitch", 0.2),
])
def test_motion_ops_match_jax(op, amount):
    """Every motion op bit for bit; the orbits rotate by cos/sin, which the
    port takes from glibc's cosf/sinf as XLA:CPU does."""
    for seed in range(8):
        js, ts = _settings_pair(seed)
        want = getattr(jcam, op)(js, jnp.float32(amount))
        got = getattr(T, op)(ts, amount)
        for f in ("look_from", "look_at", "vup", "field_of_view", "defocus_angle",
                  "focus_distance"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert g.dtype == np.float32, f
            assert np.array_equal(g, w), (op, seed, f, g, w)


def test_render_animation_matches_jax():
    """A 3-frame orbit_yaw track through backend='torch' against JAX's
    render_animation, at the flip contract (1% / 2e-4)."""
    kw = dict(width=32, height=24, spp=2, max_depth=4)
    jtrack = J.stack_camera_track([jcam.orbit_yaw(J_CAMERA, jnp.float32(0.2 * f))
                                   for f in range(3)])
    ttrack = T.stack_camera_track([T.orbit_yaw(T_CAMERA, 0.2 * f) for f in range(3)])
    seeds = np.asarray([3, 4, 5], np.uint32)
    want = np.asarray(J.render_animation(J.base_scene(), jtrack, J.RenderConfig(**kw),
                                         frame_seeds=jnp.asarray(seeds)))
    got = T.render_animation(T.base_scene(), ttrack, T.RenderConfig(backend="torch", **kw),
                             frame_seeds=seeds)
    assert got.shape == (3, 24, 32, 3)
    for f in range(3):
        m = T.images_match(got[f], want[f], 0.01, 2e-4)
        assert m.ok, (f, m)
    with pytest.raises(ValueError, match="frame_seeds has 2 entries for 3"):
        T.render_animation(T.base_scene(), ttrack, T.RenderConfig(backend="torch", **kw),
                           frame_seeds=seeds[:2])


# --- checkpoints ----------------------------------------------------------------


def test_checkpoint_round_trip_and_fingerprint(tmp_path):
    cfg = T.RenderConfig(backend="torch", **KW)
    st = T.AccumState(rgb=torch.rand(48, 64, 3), count=torch.tensor(3, dtype=torch.int32))
    fp = T.render_fingerprint(T.base_scene(), cfg, frame_seed=7)
    assert fp == T.render_fingerprint(T.base_scene(), cfg, frame_seed=7)
    assert fp != T.render_fingerprint(T.base_scene(), cfg, frame_seed=8)
    # The budget and the backend are not part of the stream.
    assert fp == T.render_fingerprint(T.base_scene(), T.RenderConfig(**{**KW, "spp": 64}),
                                      frame_seed=7)
    path = str(tmp_path / "ckpt")
    T.save_accum(path, st, fingerprint=fp)
    assert T.checkpoint_path(path).endswith(".npz")
    back = T.load_accum(path, expect_fingerprint=fp)
    assert torch.equal(back.rgb, st.rgb) and int(back.count) == 3
    with pytest.raises(ValueError, match="different render"):
        T.load_accum(path, expect_fingerprint="0" * 64)
    # The port's checkpoint loads in the JAX package.
    jst = jckpt.load_accum(path)
    assert np.array_equal(np.asarray(jst.rgb), st.rgb.numpy()) and int(jst.count) == 3


def test_checkpoint_written_by_jax_loads(tmp_path):
    rgb = np.random.default_rng(1).random((48, 64, 3), dtype=np.float32)
    path = str(tmp_path / "jax_ckpt.npz")
    jckpt.save_accum(path, jacc.AccumState(rgb=jnp.asarray(rgb), count=jnp.int32(5)),
                     fingerprint="f" * 64)
    back = T.load_accum(path)
    assert np.array_equal(back.rgb.numpy(), rgb) and int(back.count) == 5
    # Stamped by JAX: the port's own fingerprint differs and is refused.
    with pytest.raises(ValueError, match="different render"):
        T.load_accum(path, expect_fingerprint="0" * 64)
    np.savez(str(tmp_path / "bad.npz"), rgb=rgb)
    with pytest.raises(ValueError, match="not a save_accum checkpoint"):
        T.load_accum(str(tmp_path / "bad.npz"))


# --- the device default ---------------------------------------------------------


def test_default_backend_is_the_card():
    """RenderConfig() renders on the card; without one every entry point
    given the default config raises, and nothing falls back to the CPU."""
    assert T.RenderConfig().backend == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    cfg = T.RenderConfig(width=8, height=8, spp=2, max_depth=2)
    for call in (
        lambda: T.render(T.base_scene(), T_CAMERA, cfg),
        lambda: T.progressive_step(T.init_accum(8, 8), T.base_scene(), T_CAMERA, cfg),
        lambda: T.render_progressive(T.base_scene(), T_CAMERA, cfg),
        lambda: T.render_animation(T.base_scene(), T.stack_camera_track([T_CAMERA]), cfg),
        lambda: T.count_traced_rays(T.base_scene(), T_CAMERA, cfg),
        lambda: T.adaptive_progressive_step(
            T.init_adaptive_accum(8, 8), T.base_scene(), T_CAMERA,
            T.RenderConfig(width=8, height=8, spp=4, adaptive_tol=0.05)),
    ):
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            call()
