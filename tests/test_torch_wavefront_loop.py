"""The wavefront engine's device-count loop on the CPU, through the plain
versions of its kernels (render_wavefront_reference).

The card runs the same schedule (tests/test_torch_cuda.py, chip_smoke.py):
the host enqueues max_depth (bounce, partition, step) triples a sample
batch, or iterations of a regenerating pool, and reads the device only for
the pool's done flag and the frame's counters.  Here the loop is held to
the host loop it replaced, replayed in this file: that loop read the live
count after every bounce, compacted by `_permutation` when the live share
fell below compact_threshold, and refilled a pool's dead slots by a cumsum
of their ranks.  `LAST_RUN`'s counts (bounce and ray-generation launches,
compactions, live ray-bounces, live rays per iteration) equal the replay's
for every scheduling option; batching samples leaves images and ray counts
bit for bit; the refill rule holds at its thresholds.
"""

import math

import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

COUNTS = ("bounce_launches", "raygen_launches", "compactions", "live_ray_bounces",
          "live_per_iteration")
T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)


def _bvh_frame():
    """test_torch_wavefront.py::test_scheduling_options_are_invisible's frame."""
    w, h = 64, 36
    scene = T.make_scene(T.one_weekend_scene(0), sphere_bvh=True)
    cam = T.derive_camera(T.CameraSettings.default(), w, h)
    return scene, cam, dict(width=w, height=h, max_depth=8, t_min=1e-3, spp=2,
                            russian_roulette_depth=4, frame_seed=3)


def _engine(scene, cam, kw):
    return wf.Engine(scene, cam, kw["frame_seed"], kw["max_depth"], kw["t_min"],
                     russian_roulette_depth=kw.get("russian_roulette_depth", 0),
                     total_width=kw["width"], plain=True)


def _ids(src, p, w, h, s0):
    return wf._stream_ids(src, p=p, width=w, height=h, y_offset=0, row_stride=1,
                          total_width=w, s0=s0)


def _replay_samples(scene, cam, kw, *, sort="octant", compact_threshold=0.9,
                    batch=1):
    """The host loop without regeneration: per batch of samples, a bounce,
    then a read of the live count, a compaction when live < threshold * n,
    and a stop when no ray lives."""
    eng = _engine(scene, cam, kw)
    w, h, spp, depth = kw["width"], kw["height"], kw["spp"], kw["max_depth"]
    p = w * h
    c = dict(bounce_launches=0, raygen_launches=0, compactions=0, live_ray_bounces=0,
             live_per_iteration=[0] * depth)
    for first in range(0, spp, batch):
        k = min(batch, spp - first)
        s0 = kw.get("sample_index", 0) + first
        n = n_live = k * p
        state_f, state_i = wf.new_state(n, False, "cpu", per_ray_sample=True)
        src = torch.arange(n)
        state_i[:wf.SMP + 1] = _ids(src, p, w, h, s0)
        wf._primary_rays_reference(eng, state_f, state_i, src, regen=False,
                                   per_ray_sample=True, sample=0)
        c["raygen_launches"] += 1
        out = torch.zeros((n, 3))
        for b in range(depth):
            wf.wavefront_bounce_reference(eng, state_f, state_i, n, regen=False, bounce=b,
                                          sample_base=s0, n_pixels=p, out=out,
                                          per_ray_sample=True)
            c["bounce_launches"] += 1
            c["live_ray_bounces"] += n_live
            c["live_per_iteration"][b] += n_live
            if b + 1 >= depth:
                break
            live = state_f[wf.LIVE, :n] > 0.5
            n_live = int(live.sum())
            if n_live == 0:
                break
            if n_live < compact_threshold * n:
                slots = wf._permutation(state_f, state_i, n, live, sort, False)[:n_live]
                state_f = state_f[:, slots].contiguous()
                state_i = state_i[:, slots].contiguous()
                n = n_live
                c["compactions"] += 1
    return c


def _replay_regen(scene, cam, kw, *, sort="octant", compact_threshold=0.9,
                  refill_threshold=0.25, pool_samples=None):
    """The host loop of a regenerating pool: a bounce, a read of the live
    count, a compaction of the whole pool when live < threshold * p, then
    the dead slots (ranked by a cumsum) take the next stream positions when
    refill_threshold of the pool died or the stream is about to drain."""
    eng = _engine(scene, cam, kw)
    w, h, spp = kw["width"], kw["height"], kw["spp"]
    p = w * h
    c = dict(bounce_launches=0, raygen_launches=0, compactions=0, live_ray_bounces=0,
             live_per_iteration=[])
    pool_samples = pool_samples or wf.REGEN_BATCH
    for first in range(0, spp, pool_samples):
        s0 = kw.get("sample_index", 0) + first
        total = min(pool_samples, spp - first) * p
        state_f, state_i = wf.new_state(p, True, "cpu")
        buf = torch.zeros((total, 3))

        def fill(src, take):
            fresh = _ids(src.clamp(min=0), p, w, h, s0)
            state_i[:wf.BNC] = torch.where(take, fresh, state_i[:wf.BNC])
            wf._primary_rays_reference(eng, state_f, state_i, torch.nonzero(take).squeeze(1),
                                       regen=True, per_ray_sample=True, sample=0)
            c["raygen_launches"] += 1

        src = torch.arange(p)
        fill(src, src >= 0)
        nxt = n_live = p
        while nxt < total or n_live > 0:
            wf.wavefront_bounce_reference(eng, state_f, state_i, p, regen=True,
                                          sample_base=s0, n_pixels=p, out=buf)
            c["bounce_launches"] += 1
            c["live_ray_bounces"] += n_live
            c["live_per_iteration"].append(n_live)
            live = state_f[wf.LIVE, :p] > 0.5
            n_live = int(live.sum())
            if n_live < compact_threshold * p:
                perm = wf._permutation(state_f, state_i, p, live, sort, True)
                state_f[:] = state_f[:, perm]
                state_i[:] = state_i[:, perm]
                src, live = src[perm], live[perm]
                c["compactions"] += 1
            dead = ~live
            src = torch.where(live, src, -1)
            avail = total - nxt
            k = min(p - n_live, avail)
            if k > 0 and ((p - n_live) >= refill_threshold * p or avail <= p):
                rank = torch.cumsum(dead.to(torch.int64), 0) - 1
                take = dead & (rank < avail)
                src = torch.where(take, nxt + rank, src)
                fill(src, take)
                n_live += k
                nxt += k
    return c


SCHEDULES = [
    {}, dict(compact_threshold=1.1), dict(compact_threshold=0.0), dict(sort="octant"),
    dict(sort="live"),
    dict(sort="spatial"), dict(sort="octant-flat"), dict(sort="live", compact_threshold=1.1),
    dict(sort="spatial", compact_threshold=1.1),
]


@pytest.mark.parametrize("extra", SCHEDULES,
                         ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "defaults")
def test_last_run_equals_the_host_loop(extra, monkeypatch):
    """Every scheduling option of test_scheduling_options_are_invisible, at
    64 x 36: the device-count loop counts what the host loop counted, one
    sample a batch and both samples in one array; regeneration on, the
    pool's counts too.  The host reads the device once a frame without
    regeneration, and at most once every POLL_EVERY iterations plus once
    with it."""
    scene, cam, kw = _bvh_frame()
    for batch in (1, 2):
        monkeypatch.setattr(wf, "PLAIN_SAMPLE_SLOTS", batch * kw["width"] * kw["height"])
        T.render_wavefront_reference(scene, cam, **kw, **extra)
        got = {k: wf.LAST_RUN[k] for k in COUNTS}
        assert got == _replay_samples(scene, cam, kw, batch=batch, **extra), batch
        assert wf.LAST_RUN["host_syncs"] == 1 and wf.LAST_RUN["sample_batch"] == batch
    T.render_wavefront_reference(scene, cam, regenerate=True, **kw, **extra)
    got = {k: wf.LAST_RUN[k] for k in COUNTS}
    assert got == _replay_regen(scene, cam, kw, **extra)
    iterations = wf.LAST_RUN["bounce_launches"]
    assert wf.LAST_RUN["host_syncs"] <= math.ceil(iterations / wf.POLL_EVERY) + 1
    assert wf.LAST_RUN["enqueued"]["bounce"] >= iterations


ROUTES = {
    "base": (T.base_scene, T_CAMERA, 50, 31,
             dict(spp=5, max_depth=6, frame_seed=2, sample_index=5)),
    "nee_mis": (lambda: T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.6, 0.6, 0.6), 0.0),
        ((0.0, 2.0, 0.0), 0.4, T.EMISSIVE, (1.0, 0.9, 0.8), 5.0),
        ((0.7, 0.5, -0.5), 0.5, T.METAL, (0.8, 0.8, 0.9), 0.1)])),
        T.CameraSettings.make([0.0, 2.0, 6.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0], 50.0, 0.0, 6.0),
        48, 32, dict(spp=3, max_depth=5, frame_seed=5, nee=True, mis=True, sky_intensity=0.0,
                     russian_roulette_depth=2)),
    "sobol_band": (T.base_scene, T_CAMERA, 40, 12,
                   dict(spp=4, max_depth=5, frame_seed=9, sampler_spec=("sobol", 3),
                        y_offset=1, row_stride=2, total_width=40)),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_sample_batching_is_bit_equal_to_one_sample_at_a_time(name, monkeypatch):
    """Without regeneration a batch of samples shares one ray array, each
    ray carrying its sample: images and ray counts equal the one-sample
    arrays' bit for bit, whatever the batch (a ragged last batch
    included).  A batch is as many samples as the array's slots hold:
    SAMPLE_SLOTS on the card, PLAIN_SAMPLE_SLOTS in the plain version,
    which traces the 1280 x 720 frame one sample at a time."""
    scene, cam_s, w, h, kw = ROUTES[name]
    scene, cam = scene(), T.derive_camera(cam_s, w, h)
    kw = dict(width=w, height=h, t_min=1e-3, **kw)
    p = w * h
    monkeypatch.setattr(wf, "PLAIN_SAMPLE_SLOTS", p)
    want, want_rays = T.render_wavefront_reference(scene, cam, return_ray_count=True, **kw)
    assert wf.LAST_RUN["sample_batch"] == 1
    assert torch.isfinite(want).all() and want.mean() > 1e-3
    for batch in sorted({2, 3, kw["spp"]}):
        monkeypatch.setattr(wf, "PLAIN_SAMPLE_SLOTS", batch * p + p // 2)
        got, rays = T.render_wavefront_reference(scene, cam, return_ray_count=True, **kw)
        assert torch.equal(got, want) and torch.equal(rays, want_rays), batch
        assert wf.LAST_RUN["sample_batch"] == batch
    monkeypatch.undo()
    assert wf._sample_batch(kw["spp"], p, plain=True) == kw["spp"]
    assert wf._sample_batch(16, 1280 * 720, plain=True) == 1
    assert wf._sample_batch(16, 1280 * 720, plain=False) == 16
    assert wf._sample_batch(64, 1280 * 720, plain=False) == wf.SAMPLE_SLOTS // (1280 * 720)
    assert wf._sample_batch(16, wf.SAMPLE_SLOTS + 1, plain=False) == 1


@pytest.mark.parametrize("refill", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("pool_samples", [2, None], ids=["regen_batch_2", "one_pool"])
def test_refill_rule(refill, pool_samples):
    """The refill decided on the device from its counts: at
    refill_threshold 0 (refill whenever a slot died), 0.25 and 1.0 (only
    when the whole pool died, or the stream is about to drain), and with
    REGEN_BATCH = 2 (spp 5: pools of 2, 2 and 1 samples), the counts equal
    the host loop's and the image the sample-major loop's."""
    scene, cam_s, w, h, kw = ROUTES["base"]
    scene, cam = scene(), T.derive_camera(cam_s, w, h)
    kw = dict(width=w, height=h, t_min=1e-3, **kw)
    want = T.render_wavefront_reference(scene, cam, **kw)
    batch = wf.REGEN_BATCH
    try:
        if pool_samples is not None:
            wf.REGEN_BATCH = pool_samples
        got = T.render_wavefront_reference(scene, cam, regenerate=True,
                                           refill_threshold=refill, **kw)
    finally:
        wf.REGEN_BATCH = batch
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-5)
    counts = {k: wf.LAST_RUN[k] for k in COUNTS}
    assert counts == _replay_regen(scene, cam, kw, refill_threshold=refill,
                                   pool_samples=pool_samples)
