"""The port's multi-GPU rendering (gpu_ray_tracing_tpu_torch/parallel) on CPU
ranks, against the JAX package's parallel/ and the port's unsharded render.

One pool of four spawned ranks (gloo over localhost, one torch thread each)
runs every case of the module, submitted when the pool starts, so that the
ranks render while this process computes the references; each rank makes
the case's calls with the same arguments, as a `torchrun` job would.  The
counterparts of the 24 cases of tests/test_sharding.py hold the port's
sharded result
  - against JAX's render_sharded / progressive_step_sharded on the
    conftest's 8 virtual devices, at test_sharding's assert_images_match
    (1% / 1e-4), on JAX's own mesh shapes;
  - for row shards, against the port's unsharded render() bit for bit;
  - for spp shards, against it at rtol 1e-5 / atol 1e-6 (the same samples,
    summed in another order).
The megakernel's cases (JAX's backend='pallas', interpret mode there) run
the kernel's plain version: render_reference(light_pick='sample') stands in
for render_cuda on the CPU, in the ranks and in this process
(`_kernel_on_the_cpu`).  chip_smoke.py's `sharded` phase runs the kernels.
JAX is imported inside the tests only, so the ranks never load it.
"""

from __future__ import annotations

import datetime
import hashlib
import queue
import socket
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
from gpu_ray_tracing_tpu_torch.parallel import sharding
from gpu_ray_tracing_tpu_torch.parallel.mesh import ROW_AXIS, SPP_AXIS, make_mesh

# The suite runs in several worker processes at once: one torch thread
# each keeps them (and the ranks, which import this module) from
# oversubscribing the CPU.
torch.set_num_threads(1)

WORLD = 4
T_CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                                 60.0, 0.0, 2.0)
MIS_SPHERES = [
    ((0, -1000.0, 0), 1000.0, "LAMBERTIAN", (0.7, 0.7, 0.7), 0.0),
    ((-0.6, 0.35, -2.2), 0.35, "LAMBERTIAN", (0.8, 0.3, 0.3), 0.0),
    ((0.0, 1.6, -2.0), 1.2, "EMISSIVE", (1.0, 0.9, 0.7), 2.0),
]
ADAPTIVE = dict(width=64, height=128, max_depth=4, backend="cuda")


def assert_images_match(a, b, flip_frac=0.01, mean_tol=1e-4):
    """tests/test_sharding.py's contract: the same RNG stream, identical
    but for a small fraction of rounding-flipped decisions."""
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b).max(axis=-1)
    assert d.size > 0
    frac = float((d > 1e-3).sum()) / d.size
    assert frac <= flip_frac, f"{frac:.4%} of pixels differ materially"
    assert float(np.abs(a - b).mean()) < mean_tol


def _cfg(**kw) -> dict:
    return {**dict(width=64, height=48, spp=1, max_depth=6, backend="torch"), **kw}


def _scene(name: str, T_or_J=T):
    if name == "base":
        return T_or_J.base_scene()
    if name == "one_weekend":
        if T_or_J is T:
            return T.one_weekend_scene(0)
        import jax
        return T_or_J.one_weekend_scene(jax.random.key(0))
    kinds = {"LAMBERTIAN": T_or_J.LAMBERTIAN, "EMISSIVE": T_or_J.EMISSIVE}
    return T_or_J.make_scene(T_or_J.make_spheres(
        [(c, r, kinds[k], a, p) for c, r, k, a, p in MIS_SPHERES]))


def _render_cuda_plain(scene, camera, **kw):
    """render_cuda's plain version, on the scene's device."""
    return mk.render_reference(scene, camera, light_pick="sample", **kw)


class _kernel_on_the_cpu:
    """backend='cuda' through the kernel's plain version on CPU tensors, for
    the duration of a `with`."""

    def __enter__(self):
        self.saved = api.render_cuda, api._cuda_device
        api.render_cuda = _render_cuda_plain
        api._cuda_device = lambda *a, **k: torch.device("cpu")

    def __exit__(self, *exc):
        api.render_cuda, api._cuda_device = self.saved


# --- what each rank runs --------------------------------------------------

_MESHES: dict = {}


def _mesh(shape):
    """The rank's (rows, spp) mesh of `shape`, made once (a mesh's groups
    are made collectively, by every rank in the same order)."""
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(*shape, device_type="cpu")
    return _MESHES[shape]


def _digest(img: torch.Tensor) -> str:
    return hashlib.sha256(img.contiguous().numpy().tobytes()).hexdigest()


def case_render(mesh_shape, scene, cfg, seed, row_partition="contiguous"):
    """render_sharded on every rank: rank 0's image, and every rank's digest
    of its whole image."""
    with _kernel_on_the_cpu():
        img = sharding.render_sharded(_scene(scene), T_CAMERA, T.RenderConfig(**cfg),
                                      _mesh(mesh_shape), frame_seed=seed,
                                      row_partition=row_partition)
    return dict(img=img.numpy() if dist.get_rank() == 0 else None, digest=_digest(img),
                shape=tuple(img.shape))


def case_progressive(mesh_shape, scene, cfg, seed, steps, row_partition="contiguous",
                     resume=None, reset_at=None):
    """`steps` progressive_step_sharded calls from a zero (or `resume` =
    (value, count)) state cut by shard_accum_state, a reset at step
    `reset_at`: the counts after each step, the rank's band shape, and the
    gathered image (accum_image)."""
    config = T.RenderConfig(**cfg)
    mesh = _mesh(mesh_shape)
    whole = T.init_accum(config.height, config.width)
    if resume is not None:
        whole = T.AccumState(rgb=torch.full_like(whole.rgb, resume[0]),
                             count=torch.tensor(resume[1], dtype=torch.int32))
    state = sharding.shard_accum_state(whole, mesh)
    counts = []
    with _kernel_on_the_cpu():
        for i in range(steps):
            state = sharding.progressive_step_sharded(
                state, _scene(scene), T_CAMERA, config, mesh, frame_seed=seed,
                reset=i == reset_at, row_partition=row_partition)
            counts.append(int(state.count))
    img = sharding.accum_image(state, mesh, row_partition)
    return dict(img=img.numpy() if dist.get_rank() == 0 else None, digest=_digest(img),
                counts=counts, band=tuple(state.rgb.shape),
                finite=bool(torch.isfinite(state.rgb).all()))


def case_refusals():
    """The refusals of render_sharded and progressive_step_sharded (none
    reaches a collective, so every rank raises alike), by message."""
    out = {}

    def refused(name, fn):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)

    base = T.base_scene()
    rows = _mesh((4, 1))
    refused("threefry", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg(rng="threefry")), rows))
    refused("height", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg(height=50)), rows))
    refused("interleaved_wgsl", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg(rng="wgsl")), rows, row_partition="interleaved"))
    refused("partition", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg()), rows, row_partition="diagonal"))
    refused("spp", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg(spp=3)), _mesh((2, 2))))
    ad = T.RenderConfig(**ADAPTIVE, spp=8, adaptive_tol=0.05, adaptive_min_spp=2)
    refused("adaptive_spp_axis", lambda: sharding.render_sharded(base, T_CAMERA, ad,
                                                                 _mesh((2, 2))))
    st = sharding.shard_accum_state(T.init_accum(ad.height, ad.width), rows)
    refused("adaptive_progressive", lambda: sharding.progressive_step_sharded(
        st, base, T_CAMERA, ad, rows))
    refused("band", lambda: sharding.progressive_step_sharded(
        T.init_accum(48, 64), base, T_CAMERA, T.RenderConfig(**_cfg()), rows))
    if "x_only" not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        _MESHES["x_only"] = init_device_mesh("cpu", (WORLD,), mesh_dim_names=(ROW_AXIS,))
    refused("missing_axis", lambda: sharding.render_sharded(
        base, T_CAMERA, T.RenderConfig(**_cfg()), _MESHES["x_only"]))
    return out


def case_spans(mesh_shape, cfg, seed):
    """render_sharded under torch.profiler on every rank: the program's
    spans, (name, start, end) in start order."""
    from torch.profiler import ProfilerActivity, profile

    mesh = _mesh(mesh_shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sharding.render_sharded(_scene("base"), T_CAMERA, T.RenderConfig(**cfg), mesh,
                                frame_seed=seed)
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("grt.")), key=lambda s: s[1])


def case_mesh():
    """make_mesh on the world of 4: each rank's coordinates on a 2x2 and a
    4x1 mesh, the default shape, and the refusals by message."""
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    m = _mesh((2, 2))
    out["2x2"] = (m.get_local_rank(ROW_AXIS), m.get_local_rank(SPP_AXIS),
                  tuple(m.shape), tuple(m.mesh_dim_names), m.device_type)
    out["default"] = tuple(make_mesh(device_type="cpu").shape)
    for name, args in (("spp0", (4, 0)), ("zero_rows", (None, 8)), ("larger", (4, 2)),
                       ("smaller", (2, 1))):
        try:
            make_mesh(*args, device_type="cpu")
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_main(rank: int, port: int, tasks, results) -> None:
    """A rank: run each (case id, case, kwargs) task, put (rank, id,
    output, traceback or None) on `results`, until a None task."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        for task in iter(tasks.get, None):
            cid, case, kw = task
            try:
                results.put((rank, cid, globals()[case](**kw), None))
            except Exception:  # reported to the test, which fails on it
                results.put((rank, cid, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """WORLD spawned ranks, each running every submitted case in order."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.tasks = [ctx.Queue() for _ in range(WORLD)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, args=(r, port, self.tasks[r],
                                                           self.results), daemon=True)
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self.done: dict = {}

    def submit(self, cid: str, case: str, **kw) -> None:
        for q in self.tasks:
            q.put((cid, case, kw))

    def result(self, cid: str, timeout: float = 600) -> list:
        """Every rank's output of case `cid`, in rank order; a rank's
        traceback fails the test."""
        while len(self.done.get(cid, {})) < WORLD:
            rank, got, out, err = self.results.get(timeout=timeout)
            self.done.setdefault(got, {})[rank] = (out, err)
        errs = [e for _, e in self.done[cid].values() if e]
        assert not errs, errs[0]
        return [self.done[cid][r][0] for r in range(WORLD)]

    def close(self) -> None:
        """Stop the ranks: each leaves after the tasks it has; what they
        still put on `results` is drained so that none blocks on exit."""
        for q in self.tasks:
            q.put(None)
        deadline = time.monotonic() + 120
        while any(p.is_alive() for p in self.procs) and time.monotonic() < deadline:
            try:
                self.results.get(timeout=0.5)
            except queue.Empty:
                pass
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


# Every case: (case id, case, kwargs), submitted when the pool starts.
PROG4 = _cfg(spp=4)
CASES = [
    ("mesh", "case_mesh", {}),
    ("row", "case_render", dict(mesh_shape=(4, 1), scene="base", cfg=_cfg(), seed=5)),
    ("wgsl", "case_render", dict(mesh_shape=(4, 1), scene="base", cfg=_cfg(rng="wgsl"),
                                 seed=9)),
    ("spp", "case_render", dict(mesh_shape=(2, 2), scene="base", cfg=_cfg(spp=4), seed=1)),
    ("one_weekend", "case_render", dict(mesh_shape=(4, 1), scene="one_weekend",
                                        cfg=_cfg(height=40, max_depth=8), seed=3)),
    ("prog_batch", "case_progressive", dict(mesh_shape=(2, 2), scene="base", cfg=PROG4,
                                            seed=11, steps=2)),
    ("prog_freeze", "case_progressive", dict(mesh_shape=(4, 1), scene="base",
                                             cfg=_cfg(spp=2), seed=0, steps=5, reset_at=4)),
    ("prog_straddle", "case_progressive", dict(mesh_shape=(2, 2), scene="base", cfg=PROG4,
                                               seed=5, steps=2, resume=(0.25, 3))),
    ("refusals", "case_refusals", {}),
    ("kernel", "case_render", dict(mesh_shape=(4, 1), scene="base",
                                   cfg=_cfg(backend="cuda"), seed=5)),
    ("prog_kernel", "case_progressive", dict(mesh_shape=(4, 1), scene="base",
                                             cfg=_cfg(spp=4, backend="cuda"), seed=3,
                                             steps=2)),
    ("interleaved", "case_render", dict(mesh_shape=(4, 1), scene="base", cfg=_cfg(), seed=5,
                                        row_partition="interleaved")),
    ("interleaved_cuda", "case_render", dict(mesh_shape=(2, 2), scene="base",
                                             cfg=_cfg(spp=2, backend="cuda"), seed=7,
                                             row_partition="interleaved")),
    ("interleaved_wavefront", "case_render", dict(mesh_shape=(2, 2), scene="base",
                                                  cfg=_cfg(spp=2, backend="wavefront_torch"),
                                                  seed=7, row_partition="interleaved")),
    ("prog_interleaved", "case_progressive", dict(mesh_shape=(4, 1), scene="base",
                                                  cfg=_cfg(spp=2), seed=3, steps=2,
                                                  row_partition="interleaved")),
    ("stratified", "case_render", dict(mesh_shape=(2, 2), scene="base",
                                       cfg=_cfg(spp=4, max_depth=4, sampler="stratified"),
                                       seed=5)),
    ("sobol", "case_render", dict(mesh_shape=(2, 2), scene="base",
                                  cfg=_cfg(spp=4, max_depth=4, sampler="sobol"), seed=5)),
    ("mis", "case_render", dict(mesh_shape=(2, 2), scene="mis",
                                cfg=_cfg(spp=4, max_depth=4, nee=True, mis=True,
                                         sky_intensity=0.0), seed=5)),
    ("adaptive_prefix", "case_render", dict(mesh_shape=(4, 1), scene="base",
                                            cfg=dict(ADAPTIVE, spp=16, adaptive_tol=1e6,
                                                     adaptive_min_spp=4), seed=2)),
    ("adaptive", "case_render", dict(mesh_shape=(4, 1), scene="base",
                                     cfg=dict(ADAPTIVE, spp=8, adaptive_tol=0.05,
                                              adaptive_min_spp=2), seed=3)),
    ("spans", "case_spans", dict(mesh_shape=(2, 2), cfg=_cfg(spp=2, backend="wavefront_torch"),
                                 seed=4)),
    ("adaptive_interleaved", "case_render", dict(mesh_shape=(4, 1), scene="base",
                                                 cfg=dict(ADAPTIVE, spp=8, adaptive_tol=0.05,
                                                          adaptive_min_spp=2), seed=3,
                                                 row_partition="interleaved")),
]


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    for cid, case, kw in CASES:
        pool.submit(cid, case, **kw)
    yield pool
    pool.close()


@pytest.fixture
def kernel_on_the_cpu():
    with _kernel_on_the_cpu():
        yield


def _unsharded(scene, cfg, seed, **kw) -> np.ndarray:
    return T.render(_scene(scene), T_CAMERA, T.RenderConfig(**cfg), frame_seed=seed,
                    **kw).numpy()


def _image(outs: list) -> np.ndarray:
    """Rank 0's image, after checking that every rank holds the same whole
    image."""
    assert len({o["digest"] for o in outs}) == 1, "the ranks' images differ"
    return outs[0]["img"]


_J_BACKEND = {"torch": "jax", "cuda": "pallas", "wavefront_torch": "wavefront"}


def _jax_config(cfg: dict):
    import gpu_ray_tracing_tpu as J
    return J.RenderConfig(**{**cfg, "backend": _J_BACKEND[cfg["backend"]]})


def _jax_camera():
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    return J.CameraSettings(
        look_from=jnp.asarray([0.0, 0.0, 1.0]), look_at=jnp.asarray([0.0, 0.0, -1.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]), field_of_view=jnp.float32(60.0),
        defocus_angle=jnp.float32(0.0), focus_distance=jnp.float32(2.0))


def _jax_sharded(shape, scene, cfg, seed, row_partition="contiguous") -> np.ndarray:
    """JAX's render_sharded on the conftest's virtual devices, on a mesh of
    `shape` (tests/test_sharding.py's)."""
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu.parallel import mesh as jm
    from gpu_ray_tracing_tpu.parallel import sharding as js
    return np.asarray(js.render_sharded(_scene(scene, J), _jax_camera(), _jax_config(cfg),
                                        jm.make_mesh(*shape), frame_seed=jnp.uint32(seed),
                                        row_partition=row_partition))


def _jax_progressive(shape, cfg, seed, steps, row_partition="contiguous", resume=None):
    """JAX's progressive_step_sharded from a zero (or resumed) state: (the
    image in image order, the count)."""
    import gpu_ray_tracing_tpu as J
    import jax.numpy as jnp
    from gpu_ray_tracing_tpu.ops.accumulate import AccumState
    from gpu_ray_tracing_tpu.parallel import mesh as jm
    from gpu_ray_tracing_tpu.parallel import sharding as js
    jcfg, mesh = _jax_config(cfg), jm.make_mesh(*shape)
    state = J.init_accum(jcfg.height, jcfg.width)
    if resume is not None:
        state = AccumState(rgb=jnp.full_like(state.rgb, resume[0]), count=jnp.int32(resume[1]))
    state = js.shard_accum_state(state, mesh)
    for _ in range(steps):
        state = js.progressive_step_sharded(state, J.base_scene(), _jax_camera(), jcfg, mesh,
                                            frame_seed=jnp.uint32(seed),
                                            row_partition=row_partition)
    return np.asarray(js.accum_image(state, mesh, row_partition)), int(state.count)


def _unsharded_progressive(cfg, seed, steps) -> np.ndarray:
    config = T.RenderConfig(**cfg)
    state = T.init_accum(config.height, config.width)
    for _ in range(steps):
        state = T.progressive_step(state, T.base_scene(), T_CAMERA, config, frame_seed=seed)
    return state.rgb.numpy()


# --- make_mesh --------------------------------------------------------------


def test_four_ranks_sit_at_row_major_mesh_coordinates(ranks):
    """The counterpart of test_eight_devices_available: four ranks, rank r
    at (r // spp, r % spp) of a 2x2 mesh named ('x', 's'), JAX's row-major
    reshape; the default mesh puts every rank on the row axis."""
    outs = ranks.result("mesh")
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"]) == (r, WORLD)
        assert o["2x2"] == (r // 2, r % 2, (2, 2), ("x", "s"), "cpu")
        assert o["default"] == (WORLD, 1)


def test_make_mesh_refusals(ranks):
    o = ranks.result("mesh")[0]
    assert "num_spp_shards must be >= 1" in o["spp0"]
    assert "0 row shards" in o["zero_rows"]
    assert "needs 8 ranks, have 4" in o["larger"]
    assert "world size of 4" in o["smaller"]


def test_make_mesh_on_cuda_without_a_card_raises(monkeypatch):
    """The default device type is the card's; without one it raises
    before any process group is touched, and nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        make_mesh(1, 1)
    assert not dist.is_initialized()


def test_deinterleave_rows_inverts_the_interleaved_order():
    img = torch.arange(12 * 2 * 3, dtype=torch.float32).reshape(12, 2, 3)
    # Shard xi holds rows xi, xi + 3, ...: partition order is the
    # shard-major stack of those rows.
    part = torch.cat([img[xi::3] for xi in range(3)])
    assert torch.equal(sharding.deinterleave_rows(part, 3), img)


# --- the 24 counterparts of tests/test_sharding.py ---------------------------


def test_row_sharded_render_matches_unsharded(ranks):
    img = _image(ranks.result("row"))
    np.testing.assert_array_equal(img, _unsharded("base", _cfg(), 5))
    assert_images_match(img, _jax_sharded((8, 1), "base", _cfg(), 5))


def test_row_sharded_render_wgsl_stream(ranks):
    cfg = _cfg(rng="wgsl")
    img = _image(ranks.result("wgsl"))
    np.testing.assert_array_equal(img, _unsharded("base", cfg, 9))
    assert_images_match(img, _jax_sharded((8, 1), "base", cfg, 9))


def test_spp_sharded_render_matches_unsharded(ranks):
    cfg = _cfg(spp=4)
    img = _image(ranks.result("spp"))
    np.testing.assert_allclose(img, _unsharded("base", cfg, 1), rtol=1e-5, atol=1e-6)
    assert_images_match(img, _jax_sharded((4, 2), "base", cfg, 1))


def test_sharded_output_is_row_sharded(ranks):
    """Each rank's progressive state holds its (local_h, W, 3) band only;
    render_sharded and accum_image give every rank the whole image."""
    outs = ranks.result("prog_freeze")
    assert [o["band"] for o in outs] == [(12, 64, 3)] * WORLD
    assert len({o["digest"] for o in outs}) == 1
    assert all(o["shape"] == (48, 64, 3) for o in ranks.result("row"))


def test_sharded_one_weekend_scene(ranks):
    cfg = _cfg(height=40, max_depth=8)
    img = _image(ranks.result("one_weekend"))
    np.testing.assert_array_equal(img, _unsharded("one_weekend", cfg, 3))
    assert_images_match(img, _jax_sharded((8, 1), "one_weekend", cfg, 3))


def test_progressive_sharded_matches_batch(ranks):
    """2 steps of 2 spp shards = 4 samples = the full batch render."""
    outs = ranks.result("prog_batch")
    assert outs[0]["counts"] == [2, 4]
    img = _image(outs)
    np.testing.assert_allclose(img, _unsharded("base", PROG4, 11), rtol=1e-5, atol=1e-6)
    jimg, jcount = _jax_progressive((4, 2), PROG4, 11, 2)
    assert jcount == 4
    assert_images_match(img, jimg)


def test_progressive_sharded_freeze_and_reset(ranks):
    o = ranks.result("prog_freeze")[0]
    assert o["counts"] == [1, 2, 2, 2, 1]  # frozen at the target, then reset
    np.testing.assert_array_equal(_image(ranks.result("prog_freeze")),
                                  _unsharded_progressive(_cfg(spp=2), 0, 1))


def test_progressive_sharded_resumed_straddle_freezes_at_target(ranks):
    """A state resumed at a count misaligned to the 2-sample batch folds
    only the taken fraction and freezes at config.spp."""
    outs = ranks.result("prog_straddle")
    assert outs[0]["counts"] == [4, 4]
    assert all(o["finite"] for o in outs)
    jimg, jcount = _jax_progressive((4, 2), PROG4, 5, 2, resume=(0.25, 3))
    assert jcount == 4
    assert_images_match(_image(outs), jimg)


def test_threefry_rejected_for_sharding(ranks):
    assert "position-equivariant" in ranks.result("refusals")[0]["threefry"]


def test_indivisible_height_rejected(ranks):
    out = ranks.result("refusals")
    assert all("height 50 not divisible by mesh rows 4" in o["height"] for o in out)
    assert "spp 3 not divisible" in out[0]["spp"]
    assert "expected 'contiguous' or 'interleaved'" in out[0]["partition"]
    assert "missing axis(es) ['s']" in out[0]["missing_axis"]
    assert "a rank's band is (12, 64, 3)" in out[0]["band"]


def test_sharded_pallas_backend(ranks, kernel_on_the_cpu):
    cfg = _cfg(backend="cuda")
    img = _image(ranks.result("kernel"))
    np.testing.assert_array_equal(img, _unsharded("base", cfg, 5))
    assert_images_match(img, _jax_sharded((4, 1), "base", cfg, 5))


def test_progressive_sharded_pallas(ranks, kernel_on_the_cpu):
    cfg = _cfg(spp=4, backend="cuda")
    outs = ranks.result("prog_kernel")
    assert outs[0]["counts"] == [1, 2] and all(o["finite"] for o in outs)
    np.testing.assert_array_equal(_image(outs), _unsharded_progressive(cfg, 3, 2))
    jimg, jcount = _jax_progressive((4, 1), cfg, 3, 2)
    assert jcount == 2
    assert_images_match(_image(outs), jimg)


def test_interleaved_row_partition_matches_unsharded(ranks):
    """Interleaved rows, de-interleaved: the unsharded image and the
    contiguous partition's, bit for bit."""
    img = _image(ranks.result("interleaved"))
    np.testing.assert_array_equal(img, _unsharded("base", _cfg(), 5))
    np.testing.assert_array_equal(img, _image(ranks.result("row")))
    assert_images_match(img, _jax_sharded((8, 1), "base", _cfg(), 5, "interleaved"))


@pytest.mark.parametrize("backend", ["cuda", "wavefront_torch"])
def test_interleaved_kernel_backends(ranks, kernel_on_the_cpu, backend):
    """Interleaved rows on a 2x2 mesh through both engines' plain versions
    (strided global pixel ids)."""
    cfg = _cfg(spp=2, backend=backend)
    img = _image(ranks.result("interleaved_" + backend.split("_")[0]))
    np.testing.assert_allclose(img, _unsharded("base", cfg, 7), rtol=1e-5, atol=1e-6)
    assert_images_match(img, _jax_sharded((4, 2), "base", cfg, 7, "interleaved"))


def test_interleaved_progressive_accum_image(ranks):
    """The state stays in partition order; accum_image restores image
    order, bit-equal to the unsharded progressive steps."""
    cfg = _cfg(spp=2)
    outs = ranks.result("prog_interleaved")
    assert outs[0]["counts"] == [1, 2]
    img = _image(outs)
    np.testing.assert_array_equal(img, _unsharded_progressive(cfg, 3, 2))
    jimg, _ = _jax_progressive((8, 1), cfg, 3, 2, "interleaved")
    assert_images_match(img, jimg)


def test_interleaved_rejects_wgsl(ranks):
    assert "interleaved" in ranks.result("refusals")[0]["interleaved_wgsl"]


@pytest.mark.parametrize("sampler", ["stratified", "sobol"])
def test_sharded_sampler_matches_unsharded(ranks, sampler):
    """The counterparts of test_sharded_stratified_sampler_matches_unsharded
    and test_sharded_sobol_sampler_matches_unsharded: sample points keyed on
    (global pixel id, absolute sample index)."""
    cfg = _cfg(spp=4, max_depth=4, sampler=sampler)
    img = _image(ranks.result(sampler))
    np.testing.assert_allclose(img, _unsharded("base", cfg, 5), rtol=1e-5, atol=1e-6)
    assert_images_match(img, _jax_sharded((4, 2), "base", cfg, 5))


def test_sharded_mis_matches_unsharded(ranks):
    cfg = _cfg(spp=4, max_depth=4, nee=True, mis=True, sky_intensity=0.0)
    img = _image(ranks.result("mis"))
    np.testing.assert_allclose(img, _unsharded("mis", cfg, 5), rtol=1e-5, atol=1e-6)
    assert_images_match(img, _jax_sharded((4, 2), "mis", cfg, 5))


def test_adaptive_row_sharded_prefix_property(ranks, kernel_on_the_cpu):
    """A huge tolerance stops every tile of every band at min_spp: the
    image is the fixed 4-spp render, and not the 16-spp one."""
    img = _image(ranks.result("adaptive_prefix"))
    cfg = dict(ADAPTIVE, spp=16, adaptive_tol=1e6, adaptive_min_spp=4)
    np.testing.assert_array_equal(img, _unsharded("base", cfg, 2))
    np.testing.assert_array_equal(img, _unsharded("base", dict(ADAPTIVE, spp=4), 2))
    assert not np.array_equal(img, _unsharded("base", dict(ADAPTIVE, spp=16), 2))
    assert_images_match(img, _jax_sharded((4, 1), "base", cfg, 2))


def test_adaptive_row_sharded_matches_unsharded(ranks, kernel_on_the_cpu):
    """32-row bands hold exactly the unsharded frame's 32-row tiles: the
    per-tile exits and the image match the unsharded adaptive render."""
    cfg = dict(ADAPTIVE, spp=8, adaptive_tol=0.05, adaptive_min_spp=2)
    img = _image(ranks.result("adaptive"))
    np.testing.assert_array_equal(img, _unsharded("base", cfg, 3))
    assert_images_match(img, _jax_sharded((4, 1), "base", cfg, 3))


def test_adaptive_sharded_interleaved_is_valid(ranks):
    """Interleaved bands take tile statistics over strided rows: the
    allocation may differ, the estimate agrees to Monte Carlo noise."""
    a = _image(ranks.result("adaptive_interleaved"))
    b = _image(ranks.result("adaptive"))
    assert a.shape == b.shape and np.isfinite(a).all()
    assert abs(float(a.mean()) - float(b.mean())) < 0.02


def test_adaptive_sharded_rejections(ranks):
    out = ranks.result("refusals")[0]
    assert "ROWS only" in out["adaptive_spp_axis"]
    assert "does not compose" in out["adaptive_progressive"]


def test_sharded_render_records_its_band_and_its_gather(ranks):
    """On every rank: grt.sharded.band encloses the camera's derivation and
    the band's render, then grt.sharded.gather (the spp all_reduce and the
    rows' all_gather) follows it."""
    for spans in ranks.result("spans"):
        names = [s[0] for s in spans]
        assert names[0] == "grt.sharded.band" and names.count("grt.sharded.gather") == 1
        band = spans[0]
        gather = spans[names.index("grt.sharded.gather")]
        inside = [s for s in spans if band[1] <= s[1] and s[2] <= band[2]][1:]
        assert [s[0] for s in inside][:2] == ["grt.camera", "grt.wavefront"]
        assert band[2] <= gather[1] and len(inside) == len(spans) - 2
