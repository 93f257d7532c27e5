"""Wavefront path tracing: one kernel launch per bounce over a compacted
ray array (port of gpu_ray_tracing_tpu/ops/pallas/wavefront.py).

The megakernel traces a pixel to termination in one thread, so a warp idles
until its deepest path ends.  This engine keeps every ray's state in device
memory and runs the loop the wavefront way (Laine et al., PAPERS.md):

  per bounce:  [bounce kernel over the ray array, one thread per ray]
               -> finished samples go to the image by pixel id
               -> the live rays are gathered to the front (and grouped by
                  direction octant), the dead ones dropped
               -> the next bounce launches over the live rays only

`render_wavefront` drives the two CUDA kernels of ops/cuda/megakernel.cu
(`wavefront_raygen_kernel`, `wavefront_bounce_kernel`, K2) and takes CUDA
tensors only; `render_wavefront_reference` is the same host loop around
their plain PyTorch versions (`wavefront_raygen_reference`,
`wavefront_bounce_reference`, which wraps ops/integrators.path_bounce on the
kernel's state layout), on the device the scene lies on.  The compaction,
sort keys, cumsums and gathers are torch calls in both, as they are XLA
code around the Pallas kernel.

Design, against the TPU engine:

- **Per-ray state, no tiles.**  One thread per ray slot over (16, N) f32 and
  (2 or 4, N) i32 structure-of-arrays planes, updated in place.  A dead slot
  returns at once; compaction drops dead rays, so no launch copies them.
- **Radiance is carried, not emitted as deltas.**  A path keeps its running
  radiance in its state and writes its sample's total (clamped) into the
  sample's image slot when it ends.  Every sum then has the megakernel's
  order, so with regeneration off the image equals `render_cuda`'s bit for
  bit on every route, NEE with several lights included, and `clamp` has
  its per-sample total.
- **Compaction is per ray.**  The TPU moved 128-ray rows because that is
  all its gathers move; here every slot moves on its own, and a ray's
  stream is unchanged by it, since every draw keys on (pixel id, sample,
  frame seed, salt).  Moving 32-ray warp rows instead was measured on the
  H100 and dropped: a regenerating pool of rows refills only rows that died
  whole and took more than twice the launches and the time, and without
  regeneration the two were within the host's run-to-run spread (PERF.md).
- **Regeneration is deterministic.**  The pool (`regenerate=True`) refills
  dead slots with the next samples' primary rays, so rays of one launch mix
  (sample, bounce), carried per ray.  Each finished (pixel, sample) writes
  its total into its own slot of a (samples, pixels, 3) buffer, a plain
  store, and the samples are folded in sample order afterwards: the image
  is the same in every run and equals the sample-major loop's.  The buffer
  holds at most REGEN_BATCH samples; a larger spp runs one pool per batch.
- **Host synchronisation.**  The loop reads the live count once per bounce
  (`.item()` of a sum), which stalls the host; `LAST_RUN` counts those
  reads beside the launches and compactions.  On an H100 no kernel runs
  for most of a frame's span; the sort keys and `compact_threshold` keep
  the JAX engine's defaults, though fewer and cheaper compactions measured
  faster there (PERF.md).

The TPU-only knobs (tile_rows, interpret, the triangle and node caps, the
sort-cell environment variable) are left behind.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.camera import Camera
from gpu_ray_tracing_tpu_torch.models.scene import Scene, as_scene
from gpu_ray_tracing_tpu_torch.ops import integrators
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.cuda import build
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
from gpu_ray_tracing_tpu_torch.ops.rays import generate_rays_for_ids

#: The launch counts shared with the megakernel.  A bounce launch adds one to
#: "wavefront:<route>[+nee][+<sampler>][+regen][+rays]", a ray-generation
#: launch to "wavefront_raygen".
LAUNCHES = mk.LAUNCHES

# Rows of the (16, N) f32 state planes (megakernel.cu::WfPlane): origin,
# direction, throughput, radiance so far, prev_diffuse, prev_cos, live, rays
# traced so far; and of the i32 planes (WfInt): global pixel id (u32 bits),
# local pixel index (-1: the slot holds no ray), and under regeneration the
# absolute sample index (u32 bits) and the bounce.
OX, OY, OZ, DX, DY, DZ, TR, TG, TB, RR, RG, RB, PD, PC, LIVE, RAYS = range(16)
F_PLANES = 16
PID, PIX, SMP, BNC = range(4)

#: Per-axis cell count of the spatial sort's origin grid (sort='spatial').
SORT_CELLS = 4
#: Samples one regenerating pool folds through its (samples, pixels, 3)
#: buffer; a larger spp runs one pool per batch of this many.
REGEN_BATCH = 64
SORTS = ("octant", "octant-flat", "spatial", "live")

#: What the last render did: bounce and ray-generation launches,
#: compactions, host synchronisations (reads of the live count), the sum of
#: live rays over the bounce launches, and the live rays entering each
#: iteration (per bounce, summed over samples, without regeneration).
LAST_RUN: dict = {}


def _global_pids(local: torch.Tensor, *, p: int, width: int, height: int, y_offset: int,
                 total_width: int, row_stride: int = 1) -> torch.Tensor:
    """Global pixel ids for local flat indices of a (padded) row band: local
    row r is global row `y_offset + r * row_stride`.  Pad slots (local >= p)
    get ids just past the band's own range, unique within it; they are born
    dead."""
    return torch.where(
        local < p,
        (local // width * row_stride + y_offset) * total_width + local % width,
        (y_offset + height * row_stride) * total_width + (local - p),
    )


def _partition_live(live: torch.Tensor) -> torch.Tensor:
    """Gather permutation placing live entries first, order-stable (two
    cumsums, no sort)."""
    lv = live > 0.5
    n_live = lv.sum()
    pos_live = torch.cumsum(lv.to(torch.int64), 0) - 1
    pos_dead = n_live + torch.cumsum((~lv).to(torch.int64), 0) - 1
    dest = torch.where(lv, pos_live, pos_dead)
    perm = torch.empty_like(dest)
    perm[dest] = torch.arange(live.shape[0], dtype=torch.int64, device=live.device)
    return perm


def _sort_rows_octant(live_rows: torch.Tensor, dx, dy, dz, bounce_rows=None, origins=None,
                      cells: int = SORT_CELLS) -> torch.Tensor:
    """Gather permutation: live rows first, grouped by the octant of each
    row's mean bounce direction (dead rows last), so that rays of one warp
    walk similar subtrees.  The planes are (rows, G): a row is G rays that
    move together (the engine passes G = 1: every ray on its own).  `bounce_rows`
    (regeneration pools) groups rows by a capped bounce bucket before the
    octant, so fresh coherent rays stay apart from deep diffuse ones;
    `origins` (sort='spatial', the (ox, oy, oz) planes) bins rows by the
    cell of their mean origin on a `cells`^3 grid over the live rows' origin
    bounding box: bounce bucket, then cell, then octant."""
    key = ((dx.mean(dim=1) > 0).to(torch.int64) * 4
           + (dy.mean(dim=1) > 0).to(torch.int64) * 2
           + (dz.mean(dim=1) > 0).to(torch.int64))
    n_keys = 8
    if origins is not None:
        live_m = live_rows > 0.5
        big = torch.tensor(3.4e38, dtype=torch.float32, device=key.device)
        cell = torch.zeros_like(key)
        for plane in origins:
            m = plane.mean(dim=1)
            lo = torch.where(live_m, m, big).min()
            hi = torch.where(live_m, m, -big).max()
            step = torch.clamp(hi - lo, min=1e-6) / cells
            c = torch.clamp(((m - lo) / step).to(torch.int32), 0, cells - 1)
            cell = cell * cells + c
        key = key + n_keys * cell
        n_keys *= cells ** 3
    if bounce_rows is not None:
        key = key + n_keys * torch.clamp(bounce_rows.to(torch.int64), 0, 3)
        n_keys *= 4
    key = torch.where(live_rows > 0.5, key, n_keys)
    return torch.argsort(key, stable=True)


@dataclasses.dataclass
class Engine:
    """A scene, a camera and the options of one wavefront render, packed
    once: what every launch of the two kernels (or a call of their plain
    versions) takes besides the ray state.  `plain=True` runs the plain
    versions even on CUDA tensors (chip_smoke.py holds the kernels against
    them); on CPU tensors the wrappers take them anyway."""

    scene: Scene
    camera: Camera
    frame_seed: int
    max_depth: int
    t_min: float
    t_max: float = 3.4e35
    russian_roulette_depth: int = 0
    sky_intensity: float = 1.0
    nee: bool = False
    mis: bool = False
    sampler_spec: tuple | None = None
    clamp: float = 0.0
    total_width: int = 0
    count_rays: bool = False
    plain: bool = False

    def __post_init__(self):
        self.scene = as_scene(self.scene)
        self.frame_seed = int(self.frame_seed) & 0xFFFFFFFF
        if self.mis and not self.nee:
            raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
        if self.scene.mesh is not None and self.scene.bvh is None:
            raise ValueError("wavefront mesh rendering requires a BVH (make_scene)")
        if self.total_width <= 0:
            raise ValueError(f"total_width={self.total_width}: the frame's width in pixels")
        self.device = self.scene.device
        self.camera = self.camera.to(self.device)
        # The plain versions' context: the kernel's > 4-light pick.
        self.ctx = integrators.PathContext(
            self.scene, self.max_depth, self.t_min, self.t_max,
            russian_roulette_depth=self.russian_roulette_depth,
            sky_intensity=self.sky_intensity, nee=self.nee, mis=self.mis,
            frame_seed_u32=self.frame_seed, sampler_spec=self.sampler_spec,
            light_pick="sample", count_rays=self.count_rays)
        self._packed = None
        self._cam_vec = None

    def on_card(self, state_f: torch.Tensor) -> bool:
        """Whether a call on this state launches the kernel."""
        return state_f.is_cuda and not self.plain

    def packed(self) -> mk.PackedScene:
        if self._packed is None:
            self._packed = mk.pack_scene(self.scene, self.nee, self.mis, self.sampler_spec)
            self._cam_vec = mk.camera_vector(self.camera).contiguous()
        return self._packed

    def route(self, regen: bool) -> str:
        return ("wavefront:" + self.packed().route + ("+regen" if regen else "")
                + ("+rays" if self.count_rays else ""))


def new_state(n: int, regen: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (16, n) f32 and (2 or 4, n) i32 state planes; pix is -1 (no
    slot holds a ray)."""
    state_f = torch.zeros((F_PLANES, n), dtype=torch.float32, device=device)
    state_i = torch.zeros((4 if regen else 2, n), dtype=torch.int32, device=device)
    state_i[PIX] = -1
    return state_f, state_i


def _check_state(state_f, state_i, n: int, regen: bool) -> None:
    if (state_f.dtype != torch.float32 or state_f.dim() != 2 or state_f.shape[0] != F_PLANES
            or not state_f.is_contiguous()):
        raise ValueError(f"state_f must be a contiguous ({F_PLANES}, N) f32 tensor")
    if (state_i.dtype != torch.int32 or state_i.dim() != 2
            or state_i.shape != ((4 if regen else 2), state_f.shape[1])
            or not state_i.is_contiguous() or state_i.device != state_f.device):
        raise ValueError("state_i must be a contiguous (4 if regen else 2, N) i32 tensor "
                         "beside state_f")
    if not 0 <= n <= state_f.shape[1]:
        raise ValueError(f"n={n} slots outside the state's {state_f.shape[1]}")


def wavefront_raygen_reference(eng: Engine, state_f, state_i, n: int, *, regen: bool,
                               sample: int = 0, take: torch.Tensor | None = None) -> None:
    """Plain version of wavefront_raygen: primary rays from ops/rays.py into
    slots [0, n) (those `take` flags), in place."""
    _check_state(state_f, state_i, n, regen)
    idx = torch.arange(n, device=state_f.device) if take is None else torch.nonzero(
        take[:n]).squeeze(1)
    if idx.numel() == 0:
        return
    pix = state_i[PIX, idx]
    real = pix >= 0
    s = rng_ops.as_u32(state_i[SMP, idx]) if regen else int(sample) & 0xFFFFFFFF
    o, d, _ = generate_rays_for_ids(eng.camera, rng_ops.as_u32(state_i[PID, idx]), s,
                                    eng.frame_seed, total_width=eng.total_width,
                                    sampler_spec=eng.sampler_spec)
    zero = torch.zeros((), dtype=torch.float32, device=state_f.device)
    state_f[OX:DX, idx] = torch.where(real, o.T, zero)
    state_f[DX:TR, idx] = torch.where(real, d.T, zero)
    state_f[TR:RR, idx] = 1.0
    state_f[RR:LIVE, idx] = 0.0
    state_f[LIVE, idx] = real.to(torch.float32)
    state_f[RAYS, idx] = 0.0
    if regen:
        state_i[BNC, idx] = 0


def wavefront_raygen(eng: Engine, state_f, state_i, n: int, *, regen: bool, sample: int = 0,
                     take: torch.Tensor | None = None) -> None:
    """Primary rays into slots [0, n) of the ray state (those `take`, an i32
    flag per slot, marks; all when None), in place: sample `sample` of each
    slot's pixel, or under `regen` the slot's own sample; throughput 1, no
    radiance, bounce 0, live unless the slot's pix is negative.  On CUDA
    tensors it launches `wavefront_raygen_kernel` (the megakernel's own ray
    generation); on CPU tensors it is the plain version."""
    if not eng.on_card(state_f):
        return wavefront_raygen_reference(eng, state_f, state_i, n, regen=regen,
                                          sample=sample, take=take)
    _check_state(state_f, state_i, n, regen)
    if take is not None and (take.dtype != torch.int32 or take.numel() < n
                             or not take.is_contiguous()):
        raise ValueError("take must be a contiguous i32 flag per slot")
    eng.packed()
    kind, kx, ky, nbits = mk._sampler_args(eng.sampler_spec)
    lib = build.load()
    dev = state_f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wavefront_raygen(
            eng._cam_vec.data_ptr(), kind, kx, ky, nbits, eng.frame_seed,
            int(eng.total_width), state_f.data_ptr(), state_i.data_ptr(),
            state_f.shape[1], n, int(regen), int(sample) & 0xFFFFFFFF,
            None if take is None else take.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_raygen")
    if n > 0:
        LAUNCHES["wavefront_raygen"] += 1


def wavefront_bounce_reference(eng: Engine, state_f, state_i, n: int, *, regen: bool,
                               sample: int = 0, bounce: int = 0, sample_base: int = 0,
                               n_pixels: int = 0, out: torch.Tensor,
                               rays_out: torch.Tensor | None = None) -> None:
    """Plain version of wavefront_bounce: ops/integrators.path_bounce on the
    live rays of slots [0, n), in place, finished samples written to `out`."""
    _check_state(state_f, state_i, n, regen)
    idx = torch.nonzero(state_f[LIVE, :n] > 0.5).squeeze(1)
    if idx.numel() == 0:
        return
    pid = rng_ops.as_u32(state_i[PID, idx])
    if regen:
        s, i = rng_ops.as_u32(state_i[SMP, idx]), state_i[BNC, idx].to(torch.int64)
    else:
        s, i = int(sample) & 0xFFFFFFFF, int(bounce)
    st = integrators.PathState(
        o=state_f[OX:DX, idx].T, d=state_f[DX:TR, idx].T, throughput=state_f[TR:RR, idx].T,
        result=state_f[RR:PD, idx].T, live=torch.ones_like(idx, dtype=torch.bool),
        prev_diffuse=state_f[PD, idx] > 0.5, prev_cos=state_f[PC, idx],
        rays=state_f[RAYS, idx] if eng.count_rays else None,
        pixel_seeds=rng_ops.hash_pixel_seeds(pid, s, eng.frame_seed), pixel_ids=pid)
    st = integrators.path_bounce(eng.ctx, st, i, s)
    if regen:
        state_i[BNC, idx] = (i + 1).to(torch.int32)
    done = ~st.live | ((i + 1) >= eng.max_depth)
    rgb = integrators.clamp_radiance(st.result, eng.clamp) if eng.clamp > 0.0 else st.result
    slot = state_i[PIX, idx].to(torch.int64)
    if regen:
        slot = slot + ((s - (int(sample_base) & 0xFFFFFFFF)) & 0xFFFFFFFF) * int(n_pixels)
    out.reshape(-1, 3)[slot[done]] = rgb[done]
    if rays_out is not None:
        rays_out.reshape(-1)[slot[done]] = st.rays[done]
    state_f[OX:DX, idx] = st.o.T
    state_f[DX:TR, idx] = st.d.T
    state_f[TR:RR, idx] = st.throughput.T
    state_f[RR:PD, idx] = st.result.T
    state_f[PD, idx] = st.prev_diffuse.to(torch.float32)
    state_f[PC, idx] = st.prev_cos
    state_f[LIVE, idx] = (st.live & ~done).to(torch.float32)
    if eng.count_rays:
        state_f[RAYS, idx] = st.rays


def wavefront_bounce(eng: Engine, state_f, state_i, n: int, *, regen: bool, sample: int = 0,
                     bounce: int = 0, sample_base: int = 0, n_pixels: int = 0,
                     out: torch.Tensor, rays_out: torch.Tensor | None = None) -> None:
    """One path bounce of every live ray of slots [0, n), in place
    (`_wf_kernel`'s contract): the next ray, throughput, radiance so far,
    prev_diffuse, prev_cos and live flag, and the rays traced so far when
    the engine counts them.  Without `regen` every ray is at (`sample`,
    `bounce`); with it each reads its own from state_i.  A ray whose path
    ends, or whose bounce was the last of max_depth, writes its sample's
    total radiance (clamped) to `out[slot]` and its ray count to
    `rays_out[slot]`, slot = pix, plus (sample - sample_base) * n_pixels
    under `regen`, and goes dead.  On CUDA tensors it launches
    `wavefront_bounce_kernel`; on CPU tensors it is the plain version."""
    if eng.count_rays != (rays_out is not None):
        raise ValueError("rays_out goes with an Engine built with count_rays=True")
    if not eng.on_card(state_f):
        return wavefront_bounce_reference(
            eng, state_f, state_i, n, regen=regen, sample=sample, bounce=bounce,
            sample_base=sample_base, n_pixels=n_pixels, out=out, rays_out=rays_out)
    _check_state(state_f, state_i, n, regen)
    for t in (out, rays_out):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != state_f.device):
            raise ValueError("out and rays_out must be contiguous f32 tensors beside the state")
    packed = eng.packed()
    lib = build.load()
    dev = state_f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wavefront_bounce(
            *packed.args, eng.frame_seed, eng.max_depth, float(eng.t_min), float(eng.t_max),
            int(eng.russian_roulette_depth), float(eng.sky_intensity), float(eng.clamp),
            state_f.data_ptr(), state_i.data_ptr(), state_f.shape[1], n, int(regen),
            int(sample) & 0xFFFFFFFF, int(bounce), int(sample_base) & 0xFFFFFFFF,
            int(n_pixels), out.data_ptr(), None if rays_out is None else rays_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_bounce")
    if n > 0:
        LAUNCHES[eng.route(regen)] += 1


def _permutation(state_f, state_i, n: int, live, sort: str, regen: bool) -> torch.Tensor:
    """The slot order a compaction gathers by: live rays first, by `sort`."""
    if sort == "live":
        return _partition_live(live.to(torch.float32))
    plane = lambda r: state_f[r, :n, None]
    bounce = state_i[BNC, :n] if regen and sort != "octant-flat" else None
    origins = (plane(OX), plane(OY), plane(OZ)) if sort == "spatial" else None
    return _sort_rows_octant(live.to(torch.float32), plane(DX), plane(DY), plane(DZ),
                             bounce_rows=bounce, origins=origins)


def _live_count(state_f, n: int, stats: dict):
    """(live mask, live rays) of slots [0, n): one read of the device by the
    host."""
    live = state_f[LIVE, :n] > 0.5
    stats["host_syncs"] += 1
    return live, int(live.sum().item())


def _new_stats() -> dict:
    return dict(bounce_launches=0, raygen_launches=0, compactions=0, host_syncs=0,
                live_ray_bounces=0, live_per_iteration=[])


def _run_samples(eng: Engine, *, width, height, spp, sample_index, y_offset, row_stride,
                 sort, compact_threshold, stats):
    """The sample-major loop (wavefront.py:505-608): each sample traced to
    termination, bounce by bounce, over a ray array that shrinks to its live
    rays whenever their share of it falls below `compact_threshold`."""
    dev = eng.device
    p = width * height
    local = torch.arange(p, dtype=torch.int64, device=dev)
    pid0 = _global_pids(local, p=p, width=width, height=height, y_offset=y_offset,
                        total_width=eng.total_width, row_stride=row_stride)
    ids0 = torch.stack([pid0, local]).to(torch.int32)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    rays_acc = torch.zeros(p, dtype=torch.float32, device=dev) if eng.count_rays else None
    per_bounce = [0] * eng.max_depth
    for k in range(spp):
        s = (int(sample_index) + k) & 0xFFFFFFFF
        state_f = torch.empty((F_PLANES, p), dtype=torch.float32, device=dev)
        state_i = ids0.clone()
        out = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        rays = torch.zeros(p, dtype=torch.float32, device=dev) if eng.count_rays else None
        if eng.max_depth > 0:
            wavefront_raygen(eng, state_f, state_i, p, regen=False, sample=s)
            stats["raygen_launches"] += 1
        n = n_live = p
        for b in range(eng.max_depth):
            wavefront_bounce(eng, state_f, state_i, n, regen=False, sample=s, bounce=b,
                             out=out, rays_out=rays)
            stats["bounce_launches"] += 1
            stats["live_ray_bounces"] += n_live
            per_bounce[b] += n_live
            if b + 1 >= eng.max_depth:
                break  # every remaining ray has written its sample
            live, n_live = _live_count(state_f, n, stats)
            if n_live == 0:
                break
            if n_live < compact_threshold * n:
                # Keep the live rays only, in sort order: the next launch
                # covers them and nothing else.
                slots = _permutation(state_f, state_i, n, live, sort, False)[:n_live]
                state_f = state_f.index_select(1, slots)
                state_i = state_i.index_select(1, slots)
                n = n_live
                stats["compactions"] += 1
        # Samples fold in sample order, as the megakernel's spp loop adds them.
        acc += out
        if rays is not None:
            rays_acc += rays
    stats["live_per_iteration"] = per_bounce
    return acc, rays_acc


def _run_regen(eng: Engine, *, width, height, spp, sample_index, y_offset, row_stride, sort,
               compact_threshold, refill_threshold, stats, acc):
    """The regenerating pool (wavefront.py:611-794) over samples
    sample_index .. sample_index + spp - 1, added into `acc` in sample
    order.  The sample stream is the spp * p primary rays, sample-major; the
    pool holds p slots, and one iteration is one bounce of every pooled ray.
    When at least `refill_threshold` of the slots have died (or the stream
    is about to drain), dead slots take the next rays of the stream in
    stream order."""
    dev = eng.device
    p = width * height
    total = spp * p
    s0 = int(sample_index) & 0xFFFFFFFF
    state_f, state_i = new_state(p, True, dev)
    buf = torch.zeros((total, 3), dtype=torch.float32, device=dev)

    def fill(src, take):
        """Point the slots `take` marks at their stream positions `src` and
        generate their primary rays."""
        local = src % p
        pid = _global_pids(local, p=p, width=width, height=height, y_offset=y_offset,
                           total_width=eng.total_width, row_stride=row_stride)
        fresh = torch.stack([pid, local, s0 + src // p])
        state_i[:BNC] = torch.where(take, fresh.to(torch.int32), state_i[:BNC])
        wavefront_raygen(eng, state_f, state_i, p, regen=True,
                         take=take.to(torch.int32).contiguous())
        stats["raygen_launches"] += 1

    # The stream position each slot traces, -1 where it holds no ray.
    src = torch.arange(p, dtype=torch.int64, device=dev)
    fill(src, src >= 0)
    nxt = n_live = p
    while nxt < total or n_live > 0:
        wavefront_bounce(eng, state_f, state_i, p, regen=True, sample_base=s0, n_pixels=p,
                         out=buf)
        stats["bounce_launches"] += 1
        stats["live_ray_bounces"] += n_live
        stats["live_per_iteration"].append(n_live)
        live, n_live = _live_count(state_f, p, stats)
        if n_live < compact_threshold * p:
            perm = _permutation(state_f, state_i, p, live, sort, True)
            state_f = state_f.index_select(1, perm)
            state_i = state_i.index_select(1, perm)
            src, live = src[perm], live[perm]
            stats["compactions"] += 1
        dead = ~live
        src = torch.where(live, src, -1)
        avail = total - nxt
        k = min(p - n_live, avail)
        # Refill when enough slots died to amortize the ray-generation pass,
        # or unconditionally near the stream's end (so that it drains).
        if k > 0 and ((p - n_live) >= refill_threshold * p or avail <= p):
            rank = torch.cumsum(dead.to(torch.int64), 0) - 1
            take = dead & (rank < avail)
            src = torch.where(take, nxt + rank, src)
            fill(src, take)
            n_live += k
            nxt += k
    # Fold the finished samples in sample order: the megakernel's order.
    for k in range(spp):
        acc += buf[k * p:(k + 1) * p]


def _render(scene_or_spheres, camera, *, plain: bool, width, height, sample_index=0,
            frame_seed=0, max_depth, t_min, t_max=3.4e35, russian_roulette_depth=0,
            sky_intensity=1.0, nee=False, spp=1, sort="octant", compact_threshold=0.9,
            y_offset=0, total_width=None, row_stride=1, regenerate=False,
            refill_threshold=0.25, sampler_spec=None, mis=False, clamp=0.0,
            return_ray_count=False):
    if sort not in SORTS:
        raise ValueError(
            f"sort={sort!r}; expected 'octant', 'octant-flat', 'spatial' "
            "or 'live'"
        )
    if regenerate and not 0.0 <= refill_threshold <= 1.0:
        # > 1.0 would never refill while stream blocks remain: the pool
        # loop could spin forever with zero live rays.
        raise ValueError(
            f"refill_threshold={refill_threshold} must be within [0, 1]"
        )
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if mis and not nee:
        raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
    if clamp > 0.0 and regenerate:
        raise ValueError("clamp > 0 is unsupported with ray regeneration")
    if return_ray_count and regenerate:
        raise ValueError(
            "return_ray_count is unsupported with ray regeneration; use "
            "the megakernel counter (count_traced_rays) — the count is "
            "engine-invariant"
        )
    if width <= 0 or height <= 0:
        raise ValueError(f"invalid resolution {width}x{height}")
    if sampler_spec is not None and sampler_spec[0] not in mk.SAMPLERS:
        raise ValueError(f"unknown sampler spec {sampler_spec!r}")
    sc = as_scene(scene_or_spheres)
    if not plain:
        dev = mk._require_cuda(*mk.dataclass_tensors(sc), *mk.dataclass_tensors(camera))
    else:
        dev = sc.device
    eng = Engine(sc, camera, frame_seed, max_depth, t_min, t_max, russian_roulette_depth,
                 sky_intensity, nee, mis, sampler_spec, clamp,
                 width if total_width is None else total_width, return_ray_count, plain)
    stats = _new_stats()
    common = dict(width=width, height=height, y_offset=int(y_offset),
                  row_stride=int(row_stride), sort=sort, compact_threshold=compact_threshold,
                  stats=stats)
    p = width * height
    rays = None
    if regenerate:
        acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        # max_depth <= 0 renders black on every engine; the pool would
        # otherwise trace one bounce first.
        for first in range(0, spp if max_depth > 0 else 0, REGEN_BATCH):
            _run_regen(eng, spp=min(REGEN_BATCH, spp - first),
                       sample_index=int(sample_index) + first,
                       refill_threshold=refill_threshold, acc=acc, **common)
    else:
        acc, rays = _run_samples(eng, spp=spp, sample_index=sample_index, **common)
    LAST_RUN.clear()
    LAST_RUN.update(stats, regenerate=bool(regenerate), sort=sort)
    # The megakernel's mean is an IEEE division; torch divides a CUDA tensor
    # by a Python number as a multiplication by its reciprocal, which rounds
    # differently unless spp is a power of two.
    img = (acc / torch.full((), float(spp), device=dev)).reshape(height, width, 3)
    if return_ray_count:
        return img, rays.reshape(height, width)
    return img


def render_wavefront(scene_or_spheres, camera: Camera, *, width: int, height: int, **kw):
    """Path-trace spp samples with per-bounce ray compaction on the card;
    returns the (height, width, 3) f32 mean on the scene's CUDA device, and
    with `return_ray_count=True` the (height, width) rays-traced plane too.
    It takes CUDA tensors only and never falls back: no device, a failed
    build or a failed launch raises.

    With `regenerate=False` the image equals render_cuda's bit for bit
    (same counter-based stream, same arithmetic in the same order), and the
    ray counts equal its plane.  `y_offset`, `row_stride` and `total_width`
    address a row band of a larger frame: pixel ids, and so the stream, are
    global.  `sort` ('octant', 'octant-flat', 'spatial', 'live') and
    `compact_threshold` (compact when the live share of the ray array falls
    below it) only schedule.  `regenerate=True` keeps one persistent ray pool across the
    samples and refills dead slots with the next samples' primary rays once
    `refill_threshold` of the pool has died; it composes with neither
    `clamp` nor `return_ray_count`, as in the JAX package.  Keywords:
    sample_index, frame_seed, max_depth, t_min, t_max,
    russian_roulette_depth, sky_intensity, nee, mis, spp, sampler_spec,
    clamp, return_ray_count, and the scheduling ones above."""
    return _render(scene_or_spheres, camera, plain=False, width=width, height=height, **kw)


def render_wavefront_reference(scene_or_spheres, camera: Camera, *, width: int, height: int,
                               **kw):
    """The plain PyTorch version of render_wavefront: the same host loop
    around wavefront_raygen_reference and wavefront_bounce_reference, on the
    device the scene lies on.  Its image equals
    render_reference(light_pick='sample') bit for bit."""
    return _render(scene_or_spheres, camera, plain=True, width=width, height=height, **kw)
