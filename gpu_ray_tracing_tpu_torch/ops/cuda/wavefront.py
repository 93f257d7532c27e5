"""Wavefront path tracing: one kernel launch per bounce over a compacted
ray array (port of gpu_ray_tracing_tpu/ops/pallas/wavefront.py).

The megakernel traces a pixel to termination in one thread, so a warp idles
until its deepest path ends.  This engine keeps every ray's state in device
memory and runs the loop the wavefront way (Laine et al., PAPERS.md):

  per bounce:  [bounce kernel over the ray array, one thread per ray]
               -> finished samples go to the image by pixel id
               -> the live rays are gathered to the front (in their order,
                  or grouped by direction octant), the dead ones dropped
               -> the next bounce launches over the live rays only

`render_wavefront` drives the CUDA kernels of ops/cuda/megakernel.cu
(`wavefront_bounce_kernel`, `wavefront_raygen_kernel`) and
ops/cuda/wavefront.cu (the partition `wf_*_kernel`s and
`wf_advance_kernel`), K2, and takes CUDA tensors only;
`render_wavefront_reference` runs the same schedule around their plain
PyTorch versions (`wavefront_bounce_reference`, which wraps
ops/integrators.path_bounce on the kernel's state layout;
`wavefront_raygen_reference`; `wavefront_partition_reference`, which is
`_permutation`, the torch sort keys and cumsums; `wavefront_advance_reference`)
on the device the scene lies on.

Design, against the TPU engine:

- **Per-ray state, no tiles.**  One thread per ray slot over (16, N) f32 and
  (2-4, N) i32 structure-of-arrays planes, updated in place, in two
  buffers: a compaction gathers the live rays into the other one.
- **Radiance is carried, not emitted as deltas.**  A path keeps its running
  radiance in its state and writes its sample's total (clamped) into the
  sample's image slot when it ends.  Every sum then has the megakernel's
  order, so with regeneration off the image equals `render_cuda`'s bit for
  bit on every route, NEE with several lights included, and `clamp` has
  its per-sample total.
- **Compaction is per ray and stable.**  The TPU moved 128-ray rows because
  that is all its gathers move; here every slot moves on its own, and a
  ray's stream is unchanged by it, since every draw keys on (pixel id,
  sample, frame seed, salt).  The partition is a counting sort over the
  sort's keys (at most 8 * 64 * 4 + 1), written by hand without atomics:
  it gives exactly `_permutation`'s order.
- **Samples are batched.**  Without regeneration a batch of samples (as
  many as SAMPLE_SLOTS slots hold on the card, PLAIN_SAMPLE_SLOTS in the
  plain version) is traced in one array, each ray carrying
  its sample: the late bounces of 16 samples fill the card where one
  sample's few thousand rays did not.  Each sample writes its own slice of
  a (samples, pixels, 3) buffer, folded in sample order.
- **Regeneration is deterministic.**  The pool (`regenerate=True`) refills
  dead slots with the next samples' primary rays, in the dead slots' order,
  so rays of one launch mix (sample, bounce), carried per ray.  Each
  finished (pixel, sample) writes its total into its own slot of a
  (samples, pixels, 3) buffer, a plain store, and the samples are folded in
  sample order afterwards: the image is the same in every run and equals
  the sample-major loop's.  The buffer holds at most REGEN_BATCH samples; a
  larger spp runs one pool per batch.
- **Host synchronisation.**  The loop's counts live in a small i32 tensor
  on the device: the array's slot count, its live rays, its buffer, the
  stream cursor and a "done" flag.  Every kernel of an iteration reads them
  and decides from them alone what to do (compact when live <
  compact_threshold * n; refill when refill_threshold of the pool died or
  the stream is about to drain; nothing once the loop is over); the last
  kernel of the iteration updates them.  So the host enqueues a fixed
  schedule: max_depth (bounce, compaction) pairs a sample batch, or
  iterations of a pool, reading the done flag once every POLL_EVERY
  iterations (one poll behind, so that the card always has queued work),
  and reads the frame's counters once at its end.  `LAST_RUN` keeps what the
  device counted (launches that ran over rays, compactions, live rays) and
  the host's reads and enqueued launches.

The TPU-only knobs (tile_rows, interpret, the triangle and node caps, the
sort-cell environment variable) are left behind.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
#: launch to "wavefront_raygen", a partition to "wavefront_partition", a
#: loop step to "wavefront_advance".
LAUNCHES = mk.LAUNCHES

# Rows of the (16, N) f32 state planes (wavefront.cuh::WfPlane): origin,
# direction, throughput, radiance so far, prev_diffuse, prev_cos, live, rays
# traced so far; and of the i32 planes (WfInt): global pixel id (u32 bits),
# local pixel index (-1: the slot holds no ray), the absolute sample (u32
# bits; batched samples and regeneration) and the bounce (regeneration).
OX, OY, OZ, DX, DY, DZ, TR, TG, TB, RR, RG, RB, PD, PC, LIVE, RAYS = range(16)
F_PLANES = 16
PID, PIX, SMP, BNC = range(4)
# The loop's i32 counts (wavefront.cuh::WfCtr) and the frame's i64 counters
# (WfStat).
CTR_N, CTR_LIVE, CTR_CUR, CTR_NXT, CTR_DONE, CTR_ENTER = range(6)
CTR_WORDS = 8
STAT_BOUNCE, STAT_RAYGEN, STAT_COMPACT, STAT_LIVE_BOUNCES = range(4)
STAT_WORDS = 4

#: Per-axis cell count of the spatial sort's origin grid (sort='spatial').
SORT_CELLS = 4
#: Samples one regenerating pool folds through its (samples, pixels, 3)
#: buffer; a larger spp runs one pool per batch of this many.
REGEN_BATCH = 64
#: Slots of one ray array without regeneration, which bound the samples of
#: a batch: on the card, and in the plain version, whose f64 (rays,
#: primitives) intermediates are larger (16 samples of the 1280 x 720 frame
#: at once would not fit on an 80 GB card; one sample an array does).
SAMPLE_SLOTS = 1 << 24
PLAIN_SAMPLE_SLOTS = 1 << 20
#: Iterations of a regenerating pool between two reads of its done flag.
POLL_EVERY = 8
SORTS = ("octant", "octant-flat", "spatial", "live")
# Slots the partition's keys kernel ranks a block (wavefront.cu::kTile).
_TILE = 2048


def _ordered(x: float) -> int:
    """wavefront.cuh::wf_ordered of an f32, as a signed 32-bit value."""
    u = int(np.array([x], np.float32).view(np.uint32)[0])
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return u - (1 << 32) if u >= 1 << 31 else u


_BOUNDS_RESET = (_ordered(3.4e38), _ordered(-3.4e38))

#: What the last render did: bounce and ray-generation launches that ran
#: over rays, compactions, live ray-bounces, the live rays entering each
#: iteration (per bounce, summed over samples, without regeneration), all
#: counted on the device; host reads of the device (`host_syncs`), and the
#: launches the host enqueued (`enqueued`).
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


def new_state(n: int, regen: bool, device, *, per_ray_sample: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (16, n) f32 and (2, 3 or 4, n) i32 state planes; pix is -1 (no
    slot holds a ray)."""
    state_f = torch.zeros((F_PLANES, n), dtype=torch.float32, device=device)
    state_i = torch.zeros((_int_planes(regen, per_ray_sample), n), dtype=torch.int32,
                          device=device)
    state_i[PIX] = -1
    return state_f, state_i


def _int_planes(regen: bool, per_ray_sample: bool) -> int:
    return 4 if regen else 3 if per_ray_sample else 2


def _check_state(state_f, state_i, n: int, regen: bool, per_ray_sample: bool = False) -> None:
    if (state_f.dtype != torch.float32 or state_f.dim() != 2 or state_f.shape[0] != F_PLANES
            or not state_f.is_contiguous()):
        raise ValueError(f"state_f must be a contiguous ({F_PLANES}, N) f32 tensor")
    rows = _int_planes(regen, per_ray_sample)
    if (state_i.dtype != torch.int32 or state_i.dim() != 2
            or state_i.shape != (rows, state_f.shape[1])
            or not state_i.is_contiguous() or state_i.device != state_f.device):
        raise ValueError(f"state_i must be a contiguous ({rows}, N) i32 tensor beside state_f "
                         "(4 rows under regen, 3 with per-ray samples, else 2)")
    if not 0 <= n <= state_f.shape[1]:
        raise ValueError(f"n={n} slots outside the state's {state_f.shape[1]}")


# --- the loop's ray array, schedule and counts --------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The constants every kernel of an iteration reads beside the counts
    (wavefront.cuh::WfSched): compact when live < compact_threshold * n;
    under `regen` refill from a stream of `total` rays into a pool of
    `pool` slots when refill_threshold of it died or the stream is about to
    drain; `last`: the iteration's bounce is the last (no compaction)."""

    compact_threshold: float
    refill_threshold: float = 0.0
    total: int = 0
    pool: int = 0
    regen: bool = False
    last: bool = False

    def args(self) -> tuple:
        return (float(self.compact_threshold), float(self.refill_threshold), int(self.total),
                int(self.pool), int(self.regen), int(self.last))


@dataclasses.dataclass
class _Plan:
    done: bool
    n: int
    live: int
    cur: int
    nxt: int
    compact: bool = False
    refill: bool = False
    rank: bool = False
    k: int = 0


def _plan(ctr: torch.Tensor, sched: Schedule) -> _Plan:
    """wavefront.cuh::wf_plan on the counts (read by the plain versions)."""
    c = ctr.tolist()
    pl = _Plan(bool(c[CTR_DONE]), c[CTR_N], c[CTR_LIVE], c[CTR_CUR], c[CTR_NXT])
    if pl.done:
        return pl
    if sched.regen:
        pl.compact = pl.live < sched.compact_threshold * pl.n
        avail, dead = sched.total - pl.nxt, sched.pool - pl.live
        pl.k = min(dead, avail)
        pl.refill = pl.k > 0 and (dead >= sched.refill_threshold * sched.pool
                                  or avail <= sched.pool)
        pl.rank = pl.refill and not pl.compact
    else:
        pl.compact = (not sched.last and pl.live > 0
                      and pl.live < sched.compact_threshold * pl.n)
    return pl


def _sort_code(sort: str, regen: bool) -> tuple[int, bool, int]:
    """(wavefront.cuh::WfSort code, bounce bucket, keys of live rays) of a
    sort: the keys `_permutation` sorts by."""
    bucket = regen and sort in ("octant", "spatial")
    n_keys = 1 if sort == "live" else 8 * (SORT_CELLS ** 3 if sort == "spatial" else 1)
    return SORTS.index(sort), bucket, n_keys * (4 if bucket else 1)


class RayArray:
    """The ray array of the device loop: two state buffers ((2, 16, cap) f32
    and (2, rows, cap) i32: the second takes a compaction's gather), the
    loop's counts (CTR_*, i32) and the partition's scratch, on one
    device."""

    def __init__(self, cap: int, regen: bool, sort: str, device):
        self.cap, self.regen, self.sort = cap, regen, sort
        self.rows = _int_planes(regen, True)
        self.f = torch.empty((2, F_PLANES, cap), dtype=torch.float32, device=device)
        self.i = torch.empty((2, self.rows, cap), dtype=torch.int32, device=device)
        self.ctr = torch.zeros(CTR_WORDS, dtype=torch.int32, device=device)
        self.code, self.bucket, self.n_keys = _sort_code(sort, regen)
        self.keys = torch.empty(cap, dtype=torch.int16, device=device)
        self.rank = torch.empty(cap, dtype=torch.int32, device=device)
        self.hist = torch.empty((self.n_keys + 1) * -(-cap // _TILE), dtype=torch.int32,
                                device=device)
        self.perm = torch.empty(cap, dtype=torch.int32, device=device)
        self.bounds = torch.empty(6, dtype=torch.int32, device=device)
        self.reset_bounds()

    def reset_bounds(self) -> None:
        """The partition's bounding box before any live origin is seen
        (wavefront.cuh::wf_reset_bounds), filled on the device."""
        self.bounds[:3].fill_(_BOUNDS_RESET[0])
        self.bounds[3:].fill_(_BOUNDS_RESET[1])

    def buffers(self) -> tuple:
        return (self.f[0].data_ptr(), self.f[1].data_ptr(), self.i[0].data_ptr(),
                self.i[1].data_ptr())


class _Run:
    """A frame's device counters (STAT_*, and the live rays entering each
    iteration), the host's reads of the device and its enqueued launches."""

    def __init__(self, device, iterations: int):
        self.stats = torch.zeros(STAT_WORDS, dtype=torch.int64, device=device)
        self.iter_live = torch.zeros(max(iterations, 1), dtype=torch.int64, device=device)
        self.iterations = 0
        self.host_syncs = 0
        self.enqueued = dict(bounce=0, raygen=0, partition=0, advance=0)

    def reserve(self, iterations: int) -> None:
        """Room for `iterations` entries of iter_live (a stream-ordered copy
        into a larger tensor: no read)."""
        if iterations > self.iter_live.numel():
            grown = torch.zeros(2 * iterations, dtype=torch.int64, device=self.stats.device)
            grown[:self.iter_live.numel()] = self.iter_live
            self.iter_live = grown

    def done_flag(self, arr: RayArray):
        """Start copying the array's done flag to the host (no wait)."""
        if not arr.ctr.is_cuda:
            return arr.ctr[CTR_DONE:CTR_DONE + 1].clone(), None
        host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        host.copy_(arr.ctr[CTR_DONE:CTR_DONE + 1], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def read_flag(self, flag) -> bool:
        """Wait for a done flag's copy: one read of the device."""
        host, event = flag
        if event is not None:
            event.synchronize()
        self.host_syncs += 1
        return bool(host[0])

    def counts(self, regen: bool, max_depth: int) -> dict:
        """The device's counters, read once."""
        values = torch.cat([self.stats, self.iter_live]).tolist()
        self.host_syncs += 1
        stats, per_iteration = values[:STAT_WORDS], values[STAT_WORDS:]
        return dict(bounce_launches=stats[STAT_BOUNCE], raygen_launches=stats[STAT_RAYGEN],
                    compactions=stats[STAT_COMPACT], host_syncs=self.host_syncs,
                    live_ray_bounces=stats[STAT_LIVE_BOUNCES],
                    live_per_iteration=per_iteration[:stats[STAT_BOUNCE] if regen
                                                     else max_depth],
                    enqueued=dict(self.enqueued))


# --- ray generation -----------------------------------------------------------


def _primary_rays_reference(eng: Engine, state_f, state_i, idx, *, regen: bool,
                            per_ray_sample: bool, sample: int) -> None:
    """Primary rays for slots `idx` of a state from their pid, pix (and
    sample), in place."""
    if idx.numel() == 0:
        return
    pix = state_i[PIX, idx]
    real = pix >= 0
    s = (rng_ops.as_u32(state_i[SMP, idx]) if regen or per_ray_sample
         else int(sample) & 0xFFFFFFFF)
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


def wavefront_raygen_reference(eng: Engine, state_f, state_i, n: int, *, regen: bool,
                               sample: int = 0, per_ray_sample: bool = False) -> None:
    """Plain version of wavefront_raygen: primary rays from ops/rays.py into
    slots [0, n), in place."""
    _check_state(state_f, state_i, n, regen, per_ray_sample)
    _primary_rays_reference(eng, state_f, state_i, torch.arange(n, device=state_f.device),
                            regen=regen, per_ray_sample=per_ray_sample, sample=sample)


def _raygen_launch(eng: Engine, f, i, stride: int, *, per_ray_sample: bool, regen: bool,
                   sample: int = 0, mode: int, count: int = 0, geometry=(0, 0, 0, 1, 0),
                   ctr=None, sched: Schedule | None = None, perm=None, run: _Run | None = None,
                   bounds=None) -> None:
    """One launch of wavefront_raygen_kernel (grt_wavefront_raygen's modes:
    0 slots, 1 stream, 2 refill); f and i are (2, planes, stride) buffers or
    a single (planes, stride) state."""
    eng.packed()
    kind, kx, ky, nbits = mk._sampler_args(eng.sampler_spec)
    pool, width, y_offset, row_stride, s0 = geometry
    sched = sched or Schedule(0.0)
    pair = (lambda t: (t[0].data_ptr(), t[1].data_ptr())) if f.dim() == 3 else (
        lambda t: (t.data_ptr(), t.data_ptr()))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.load()
    dev = f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wavefront_raygen(
            eng._cam_vec.data_ptr(), kind, kx, ky, nbits, eng.frame_seed,
            int(eng.total_width), *pair(f), *pair(i), stride, int(per_ray_sample), int(regen),
            int(sample) & 0xFFFFFFFF, mode, count, pool, width, y_offset, row_stride,
            s0 & 0xFFFFFFFF, ptr(ctr), sched.compact_threshold, sched.refill_threshold,
            sched.total, ptr(perm), None if run is None else run.stats.data_ptr(),
            ptr(bounds), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_raygen")
    LAUNCHES["wavefront_raygen"] += 1
    if run is not None:
        run.enqueued["raygen"] += 1


def wavefront_raygen(eng: Engine, state_f, state_i, n: int, *, regen: bool, sample: int = 0,
                     per_ray_sample: bool = False) -> None:
    """Primary rays into slots [0, n) of the ray state, in place: sample
    `sample` of each slot's pixel, or under `regen` or `per_ray_sample` the
    slot's own sample; throughput 1, no radiance, bounce 0, live unless the
    slot's pix is negative.  On CUDA tensors it launches
    `wavefront_raygen_kernel` (the megakernel's own ray generation); on CPU
    tensors it is the plain version."""
    if not eng.on_card(state_f):
        return wavefront_raygen_reference(eng, state_f, state_i, n, regen=regen,
                                          sample=sample, per_ray_sample=per_ray_sample)
    _check_state(state_f, state_i, n, regen, per_ray_sample)
    if n > 0:
        _raygen_launch(eng, state_f, state_i, state_f.shape[1], per_ray_sample=per_ray_sample,
                       regen=regen, sample=sample, mode=0, count=n)


def _stream_ids(src, *, p, width, height, y_offset, row_stride, total_width, s0):
    """(pid, pix, sample) of stream positions `src`: pixel src mod p of the
    band, sample s0 + src // p."""
    local = src % p
    pid = _global_pids(local, p=p, width=width, height=height, y_offset=y_offset,
                       total_width=total_width, row_stride=row_stride)
    return torch.stack([pid, local, (s0 + src // p) & 0xFFFFFFFF]).to(torch.int32)


def _fill_reference(eng: Engine, arr: RayArray, count: int, frame: dict, s0: int,
                    run: _Run) -> None:
    """Plain version of the stream fill: slot j takes stream position j,
    and the array's counts start over (count slots, all entering)."""
    src = torch.arange(count, device=arr.f.device)
    arr.i[0, :SMP + 1, :count] = _stream_ids(src, total_width=eng.total_width, s0=s0, **frame)
    _primary_rays_reference(eng, arr.f[0], arr.i[0], src, regen=arr.regen,
                            per_ray_sample=True, sample=0)
    arr.ctr.zero_()
    arr.ctr[CTR_N] = arr.ctr[CTR_NXT] = arr.ctr[CTR_ENTER] = count
    run.stats[STAT_RAYGEN] += 1


def wavefront_fill(eng: Engine, arr: RayArray, count: int, frame: dict, s0: int,
                   run: _Run) -> None:
    """Start the array over with the first `count` positions of the
    sample-major stream of the band's pixels from sample s0 (`frame`:
    p, width, height, y_offset, row_stride): ids and primary rays, and the
    counts of a new array.  Launches wavefront_raygen_kernel (mode 1) on
    the card; the plain version elsewhere."""
    if not eng.on_card(arr.f):
        return _fill_reference(eng, arr, count, frame, s0, run)
    geometry = (frame["p"], frame["width"], frame["y_offset"], frame["row_stride"], s0)
    _raygen_launch(eng, arr.f, arr.i, arr.cap, per_ray_sample=True, regen=arr.regen, mode=1,
                   count=count, geometry=geometry, ctr=arr.ctr, run=run, bounds=arr.bounds)


def _refill_reference(eng: Engine, arr: RayArray, sched: Schedule, frame: dict, s0: int,
                      run: _Run) -> None:
    """Plain version of the refill: the dead slots in their order (after a
    compaction, slots live ..; else perm[live ..]) take the next k stream
    positions from the cursor."""
    pl = _plan(arr.ctr, sched)
    if not pl.refill:
        return
    r = torch.arange(pl.k, device=arr.f.device)
    cur = pl.cur ^ int(pl.compact)
    slots = pl.live + r if pl.compact else arr.perm[pl.live:pl.live + pl.k].long()
    arr.i[cur, :SMP + 1, slots] = _stream_ids(pl.nxt + r, total_width=eng.total_width,
                                              s0=s0, **frame)
    _primary_rays_reference(eng, arr.f[cur], arr.i[cur], slots, regen=True,
                            per_ray_sample=True, sample=0)
    run.stats[STAT_RAYGEN] += 1


def wavefront_refill(eng: Engine, arr: RayArray, sched: Schedule, frame: dict, s0: int,
                     run: _Run) -> None:
    """The refill the counts call for, in stream order: launches
    wavefront_raygen_kernel (mode 2) on the card; the plain version
    elsewhere."""
    if not eng.on_card(arr.f):
        return _refill_reference(eng, arr, sched, frame, s0, run)
    geometry = (frame["p"], frame["width"], frame["y_offset"], frame["row_stride"], s0)
    _raygen_launch(eng, arr.f, arr.i, arr.cap, per_ray_sample=True, regen=True, mode=2,
                   geometry=geometry, ctr=arr.ctr, sched=sched, perm=arr.perm, run=run)


# --- the bounce ---------------------------------------------------------------


def wavefront_bounce_reference(eng: Engine, state_f, state_i, n: int, *, regen: bool,
                               sample: int = 0, bounce: int = 0, sample_base: int = 0,
                               n_pixels: int = 0, out: torch.Tensor,
                               rays_out: torch.Tensor | None = None,
                               per_ray_sample: bool = False) -> int:
    """Plain version of wavefront_bounce: ops/integrators.path_bounce on the
    live rays of slots [0, n), in place, finished samples written to `out`;
    returns the rays that go on."""
    _check_state(state_f, state_i, n, regen, per_ray_sample)
    idx = torch.nonzero(state_f[LIVE, :n] > 0.5).squeeze(1)
    if idx.numel() == 0:
        return 0
    pid = rng_ops.as_u32(state_i[PID, idx])
    s = (rng_ops.as_u32(state_i[SMP, idx]) if regen or per_ray_sample
         else int(sample) & 0xFFFFFFFF)
    i = state_i[BNC, idx].to(torch.int64) if regen else int(bounce)
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
    if regen or per_ray_sample:
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
    going = st.live & ~done
    state_f[LIVE, idx] = going.to(torch.float32)
    if eng.count_rays:
        state_f[RAYS, idx] = st.rays
    return int(going.sum())


def _bounce_launch(eng: Engine, f, i, stride: int, n: int, *, ctr=None, regen: bool,
                   per_ray_sample: bool, sample: int, bounce: int, sample_base: int,
                   n_pixels: int, out, rays_out) -> None:
    for t in (out, rays_out):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != f.device):
            raise ValueError("out and rays_out must be contiguous f32 tensors beside the state")
    packed = eng.packed()
    pair = (lambda t: (t[0].data_ptr(), t[1].data_ptr())) if f.dim() == 3 else (
        lambda t: (t.data_ptr(), t.data_ptr()))
    lib = build.load()
    dev = f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wavefront_bounce(
            *packed.args, eng.frame_seed, eng.max_depth, float(eng.t_min), float(eng.t_max),
            int(eng.russian_roulette_depth), float(eng.sky_intensity), float(eng.clamp),
            *pair(f), *pair(i), stride, n, None if ctr is None else ctr.data_ptr(),
            int(per_ray_sample), int(regen), int(sample) & 0xFFFFFFFF, int(bounce),
            int(sample_base) & 0xFFFFFFFF, int(n_pixels), out.data_ptr(),
            None if rays_out is None else rays_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_bounce")
    LAUNCHES[eng.route(regen)] += 1


def wavefront_bounce(eng: Engine, state_f, state_i, n: int, *, regen: bool, sample: int = 0,
                     bounce: int = 0, sample_base: int = 0, n_pixels: int = 0,
                     out: torch.Tensor, rays_out: torch.Tensor | None = None,
                     per_ray_sample: bool = False) -> None:
    """One path bounce of every live ray of slots [0, n), in place
    (`_wf_kernel`'s contract): the next ray, throughput, radiance so far,
    prev_diffuse, prev_cos and live flag, and the rays traced so far when
    the engine counts them.  Without `regen` every ray is at `bounce`, and
    at `sample` unless `per_ray_sample` (a batch of samples: each reads its
    own); with `regen` each reads both from state_i.  A ray whose path
    ends, or whose bounce was the last of max_depth, writes its sample's
    total radiance (clamped) to `out[slot]` and its ray count to
    `rays_out[slot]`, slot = pix, plus (sample - sample_base) * n_pixels
    with per-ray samples, and goes dead.  On CUDA tensors it launches
    `wavefront_bounce_kernel`; on CPU tensors it is the plain version."""
    if eng.count_rays != (rays_out is not None):
        raise ValueError("rays_out goes with an Engine built with count_rays=True")
    if not eng.on_card(state_f):
        wavefront_bounce_reference(
            eng, state_f, state_i, n, regen=regen, sample=sample, bounce=bounce,
            sample_base=sample_base, n_pixels=n_pixels, out=out, rays_out=rays_out,
            per_ray_sample=per_ray_sample)
        return
    _check_state(state_f, state_i, n, regen, per_ray_sample)
    if n > 0:
        _bounce_launch(eng, state_f, state_i, state_f.shape[1], n, regen=regen,
                       per_ray_sample=per_ray_sample, sample=sample, bounce=bounce,
                       sample_base=sample_base, n_pixels=n_pixels, out=out, rays_out=rays_out)


def _bounce_step(eng: Engine, arr: RayArray, run: _Run, *, bounce: int = 0, sample_base: int,
                 n_pixels: int, out, rays_out=None) -> None:
    """One bounce of the loop's array: the slots and buffer its counts
    name, nothing once the loop is over; the surviving rays are added to
    the live count."""
    run.enqueued["bounce"] += 1
    if eng.on_card(arr.f):
        return _bounce_launch(eng, arr.f, arr.i, arr.cap, 0, ctr=arr.ctr, regen=arr.regen,
                              per_ray_sample=True, sample=0, bounce=bounce,
                              sample_base=sample_base, n_pixels=n_pixels, out=out,
                              rays_out=rays_out)
    c = arr.ctr.tolist()
    if c[CTR_DONE]:
        return
    cur = c[CTR_CUR]
    arr.ctr[CTR_LIVE] += wavefront_bounce_reference(
        eng, arr.f[cur], arr.i[cur], c[CTR_N], regen=arr.regen, bounce=bounce,
        sample_base=sample_base, n_pixels=n_pixels, out=out, rays_out=rays_out,
        per_ray_sample=True)


# --- the partition and the loop's step ----------------------------------------


def _permutation(state_f, state_i, n: int, live, sort: str, regen: bool) -> torch.Tensor:
    """The slot order a compaction gathers by: live rays first, by `sort`."""
    if sort == "live":
        return _partition_live(live.to(torch.float32))
    plane = lambda r: state_f[r, :n, None]
    bounce = state_i[BNC, :n] if regen and sort != "octant-flat" else None
    origins = (plane(OX), plane(OY), plane(OZ)) if sort == "spatial" else None
    return _sort_rows_octant(live.to(torch.float32), plane(DX), plane(DY), plane(DZ),
                             bounce_rows=bounce, origins=origins)


def wavefront_partition_reference(arr: RayArray, sched: Schedule) -> None:
    """Plain version of wavefront_partition: `_permutation` (torch sort
    keys, argsort or cumsums) into arr.perm, and the gather by torch
    indexing."""
    pl = _plan(arr.ctr, sched)
    if not (pl.compact or pl.rank):
        return
    f, i = arr.f[pl.cur], arr.i[pl.cur]
    live = f[LIVE, :pl.n] > 0.5
    perm = (_permutation(f, i, pl.n, live, arr.sort, arr.regen) if pl.compact
            else _partition_live(live.to(torch.float32)))
    arr.perm[:pl.n] = perm.to(torch.int32)
    if pl.compact:
        m = pl.n if arr.regen else pl.live
        arr.f[pl.cur ^ 1, :, :m] = f[:, perm[:m]]
        arr.i[pl.cur ^ 1, :, :m] = i[:, perm[:m]]


def wavefront_partition(eng: Engine, arr: RayArray, sched: Schedule,
                        run: _Run | None = None) -> None:
    """The compaction the counts call for: live rays first in `_permutation`'s
    order (arr.perm) and the state planes gathered into the other buffer;
    or, when a pool only refills, its dead slots' order.  On the card it
    launches the partition kernels of ops/cuda/wavefront.cu (a stable
    counting sort); elsewhere the plain version."""
    if run is not None:
        run.enqueued["partition"] += 1
    if not eng.on_card(arr.f):
        return wavefront_partition_reference(arr, sched)
    lib = build.load("wavefront")
    dev = arr.f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wf_partition(
            arr.ctr.data_ptr(), *sched.args(), *arr.buffers(), arr.rows, arr.cap, arr.code,
            int(arr.bucket), arr.n_keys, arr.keys.data_ptr(), arr.rank.data_ptr(),
            arr.hist.data_ptr(), arr.perm.data_ptr(), arr.bounds.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_partition", "wavefront")
    LAUNCHES["wavefront_partition"] += 1


def wavefront_advance_reference(arr: RayArray, sched: Schedule, run: _Run,
                                iteration: int) -> None:
    """Plain version of wavefront_advance (wf_advance_kernel)."""
    pl = _plan(arr.ctr, sched)
    if pl.done:
        return
    c = arr.ctr
    enter = int(c[CTR_ENTER])
    run.iter_live[int(run.stats[STAT_BOUNCE]) if sched.regen else iteration] += enter
    run.stats[STAT_BOUNCE] += 1
    run.stats[STAT_LIVE_BOUNCES] += enter
    live = pl.live
    if pl.compact:
        run.stats[STAT_COMPACT] += 1
        c[CTR_CUR] = pl.cur ^ 1
        if not sched.regen:
            c[CTR_N] = live
    done = live == 0
    if sched.regen:
        k = pl.k if pl.refill else 0
        live += k
        c[CTR_NXT] = pl.nxt + k
        done = not (pl.nxt + k < sched.total or live > 0)
    c[CTR_ENTER] = live
    c[CTR_LIVE] = 0
    c[CTR_DONE] = int(done)


def wavefront_advance(eng: Engine, arr: RayArray, sched: Schedule, run: _Run,
                      iteration: int) -> None:
    """End an iteration: count its bounce, swap the buffers after a
    compaction, take the refill into the counts, and decide whether the
    loop is over.  One thread of wf_advance_kernel on the card; the plain
    version elsewhere."""
    run.enqueued["advance"] += 1
    if not eng.on_card(arr.f):
        return wavefront_advance_reference(arr, sched, run, iteration)
    lib = build.load("wavefront")
    dev = arr.f.device
    with torch.cuda.device(dev):
        rc = lib.grt_wf_advance(arr.ctr.data_ptr(), *sched.args(), run.stats.data_ptr(),
                                run.iter_live.data_ptr(), iteration, arr.bounds.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "wavefront_advance", "wavefront")
    LAUNCHES["wavefront_advance"] += 1


# --- the host loops -----------------------------------------------------------


def _sample_batch(spp: int, p: int, plain: bool) -> int:
    """Samples traced in one array without regeneration."""
    return max(1, min(spp, (PLAIN_SAMPLE_SLOTS if plain else SAMPLE_SLOTS) // p))


def _run_samples(eng: Engine, *, frame, spp, sample_index, sort, compact_threshold,
                 batch, run):
    """The sample-major loop (wavefront.py:505-608), a batch of samples at a
    time: each batch traced to termination, bounce by bounce, over a ray
    array that shrinks to its live rays whenever their share of it falls
    below `compact_threshold`.  The host enqueues max_depth (bounce,
    compaction, step) triples a batch and reads nothing."""
    dev = eng.device
    p = frame["p"]
    acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    rays_acc = torch.zeros(p, dtype=torch.float32, device=dev) if eng.count_rays else None
    if eng.max_depth <= 0:
        return acc, rays_acc
    arr = RayArray(batch * p, False, sort, dev)
    for first in range(0, spp, batch):
        k = min(batch, spp - first)
        s0 = (int(sample_index) + first) & 0xFFFFFFFF
        out = torch.zeros((k * p, 3), dtype=torch.float32, device=dev)
        rays = torch.zeros(k * p, dtype=torch.float32, device=dev) if eng.count_rays else None
        wavefront_fill(eng, arr, k * p, frame, s0, run)
        for b in range(eng.max_depth):
            sched = Schedule(compact_threshold, last=b + 1 >= eng.max_depth)
            _bounce_step(eng, arr, run, bounce=b, sample_base=s0, n_pixels=p, out=out,
                         rays_out=rays)
            if not sched.last:
                wavefront_partition(eng, arr, sched, run)
            wavefront_advance(eng, arr, sched, run, b)
        # Samples fold in sample order, as the megakernel's spp loop adds them.
        for j in range(k):
            acc += out[j * p:(j + 1) * p]
            if rays is not None:
                rays_acc += rays[j * p:(j + 1) * p]
    return acc, rays_acc


def _run_regen(eng: Engine, *, frame, spp, sample_index, sort, compact_threshold,
               refill_threshold, run, acc):
    """The regenerating pool (wavefront.py:611-794) over samples
    sample_index .. sample_index + spp - 1, added into `acc` in sample
    order.  The sample stream is the spp * p primary rays, sample-major; the
    pool holds p slots, and one iteration is one bounce of every pooled ray.
    When at least `refill_threshold` of the slots have died (or the stream
    is about to drain), dead slots take the next rays of the stream in
    stream order.  The host enqueues POLL_EVERY iterations at a time and
    reads the done flag of the previous group: the loop has ended when it
    is set."""
    dev = eng.device
    p = frame["p"]
    total = spp * p
    s0 = int(sample_index) & 0xFFFFFFFF
    arr = RayArray(p, True, sort, dev)
    buf = torch.zeros((total, 3), dtype=torch.float32, device=dev)
    sched = Schedule(compact_threshold, refill_threshold, total, p, regen=True)
    wavefront_fill(eng, arr, p, frame, s0, run)
    # Each iteration bounces at least one ray of the stream: a bound that
    # only a fault reaches.
    limit = run.iterations + total * max(eng.max_depth, 1) + 2 * POLL_EVERY
    pending = None
    while True:
        run.reserve(run.iterations + POLL_EVERY)
        for _ in range(POLL_EVERY):
            _bounce_step(eng, arr, run, sample_base=s0, n_pixels=p, out=buf)
            wavefront_partition(eng, arr, sched, run)
            wavefront_refill(eng, arr, sched, frame, s0, run)
            wavefront_advance(eng, arr, sched, run, run.iterations)
            run.iterations += 1
        flag = run.done_flag(arr)
        if pending is not None and run.read_flag(pending):
            break
        pending = flag
        if run.iterations > limit:
            raise RuntimeError(f"the regenerating pool did not drain in {limit} iterations")
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
    p = width * height
    batch = _sample_batch(spp, p, plain)
    if (REGEN_BATCH if regenerate else batch) * p >= 2 ** 31:
        raise ValueError(f"{width}x{height} pixels overflow the loop's 32-bit slot counts")
    sc = as_scene(scene_or_spheres)
    if not plain:
        dev = mk._require_cuda(*mk.dataclass_tensors(sc), *mk.dataclass_tensors(camera))
    else:
        dev = sc.device
    eng = Engine(sc, camera, frame_seed, max_depth, t_min, t_max, russian_roulette_depth,
                 sky_intensity, nee, mis, sampler_spec, clamp,
                 width if total_width is None else total_width, return_ray_count, plain)
    run = _Run(dev, max_depth if not regenerate else 4 * POLL_EVERY)
    frame = dict(p=p, width=width, height=height, y_offset=int(y_offset),
                 row_stride=int(row_stride))
    common = dict(frame=frame, sort=sort, compact_threshold=compact_threshold, run=run)
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
        acc, rays = _run_samples(eng, spp=spp, sample_index=sample_index, batch=batch,
                                 **common)
    LAST_RUN.clear()
    LAST_RUN.update(run.counts(regenerate, max(max_depth, 0)), regenerate=bool(regenerate),
                    sort=sort, sample_batch=None if regenerate else batch,
                    poll_every=POLL_EVERY)
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
    global.  `sort` ('octant', 'octant-flat', 'spatial', 'live'),
    `compact_threshold` (compact when the live share of the ray array falls
    below it) only schedule.  `regenerate=True` keeps one persistent ray
    pool across the samples and refills dead slots with the next samples'
    primary rays once `refill_threshold` of the pool has died; it composes
    with neither `clamp` nor `return_ray_count`, as in the JAX package.
    Keywords:
    sample_index, frame_seed, max_depth, t_min, t_max,
    russian_roulette_depth, sky_intensity, nee, mis, spp, sampler_spec,
    clamp, return_ray_count, and the scheduling ones above."""
    return _render(scene_or_spheres, camera, plain=False, width=width, height=height, **kw)


def render_wavefront_reference(scene_or_spheres, camera: Camera, *, width: int, height: int,
                               **kw):
    """The plain PyTorch version of render_wavefront: the same schedule
    around the kernels' plain versions, on the device the scene lies on.
    Its image equals render_reference(light_pick='sample') bit for bit."""
    return _render(scene_or_spheres, camera, plain=True, width=width, height=height, **kw)
