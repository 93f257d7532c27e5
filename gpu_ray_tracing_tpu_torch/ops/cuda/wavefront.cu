// The wavefront engine's loop on the device (K2, with the bounce and ray-
// generation kernels of megakernel.cu): the stable partition that compacts
// the ray array between bounces, and the loop's step.  Replaces what the
// Pallas TPU engine gpu_ray_tracing_tpu/ops/pallas/wavefront.py ran as XLA
// code inside its jitted bounce loop (`one_sample` :505-608, the compaction
// under `lax.cond` :545-572, `_sort_rows_octant` :240 and `_partition_live`
// :222; `_run_regen` :611-794, the refill :756-767): the live count, the
// sort keys and the stable sort or partition, the gathers of the state
// planes, and the loop's own counters.
//
// The host enqueues a fixed schedule and reads nothing between bounces:
// every kernel of an iteration reads the array's counts from device memory
// (wavefront.cuh), decides from them what the iteration does, and returns
// at once when it has nothing to do; wf_advance_kernel, the iteration's
// last, updates the counts.
//
// The partition gives exactly the permutation of a stable argsort of one
// integer key per slot (live rays by direction octant, optionally by the
// bounce bucket and a 4^3 grid over the live origins' bounding box; dead
// rays last): a counting sort over tiles of 2,048 slots, in two launches
// (three with 'spatial') of a grid that stays resident and walks the tiles
// below the live slot count, so that a call with nothing to do costs two
// small grids:
//   wf_bounds_kernel   the live origins' bounding box (sort 'spatial'):
//                      min/max are order-free, so atomics on their ordered
//                      bit patterns give one answer;
//   wf_count_kernel    a block takes tiles in order from a ticket counter,
//                      computes the keys of a tile's slots (stored as i16)
//                      and counts them: each warp walks 256 contiguous
//                      slots 32 at a time, grouping equal keys with
//                      __match_any_sync, into per-warp counts in shared
//                      memory (u16, up to 2,049 keys).  Then, per key, a
//                      chained scan across tiles (decoupled look-back): the
//                      tile publishes its count, walks back over the tiles
//                      before it adding their counts until one has
//                      published its inclusive prefix, and publishes its
//                      own.  A tile waits only on tiles handed out before
//                      it, so the order of the tickets is what makes the
//                      wait finite; no sum depends on it.  Two forms: for
//                      an array of at most one tile a resident block (the
//                      regenerating pool) latency rules, so every plane a
//                      key needs is read at once and the look-back reads 8
//                      tiles a step; for a larger one, one tile a step and
//                      the direction only of live rays, in half the
//                      registers (twice the blocks an SM);
//   wf_scatter_kernel  a block re-ranks a tile from the stored keys (the
//                      same deterministic grouping), places each slot at
//                      (key, rank) in the tile's sorted order in shared
//                      memory, and writes the tile's run of each key to its
//                      offset: the keys' totals scanned (the last tile's
//                      prefixes) plus the key's prefix over earlier tiles.
//                      The permutation, then the state planes two at a
//                      time (8 KB a plane and tile), go through shared
//                      memory: the reads and the writes move whole sectors.
//
// What bounds it on this card: bytes.  A compaction reads the keys' planes
// (16 bytes a slot), writes and reads the keys (2 + 2) and writes the
// permutation (4); it reads 16 f32 and 2-4 i32 planes of the rays that
// move and writes them once (about 72-80 bytes a ray each way); the
// look-back words are 8 bytes a key and tile.  The step is one thread.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "wavefront.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // slots a thread ranks
constexpr int kTile = kThreads * kItems;   // slots of a tile
constexpr int kCells = 4;                  // sort 'spatial': cells per axis

struct WfPart {
  int* ctr;
  WfSched sched;
  float* f[2];
  int* i[2];
  int ni;
  int stride;
  int sort;
  int bucket;   // add the bounce bucket (regeneration, sort != 'octant-flat')
  int n_keys;   // keys of live rays; dead rays take key n_keys
  short* keys;
  // The look-back words of a call, (tiles, keys + 1): the high half is
  // 2 x epoch + 1 for an inclusive prefix (+ 0 for the tile's own count),
  // the low half the value; a word of another epoch is not yet published.
  unsigned long long* status;
  // [0] the tile ticket, [1] the epoch of the next call (both advanced by
  // wf_scatter_kernel for the next call).
  unsigned int* sync;
  int* perm;
  unsigned int* bounds;
};

__device__ __forceinline__ bool wf_active(const WfPlan& pl) { return pl.compact || pl.rank; }

__device__ __forceinline__ int wf_live_keys(const WfPart& a, const WfPlan& pl) {
  return pl.compact ? a.n_keys : 1;  // a ranking only: live 0, dead 1
}

// The live origins' bounding box, for sort 'spatial'.
__global__ void __launch_bounds__(kThreads) wf_bounds_kernel(const WfPart a) {
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!pl.compact) return;
  const float* f = a.f[pl.cur];
  const size_t s = (size_t)a.stride;
  float lo[3] = {3.4e38f, 3.4e38f, 3.4e38f}, hi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < pl.n; t += gridDim.x * blockDim.x) {
    if (!(f[WLIVE * s + t] > 0.5f)) continue;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float v = f[(WOX + ax) * s + t];
      lo[ax] = fminf(lo[ax], v);
      hi[ax] = fmaxf(hi[ax], v);
    }
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[ax] = fminf(lo[ax], __shfl_xor_sync(0xffffffffu, lo[ax], off));
      hi[ax] = fmaxf(hi[ax], __shfl_xor_sync(0xffffffffu, hi[ax], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      atomicMin(&a.bounds[ax], wf_ordered(lo[ax]));
      atomicMax(&a.bounds[3 + ax], wf_ordered(hi[ax]));
    }
  }
}

// The sort key of slot e, as ops/cuda/wavefront.py::_sort_rows_octant
// computes it for one-ray rows: octant (x 4, y 2, z 1), + 8 x the origin's
// cell (sort 'spatial'), + keys x the bounce bucket min(bounce, 3); dead
// rays take n_keys.  kWide: every plane the key may need is read at once,
// so that a thread's loads are in flight together; else the direction,
// origin and bounce only for a live ray, in fewer registers.
template <bool kWide>
__device__ __forceinline__ int wf_sort_key(const WfPart& a, const float* f, const int* iv,
                                           size_t s, int e, const float* lo,
                                           const float* step) {
  const float live = f[WLIVE * s + e];
  float d[3], o[3] = {0.0f, 0.0f, 0.0f};
  int bounce = 0;
  const auto read = [&] {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) d[ax] = f[(WDX + ax) * s + e];
    if (a.sort == kSortSpatial) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) o[ax] = f[(WOX + ax) * s + e];
    }
    if (a.bucket) bounce = iv[WBNC * s + e];
  };
  if (kWide) read();
  if (!(live > 0.5f)) return a.n_keys;
  if (a.sort == kSortLive) return 0;
  if (!kWide) read();
  int key = (d[0] > 0.0f ? 4 : 0) + (d[1] > 0.0f ? 2 : 0) + (d[2] > 0.0f ? 1 : 0);
  int keys = 8;
  if (a.sort == kSortSpatial) {
    int cell = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int c = (int)((o[ax] - lo[ax]) / step[ax]);
      cell = cell * kCells + min(max(c, 0), kCells - 1);
    }
    key += keys * cell;
    keys *= kCells * kCells * kCells;
  }
  if (a.bucket) key += keys * min(max(bounce, 0), 3);
  return key;
}

// Shared memory of the two passes (dynamic, 16-byte aligned), in 32-bit
// words: the block's tile ticket and warp sums, then what each pass keeps
// per key, then (scatter) two sets of kPlaneStep staging buffers of a
// tile.
constexpr int kHead = 16;  // ticket, kWarps warp sums, padding

__host__ __device__ inline int wf_count_words(int k1) { return kHead + (kWarps * k1 + 1) / 2; }

constexpr int kPlaneStep = 2;  // state planes a scatter step stages

__host__ __device__ inline int wf_scatter_words(int k1) {
  return kHead + 3 * k1 + (kWarps * k1 + 1) / 2 + 2 * kPlaneStep * kTile;
}

// The keys of the warp's kItems x 32 slots in slot order, grouped with
// __match_any_sync: rk[j] = the earlier slots of the warp with the same
// key, wc[key] (u16) the warp's count of each key.  A slot outside the
// array carries key k1 and is neither counted nor ranked.
__device__ __forceinline__ void wf_warp_rank(const int* key, int k1, unsigned short* wc,
                                             int lane, int* rk) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = key[j];
    const bool in = k < k1;
    const unsigned int peers = __match_any_sync(0xffffffffu, k);
    int r = 0;
    if (in) r = wc[k] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    // The group's highest lane adds the group's size.
    if (in && (peers >> lane) == 1u) wc[k] = (unsigned short)(wc[k] + __popc(peers));
    __syncwarp();
    rk[j] = r;
  }
}

// An exclusive prefix sum of v[0 .. len) in shared memory, in place, by
// the whole block (each thread a contiguous run); `sums` holds kWarps ints.
__device__ void wf_block_scan(int* v, int len, int* sums) {
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, len);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += v[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  int run = x - own;
  for (int w = 0; w < warp; ++w) run += sums[w];
  for (int k = lo; k < hi; ++k) {
    const int c = v[k];
    v[k] = run;
    run += c;
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long wf_word(unsigned int epoch, bool inclusive,
                                                      unsigned int value) {
  return ((unsigned long long)(2u * epoch + (inclusive ? 1u : 0u)) << 32) | value;
}

__device__ __forceinline__ void wf_publish(unsigned long long* p, unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(p) = word;
}

constexpr int kLookBack = 8;  // tiles a wide look-back step reads at once

// A key's count in the tiles before this one (`own` points at this tile's
// word of the key, tiles lie k1 words apart, `t` tiles precede it): walk
// back, adding published counts, until a tile's inclusive prefix, waiting
// on a tile not yet published in this epoch.  The nearest tile is read
// alone (it usually holds its prefix); after it one tile a step, or
// (kWide) kLookBack tiles at once.
template <bool kWide>
__device__ unsigned int wf_look_back(const unsigned long long* own, int k1, int t,
                                     unsigned int epoch) {
  constexpr int kStep = kWide ? kLookBack : 1;
  const volatile unsigned long long* p = own;
  unsigned int sum = 0;
  for (int width = 1; t > 0; width = kStep) {
    unsigned long long word[kStep];
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      if (i < width && i < t) word[i] = *(p - (size_t)(i + 1) * k1);
    }
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      if (i < width && i < t) {
        while ((unsigned int)(word[i] >> 33) != epoch) word[i] = *(p - (size_t)(i + 1) * k1);
        sum += (unsigned int)word[i];
        if ((word[i] >> 32) & 1u) return sum;
      }
    }
    const int step = width < t ? width : t;
    p -= (size_t)step * k1;
    t -= step;
  }
  return sum;
}

// A tile's count of key k, the sum of its warps' counts.
__device__ __forceinline__ int wf_tile_count(const unsigned short* cnt, int k1, int k) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) c += cnt[w * k1 + k];
  return c;
}

// Pass 1: keys, tile counts and their chained scan across tiles.  kWide
// for an array of at most one tile per resident block, where each block
// counts about one tile and the loads' and the look-back's latency rule;
// else many tiles a block, where blocks an SM (registers) rule.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) wf_count_kernel(const WfPart a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!wf_active(pl)) return;
  const int n = pl.n;
  const int nt = (n + kTile - 1) / kTile;
  const int k1 = wf_live_keys(a, pl) + 1;
  const unsigned int epoch = a.sync[1];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem + kHead);
  float lo[3] = {0.0f, 0.0f, 0.0f}, step[3] = {1.0f, 1.0f, 1.0f};
  if (pl.compact && a.sort == kSortSpatial) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = wf_unordered(a.bounds[ax]);
      const float hi = wf_unordered(a.bounds[3 + ax]);
      step[ax] = fmaxf(hi - lo[ax], 1e-6f) / (float)kCells;
    }
  }
  const float* f = a.f[pl.cur];
  const int* iv = a.i[pl.cur];
  const size_t s = (size_t)a.stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (;;) {
    if (threadIdx.x == 0) smem[0] = (int)atomicAdd(&a.sync[0], 1u);
    for (int k = threadIdx.x; k < kWarps * k1; k += kThreads) cnt[k] = 0;
    __syncthreads();
    const int t = smem[0];
    if (t >= nt) return;
    const int base = t * kTile + warp * 32 * kItems;
    int key[kItems], rk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = base + j * 32 + lane;
      key[j] = k1;
      if (e < n) {
        key[j] = pl.compact ? wf_sort_key<kWide>(a, f, iv, s, e, lo, step)
                            : (f[WLIVE * s + e] > 0.5f ? 0 : 1);
        a.keys[e] = (short)key[j];
      }
    }
    wf_warp_rank(key, k1, cnt + warp * k1, lane, rk);
    __syncthreads();
    unsigned long long* own = a.status + (size_t)t * k1;
    for (int k = threadIdx.x; k < k1; k += kThreads) {
      wf_publish(own + k, wf_word(epoch, t == 0, (unsigned int)wf_tile_count(cnt, k1, k)));
    }
    if (t > 0) {
      for (int k = threadIdx.x; k < k1; k += kThreads) {
        const unsigned int before = wf_look_back<kWide>(own + k, k1, t, epoch);
        wf_publish(own + k, wf_word(epoch, true, before + (unsigned int)wf_tile_count(cnt, k1, k)));
      }
    }
    __syncthreads();
  }
}

// Pass 2: the permutation and (a compaction) the state planes of the slots
// that move, m of them (the live rays; the whole pool under regeneration,
// whose dead slots follow the live ones and are refilled in that order),
// tile by tile through shared memory.
__global__ void __launch_bounds__(kThreads, 4) wf_scatter_kernel(const WfPart a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!wf_active(pl)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // Pass 1 is over: the next call draws tickets from 0 in a new epoch.
    a.sync[0] = 0u;
    a.sync[1] += 1u;
  }
  const int n = pl.n;
  const int nt = (n + kTile - 1) / kTile;
  if (nt == 0) return;
  const int k1 = wf_live_keys(a, pl) + 1;
  const int dead_key = k1 - 1;
  const bool moves_dead = a.sched.regen != 0;
  const int m = pl.compact ? (moves_dead ? n : pl.live) : 0;
  int* sums = smem + 1;
  int* keyoff = smem + kHead;   // the key's first output slot
  int* start = keyoff + k1;     // the key's first place in the tile's order
  int* shift = start + k1;      // output slot - place in the tile, per key
  unsigned short* cnt = reinterpret_cast<unsigned short*>(shift + k1);
  int* stage = smem + wf_scatter_words(k1) - 2 * kPlaneStep * kTile;
  // The keys' totals (the last tile's inclusive prefixes), scanned.
  const unsigned long long* last = a.status + (size_t)(nt - 1) * k1;
  for (int k = threadIdx.x; k < k1; k += kThreads) keyoff[k] = (int)(unsigned int)last[k];
  __syncthreads();
  wf_block_scan(keyoff, k1, sums);
  const size_t s = (size_t)a.stride;
  const unsigned int* sf = reinterpret_cast<const unsigned int*>(a.f[pl.cur]);
  unsigned int* df = reinterpret_cast<unsigned int*>(a.f[pl.cur ^ 1]);
  const unsigned int* si = reinterpret_cast<const unsigned int*>(a.i[pl.cur]);
  unsigned int* di = reinterpret_cast<unsigned int*>(a.i[pl.cur ^ 1]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    for (int k = threadIdx.x; k < kWarps * k1; k += kThreads) cnt[k] = 0;
    __syncthreads();
    const int base = t * kTile + warp * 32 * kItems;
    int key[kItems], rk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = base + j * 32 + lane;
      key[j] = e < n ? (int)a.keys[e] : k1;
    }
    wf_warp_rank(key, k1, cnt + warp * k1, lane, rk);
    __syncthreads();
    // Per key: the warps' counts become their offsets, and the tile's
    // count gives the key's prefix over earlier tiles.
    const unsigned long long* own = a.status + (size_t)t * k1;
    for (int k = threadIdx.x; k < k1; k += kThreads) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w * k1 + k];
        cnt[w * k1 + k] = (unsigned short)run;
        run += c;
      }
      start[k] = run;
      shift[k] = keyoff[k] + (int)(unsigned int)own[k] - run;
    }
    __syncthreads();
    wf_block_scan(start, k1, sums);
    for (int k = threadIdx.x; k < k1; k += kThreads) shift[k] -= start[k];
    // Each slot's place in the tile's order, and at each place its slot and
    // key.
    int place[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      place[j] = -1;
      if (key[j] < k1) {
        place[j] = start[key[j]] + cnt[warp * k1 + key[j]] + rk[j];
        stage[place[j]] = warp * 32 * kItems + j * 32 + lane;
        stage[kTile + place[j]] = key[j];
      }
    }
    __syncthreads();
    const int items = min(kTile, n - t * kTile);
    int dst[kItems];
    unsigned int writes = 0;  // bit j: the ray at place threadIdx.x + j kThreads moves
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int q = threadIdx.x + j * kThreads;
      dst[j] = 0;
      if (q < items) {
        dst[j] = shift[stage[kTile + q]] + q;
        a.perm[dst[j]] = t * kTile + stage[q];
        if (dst[j] < m) writes |= 1u << j;
      }
    }
    if (m == 0) continue;
    unsigned int reads = 0;  // bit j: this thread's slot j moves
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (place[j] >= 0 && (moves_dead || key[j] != dead_key)) reads |= 1u << j;
    }
    __syncthreads();
    // The planes, kPlaneStep at a time through alternate sets of buffers:
    // a set is written again only after the barrier of the step that
    // follows.
    const size_t slot = (size_t)(base + lane);
    const int planes = kWfPlanes + a.ni;
    for (int r0 = 0; r0 < planes; r0 += kPlaneStep) {
      int* bufs = stage + ((r0 / kPlaneStep) & 1) * kPlaneStep * kTile;
#pragma unroll
      for (int h = 0; h < kPlaneStep; ++h) {
        const int r = r0 + h;
        if (r >= planes) break;
        const unsigned int* src = (r < kWfPlanes ? sf + r * s : si + (r - kWfPlanes) * s) + slot;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if ((reads >> j) & 1u) bufs[h * kTile + place[j]] = (int)src[j * 32];
        }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < kPlaneStep; ++h) {
        const int r = r0 + h;
        if (r >= planes) break;
        unsigned int* out = r < kWfPlanes ? df + r * s : di + (r - kWfPlanes) * s;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if ((writes >> j) & 1u) {
            out[dst[j]] = (unsigned int)bufs[h * kTile + threadIdx.x + j * kThreads];
          }
        }
      }
    }
  }
}

// The iteration's last kernel: count the bounce, swap the buffers after a
// compaction, take the refill into the counts, and decide whether the loop
// is over (no live ray; under regeneration, and the stream drained).
__global__ void wf_advance_kernel(int* ctr, const WfSched sched, long long* stats,
                                  long long* iter_live, int iteration, unsigned int* bounds) {
  const WfPlan pl = wf_plan(ctr, sched);
  if (pl.done) return;
  const int enter = ctr[kCtrEnter];
  // Live rays entering each iteration: by bounce without regeneration
  // (summed over sample batches), in order of the pool's iterations with it.
  iter_live[sched.regen ? stats[kStatBounce] : iteration] += enter;
  stats[kStatBounce] += 1;
  stats[kStatLiveBounces] += enter;
  int live = pl.live;
  if (pl.compact) {
    stats[kStatCompact] += 1;
    ctr[kCtrCur] = pl.cur ^ 1;
    if (!sched.regen) ctr[kCtrN] = live;
  }
  bool done = live == 0;
  if (sched.regen) {
    const int k = pl.refill ? pl.k : 0;
    live += k;
    ctr[kCtrNxt] = pl.nxt + k;
    done = !(pl.nxt + k < sched.total || live > 0);
  }
  ctr[kCtrEnter] = live;
  ctr[kCtrLive] = 0;
  ctr[kCtrDone] = done ? 1 : 0;
  wf_reset_bounds(bounds);
}

}  // namespace

// Plain C interface for ctypes (ops/cuda/build.py).  Each launcher enqueues
// on the given stream, does not synchronise, and returns cudaGetLastError()
// as an int (0 = launched; 1, cudaErrorInvalidValue, for an argument the
// kernels do not take).

// One compaction of the ray array in (f0, i0) or (f1, i1) (whichever
// ctr[cur] names; (16, stride) f32 and (ni, stride) i32 planes each), when
// the counts in ctr call for one: keys by `sort` (0 octant, 1 octant-flat,
// 2 spatial, 3 live; `bucket`: + the bounce bucket), n_keys keys of live
// rays, the permutation to `perm` and the planes to the other buffer; or,
// under regeneration when only a refill follows, the dead slots' order to
// perm[live ..).  Scratch: keys (stride i16), status ((n_keys + 1) x
// ceil(stride / 2048) u64, zeroed before the first call), sync (2 u32,
// {0, 1} before the first call), bounds (6 u32, reset by grt_wf_advance).
extern "C" int grt_wf_partition(int* ctr, double compact_threshold, double refill_threshold,
                                int total, int p, int regen, int last, float* f0, float* f1,
                                int* i0, int* i1, int ni, int stride, int sort, int bucket,
                                int n_keys, short* keys, unsigned long long* status,
                                unsigned int* sync, int* perm, unsigned int* bounds,
                                void* stream) {
  if (stride <= 0) return 0;
  if (n_keys < 1 || n_keys > 2048 || ni < 2 || ni > 4 || sort < 0 || sort > kSortLive) return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WfPart a = {ctr, {compact_threshold, refill_threshold, total, p, regen, last},
                    {f0, f1}, {i0, i1}, ni, stride, sort, bucket, n_keys, keys, status, sync,
                    perm, bounds};
  const int k1 = n_keys + 1;
  const size_t count_bytes = wf_count_words(k1) * sizeof(int);
  const size_t scatter_bytes = wf_scatter_words(k1) * sizeof(int);
  // The blocks of each pass resident on the card at once (the wide count
  // pass runs a block a tile only when every tile's block is resident).
  Fit wide, narrow, scatter;
  cudaError_t err = fit(wf_count_kernel<true>, kThreads, count_bytes, &wide);
  if (err == cudaSuccess) err = fit(wf_count_kernel<false>, kThreads, count_bytes, &narrow);
  if (err == cudaSuccess) err = fit(wf_scatter_kernel, kThreads, scatter_bytes, &scatter);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (stride + kTile - 1) / kTile;
  if (sort == kSortSpatial) {
    // A thread a slot, at most 2,048 threads an SM.
    const long long need = (stride + kThreads - 1) / kThreads;
    wf_bounds_kernel<<<grid_of(need, wide.sms * (2048LL / kThreads)), kThreads, 0, s>>>(a);
  }
  if (tiles <= wide.resident()) {
    wf_count_kernel<true><<<tiles, kThreads, count_bytes, s>>>(a);
  } else {
    wf_count_kernel<false><<<grid_of(tiles, narrow.resident()), kThreads, count_bytes, s>>>(a);
  }
  wf_scatter_kernel<<<grid_of(tiles, scatter.resident()), kThreads, scatter_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The step that ends an iteration (see wf_advance_kernel): `stats` (i64,
// kStatWords), `iter_live` (i64 per iteration), `iteration` the host's
// index of this iteration.
extern "C" int grt_wf_advance(int* ctr, double compact_threshold, double refill_threshold,
                              int total, int p, int regen, int last, long long* stats,
                              long long* iter_live, int iteration, unsigned int* bounds,
                              void* stream) {
  const WfSched sched = {compact_threshold, refill_threshold, total, p, regen, last};
  wf_advance_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ctr, sched, stats, iter_live,
                                                                    iteration, bounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
