// The wavefront engine's loop on the device (K2, with the bounce and ray-
// generation kernels of megakernel.cu): the stable partition that compacts
// the ray array between bounces, and the loop's step.  Replaces what the
// Pallas TPU engine gpu_ray_tracing_tpu/ops/pallas/wavefront.py ran as XLA
// code inside its jitted bounce loop (`one_sample` :505-608, the compaction
// under `lax.cond` :545-572; `_run_regen` :611-794, the refill :756-767):
// the live count, the sort keys and the stable sort or partition, the
// gathers of the state planes, and the loop's own counters.
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
// rays last), without atomics:
//   wf_bounds_kernel  the live origins' bounding box (sort 'spatial'):
//                     min/max are order-free, so atomics on their ordered
//                     bit patterns give one answer;
//   wf_keys_kernel    a block ranks its 2,048 slots: each warp walks 256
//                     contiguous slots 32 at a time, grouping equal keys with
//                     __match_any_sync, and keeps per-key counts in shared
//                     memory (8 warps x up to 2,049 keys as u16); the warps'
//                     counts are then prefix-summed, and the block's per-key
//                     totals go to a key-major histogram;
//   wf_scan_kernel    one block scans the histogram (keys x blocks);
//   wf_perm_kernel    each slot's destination: its key's global offset for
//                     its block plus its rank in the block;
//   wf_gather_kernel  the state planes to the other of two buffers, one
//                     thread per destination slot: the writes coalesce, the
//                     reads follow the permutation.
//
// What bounds it on this card: bytes.  A compaction reads 16 f32 and 2-4
// i32 planes of the live rays and writes them once (about 72-80 bytes a
// ray), plus the keys, ranks and permutation (10 bytes a slot); the scan
// reads keys x blocks integers twice.  The step is one thread.

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // slots a thread ranks
constexpr int kTile = kThreads * kItems;   // slots a block ranks
constexpr int kScanThreads = 1024;
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
  int* rank;
  int* hist;
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
// rays take n_keys.
__device__ __forceinline__ int wf_sort_key(const WfPart& a, const float* f, const int* iv,
                                           size_t s, int e, const float* lo,
                                           const float* step) {
  if (!(f[WLIVE * s + e] > 0.5f)) return a.n_keys;
  if (a.sort == kSortLive) return 0;
  int key = (f[WDX * s + e] > 0.0f ? 4 : 0) + (f[WDY * s + e] > 0.0f ? 2 : 0) +
            (f[WDZ * s + e] > 0.0f ? 1 : 0);
  int keys = 8;
  if (a.sort == kSortSpatial) {
    int cell = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int c = (int)((f[(WOX + ax) * s + e] - lo[ax]) / step[ax]);
      cell = cell * kCells + min(max(c, 0), kCells - 1);
    }
    key += keys * cell;
    keys *= kCells * kCells * kCells;
  }
  if (a.bucket) key += keys * min(max(iv[WBNC * s + e], 0), 3);
  return key;
}

// Pass 1: keys, block-local stable ranks, and the key-major histogram
// hist[key * blocks + block].  Dynamic shared memory: kWarps x (keys + 1)
// u16 counts.
__global__ void __launch_bounds__(kThreads) wf_keys_kernel(const WfPart a) {
  extern __shared__ unsigned short cnt[];
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!wf_active(pl)) return;
  const int n = pl.n;
  const int nb = (n + kTile - 1) / kTile;
  const int b = blockIdx.x;
  if (b >= nb) return;
  const int dead_key = wf_live_keys(a, pl);
  const int k1 = dead_key + 1;
  for (int k = threadIdx.x; k < kWarps * k1; k += kThreads) cnt[k] = 0;
  float lo[3] = {0.0f, 0.0f, 0.0f}, step[3] = {1.0f, 1.0f, 1.0f};
  if (pl.compact && a.sort == kSortSpatial) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = wf_unordered(a.bounds[ax]);
      const float hi = wf_unordered(a.bounds[3 + ax]);
      step[ax] = fmaxf(hi - lo[ax], 1e-6f) / (float)kCells;
    }
  }
  __syncthreads();
  const float* f = a.f[pl.cur];
  const int* iv = a.i[pl.cur];
  const size_t s = (size_t)a.stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned short* wc = cnt + warp * k1;
  const int base = b * kTile + warp * 32 * kItems;
  int key[kItems], rk[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = base + j * 32 + lane;
    const bool in = e < n;
    int k = k1;  // outside the array: a key of its own, never counted
    if (in) k = pl.compact ? wf_sort_key(a, f, iv, s, e, lo, step)
                           : (f[WLIVE * s + e] > 0.5f ? 0 : 1);
    const unsigned int peers = __match_any_sync(0xffffffffu, k);
    int r = 0;
    if (in) r = wc[k] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    // The group's highest lane adds the group's size.
    if (in && (peers >> lane) == 1u) wc[k] = (unsigned short)(wc[k] + __popc(peers));
    __syncwarp();
    key[j] = k;
    rk[j] = r;
  }
  __syncthreads();
  // Each key's count in warp order becomes the warps' offsets; the block's
  // total goes to the histogram.
  for (int k = threadIdx.x; k < k1; k += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * k1 + k];
      cnt[w * k1 + k] = (unsigned short)run;
      run += c;
    }
    a.hist[(size_t)k * nb + b] = run;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = base + j * 32 + lane;
    if (e < n) {
      a.keys[e] = (short)key[j];
      a.rank[e] = rk[j] + wc[key[j]];
    }
  }
}

// Pass 2: the exclusive scan of the histogram, in place, in one block.
__global__ void __launch_bounds__(kScanThreads) wf_scan_kernel(const WfPart a) {
  __shared__ int part[kScanThreads];
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!wf_active(pl)) return;
  const int nb = (pl.n + kTile - 1) / kTile;
  const long long total = (long long)(wf_live_keys(a, pl) + 1) * nb;
  const long long chunk = (total + kScanThreads - 1) / kScanThreads;
  const long long lo = (long long)threadIdx.x * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;
  int sum = 0;
  for (long long i = lo; i < hi; ++i) sum += a.hist[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (long long i = lo; i < hi; ++i) {
    const int h = a.hist[i];
    a.hist[i] = run;
    run += h;
  }
}

// Pass 3: perm[destination] = slot.
__global__ void __launch_bounds__(kThreads) wf_perm_kernel(const WfPart a) {
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!wf_active(pl)) return;
  const int nb = (pl.n + kTile - 1) / kTile;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < pl.n; e += gridDim.x * blockDim.x) {
    a.perm[a.hist[(size_t)a.keys[e] * nb + e / kTile] + a.rank[e]] = e;
  }
}

// Pass 4 (a compaction): the state planes of slots perm[0 .. m) into the
// other buffer, m the live rays (the whole pool under regeneration, whose
// dead slots follow the live ones and are refilled in that order).
__global__ void __launch_bounds__(kThreads) wf_gather_kernel(const WfPart a) {
  const WfPlan pl = wf_plan(a.ctr, a.sched);
  if (!pl.compact) return;
  const int m = a.sched.regen ? pl.n : pl.live;
  const size_t s = (size_t)a.stride;
  const float* sf = a.f[pl.cur];
  float* df = a.f[pl.cur ^ 1];
  const int* si = a.i[pl.cur];
  int* di = a.i[pl.cur ^ 1];
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < m; d += gridDim.x * blockDim.x) {
    const int e = a.perm[d];
#pragma unroll
    for (int r = 0; r < kWfPlanes; ++r) df[r * s + d] = sf[r * s + e];
    for (int r = 0; r < a.ni; ++r) di[r * s + d] = si[r * s + e];
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

int g_sms = 0;

int grid_for(int slots) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms < 1) g_sms = 1;
  }
  const int need = (slots + kThreads - 1) / kThreads;
  const int fill = g_sms * (2048 / kThreads);
  return need < fill ? (need > 0 ? need : 1) : fill;
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
// perm[live ..).  Scratch: keys (stride i16), rank (stride i32), hist
// ((n_keys + 1) x ceil(stride / 2048) i32), bounds (6 u32, reset by
// grt_wf_advance).
extern "C" int grt_wf_partition(int* ctr, double compact_threshold, double refill_threshold,
                                int total, int p, int regen, int last, float* f0, float* f1,
                                int* i0, int* i1, int ni, int stride, int sort, int bucket,
                                int n_keys, short* keys, int* rank, int* hist, int* perm,
                                unsigned int* bounds, void* stream) {
  if (stride <= 0) return 0;
  if (n_keys < 1 || n_keys > 2048 || ni < 2 || ni > 4 || sort < 0 || sort > kSortLive) return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WfPart a = {ctr, {compact_threshold, refill_threshold, total, p, regen, last},
                    {f0, f1}, {i0, i1}, ni, stride, sort, bucket, n_keys, keys, rank, hist,
                    perm, bounds};
  const int grid = grid_for(stride);
  if (sort == kSortSpatial) wf_bounds_kernel<<<grid, kThreads, 0, s>>>(a);
  const size_t smem = (size_t)kWarps * (n_keys + 1) * sizeof(unsigned short);
  wf_keys_kernel<<<(stride + kTile - 1) / kTile, kThreads, smem, s>>>(a);
  wf_scan_kernel<<<1, kScanThreads, 0, s>>>(a);
  wf_perm_kernel<<<grid, kThreads, 0, s>>>(a);
  wf_gather_kernel<<<grid, kThreads, 0, s>>>(a);
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
