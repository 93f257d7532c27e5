// What the wavefront engine's kernels share (megakernel.cu: the bounce and
// ray-generation kernels; wavefront.cu: the partition and the loop's step):
// the state plane layout, the loop's device-resident counts, and the rule
// that decides, from those counts alone, what one iteration of the loop
// does.  Every kernel of an iteration evaluates the same rule on the same
// counts, and only the last one (wf_advance_kernel) changes them, so the
// host enqueues a fixed schedule and never reads a count between bounces.
#pragma once

#include <cuda_runtime.h>

// Rows of the (16, stride) f32 state planes: origin, direction, throughput,
// radiance so far, prev_diffuse, prev_cos, live, rays traced so far.
enum WfPlane {
  WOX = 0, WOY, WOZ, WDX, WDY, WDZ, WTR, WTG, WTB, WRR, WRG, WRB, WPD, WPC, WLIVE, WRAYS,
  kWfPlanes
};
// Rows of the (2-4, stride) i32 planes: global pixel id, local pixel index
// (-1: no ray), the ray's absolute sample (batched samples and
// regeneration), its bounce (regeneration).
enum WfInt { WPID = 0, WPIX, WSMP, WBNC };

// The i32 counts of one ray array (ops/cuda/wavefront.py::CTR_*): its slot
// count, the rays alive after the last bounce (the bounce kernel adds its
// survivors), which of the two state buffers holds the rays, the stream
// cursor of a regenerating pool, whether the loop is over, and the live
// rays entering the next bounce.
enum WfCtr { kCtrN = 0, kCtrLive, kCtrCur, kCtrNxt, kCtrDone, kCtrEnter, kCtrWords = 8 };
// The i64 counts of a frame (wavefront.py::STAT_*): bounce launches that
// ran over rays, ray-generation launches that did, compactions, live
// ray-bounces.
enum WfStat { kStatBounce = 0, kStatRaygen, kStatCompact, kStatLiveBounces, kStatWords };

// Sort keys of a compaction (wavefront.py::SORTS).
enum WfSort { kSortOctant = 0, kSortOctantFlat, kSortSpatial, kSortLive };

// The launch constants of the rule: the compaction threshold, the refill
// threshold, the stream's length and the pool's size (regeneration), and
// whether this iteration's bounce is the last one (no compaction follows).
struct WfSched {
  double compact_threshold;
  double refill_threshold;
  int total;
  int p;
  int regen;
  int last;
};

// What one iteration does: nothing once the loop is over; else compact
// when live < compact_threshold * n (without regeneration only while rays
// live and another bounce follows); under regeneration refill k slots from
// the stream when refill_threshold of the pool died or the stream is about
// to drain (`rank`: the dead slots are ranked in place, no compaction).
struct WfPlan {
  bool done, compact, refill, rank;
  int n, live, cur, nxt, k;
};

__host__ __device__ inline WfPlan wf_plan(const int* ctr, const WfSched& s) {
  WfPlan pl = {};
  pl.n = ctr[kCtrN];
  pl.live = ctr[kCtrLive];
  pl.cur = ctr[kCtrCur];
  pl.nxt = ctr[kCtrNxt];
  pl.done = ctr[kCtrDone] != 0;
  if (pl.done) return pl;
  if (s.regen) {
    pl.compact = (double)pl.live < s.compact_threshold * (double)pl.n;
    const int avail = s.total - pl.nxt;
    const int dead = s.p - pl.live;
    pl.k = dead < avail ? dead : avail;
    pl.refill = pl.k > 0 && ((double)dead >= s.refill_threshold * (double)s.p || avail <= s.p);
    pl.rank = pl.refill && !pl.compact;
  } else {
    pl.compact = !s.last && pl.live > 0 &&
                 (double)pl.live < s.compact_threshold * (double)pl.n;
  }
  return pl;
}

// Floats as unsigned integers in the same order (for atomicMin/atomicMax on
// the live origins' bounding box), and back.
__device__ __forceinline__ unsigned int wf_ordered(float x) {
  const unsigned int u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float wf_unordered(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The bounding box before any live origin is seen: mins at 3.4e38, maxima
// at -3.4e38 (what _sort_rows_octant puts in place of dead rows).
__device__ __forceinline__ void wf_reset_bounds(unsigned int* bounds) {
  for (int ax = 0; ax < 3; ++ax) {
    bounds[ax] = wf_ordered(3.4e38f);
    bounds[3 + ax] = wf_ordered(-3.4e38f);
  }
}
