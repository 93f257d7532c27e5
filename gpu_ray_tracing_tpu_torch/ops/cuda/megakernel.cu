// Path-tracing megakernel for Hopper (sm_90a): warps that regenerate paths
// (render_kernel), one thread per pixel over a staged sphere table for the
// AOV modes (render_aov_kernel), or a thread block cluster per tile for the
// adaptive spp loop (render_adaptive_kernel).
//
// Replaces the Pallas TPU kernel gpu_ray_tracing_tpu/ops/pallas/megakernel.py
// `_kernel` (launched by `render_pallas`) on its K1a-K1f paths: spheres by
// the brute-force closest-hit scan (K1a) or through a sphere BVH (K1c),
// triangle meshes behind a threaded BVH, flat or smooth shaded (K1d);
// next-event estimation toward sphere lights (cone sampling) and triangle
// lights (area sampling) with MIS power-heuristic weights, an any-hit
// shadow query and the > 4-light pick (K1b); the independent, stratified
// and Owen-scrambled Sobol samplers (K1e); the fixed spp loop, the
// normal/albedo/depth AOV modes, Russian roulette and the per-sample clamp;
// the adaptive spp loop with its exact resume, the spp map and the in-kernel
// ray counters (K1f).  In the fixed loop a warp's lanes trace (pixel,
// sample) items of its pixels, each lane taking the next item as soon as
// its path ends, and fold each pixel's samples in sample order into one RGB
// triple (and its ray count); the adaptive loop keeps its six state planes
// in device memory, and its warps regenerate paths the same way within a
// run of samples (render_adaptive_kernel below).
//
// What bounds it on this card: arithmetic on small scenes, scattered loads
// on large ones.  The brute scan tests every sphere (17 flops each, and 6
// more for the roots where the ray may hit it; N = 197 for the One-Weekend
// scene); the scene is a few KB that every thread of a warp reads at the
// same address, so loads are broadcasts out of shared memory or L1.  A BVH
// walk is one cursor per thread (the TPU walked one per tile and descended
// when any lane overlapped): threads of a warp visit different nodes, so
// node and triangle loads scatter through L1/L2 (a 81,920-face mesh table
// is 10 MB, inside the 50 MB L2).  NEE adds one shadow query per light and
// diffuse vertex; it ends at the first blocker, and only threads whose
// sample is otherwise valid start one.  Divergence is the other cost: in a
// loop of one thread per pixel a thread whose path ended idles until its
// warp's deepest path ends, which render_kernel avoids by regenerating
// paths per warp.  It stages its finished samples in shared memory and,
// on a brute-scan scene of at most 1,024 spheres or a small BVH scene, the
// scene itself (the staged routes: spheres, nodes and faces copied once a
// launch, the roots of missed spheres skipped; the global walk otherwise).
// It is built with -fmad=false and without fast math, so the compiler
// contracts nothing on its own.  Fused multiply-adds appear only where
// written (fmaf), where the reference's own rounding (XLA:CPU contracts
// a*b+c, and the goldens carry that) decides grazing hits,
// self-intersections and shadow rays: the ray generation, the sphere
// quadratic, Moller-Trumbore, hit points and the NEE sample directions, as
// the plain version (ops/integrators.py) writes them.
//
// Counter-based RNG: every draw is a pure function of (global pixel id,
// sample index, frame seed, salt), bit-exact with ops/rng.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "launch.cuh"
#include "wavefront.cuh"

namespace {

// Rows of the (16, N) scene planes (ops/cuda/megakernel.py::scene_planes).
enum SceneRow { CX = 0, CY, CZ, RAD, C2R2, ALR, ALG, ALB, KIND, PARAM, ACTIVE, LIGHTID };

// Rows of the (8, L) sphere-light and (16, T) triangle-light planes
// (megakernel.py::lights_planes, tri_lights_planes).
enum LightRow { LCX = 0, LCY, LCZ, LRAD, LER, LEG, LEB };
enum TriLightRow { TLV0 = 0, TLE1 = 3, TLE2 = 6, TLN = 9, TLAREA = 12, TLE = 13 };

// Slots of the (1, 24) camera vector (megakernel.py::camera_vector).
enum CamSlot {
  CENTER = 0, UPPER_LEFT = 3, PDU = 6, PDV = 9, DISK_U = 12, DISK_V = 15,
  DEFOCUS_ANGLE = 18
};

// GUIDES is render_aov_kernel's alone: the albedo, normal and depth planes
// of one closest hit per sample (megakernel.py::render_guides).
enum Mode { PATH = 0, NORMAL = 1, ALBEDO = 2, DEPTH = 3, GUIDES = 4 };

constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ unsigned int wgsl_hash(unsigned int s) {
  s ^= 2747636419u;
  s *= 2654435769u;
  s ^= s >> 16;
  s *= 2654435769u;
  s ^= s >> 16;
  s *= 2654435769u;
  return s;
}

__device__ __forceinline__ unsigned int hash2(unsigned int seed, unsigned int salt) {
  return wgsl_hash(seed + salt * 0x68E31DA4u);
}

// Top 24 bits / 2^24: exact in f32, part of the stream.
__device__ __forceinline__ float uniform_hash(unsigned int seed, unsigned int salt) {
  return (float)(hash2(seed, salt) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ unsigned int hash_pixel_seeds(
    unsigned int pid, unsigned int sample, unsigned int frame_seed) {
  return wgsl_hash(pid * 2654435761u ^ wgsl_hash(sample * 0x85EBCA6Bu + frame_seed));
}

// The stratified and Sobol samplers of ops/rng.py (`sampler_uniforms`):
// one dimension pair (u1, u2) of absolute sample s, remapped per (pixel,
// frame, pair id `salt`).  Two knobs round as jitted XLA rounds what the
// callers do next (ops/rng.py::stratified_uniforms): `shift` is subtracted
// in one fused multiply-add with the stratified scaling (the AA jitter's
// 0.5), and `y_scale` multiplies u2, folded into its 1/ky (the lens
// angle's 2 pi).  `base0` is the pixel's sample-0 seed,
// hash_pixel_seeds(pid, 0, frame_seed).
enum SamplerKind { INDEPENDENT = 0, STRATIFIED = 1, SOBOL = 2 };

struct Sampler {
  int kind;
  int kx, ky;  // stratified grid
  int nbits;   // Sobol index bits
};

// Laine-Karras permutation (Burley, JCGT 2020).
__device__ __forceinline__ unsigned int laine_karras(unsigned int x, unsigned int seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ float msb_to_unit(unsigned int bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ void sampler_uniforms(const Sampler& sm, unsigned int base0, unsigned int s,
                                 unsigned int salt, float& u1, float& u2,
                                 float shift = 0.0f, float y_scale = 1.0f) {
  if (sm.kind == STRATIFIED && sm.kx * sm.ky > 1) {
    const int k = sm.kx * sm.ky;
    // Sample s takes stratum (s + rot) mod K, jittered by (u1, u2);
    // division by kx, ky is a multiply by the f32 reciprocal, as jitted XLA
    // computes it.
    const float rot = fminf(floorf(uniform_hash(base0, salt) * (float)k), (float)(k - 1));
    float stratum = rot + (float)(s % (unsigned int)k);
    if (stratum >= (float)k) stratum = stratum - (float)k;
    const float inv_kx = 1.0f / (float)sm.kx;
    const float inv_ky = 1.0f / (float)sm.ky;
    const float cy = floorf(stratum * inv_kx);
    const float cx = stratum - cy * (float)sm.kx;
    u1 = fmaf(cx + u1, inv_kx, -shift);
    u2 = fmaf(cy + u2, inv_ky * y_scale, -shift);
    return;
  }
  if (sm.kind == SOBOL) {
    const unsigned int seed_x = hash2(base0, salt);
    const unsigned int seed_y = wgsl_hash(seed_x);
    // Dimension 0 is the bit-reversed index; dimension 1 XORs the direction
    // numbers v_0 = 2^31, v_{b+1} = v_b ^ (v_b >> 1) of the set bits.
    const unsigned int x = __brev(laine_karras(s, seed_x));
    unsigned int y1 = 0u, v = 0x80000000u;
    for (int b = 0; b < sm.nbits; ++b) {
      if ((s >> b) & 1u) y1 ^= v;
      v ^= v >> 1;
    }
    const unsigned int y = __brev(laine_karras(__brev(y1), seed_y));
    u1 = msb_to_unit(x);
    u2 = msb_to_unit(y);
  }
  u1 = u1 - shift;
  u2 = u2 * y_scale - shift;
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ Vec3 normalize3(Vec3 v) {
  float inv = rsqrtf(fmaxf(dot3(v, v), 1e-20f));
  return {v.x * inv, v.y * inv, v.z * inv};
}

__device__ __forceinline__ Vec3 reflect3(Vec3 d, Vec3 n) {
  float dn = dot3(d, n);
  return {d.x - 2.0f * dn * n.x, d.y - 2.0f * dn * n.y, d.z - 2.0f * dn * n.z};
}

struct Hit {
  bool hit;
  bool front;
  float t;  // 1.0 on a miss (a benign value, as in the Pallas kernel)
  Vec3 p, n;  // hit point, face normal flipped toward the ray
  float ar, ag, ab, kind, param;
  float lid;  // NEE light ordinal of the winning primitive, -1 if none
};

// Inner product as a chain of fused multiply-adds: the rounding XLA:CPU
// gives a 3-term dot or sum, which the committed goldens carry.
__device__ __forceinline__ float fdot3(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  return fmaf(az, bz, fmaf(ay, by, ax * bx));
}

// A threaded BVH as the kernels read it (ops/cuda/megakernel.py::bvh_nodes):
// two float4 records a node, one 32-byte sector, (min x, min y, min z, max
// x) and (max y, max z, miss link, start << kLeafCountBits | count) with the
// links' int bits: the BVH's bounds and links bit for bit.  An inner
// node's start is -1, which keeps the last word negative; a leaf holds at
// most 2^kLeafCountBits - 1 primitives from a start below 2^(31 -
// kLeafCountBits), which bvh_nodes checks before any launch.  bvh_nodes
// reads kLeafCountBits from this line (megakernel.py: LEAF_COUNT_BITS).
constexpr int kLeafCountBits = 8;
constexpr int kLeafCountMask = (1 << kLeafCountBits) - 1;

struct Bvh {
  const float4* node;  // (m, 2) records
  int m;               // node count; 0 when absent
};

// Slots of a (F, 32) mesh table row (megakernel.py::mesh_table).
enum TriSlot {
  TV0 = 0, TE1 = 3, TE2 = 6, TN0 = 9, TN1 = 12, TN2 = 15, TALB = 18, TKIND = 21,
  TPARAM = 22, TLID = 23
};
constexpr int kTriSlots = 32;

// What one path's BVH walks did, counted by the counting instances
// (kCount): the nodes visited (every node whose slab test ran, so a walk
// that misses the root box counts one) and the faces tested, closest-hit
// and shadow queries alike.  A Tally<false> counts nothing: its counts
// compile away, and the timed instances walk as they did without it.
template <bool kOn>
struct Tally {
  unsigned int nodes = 0u, faces = 0u;
  __device__ __forceinline__ void node() {
    if (kOn) ++nodes;
  }
  __device__ __forceinline__ void face(int k) {
    if (kOn) faces += (unsigned int)k;
  }
};

// Stackless walk of a threaded BVH (`_traverse_bvh`, megakernel.py:273),
// one cursor per thread: a node whose slab interval overlaps the thread's
// window (t_min, tb) descends to node + 1, or runs `leaf(start, count)` if
// it is a leaf; otherwise the cursor follows the miss link, and -1 ends the
// walk.  `tb` is read at every node, so the window shrinks as leaves find
// hits; a leaf that returns true ends the walk (the any-hit query).  The
// entry test clamps tn to t_min first (megakernel.py:316-317).  A node is
// its two records, read at once: from device memory through the read-only
// cache (two LDG.128 of one sector), or from render_kernel's shared-memory
// stage (kShared, two LDS.128).  `tally` counts each node visited.
template <bool kShared = false, class Leaf, class W>
__device__ __forceinline__ void walk_nodes(const float4* nodes, Vec3 o, Vec3 inv, float t_min,
                                           const float& tb, W& tally, Leaf leaf) {
  int node = 0;
  while (node >= 0) {
    tally.node();
    const float4 a = kShared ? nodes[2 * node] : __ldg(nodes + 2 * node);
    const float4 b = kShared ? nodes[2 * node + 1] : __ldg(nodes + 2 * node + 1);
    const float t0x = (a.x - o.x) * inv.x;
    const float t0y = (a.y - o.y) * inv.y;
    const float t0z = (a.z - o.z) * inv.z;
    const float t1x = (a.w - o.x) * inv.x;
    const float t1y = (b.x - o.y) * inv.y;
    const float t1z = (b.y - o.z) * inv.z;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const float tn_eff = fmaxf(tn, t_min);
    const bool enter = (tf >= tn_eff) & (tn_eff < tb);
    const int link = __float_as_int(b.w);
    if (enter & (link >= 0)) {
      if (leaf(link >> kLeafCountBits, link & kLeafCountMask)) return;
    }
    node = (enter & (link < 0)) ? node + 1 : __float_as_int(b.z);
  }
}

// 1 / d with |d| < 1e-20 replaced by 1e-20 (megakernel.py:283): a zero
// component would give 0 * inf = NaN slabs.
__device__ __forceinline__ Vec3 safe_inverse(Vec3 d) {
  const auto inv = [](float v) { return 1.0f / (fabsf(v) < 1e-20f ? 1e-20f : v); };
  return {inv(d.x), inv(d.y), inv(d.z)};
}

// Ray terms of the sphere quadratic, shared by every sphere of one scan.
struct SphereRay {
  float a, inv_a, od, oo;
};

// Shrinking-window scan of spheres [j0, j1) (wgsl:164-221): the quadratic
// of `_sphere_root` (megakernel.py:530) with its far-root fallback.  A ray
// that leaves a surface starts with |o - c|^2 - r^2 near 0, so the last
// bits of this quadratic decide self-intersections; its inner products and
// discriminant round as fused multiply-adds, like the reference renders
// (ops/intersect.py::_sphere_roots), and it forms |c|^2 - r^2 in-kernel the
// same way instead of reading the C2R2 row.  The brute scan runs it over
// all spheres, the sphere-BVH walk over each entered leaf.
// Sphere j against the window (t_min, tb): true with its root when hit.
__device__ __forceinline__ bool sphere_root(const float* __restrict__ sc, int n, int j,
                                            float t_min, Vec3 o, Vec3 d, const SphereRay& r,
                                            float tb, float& root) {
  const float cx = __ldg(sc + CX * n + j);
  const float cy = __ldg(sc + CY * n + j);
  const float cz = __ldg(sc + CZ * n + j);
  const float rj = __ldg(sc + RAD * n + j);
  const float c2r2 = fdot3(cx, cy, cz, cx, cy, cz) - rj * rj;
  const float h = fdot3(d.x, d.y, d.z, cx, cy, cz) - r.od;
  const float cc = c2r2 - 2.0f * fdot3(o.x, o.y, o.z, cx, cy, cz) + r.oo;
  const float disc = fmaf(h, h, -(r.a * cc));
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float rn = (h - sq) * r.inv_a;
  const float rf = (h + sq) * r.inv_a;
  const bool nok = (rn > t_min) & (rn < tb);
  const bool fok = (rf > t_min) & (rf < tb);
  root = nok ? rn : rf;
  return (disc >= 0.0f) & (nok | fok) & (__ldg(sc + ACTIVE * n + j) > 0.0f);
}

__device__ __forceinline__ void sphere_scan(const float* __restrict__ sc, int n, int j0,
                                            int j1, float t_min, Vec3 o, Vec3 d,
                                            const SphereRay& r, float& tb, int& best) {
  for (int j = j0; j < j1; ++j) {
    float root;
    if (sphere_root(sc, n, j, t_min, o, d, r, tb, root)) {
      tb = root;
      best = j;
    }
  }
}

// The staged brute scan, shared by render_aov_kernel and
// wavefront_bounce_kernel: a block stages the active spheres of a brute-route
// scene in shared memory as float4 (cx, cy, cz, |c|^2 - r^2), formed with
// sphere_root's fdot3, in scene order with their scene index beside them
// (inactive spheres never win, so they are left out; ties and materials are
// unchanged).  A test is then one broadcast LDS.128 and the quadratic; a
// negative (or NaN) discriminant skips the root arithmetic, where
// sphere_root returns false, and the lanes that take it run sphere_root's
// operations in its order.  So the staged scans find sphere_scan's and
// sphere_root's hits, windows and winners bit for bit.
// A block is kThreads threads in full 32-lane warps (grt_render launches
// render_aov_kernel as (32, kStageThreads / 32), grt_wavefront_bounce
// kStageThreads, render_kernel kRegenWarps * 32): the staging's ballots and
// prefix sums count on it.
constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
static_assert(kStageThreads % 32 == 0 && kStageThreads <= 1024, "whole warps, one block");
constexpr int kStageSpheres = 1024;  // 16 KB of spheres and 4 KB of indices a block

// Stage the active spheres of [j0, j1) in scene order: s_sph[k] = (cx,
// cy, cz, |c|^2 - r^2) and s_idx[k] = the scene index.  Returns the count.
// Every thread of the block calls it (it meets __syncthreads), and the
// staged table is visible to all when it returns.  s_warp holds a count
// for each of the block's kThreads / 32 warps.
template <int kThreads = kStageThreads>
__device__ __forceinline__ int stage_spheres(const float* __restrict__ sc, int n, int j0,
                                             int j1, float4* s_sph, int* s_idx,
                                             int* s_warp) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int count = 0;
  for (int base = j0; base < j1; base += kThreads) {
    const int j = base + tid;
    const bool act = j < j1 && __ldg(sc + ACTIVE * n + j) > 0.0f;
    const unsigned int vote = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_warp[warp] = __popc(vote);
    __syncthreads();
    int below = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      below += w < warp ? c : 0;
      total += c;
    }
    if (act) {
      const int k = count + below + __popc(vote & ((1u << lane) - 1u));
      const float cx = __ldg(sc + CX * n + j);
      const float cy = __ldg(sc + CY * n + j);
      const float cz = __ldg(sc + CZ * n + j);
      const float rj = __ldg(sc + RAD * n + j);
      s_sph[k] = make_float4(cx, cy, cz, fdot3(cx, cy, cz, cx, cy, cz) - rj * rj);
      s_idx[k] = j;
    }
    count += total;
    __syncthreads();  // the table is complete; s_warp may be reused
  }
  return count;
}

// sphere_scan over a staged table: the same window, roots and winner (the
// winner's scene index is read once, after the scan).  Unrolled by 8: the
// loads and quadratics of 8 spheres go out ahead of their branches (the
// fastest of 1, 4 and 8 on the H100; PERF.md, K1g).
__device__ __forceinline__ void staged_scan(const float4* s_sph, const int* s_idx, int count,
                                            float t_min, Vec3 o, Vec3 d, const SphereRay& r,
                                            float& tb, int& best) {
  int k_best = -1;
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const float4 s = s_sph[k];
    const float h = fdot3(d.x, d.y, d.z, s.x, s.y, s.z) - r.od;
    const float cc = s.w - 2.0f * fdot3(o.x, o.y, o.z, s.x, s.y, s.z) + r.oo;
    const float disc = fmaf(h, h, -(r.a * cc));
    if (disc >= 0.0f) {
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float rn = (h - sq) * r.inv_a;
      const float rf = (h + sq) * r.inv_a;
      const bool nok = (rn > t_min) & (rn < tb);
      const bool fok = (rf > t_min) & (rf < tb);
      if (nok | fok) {
        tb = nok ? rn : rf;
        k_best = k;
      }
    }
  }
  if (k_best >= 0) best = s_idx[k_best];
}

// The any-hit twin of staged_scan (occluded's sphere loop): true at the
// first staged sphere with a root in (t_min, window).
__device__ __forceinline__ bool staged_any_hit(const float4* s_sph, int count, float t_min,
                                               Vec3 o, Vec3 d, const SphereRay& r,
                                               float window) {
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const float4 s = s_sph[k];
    const float h = fdot3(d.x, d.y, d.z, s.x, s.y, s.z) - r.od;
    const float cc = s.w - 2.0f * fdot3(o.x, o.y, o.z, s.x, s.y, s.z) + r.oo;
    const float disc = fmaf(h, h, -(r.a * cc));
    if (disc >= 0.0f) {
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float rn = (h - sq) * r.inv_a;
      const float rf = (h + sq) * r.inv_a;
      if (((rn > t_min) & (rn < window)) | ((rf > t_min) & (rf < window))) return true;
    }
  }
  return false;
}

// The sphere stage of wavefront_bounce_kernel and of render_kernel's brute
// route, in the block's dynamic shared memory (wf_stage_bytes(n) of it for
// a scene of n spheres): the staged count in the first 16 bytes, then up to
// n float4 spheres and n scene indices.
constexpr size_t wf_stage_bytes(int n) { return 16 + 20 * (size_t)n; }

__device__ __forceinline__ float4* wf_stage() {
  extern __shared__ float4 wf_stage_mem[];
  return wf_stage_mem;
}

__device__ __forceinline__ int& wf_stage_count() {
  return *reinterpret_cast<int*>(wf_stage());
}

__device__ __forceinline__ int* wf_stage_index(int n) {
  return reinterpret_cast<int*>(wf_stage() + 1 + n);
}

// Moller-Trumbore on face j of the mesh table (`_tri_intersect`,
// megakernel.py:439-470): determinant guard 1e-12, u, v >= 0, u + v <= 1,
// t_min < t < tb.  The cross and inner products round as fused
// multiply-adds, as the reference renders them (ops/rounding.py::cross,
// dot3).  A winner keeps its barycentrics for the smooth normal.
// Its arithmetic on a face's three records (v0, e1, e2: slots 0-11 of
// its table row), wherever they were read from (tri_test: the face
// records in device memory; staged_tri: the BVH stage).
__device__ __forceinline__ bool tri_rows(float4 r0, float4 r1, float4 r2, float t_min, Vec3 o,
                                         Vec3 d, float tb, float& t_out, float& u_out,
                                         float& v_out) {
  const Vec3 v0 = {r0.x, r0.y, r0.z};
  const Vec3 e1 = {r0.w, r1.x, r1.y};
  const Vec3 e2 = {r1.z, r1.w, r2.x};
  const Vec3 pv = {fmaf(d.y, e2.z, -(d.z * e2.y)), fmaf(d.z, e2.x, -(d.x * e2.z)),
                   fmaf(d.x, e2.y, -(d.y * e2.x))};
  const float det = fdot3(e1.x, e1.y, e1.z, pv.x, pv.y, pv.z);
  const bool near_parallel = fabsf(det) < 1e-12f;
  const float inv_det = 1.0f / (near_parallel ? 1.0f : det);
  const Vec3 tv = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
  const float u = fdot3(tv.x, tv.y, tv.z, pv.x, pv.y, pv.z) * inv_det;
  const Vec3 qv = {fmaf(tv.y, e1.z, -(tv.z * e1.y)), fmaf(tv.z, e1.x, -(tv.x * e1.z)),
                   fmaf(tv.x, e1.y, -(tv.y * e1.x))};
  const float v = fdot3(d.x, d.y, d.z, qv.x, qv.y, qv.z) * inv_det;
  const float t = fdot3(e2.x, e2.y, e2.z, qv.x, qv.y, qv.z) * inv_det;
  t_out = t;
  u_out = u;
  v_out = v;
  return !near_parallel & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > t_min) &
         (t < tb);
}

// Face j of the (n_tris, 3) face records (megakernel.py::face_records): a
// leaf's faces are consecutive records, 48 bytes a face.
__device__ __forceinline__ bool tri_test(const float4* __restrict__ faces, int j, float t_min,
                                         Vec3 o, Vec3 d, float tb, float& t_out,
                                         float& u_out, float& v_out) {
  const float4* f = faces + 3 * j;
  return tri_rows(__ldg(f), __ldg(f + 1), __ldg(f + 2), t_min, o, d, tb, t_out, u_out, v_out);
}

// The closest-hit scan of faces [j0, j1): their records are loaded two
// faces at a time, then tested in order, so that a leaf's faces cost half
// the round trips to L2 (config 4's face tests took 0.32 of 0.84 ms one
// load after another; four at a time spilled; PERF.md, K1d).  The tests,
// windows and winner are tri_test's, one face after another.
__device__ __forceinline__ void tri_scan(const float4* __restrict__ faces, int j0, int j1,
                                         float t_min, Vec3 o, Vec3 d, float& tb, int& best,
                                         float& bu, float& bv) {
  for (int j = j0; j < j1; j += 2) {
    const float4* f = faces + 3 * j;
    const bool two = j + 1 < j1;
    const float4 a0 = __ldg(f), a1 = __ldg(f + 1), a2 = __ldg(f + 2);
    const float4 b0 = two ? __ldg(f + 3) : a0, b1 = two ? __ldg(f + 4) : a1,
                 b2 = two ? __ldg(f + 5) : a2;
    float t, u, v;
    if (tri_rows(a0, a1, a2, t_min, o, d, tb, t, u, v)) {
      tb = t;
      best = j;
      bu = u;
      bv = v;
    }
    if (two && tri_rows(b0, b1, b2, t_min, o, d, tb, t, u, v)) {
      tb = t;
      best = j + 1;
      bu = u;
      bv = v;
    }
  }
}

struct Geometry {
  const float* scene;  // (16, n) sphere planes
  int n;
  Bvh sphere_bvh;      // over the reordered spheres, or m = 0: brute scan
  const float* mesh;   // (n_tris, 32) table (the winner's shading), or null
  const float4* faces; // (n_tris, 3) face records (the tests), or null
  int n_tris;
  bool smooth;
  Bvh mesh_bvh;
};

// Where closest_hit and occluded read the geometry: the global arrays, the
// sphere stage of the brute route (wf_stage: wavefront_bounce_kernel's and
// render_kernel's), or render_kernel's BVH stage (bvh_stage below).
enum Stage { kGlobal = 0, kSphereStage = 1, kBvhStage = 2 };

// render_kernel's BVH stage: a block copies a small BVH scene (its spheres,
// BVH nodes and faces) into its dynamic shared memory once a launch, and
// every walk of the launch reads it there: a node is two LDS.128 instead
// of two LDG.128, a sphere one instead of five scalar loads, a face three
// LDS.128.  The layout, in float4 records from the stage's base:
//   spheres       [0, n)              (cx, cy, cz, |c|^2 - r^2), in scene
//                                     (on a sphere BVH: leaf) order
//   sphere nodes  [n, n + 2 ms)       two records a node (below)
//   faces         [.., + 3 F)         slots 0-11 of the mesh table row
//                                     (v0, e1, e2 and 3 unread slots)
//   mesh nodes    [.., + 2 mm)
// A node is its two device-memory records (Bvh) and a face its three
// (face_records), copied as they are.  |c|^2 - r^2 is sphere_root's, formed with
// the same fdot3; an inactive sphere (ACTIVE not > 0, which sphere_root
// tests) gets a NaN there instead, so its discriminant is NaN, fails
// `disc >= 0` and the sphere never wins, as in sphere_root.
// ops/cuda/megakernel.py::bvh_stage_bytes decides the route from the same
// counts; grt_render refuses a stage of other bytes.
constexpr int kBvhStageBytes = 16384;

__host__ __device__ constexpr size_t bvh_stage_bytes(int n, int ms, int n_tris, int mm) {
  return 16 * ((size_t)n + 2 * (size_t)ms + 3 * (size_t)n_tris + 2 * (size_t)mm);
}

__device__ __forceinline__ float4* bvh_stage_mem() {
  extern __shared__ float4 bvh_stage_base[];
  return bvh_stage_base;
}

struct BvhStage {
  const float4* sph;    // spheres
  const float4* snode;  // sphere-BVH nodes
  const float4* tri;    // faces
  const float4* mnode;  // mesh-BVH nodes
};

__device__ __forceinline__ BvhStage bvh_stage(const Geometry& g) {
  const float4* base = bvh_stage_mem();
  BvhStage s;
  s.sph = base;
  s.snode = s.sph + g.n;
  s.tri = s.snode + 2 * g.sphere_bvh.m;
  s.mnode = s.tri + 3 * g.n_tris;
  return s;
}

// Copy n records into the stage: the threads of the block stride over them.
__device__ __forceinline__ void stage_records(const float4* src, int n, float4* dst) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// Stage the scene of a block (a 1-D block: the threads stride over the
// records; no ballots, so any block shape will do).  Every thread of the
// block calls it once, before any walk, and meets its barrier.
__device__ __forceinline__ void stage_bvh(const Geometry& g) {
  float4* const base = bvh_stage_mem();
  const float* sc = g.scene;
  const int n = g.n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float cx = __ldg(sc + CX * n + j);
    const float cy = __ldg(sc + CY * n + j);
    const float cz = __ldg(sc + CZ * n + j);
    const float rj = __ldg(sc + RAD * n + j);
    const bool act = __ldg(sc + ACTIVE * n + j) > 0.0f;
    base[j] = make_float4(cx, cy, cz,
                          act ? fdot3(cx, cy, cz, cx, cy, cz) - rj * rj : __int_as_float(0x7fffffff));
  }
  stage_records(g.sphere_bvh.node, 2 * g.sphere_bvh.m, base + n);
  float4* const tri = base + n + 2 * g.sphere_bvh.m;
  stage_records(g.faces, 3 * g.n_tris, tri);
  stage_records(g.mesh_bvh.node, 2 * g.mesh_bvh.m, tri + 3 * g.n_tris);
  __syncthreads();
}

// sphere_scan over staged spheres [j0, j1), each sphere c = (cx, cy, cz,
// |c|^2 - r^2): sphere_root's quadratic, window and root pick, in its
// order.  A negative or NaN discriminant skips the roots: sphere_root
// returns false there whatever the roots are (its result is a conjunction
// with disc >= 0), so the skip is exact.
__device__ __forceinline__ void staged_range(const float4* s, int j0, int j1, float t_min,
                                             Vec3 o, Vec3 d, const SphereRay& r, float& tb,
                                             int& best) {
  for (int j = j0; j < j1; ++j) {
    const float4 c = s[j];
    const float h = fdot3(d.x, d.y, d.z, c.x, c.y, c.z) - r.od;
    const float cc = c.w - 2.0f * fdot3(o.x, o.y, o.z, c.x, c.y, c.z) + r.oo;
    const float disc = fmaf(h, h, -(r.a * cc));
    if (disc >= 0.0f) {
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float rn = (h - sq) * r.inv_a;
      const float rf = (h + sq) * r.inv_a;
      const bool nok = (rn > t_min) & (rn < tb);
      const bool fok = (rf > t_min) & (rf < tb);
      if (nok | fok) {
        tb = nok ? rn : rf;
        best = j;
      }
    }
  }
}

// The any-hit twin (occluded's sphere loop): true at the first staged
// sphere of [j0, j1) with a root in (t_min, window).
__device__ __forceinline__ bool staged_range_any(const float4* s, int j0, int j1, float t_min,
                                                 Vec3 o, Vec3 d, const SphereRay& r,
                                                 float window) {
  for (int j = j0; j < j1; ++j) {
    const float4 c = s[j];
    const float h = fdot3(d.x, d.y, d.z, c.x, c.y, c.z) - r.od;
    const float cc = c.w - 2.0f * fdot3(o.x, o.y, o.z, c.x, c.y, c.z) + r.oo;
    const float disc = fmaf(h, h, -(r.a * cc));
    if (disc >= 0.0f) {
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float rn = (h - sq) * r.inv_a;
      const float rf = (h + sq) * r.inv_a;
      if (((rn > t_min) & (rn < window)) | ((rf > t_min) & (rf < window))) return true;
    }
  }
  return false;
}

// tri_test on staged face j.  It tests every conjunct, as tri_test does:
// leaving after u where u cannot hit, exact as that is, made the Cornell
// box slower on the H100 (PERF.md, K1b): a branch per lane in a leaf
// whose lanes seldom all leave.
__device__ __forceinline__ bool staged_tri(const float4* f, int j, float t_min, Vec3 o,
                                           Vec3 d, float tb, float& t_out, float& u_out,
                                           float& v_out) {
  return tri_rows(f[3 * j], f[3 * j + 1], f[3 * j + 2], t_min, o, d, tb, t_out, u_out, v_out);
}

// Closest hit over spheres, then mesh, in one record (`_closest_hit`,
// megakernel.py:632-761): the mesh walk starts from the sphere stage's
// window, so a face wins only strictly closer, as in
// ops/integrators.py::intersect_scene.
__device__ __forceinline__ SphereRay sphere_ray(Vec3 o, Vec3 d) {
  SphereRay sr;
  sr.a = fdot3(d.x, d.y, d.z, d.x, d.y, d.z);
  sr.inv_a = 1.0f / sr.a;
  sr.od = fdot3(o.x, o.y, o.z, d.x, d.y, d.z);
  sr.oo = fdot3(o.x, o.y, o.z, o.x, o.y, o.z);
  return sr;
}

// kStage: kSphereStage scans the block's sphere stage (wf_stage),
// kBvhStage walks render_kernel's BVH stage (bvh_stage), not the scene
// planes and mesh table; the winner's material is still read from those.  `tally`
// counts the walks' nodes and the faces of every leaf entered.
template <int kStage = kGlobal, class W>
__device__ Hit closest_hit(const Geometry& g, float t_min, float t_max, Vec3 o, Vec3 d,
                           W& tally) {
  const SphereRay sr = sphere_ray(o, d);
  float tb = t_max;
  int best = -1;
  const float* sc = g.scene;
  const int n = g.n;
  const Vec3 inv = safe_inverse(d);
  const BvhStage st = kStage == kBvhStage ? bvh_stage(g) : BvhStage{};
  if (kStage == kSphereStage) {
    staged_scan(wf_stage() + 1, wf_stage_index(n), wf_stage_count(), t_min, o, d, sr, tb,
                best);
  } else if (kStage == kBvhStage && g.sphere_bvh.m > 0) {
    walk_nodes<true>(st.snode, o, inv, t_min, tb, tally, [&](int start, int count) {
      staged_range(st.sph, start, start + count, t_min, o, d, sr, tb, best);
      return false;
    });
  } else if (kStage == kBvhStage) {
    staged_range(st.sph, 0, n, t_min, o, d, sr, tb, best);
  } else if (g.sphere_bvh.m > 0) {
    walk_nodes(g.sphere_bvh.node, o, inv, t_min, tb, tally, [&](int start, int count) {
      sphere_scan(sc, n, start, start + count, t_min, o, d, sr, tb, best);
      return false;
    });
  } else {
    sphere_scan(sc, n, 0, n, t_min, o, d, sr, tb, best);
  }
  int tri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (kStage == kBvhStage && g.n_tris > 0) {
    walk_nodes<true>(st.mnode, o, inv, t_min, tb, tally, [&](int start, int count) {
      tally.face(count);
      for (int j = start; j < start + count; ++j) {
        float t, u, v;
        if (staged_tri(st.tri, j, t_min, o, d, tb, t, u, v)) {
          tb = t;
          tri = j;
          bu = u;
          bv = v;
        }
      }
      return false;
    });
  } else if (g.n_tris > 0) {
    walk_nodes(g.mesh_bvh.node, o, inv, t_min, tb, tally, [&](int start, int count) {
      tally.face(count);
      tri_scan(g.faces, start, start + count, t_min, o, d, tb, tri, bu, bv);
      return false;
    });
  }

  Hit r;
  r.hit = tb < t_max;
  r.t = r.hit ? tb : 1.0f;  // a benign t for misses
  // o + t d rounded once, as the plain version (ops/intersect.py) and XLA:CPU
  // form it: the last bit decides whether the next ray leaves the surface.
  r.p = {fmaf(r.t, d.x, o.x), fmaf(r.t, d.y, o.y), fmaf(r.t, d.z, o.z)};
  r.ar = r.ag = r.ab = r.kind = r.param = 0.0f;
  r.lid = -1.0f;
  Vec3 nrm;
  if (tri >= 0) {
    const float* f = g.mesh + (size_t)tri * kTriSlots;
    r.ar = __ldg(f + TALB);
    r.ag = __ldg(f + TALB + 1);
    r.ab = __ldg(f + TALB + 2);
    r.kind = __ldg(f + TKIND);
    r.param = __ldg(f + TPARAM);
    r.lid = __ldg(f + TLID);
    if (g.smooth) {
      // Barycentric blend of the corner normals, renormalized once
      // (megakernel.py:501-505, 744-748).
      const float w0 = 1.0f - bu - bv;
      Vec3 s;
      s.x = w0 * __ldg(f + TN0) + bu * __ldg(f + TN1) + bv * __ldg(f + TN2);
      s.y = w0 * __ldg(f + TN0 + 1) + bu * __ldg(f + TN1 + 1) + bv * __ldg(f + TN2 + 1);
      s.z = w0 * __ldg(f + TN0 + 2) + bu * __ldg(f + TN1 + 2) + bv * __ldg(f + TN2 + 2);
      const float len = fmaxf(sqrtf(s.x * s.x + s.y * s.y + s.z * s.z), 1e-20f);
      nrm = {s.x / len, s.y / len, s.z / len};
    } else {
      nrm = {__ldg(f + TN0), __ldg(f + TN0 + 1), __ldg(f + TN0 + 2)};
    }
  } else {
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, rad = 0.0f;
    if (best >= 0) {
      cx = __ldg(sc + CX * n + best);
      cy = __ldg(sc + CY * n + best);
      cz = __ldg(sc + CZ * n + best);
      rad = __ldg(sc + RAD * n + best);
      r.ar = __ldg(sc + ALR * n + best);
      r.ag = __ldg(sc + ALG * n + best);
      r.ab = __ldg(sc + ALB * n + best);
      r.kind = __ldg(sc + KIND * n + best);
      r.param = __ldg(sc + PARAM * n + best);
      r.lid = __ldg(sc + LIGHTID * n + best);
    }
    // The outward normal (p - c) / r (wgsl:206).
    const float rs = rad != 0.0f ? rad : 1.0f;
    nrm = {(r.p.x - cx) / rs, (r.p.y - cy) / rs, (r.p.z - cz) / rs};
  }
  r.front = d.x * nrm.x + d.y * nrm.y + d.z * nrm.z < 0.0f;  // (wgsl:159)
  const float sign = r.front ? 1.0f : -1.0f;                  // (wgsl:160)
  r.n = {nrm.x * sign, nrm.y * sign, nrm.z * sign};
  return r;
}

// Any-hit shadow query (`_occluded`, megakernel.py:554-629): true when a
// sphere or face lies at t_min < t < window along o + t w.  It ends at the
// first blocker.  "No hit below the window" is the plain version's "nearest
// t >= window" (ops/integrators.py::nearest_t_scene).
// kStage and `tally` as in closest_hit; a face counts once tested.
template <int kStage = kGlobal, class W>
__device__ bool occluded(const Geometry& g, float t_min, Vec3 o, Vec3 w, float window,
                         W& tally) {
  if (!(window > t_min)) return false;
  const SphereRay sr = sphere_ray(o, w);
  const float* sc = g.scene;
  const int n = g.n;
  bool blocked = false;
  if (kStage == kBvhStage) {
    const BvhStage st = bvh_stage(g);
    const Vec3 inv = safe_inverse(w);
    if (g.sphere_bvh.m > 0) {
      walk_nodes<true>(st.snode, o, inv, t_min, window, tally, [&](int start, int count) {
        blocked = staged_range_any(st.sph, start, start + count, t_min, o, w, sr, window);
        return blocked;
      });
    } else {
      blocked = staged_range_any(st.sph, 0, n, t_min, o, w, sr, window);
    }
    if (!blocked && g.n_tris > 0) {
      walk_nodes<true>(st.mnode, o, inv, t_min, window, tally, [&](int start, int count) {
        for (int j = start; j < start + count; ++j) {
          float t, u, v;
          tally.face(1);
          if (staged_tri(st.tri, j, t_min, o, w, window, t, u, v)) {
            blocked = true;
            return true;
          }
        }
        return false;
      });
    }
    return blocked;
  }
  const auto spheres = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      float root;
      if (sphere_root(sc, n, j, t_min, o, w, sr, window, root)) return true;
    }
    return false;
  };
  const Vec3 inv = safe_inverse(w);
  if (kStage == kSphereStage) {
    blocked = staged_any_hit(wf_stage() + 1, wf_stage_count(), t_min, o, w, sr, window);
  } else if (g.sphere_bvh.m > 0) {
    walk_nodes(g.sphere_bvh.node, o, inv, t_min, window, tally, [&](int start, int count) {
      blocked = spheres(start, start + count);
      return blocked;
    });
  } else {
    blocked = spheres(0, n);
  }
  if (!blocked && g.n_tris > 0) {
    walk_nodes(g.mesh_bvh.node, o, inv, t_min, window, tally, [&](int start, int count) {
      for (int j = start; j < start + count; ++j) {
        float t, u, v;
        tally.face(1);
        if (tri_test(g.faces, j, t_min, o, w, window, t, u, v)) {
          blocked = true;
          return true;
        }
      }
      return false;
    });
  }
  return blocked;
}

// Vertical white->blue gradient (wgsl:293-296), `_sky` (megakernel.py:764).
__device__ __forceinline__ Vec3 sky(Vec3 d) {
  const float inv_len = rsqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  const float a = 0.5f * (d.y * inv_len + 1.0f);
  return {1.0f - 0.5f * a, 1.0f - 0.3f * a, 1.0f};
}

// Three-material scatter, `_scatter` (megakernel.py:780-866): (u1, u2) is
// the unit-vector pair (salts salt_base and +1, remapped by the sampler at
// bounce 0), u_reflect is drawn at salt_base + 2.  Only the hit material's
// BSDF is evaluated; the draws are pure functions of (seed, salt), so
// skipping unused ones changes nothing.  Returns false when the ray is
// absorbed.
__device__ __forceinline__ bool scatter(const Hit& h, Vec3 d, float u1, float u2,
                                        unsigned int seed, unsigned int salt_base,
                                        Vec3* out, Vec3* att) {
  const float kp = h.kind;
  const Vec3 n = h.n;
  if (kp >= 1.5f) {  // dielectric; param is the ior
    const float u_reflect = uniform_hash(seed, salt_base + 2u);
    const float ior = kp > 1.5f ? h.param : 1.5f;
    const float eta = h.front ? 1.0f / ior : ior;
    const Vec3 ud = normalize3(d);
    const float cos_t = fminf(-(ud.x * n.x + ud.y * n.y + ud.z * n.z), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = eta * sin_t > 1.0f;
    float r0 = (1.0f - eta) / (1.0f + eta);
    r0 = r0 * r0;
    const float om = 1.0f - cos_t;  // pow(1 - cos, 5) by squarings
    const float om2 = om * om;
    const float schlick = r0 + (1.0f - r0) * (om2 * om2 * om);
    Vec3 g;
    if (cannot | (schlick > u_reflect)) {
      g = reflect3(ud, n);
    } else {
      const Vec3 rp = {eta * (ud.x + cos_t * n.x), eta * (ud.y + cos_t * n.y),
                       eta * (ud.z + cos_t * n.z)};
      const float k = fmaxf(1.0f - (rp.x * rp.x + rp.y * rp.y + rp.z * rp.z), 0.0f);
      const float sk = sqrtf(k);
      g = {rp.x - sk * n.x, rp.y - sk * n.y, rp.z - sk * n.z};
    }
    *out = normalize3(g);
    *att = {1.0f, 1.0f, 1.0f};
    return true;
  }
  // Shared random unit vector for lambertian and metal fuzz.
  const float z = 2.0f * u1 - 1.0f;
  const float ang = u2 * kTwoPi;
  const float rr = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const Vec3 u = {rr * cosf(ang), rr * sinf(ang), z};
  *att = {h.ar, h.ag, h.ab};
  if (kp < 0.5f) {  // lambertian (wgsl:84-93), direction not normalized
    Vec3 l = {n.x + u.x, n.y + u.y, n.z + u.z};
    if (l.x * l.x + l.y * l.y + l.z * l.z < 1e-6f) l = n;
    *out = l;
    return true;
  }
  // metal (wgsl:95-100); param is the fuzz
  Vec3 r = normalize3(reflect3(d, n));
  r = {r.x + h.param * u.x, r.y + h.param * u.y, r.z + h.param * u.z};
  *out = normalize3(r);
  return r.x * n.x + r.y * n.y + r.z * n.z > 0.0f;
}

// Sphere and triangle lights for next-event estimation: (8, L) and (16, T)
// planes; L + T is the ordinal space (sphere lights first).
struct LightSet {
  const float* s;
  int L;
  const float* t;
  int T;
  __device__ float sph(int row, int l) const { return __ldg(s + row * L + l); }
  __device__ float tri(int row, int j) const { return __ldg(t + row * T + j); }
};

// The cancellation-free 1 - cos(half-angle) of a sphere's cone,
// (r2/d2) / (1 + sqrt(1 - r2/d2)), capped at 1 (`_one_minus_cos_max`,
// integrators.py:107-124).
__device__ __forceinline__ float one_minus_cos_max(float r2, float d2) {
  const float q = r2 / d2;
  return fminf(q / (1.0f + sqrtf(fminf(fmaxf(1.0f - q, 1e-12f), 1.0f))), 1.0f);
}

// cross(a, b) with each component rounded as fma(a1, b2, -(a2 b1)), as the
// plain version (ops/rounding.py::cross) and XLA:CPU round it.
__device__ __forceinline__ Vec3 fcross(Vec3 a, Vec3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// A light sample from shading point p (normal n): the direction, the
// shadow window before its 1e-3 shrink, the scan-independent validity,
// the estimator weight (also the MIS ratio p_b / p_nee) and the emission.
struct LightSample {
  Vec3 w;
  float reach;
  bool ok;
  float wgt;
  Vec3 le;
};

// Cone sample toward sphere light l (`_sphere_cand`, megakernel.py:1073;
// the arithmetic of ops/integrators.py::_sphere_candidate).
__device__ LightSample sphere_light_sample(const LightSet& ls, int l, Vec3 p, Vec3 n,
                                           float u1n, float u2n) {
  const Vec3 dc = {ls.sph(LCX, l) - p.x, ls.sph(LCY, l) - p.y, ls.sph(LCZ, l) - p.z};
  const float lr = ls.sph(LRAD, l);
  const float d2 = fdot3(dc.x, dc.y, dc.z, dc.x, dc.y, dc.z);
  const float d2s = fmaxf(d2, 1e-12f);
  const float r2 = lr * lr;
  const bool inside = d2 <= r2 * 1.0001f;
  const float omc = one_minus_cos_max(r2, d2s);
  const float cos_t = fmaf(-u1n, omc, 1.0f);
  const float sin_t = sqrtf(fmaxf(fmaf(-cos_t, cos_t, 1.0f), 0.0f));
  const float phi = u2n * kTwoPi;
  const float dl = sqrtf(d2s);
  const Vec3 wl = {dc.x / dl, dc.y / dl, dc.z / dl};
  const bool pick = fabsf(wl.x) > 0.9f;
  Vec3 ua = fcross({pick ? 0.0f : 1.0f, pick ? 1.0f : 0.0f, 0.0f}, wl);
  const float un = fmaxf(sqrtf(fdot3(ua.x, ua.y, ua.z, ua.x, ua.y, ua.z)), 1e-12f);
  ua = {ua.x / un, ua.y / un, ua.z / un};
  const Vec3 va = fcross(wl, ua);
  // cos/sin of phi rounded from double, as the plain version takes them.
  const float cp = (float)cos((double)phi) * sin_t;
  const float sp = (float)sin((double)phi) * sin_t;
  LightSample r;
  r.w = {fmaf(wl.x, cos_t, fmaf(ua.x, cp, va.x * sp)),
         fmaf(wl.y, cos_t, fmaf(ua.y, cp, va.y * sp)),
         fmaf(wl.z, cos_t, fmaf(ua.z, cp, va.z * sp))};
  const float cos_i = fdot3(n.x, n.y, n.z, r.w.x, r.w.y, r.w.z);
  const float h_l = fdot3(dc.x, dc.y, dc.z, r.w.x, r.w.y, r.w.z);
  const float disc = fmaf(h_l, h_l, -fmaf(-lr, lr, d2));
  r.reach = h_l - sqrtf(fmaxf(disc, 0.0f));
  r.ok = (cos_i > 0.0f) & !inside & (disc > 0.0f);
  r.wgt = cos_i * 2.0f * omc;
  r.le = {ls.sph(LER, l), ls.sph(LEG, l), ls.sph(LEB, l)};
  return r;
}

// Uniform-area sample on triangle light j, two-sided (`_tri_cand`,
// megakernel.py:1188; ops/integrators.py::_tri_candidate).
__device__ LightSample tri_light_sample(const LightSet& ls, int j, Vec3 p, Vec3 n,
                                        float u1n, float u2n) {
  const float su = sqrtf(u1n);
  const float b1 = 1.0f - su;
  const float b2 = u2n * su;
  Vec3 q;
  q.x = fmaf(b2, ls.tri(TLE2, j), fmaf(b1, ls.tri(TLE1, j), ls.tri(TLV0, j)));
  q.y = fmaf(b2, ls.tri(TLE2 + 1, j), fmaf(b1, ls.tri(TLE1 + 1, j), ls.tri(TLV0 + 1, j)));
  q.z = fmaf(b2, ls.tri(TLE2 + 2, j), fmaf(b1, ls.tri(TLE1 + 2, j), ls.tri(TLV0 + 2, j)));
  const Vec3 dc = {q.x - p.x, q.y - p.y, q.z - p.z};
  const float d2 = fdot3(dc.x, dc.y, dc.z, dc.x, dc.y, dc.z);
  const float d2s = fmaxf(d2, 1e-12f);
  const float dist = sqrtf(d2s);
  LightSample r;
  r.w = {dc.x / dist, dc.y / dist, dc.z / dist};
  const float cos_i = fdot3(n.x, n.y, n.z, r.w.x, r.w.y, r.w.z);
  const float cos_l = fabsf(fdot3(ls.tri(TLN, j), ls.tri(TLN + 1, j), ls.tri(TLN + 2, j),
                                  r.w.x, r.w.y, r.w.z));
  r.reach = dist;
  r.ok = (cos_i > 0.0f) & (cos_l > 1e-7f) & (d2 > 1e-12f);
  r.wgt = cos_i * cos_l * ls.tri(TLAREA, j) / (3.14159265358979f * d2s);
  r.le = {ls.tri(TLE, j), ls.tri(TLE + 1, j), ls.tri(TLE + 2, j)};
  return r;
}

struct Params {
  const float* cam;  // (24,)
  Geometry geo;
  LightSet lights;
  bool mis;  // read only by the NEE instance
  Sampler sampler;
  int width, height;
  unsigned int sample_index, frame_seed, y_offset, row_stride;
  int max_depth;
  float t_min, t_max;
  int mode;
  int rr_depth;
  float sky_intensity;
  float clamp;
  int spp;     // the fixed loop's count; the adaptive loop's budget
  float* out;  // (height, width, 3), (3, height, width, 3) in GUIDES, or null
  float* rays;  // (height, width) rays-traced plane, or null
  int* cursor;  // render_kernel's next pixel group, zero at launch
  // (2, height, width) BVH nodes visited and faces tested, which the
  // counting instances add each sample's Tally to; or null.
  unsigned int* walks;
};

// Adds a finished sample's Tally to pixel `pix` of the walk planes, in
// the counting instances when the launch passed them.
template <bool kCount>
__device__ __forceinline__ void add_walks(const Params& p, size_t pix, const Tally<kCount>& w) {
  if (kCount && p.walks != nullptr) {
    atomicAdd(p.walks + pix, w.nodes);
    atomicAdd(p.walks + (size_t)p.width * p.height + pix, w.faces);
  }
}

// The adaptive spp loop (K1f): its tile, stopping test and state planes.
struct Adaptive {
  float* state;  // (6, height, width): sum r/g/b, count, Welford mlum, m2
  int tile_rows;  // 32 for the path integrator, 64 for the AOV modes
  int min_spp;    // min(max(2, adaptive_min_spp), spp)
  int chunk;      // samples a launch may add to a tile
  float tol;
};

// MIS weight of emission reached by a BSDF ray from a diffuse vertex o
// (megakernel.py:973-1038): 1 / (1 + r^2), r = p_nee / p_b of the light the
// ray hit, from the exact light id; 0 for an emitter that is no light.
__device__ float mis_emission_weight(const Params& p, const Hit& h, Vec3 o, float prev_cos) {
  const LightSet& ls = p.lights;
  if (!(h.lid >= 0.0f)) return 0.0f;
  const int g = (int)h.lid;
  float r;
  if (g < ls.L) {
    const Vec3 dlo = {o.x - ls.sph(LCX, g), o.y - ls.sph(LCY, g), o.z - ls.sph(LCZ, g)};
    const float d2o = fmaxf(fdot3(dlo.x, dlo.y, dlo.z, dlo.x, dlo.y, dlo.z), 1e-12f);
    const float lr = ls.sph(LRAD, g);
    r = 1.0f / fmaxf(2.0f * one_minus_cos_max(lr * lr, d2o) * prev_cos, 1e-12f);
  } else {
    const int j = g - ls.L;
    const Vec3 dh = {h.p.x - o.x, h.p.y - o.y, h.p.z - o.z};
    const float d2h = fmaxf(fdot3(dh.x, dh.y, dh.z, dh.x, dh.y, dh.z), 1e-12f);
    const float d3h = d2h * sqrtf(d2h);
    const float ndot = fabsf(fdot3(dh.x, dh.y, dh.z, ls.tri(TLN, j), ls.tri(TLN + 1, j),
                                   ls.tri(TLN + 2, j)));
    r = (3.14159265358979f * d3h) / fmaxf(ndot * ls.tri(TLAREA, j) * prev_cos, 1e-12f);
  }
  if (ls.L + ls.T > 4) r = r / (float)(ls.L + ls.T);  // the pick pdf's share
  return 1.0f / fmaf(r, r, 1.0f);
}

// The camera's 19 used slots, read once per thread.
struct Cam {
  float v[19];
  bool lens;
};

__device__ __forceinline__ void load_cam(const float* src, Cam& c) {
#pragma unroll
  for (int k = 0; k < 19; ++k) c.v[k] = __ldg(src + k);
  c.lens = c.v[DEFOCUS_ANGLE] > 0.0f;
}

// Ray generation for sample s_abs of pixel (x, global row y)
// (megakernel.py:1507-1548): jitter from salts 1-2 (the sampler's pair 5),
// uniform-disk lens point from salts 3-4 (pair 7), direction not
// normalized.  `seed` is hash_pixel_seeds(pid, s_abs, frame seed), `base0`
// the pixel's sample-0 seed.
__device__ __forceinline__ void generate_ray(const Sampler& sm, const Cam& cm, int x,
                                             unsigned int y, unsigned int seed,
                                             unsigned int base0, unsigned int s_abs,
                                             Vec3& o, Vec3& d) {
  const float* cam = cm.v;
  float jx = uniform_hash(seed, 1u), jy = uniform_hash(seed, 2u);
  sampler_uniforms(sm, base0, s_abs, 5u, jx, jy, 0.5f);
  // The pixel center and lens point round as the reference renders them
  // (fused multiply-adds, cos/sin rounded from double; ops/rays.py): a
  // ray one ulp off can graze a sphere differently.
  const float fx = (float)x + 0.5f + jx;
  const float fy = (float)y + 0.5f + jy;
  Vec3 pc;
  pc.x = fmaf(cam[PDV + 0], fy, fmaf(cam[PDU + 0], fx, cam[UPPER_LEFT + 0]));
  pc.y = fmaf(cam[PDV + 1], fy, fmaf(cam[PDU + 1], fx, cam[UPPER_LEFT + 1]));
  pc.z = fmaf(cam[PDV + 2], fy, fmaf(cam[PDU + 2], fx, cam[UPPER_LEFT + 2]));
  o = {cam[CENTER + 0], cam[CENTER + 1], cam[CENTER + 2]};
  if (cm.lens) {
    float u3 = uniform_hash(seed, 3u), ang = uniform_hash(seed, 4u);
    sampler_uniforms(sm, base0, s_abs, 7u, u3, ang, 0.0f, kTwoPi);
    const float radius = sqrtf(u3);
    const float pxd = radius * (float)cos((double)ang);
    const float pyd = radius * (float)sin((double)ang);
    o.x = fmaf(pyd, cam[DISK_V + 0], fmaf(pxd, cam[DISK_U + 0], o.x));
    o.y = fmaf(pyd, cam[DISK_V + 1], fmaf(pxd, cam[DISK_U + 1], o.y));
    o.z = fmaf(pyd, cam[DISK_V + 2], fmaf(pxd, cam[DISK_U + 2], o.z));
  }
  d = {pc.x - o.x, pc.y - o.y, pc.z - o.z};
}

// What one path carries from bounce to bounce: the ray, its throughput,
// the radiance gathered so far, whether the vertex it left ran NEE
// (prev_diffuse) and the cosine of its scatter direction there (prev_cos,
// for MIS).
struct PathState {
  Vec3 o, d;
  float tr, tg, tb;
  float r, g, b;
  bool prev_diffuse;
  float prev_cos;
};

// One bounce of one path: `_path_bounce` (megakernel.py:874-1417).  Both
// engines call it, the megakernel in its bounce loop and the wavefront
// kernel once per launch (as `_wf_kernel` calls `_path_bounce` on the TPU),
// so a path computes the same arithmetic in the same order in either.  It
// keys on (seed, base0, s_abs, pick_seed, bounce i): `seed` is
// hash_pixel_seeds(pid, s_abs, frame seed), `base0` the pixel's sample-0
// seed, `pick_seed` = s_abs ^ wgsl_hash(frame seed) (the > 4-light pick).
// It returns whether the path goes on; one that ended has gathered its last
// radiance.
// kNee selects next-event estimation at compile time: the NEE code (light
// sampling, shadow queries, MIS) costs registers, and without it the
// instance keeps the register budget of the path it replaces.  kCount adds
// the rays this bounce traced to `rays` (megakernel.py:951, :1071, :1374,
// :1416): one for the closest-hit walk and one per NEE shadow ray whose
// light sample is valid, counted before its visibility test; `walk`
// counts those rays' BVH walks (Tally).  kStage names the stage
// closest_hit and occluded read (kGlobal: none).
template <bool kNee, bool kCount, int kStage = kGlobal, class W>
__device__ __forceinline__ bool path_bounce(const Params& p, PathState& st,
                                            unsigned int seed, unsigned int base0,
                                            unsigned int s_abs, unsigned int pick_seed,
                                            int i, unsigned int& rays, W& walk) {
  const Sampler& sm = p.sampler;
  const LightSet& ls = p.lights;
  const int n_lights = ls.L + ls.T;
  const Vec3 o = st.o, d = st.d;
  if (kCount) ++rays;
  const Hit h = closest_hit<kStage>(p.geo, p.t_min, p.t_max, o, d, walk);
  if (!h.hit) {
    const Vec3 sk = sky(d);
    st.r = st.r + st.tr * sk.x * p.sky_intensity;
    st.g = st.g + st.tg * sk.y * p.sky_intensity;
    st.b = st.b + st.tb * sk.z * p.sky_intensity;
    return false;
  }
  if (h.kind >= 2.5f) {
    // Emissive: radiate albedo * param and end the path.  Under NEE a
    // BSDF ray from a diffuse vertex counts it at the MIS weight, or
    // not at all without MIS (NEE sampled that light already).
    float w = 1.0f;
    if (kNee && st.prev_diffuse)
      w = p.mis ? mis_emission_weight(p, h, o, st.prev_cos) : 0.0f;
    st.r = st.r + st.tr * h.ar * (h.param * w);
    st.g = st.g + st.tg * h.ag * (h.param * w);
    st.b = st.b + st.tb * h.ab * (h.param * w);
    return false;
  }
  const bool lambertian = h.kind < 0.5f;
  // A point inside a sphere light cannot cone-sample it; such vertices
  // fall back to BSDF sampling (megakernel.py:1061-1070).
  bool inside_any = false;
  if (kNee && lambertian) {
    for (int l = 0; l < ls.L; ++l) {
      const Vec3 dc = {ls.sph(LCX, l) - h.p.x, ls.sph(LCY, l) - h.p.y,
                       ls.sph(LCZ, l) - h.p.z};
      const float lr = ls.sph(LRAD, l);
      inside_any |= fdot3(dc.x, dc.y, dc.z, dc.x, dc.y, dc.z) <= lr * lr * 1.0001f;
    }
  }
  if (kNee && lambertian && !inside_any) {
    // Next-event estimation (megakernel.py:1040-1374): with at most 4
    // lights every light, sphere lights first, salts 2000+37i+7g+{1,2}
    // (at bounce 0 the sampler's pair 8+g); above 4 one light per
    // (sample, bounce), weighted by the count.
    const unsigned int salt0 = 2000u + 37u * (unsigned int)i;
    const bool last = i == p.max_depth - 1;
    const int n_terms = n_lights <= 4 ? n_lights : 1;
    int picked = -1;
    if (n_lights > 4) {
      const unsigned int bounce_seed = hash2(pick_seed, 3000u + (unsigned int)i);
      picked = (int)(hash2(bounce_seed, 0u) % (unsigned int)n_lights);
    }
    for (int k = 0; k < n_terms; ++k) {
      const int gl = picked >= 0 ? picked : k;
      const unsigned int salt = salt0 + (picked >= 0 ? 0u : 7u * (unsigned int)k);
      float u1n = uniform_hash(seed, salt + 1u), u2n = uniform_hash(seed, salt + 2u);
      if (i == 0 && picked < 0) sampler_uniforms(sm, base0, s_abs, 8u + k, u1n, u2n);
      const LightSample ln = gl < ls.L
                                 ? sphere_light_sample(ls, gl, h.p, h.n, u1n, u2n)
                                 : tri_light_sample(ls, gl - ls.L, h.p, h.n, u1n, u2n);
      if (!ln.ok) continue;
      if (kCount) ++rays;
      if (occluded<kStage>(p.geo, p.t_min, h.p, ln.w, ln.reach * 0.999f, walk)) continue;
      float wgt = ln.wgt * (picked >= 0 ? (float)n_lights : 1.0f);
      if (p.mis && !last) wgt = wgt / fmaf(wgt, wgt, 1.0f);
      st.r = st.r + st.tr * h.ar * ln.le.x * wgt;
      st.g = st.g + st.tg * h.ag * ln.le.y * wgt;
      st.b = st.b + st.tb * h.ab * ln.le.z * wgt;
    }
  }
  float su1 = uniform_hash(seed, 16u + 3u * (unsigned int)i);
  float su2 = uniform_hash(seed, 17u + 3u * (unsigned int)i);
  if (i == 0) sampler_uniforms(sm, base0, s_abs, 6u, su1, su2);
  Vec3 nd, att;
  if (!scatter(h, d, su1, su2, seed, 16u + 3u * (unsigned int)i, &nd, &att)) return false;
  st.tr = st.tr * att.x;
  st.tg = st.tg * att.y;
  st.tb = st.tb * att.z;
  st.prev_diffuse = lambertian && !inside_any;
  if (kNee && p.mis) {
    // cos(scatter direction, normal) at this diffuse vertex: its BSDF
    // pdf is prev_cos / pi, which the next emission weight needs.
    const float nd2 = fmaxf(fdot3(nd.x, nd.y, nd.z, nd.x, nd.y, nd.z), 1e-20f);
    const float cos_s = fdot3(nd.x, nd.y, nd.z, h.n.x, h.n.y, h.n.z) * (1.0f / sqrtf(nd2));
    st.prev_cos = st.prev_diffuse ? fmaxf(cos_s, 0.0f) : 0.0f;
  }
  st.o = h.p;
  st.d = nd;
  if (p.rr_depth > 0 && i >= p.rr_depth) {
    // Russian roulette, salt 1000+i (megakernel.py:1397-1408).
    const float u_rr = uniform_hash(seed, 1000u + (unsigned int)i);
    const float pmax = fminf(fmaxf(fmaxf(st.tr, fmaxf(st.tg, st.tb)), 0.05f), 1.0f);
    if (!(u_rr < pmax)) return false;
    const float inv_p = 1.0f + (1.0f / pmax - 1.0f);
    st.tr = st.tr * inv_p;
    st.tg = st.tg * inv_p;
    st.tb = st.tb * inv_p;
  }
  return true;
}

// The per-sample clamp (megakernel.py:1647-1654): scales a finished
// sample's radiance so that its largest channel is at most p.clamp.
__device__ __forceinline__ void clamp_sample(const Params& p, float& r, float& g, float& b) {
  if (p.clamp > 0.0f) {
    const float m = fmaxf(r, fmaxf(g, b));
    const float scale = fminf(1.0f, p.clamp / fmaxf(m, 1e-12f));
    r = r * scale, g = g * scale, b = b * scale;
  }
}

// One sample of pixel (x, global row y) in a bounce-free AOV mode
// (megakernel.py:1550-1576): ray generation and one closest hit; `rays`
// counts the one ray, `walk` its BVH walk.
template <bool kCount>
__device__ __forceinline__ Vec3 aov_sample(const Params& p, const Cam& cm, int x,
                                           unsigned int y, unsigned int pid,
                                           unsigned int base0, unsigned int s_abs,
                                           unsigned int& rays, Tally<kCount>& walk) {
  const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
  Vec3 o, d;
  generate_ray(p.sampler, cm, x, y, seed, base0, s_abs, o, d);
  float r, g, b;
  if (kCount) ++rays;
  const Hit h = closest_hit(p.geo, p.t_min, p.t_max, o, d, walk);
  const Vec3 sk = sky(d);
  if (p.mode == DEPTH) {
    r = g = b = h.hit ? h.t * sqrtf(d.x * d.x + d.y * d.y + d.z * d.z) : 0.0f;
  } else if (!h.hit) {
    r = sk.x, g = sk.y, b = sk.z;
  } else if (p.mode == ALBEDO) {
    r = h.ar, g = h.ag, b = h.ab;
  } else {
    r = 0.5f * (h.n.x + 1.0f), g = 0.5f * (h.n.y + 1.0f), b = 0.5f * (h.n.z + 1.0f);
  }
  return {r, g, b};
}

// Global row and pixel id of a local pixel (megakernel.py:1492-1505): the
// stream keys on the global id, so a row band renders exactly its rows of
// the frame.
__device__ __forceinline__ unsigned int global_row(const Params& p, int y_local) {
  return (unsigned int)y_local * p.row_stride + p.y_offset;
}

// The AOV modes' fixed spp loop (K1g): one thread per pixel, the mean of
// p.spp samples of one ray each (nothing to regenerate), in the modes
// NORMAL, ALBEDO, DEPTH, or GUIDES: the albedo, normal and depth planes of
// one closest hit per sample, written to (3, height, width, 3) planes in
// that order, each equal bit for bit to its single-mode launch (a plane
// sums its samples in sample order from 0.0f and divides by spp, as the
// single modes do; depth's three channels are one sum).
//
// Replaces `_kernel`'s AOV modes (gpu_ray_tracing_tpu/ops/pallas/
// megakernel.py:1550-1576).  What bounds it on this card: the brute scan's
// arithmetic, 23 flops a sphere test (the denoiser's guides at 1280x720 /
// 16 spp on 197 spheres: 14.7 M rays, 0.997 ms at 67 TFLOP/s).  So a test
// does only the work whose result is used: nothing that depends on the
// sphere alone, and no root for a sphere the ray misses (most of them).
// On the brute route (no sphere BVH, no mesh) a block stages the active
// spheres in shared memory (stage_spheres, staged_scan), at most
// kStageSpheres a chunk: a larger scene is restaged chunk by chunk for each
// sample, the window carried across chunks.  The hit record keeps only
// what the modes read (t, the normal, the albedo), inline: no call to
// closest_hit, whose generic record needs a stack frame.  The sphere-BVH
// and mesh routes call closest_hit.  Threads outside the frame (ragged
// blocks) stage and meet every barrier, and trace nothing.

// What the AOV modes read of a closest hit.
struct AovHit {
  bool hit;
  float t;
  Vec3 n;  // the face normal flipped toward the ray
  float ar, ag, ab;
};

// closest_hit's fields for a brute-scan winner `best` (-1: none) at
// window tb, in its arithmetic.
__device__ __forceinline__ AovHit brute_hit(const float* __restrict__ sc, int n,
                                            float t_max, Vec3 o, Vec3 d, float tb, int best) {
  AovHit h;
  h.hit = tb < t_max;
  h.t = h.hit ? tb : 1.0f;
  const Vec3 pt = {fmaf(h.t, d.x, o.x), fmaf(h.t, d.y, o.y), fmaf(h.t, d.z, o.z)};
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, rad = 0.0f;
  h.ar = h.ag = h.ab = 0.0f;
  if (best >= 0) {
    cx = __ldg(sc + CX * n + best);
    cy = __ldg(sc + CY * n + best);
    cz = __ldg(sc + CZ * n + best);
    rad = __ldg(sc + RAD * n + best);
    h.ar = __ldg(sc + ALR * n + best);
    h.ag = __ldg(sc + ALG * n + best);
    h.ab = __ldg(sc + ALB * n + best);
  }
  const float rs = rad != 0.0f ? rad : 1.0f;
  const Vec3 nrm = {(pt.x - cx) / rs, (pt.y - cy) / rs, (pt.z - cz) / rs};
  const bool front = d.x * nrm.x + d.y * nrm.y + d.z * nrm.z < 0.0f;
  const float sign = front ? 1.0f : -1.0f;
  h.n = {nrm.x * sign, nrm.y * sign, nrm.z * sign};
  return h;
}

template <bool kCount, bool kBrute>
__global__ void __launch_bounds__(kStageThreads) render_aov_kernel(const Params p) {
  __shared__ float4 s_sph[kBrute ? kStageSpheres : 1];
  __shared__ int s_idx[kBrute ? kStageSpheres : 1];
  __shared__ int s_warp[kStageWarps];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_local = blockIdx.y * blockDim.y + threadIdx.y;
  const bool in_frame = x < p.width && y_local < p.height;
  const unsigned int y = global_row(p, y_local);
  const unsigned int pid = y * (unsigned int)p.width + (unsigned int)x;
  // The sample-0 seed keys the sampler's per-(pixel, frame, pair) remaps.
  const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
  Cam cm;
  load_cam(p.cam, cm);
  const int mode = p.mode;
  const float* sc = p.geo.scene;
  const int n = p.geo.n;
  const bool one_chunk = n <= kStageSpheres;
  int staged = 0;
  if (kBrute && one_chunk) staged = stage_spheres(sc, n, 0, n, s_sph, s_idx, s_warp);
  unsigned int rays = 0u;
  Tally<kCount> walk;
  float al_r = 0.0f, al_g = 0.0f, al_b = 0.0f;  // albedo (or ALBEDO's) sums
  float nm_r = 0.0f, nm_g = 0.0f, nm_b = 0.0f;  // normal sums
  float dep = 0.0f;                             // depth sum
  for (int s = 0; s < p.spp; ++s) {
    const unsigned int s_abs = p.sample_index + (unsigned int)s;
    Vec3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
    if (in_frame) {
      const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
      generate_ray(p.sampler, cm, x, y, seed, base0, s_abs, o, d);
      if (kCount) ++rays;
    }
    AovHit h;
    if (kBrute) {
      const SphereRay sr = sphere_ray(o, d);
      float tb = p.t_max;
      int best = -1;
      for (int j0 = 0; j0 < n; j0 += kStageSpheres) {
        if (!one_chunk)
          staged = stage_spheres(sc, n, j0, min(n, j0 + kStageSpheres), s_sph, s_idx, s_warp);
        if (in_frame) staged_scan(s_sph, s_idx, staged, p.t_min, o, d, sr, tb, best);
        if (!one_chunk) __syncthreads();  // scans done before the next chunk is staged
      }
      if (!in_frame) continue;
      h = brute_hit(sc, n, p.t_max, o, d, tb, best);
    } else {
      if (!in_frame) continue;
      const Hit g = closest_hit(p.geo, p.t_min, p.t_max, o, d, walk);
      h = {g.hit, g.t, g.n, g.ar, g.ag, g.ab};
    }
    const Vec3 sk = sky(d);
    if (mode == ALBEDO || mode == GUIDES) {
      al_r = al_r + (h.hit ? h.ar : sk.x);
      al_g = al_g + (h.hit ? h.ag : sk.y);
      al_b = al_b + (h.hit ? h.ab : sk.z);
    }
    if (mode == NORMAL || mode == GUIDES) {
      nm_r = nm_r + (h.hit ? 0.5f * (h.n.x + 1.0f) : sk.x);
      nm_g = nm_g + (h.hit ? 0.5f * (h.n.y + 1.0f) : sk.y);
      nm_b = nm_b + (h.hit ? 0.5f * (h.n.z + 1.0f) : sk.z);
    }
    if (mode == DEPTH || mode == GUIDES)
      dep = dep + (h.hit ? h.t * sqrtf(d.x * d.x + d.y * d.y + d.z * d.z) : 0.0f);
  }
  if (!in_frame) return;
  const float inv = (float)p.spp;  // the mean is sum / spp (megakernel.py:1789)
  const size_t pix = (size_t)y_local * p.width + x;
  const size_t plane = (size_t)p.width * p.height * 3;
  if (mode == ALBEDO || mode == GUIDES) {
    float* out = p.out + pix * 3;
    out[0] = al_r / inv;
    out[1] = al_g / inv;
    out[2] = al_b / inv;
  }
  if (mode == NORMAL || mode == GUIDES) {
    float* out = p.out + (mode == GUIDES ? plane : 0) + pix * 3;
    out[0] = nm_r / inv;
    out[1] = nm_g / inv;
    out[2] = nm_b / inv;
  }
  if (mode == DEPTH || mode == GUIDES) {
    float* out = p.out + (mode == GUIDES ? 2 * plane : 0) + pix * 3;
    out[0] = out[1] = out[2] = dep / inv;
  }
  if (kCount) p.rays[pix] = (float)rays;
  add_walks(p, pix, walk);
}

// The path integrator's fixed spp loop, with per-warp path regeneration.
//
// Replaces `_kernel` (gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1420) on
// its fixed-spp path.  The TPU kernel runs one pixel tile per grid step and
// leaves a tile's bounce loop when all its paths have ended (:1609-1614);
// the first port ran one thread per pixel, looping over its samples, so a
// warp's sample lasted as long as the deepest of its 32 paths.  At the main
// path's depth 30 the live share per bounce falls 1.0, 0.83, 0.32, 0.17 ...
// 0.003 (PERF.md): a mean path of 2.7 bounces against a warp's longest of
// about 12, so about a fifth of the lanes did useful work.
//
// Here a lane whose path has ended takes the next work item at once.  An
// item is one (pixel, sample).  A warp takes groups of 32 consecutive local
// pixels from a global cursor (one atomicAdd by lane 0 a group; the wrapper
// zeroes the cursor before each launch), so warps that drew cheap groups
// take more and the grid drains together.  It streams its groups' items in
// the order (group, sample, pixel): item k is pixel k mod 32 of row k / 32,
// and a row is one sample of one group; lane q mod 32 holds the id of the
// warp's q-th group.  At the top of each loop iteration, where every lane of
// the warp arrives, the idle lanes take the next items in lane order
// (__ballot_sync and __popc of the lanes below: no atomics in the warp),
// generate their rays from the (pixel, sample) seeds, and every lane with a
// path runs one path_bounce.  A path ends when path_bounce returns false or
// after max_depth bounces, is clamped, and stores its RGB and ray count
// into its item's slot of a ring in shared memory, 16 rows of 32 slots
// (8 KB) a warp.  Then the warp folds every finished row,
// oldest first: lane j adds slot j of the row to pixel j's running sums, so
// each pixel folds its samples in sample order from 0.0f, as the
// one-thread-per-pixel loop did, and after the last sample writes sum / spp
// and the ray count (summed as unsigned ints).  A lane may run up to 16 rows
// ahead of the oldest unfolded row, so a deep path stalls no one until the
// ring is full.  An item's result depends only on its (pixel, sample), so
// the frame is the same bit for bit whichever warp drew which group.
//
// What bounds it on this card: the closest-hit arithmetic of every traced
// ray, 17 flops a sphere test and 6 more for the roots where the
// discriminant is not negative (0.634% of the main path's tests): its
// 39.5 M rays over 197 spheres are 1.98 ms at the nominal 67 TFLOP/s.
// What a test issues is the cost above that: from device memory, five
// scalar loads, |c|^2 - r^2 and both roots for every (ray, sphere); from
// the sphere stage, one broadcast LDS.128 and the quadratic, the roots only
// where the discriminant is not negative.  Divergence between lanes that
// start a path and lanes deep in one is the remaining loss.
//
// kStage names where every closest hit and shadow query of the loop reads
// the scene (path_bounce<..., kStage>).  ops/cuda/megakernel.py::pack_scene
// decides it from the scene, and grt_render refuses a stage that does not
// match the scene.  Every thread of a block stages the scene into its
// dynamic shared memory once, before the regeneration loop, and meets one
// barrier there; there is none inside the loop, since a warp's lanes leave
// it at their own time.
//   kGlobal: the scene planes, mesh table and BVH records in device
//     memory (sphere_scan; the global walk, K1d).
//   kSphereStage, the brute route (no sphere BVH, no mesh) of at most
//     kStageSpheres spheres (K1a): the active spheres in scene order
//     (stage_spheres, wf_stage_bytes(n) bytes), scanned with the roots of
//     missed spheres skipped (staged_scan, staged_any_hit, as
//     wavefront_bounce_kernel scans them): sphere_scan's windows, winners
//     and ties bit for bit.
//   kBvhStage, the staged BVH route (K1b and K1c): a scene with a sphere
//     BVH or a mesh whose stage (bvh_stage_bytes) is at most
//     kBvhStageBytes (stage_bvh), walked with walk_nodes<true>,
//     staged_range and staged_tri: the same tree, visiting order, windows,
//     strict `<` and arithmetic as the global walk, so the same winners,
//     ties included, bit for bit, with the roots of missed spheres skipped
//     (staged_range).  Its ring is half the global route's, so that ring
//     and stage together take no more shared memory than the global ring
//     alone: the blocks an SM are not fewer (launch_render).
// The sphere stage keeps the global route's ring: registers, not shared
// memory, bound its blocks an SM.  Its plain instance (no NEE, no counters)
// asks ptxas for the global instance's 6 blocks an SM, which caps it at 80
// registers and spills 4 bytes; without the floor it took 86 registers and
// held 5 blocks, and the One-Weekend frame's kernel ran 9.0 ms against 8.7
// (PERF.md, K1a).  Every other instance asks for none (0), which leaves
// its code as it was.
constexpr int kRegenWarps = 4;   // warps a block
constexpr int kRingRows = 16;    // rows of 32 items a warp holds (a power of 2)
constexpr int kStagedRingRows = 8;  // ... on the staged BVH route
static_assert(kRegenWarps * (kRingRows - kStagedRingRows) * 32 * 16 >= kBvhStageBytes,
              "the staged route's ring and stage fit the global ring's shared memory");

template <bool kNee, bool kCount, int kStage>
__global__ void __launch_bounds__(kRegenWarps * 32,
                                  kStage == kSphereStage && !kNee && !kCount ? 6 : 0)
    render_kernel(const Params p) {
  constexpr int kRows = kStage == kBvhStage ? kStagedRingRows : kRingRows;
  constexpr int kRingSlots = kRows * 32;
  // Slot of an item: r, g, b as bits, then the rays it traced + 1 (0: open).
  __shared__ uint4 ring_all[kRegenWarps][kRingSlots];
  if (kStage == kBvhStage) stage_bvh(p.geo);
  if constexpr (kStage == kSphereStage) {
    __shared__ int s_warp[kRegenWarps];
    const int staged = stage_spheres<kRegenWarps * 32>(p.geo.scene, p.geo.n, 0, p.geo.n,
                                                       wf_stage() + 1, wf_stage_index(p.geo.n),
                                                       s_warp);
    if (threadIdx.x == 0) wf_stage_count() = staged;
    __syncthreads();
  }
  constexpr unsigned int kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  uint4* const ring = ring_all[threadIdx.x >> 5];
  const unsigned int lanes_below = (1u << lane) - 1u;
  const int n_pix = p.width * p.height;
  const int n_groups = (n_pix + 31) >> 5;
  const int group_items = 32 * p.spp;
  for (int k = lane; k < kRingSlots; k += 32) ring[k].w = 0u;
  __syncwarp();
  const unsigned int frame_hash = wgsl_hash(p.frame_seed);

  // Warp-uniform: the groups drawn and whether the cursor ran out, the next
  // item to hand out, and the oldest row not yet folded with its sample and
  // the index of its group.
  int opened = 0, next = 0, fold = 0, fold_s = 0, fold_q = 0;
  bool exhausted = false;
  int my_group = 0;
  // The lane's path: its item, seeds, bounce and state.
  bool active = false;
  int item = 0, i = 0, item_pix = 0;
  unsigned int seed = 0u, base0 = 0u, s_abs = 0u, rays = 0u;
  Tally<kCount> walk;
  PathState st;
  // Pixel `lane` of the group being folded: its running sums.
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  unsigned int acc_rays = 0u;
  while (true) {
    // Refill: draw groups while the idle lanes need items, then hand them
    // the next items in lane order, at most kRows rows past the oldest.
    const unsigned int idle = __ballot_sync(kFull, !active);
    int limit = min(next + __popc(idle), (fold + kRows) * 32);
    while (!exhausted && opened * group_items < limit) {
      int g = 0;
      if (lane == 0) g = atomicAdd(p.cursor, 1);
      g = __shfl_sync(kFull, g, 0);
      if (g >= n_groups) {
        exhausted = true;
      } else {
        if (lane == (opened & 31)) my_group = g;
        ++opened;
      }
    }
    limit = min(limit, opened * group_items);
    if (exhausted && fold == opened * p.spp) break;
    const int k = next + __popc(idle & lanes_below);
    const int q = k / group_items;
    const int group = __shfl_sync(kFull, my_group, q & 31);
    if (!active && k < limit) {
      const int pix = group * 32 + (k & 31);
      if (pix >= n_pix) {
        // No pixel: the frame's ragged last group.
        ring[k & (kRingSlots - 1)] = make_uint4(0u, 0u, 0u, 1u);
      } else {
        const int x = pix % p.width;
        const unsigned int y = global_row(p, pix / p.width);
        const unsigned int pid = y * (unsigned int)p.width + (unsigned int)x;
        s_abs = p.sample_index + (unsigned int)((k >> 5) - q * p.spp);
        seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
        base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
        Cam cm;
        load_cam(p.cam, cm);
        generate_ray(p.sampler, cm, x, y, seed, base0, s_abs, st.o, st.d);
        st.tr = st.tg = st.tb = 1.0f;
        st.r = st.g = st.b = 0.0f;
        st.prev_diffuse = false;
        st.prev_cos = 0.0f;
        item = k;
        i = 0;
        rays = 0u;
        if (kCount) {
          item_pix = pix;
          walk = Tally<kCount>();
        }
        active = true;
      }
    }
    next = limit;
    // One bounce of every path; a path that ends hands its sample to its slot.
    if (active) {
      const bool live = path_bounce<kNee, kCount, kStage>(p, st, seed, base0, s_abs,
                                                          s_abs ^ frame_hash, i, rays, walk);
      if (!live || ++i >= p.max_depth) {
        clamp_sample(p, st.r, st.g, st.b);
        add_walks(p, item_pix, walk);
        ring[item & (kRingSlots - 1)] = make_uint4(
            __float_as_uint(st.r), __float_as_uint(st.g), __float_as_uint(st.b), rays + 1u);
        active = false;
      }
    }
    __syncwarp();
    // Fold the finished rows, oldest first; each pixel in sample order.
    while (fold < opened * p.spp) {
      uint4* const slot = ring + (fold & (kRows - 1)) * 32 + lane;
      const uint4 v = *slot;
      const int fold_group = __shfl_sync(kFull, my_group, fold_q & 31);
      if (__ballot_sync(kFull, v.w != 0u) != kFull) break;
      slot->w = 0u;
      acc_r = acc_r + __uint_as_float(v.x);
      acc_g = acc_g + __uint_as_float(v.y);
      acc_b = acc_b + __uint_as_float(v.z);
      acc_rays += v.w - 1u;
      if (++fold_s == p.spp) {
        const int pix = fold_group * 32 + lane;
        if (pix < n_pix) {
          const float inv = (float)p.spp;  // the mean is sum / spp (megakernel.py:1789)
          float* out = p.out + (size_t)pix * 3;
          out[0] = acc_r / inv;
          out[1] = acc_g / inv;
          out[2] = acc_b / inv;
          if (kCount) p.rays[pix] = (float)acc_rays;
        }
        acc_r = acc_g = acc_b = 0.0f;
        acc_rays = 0u;
        fold_s = 0;
        ++fold_q;
      }
      ++fold;
    }
    if (fold_q >= 32) {
      // Rebase the counters by 32 groups, which keeps every slot, ring row
      // and group lane, so that item indices stay small (fold_q < 48 here:
      // a pass folds at most the ring's 16 or 8 rows).
      opened -= 32;
      fold_q -= 32;
      fold -= 32 * p.spp;
      next -= 32 * group_items;
      item -= 32 * group_items;
    }
    __syncwarp();
  }
}

// What sizes render_kernel<kNee, kCount, kStage>'s grid with `smem` bytes
// of stage, the ring in the largest shared memory carve-out.  A sphere
// stage of many spheres takes the block's shared memory above the default
// 48 KB, which fit() asks for.
template <bool kNee, bool kCount, int kStage>
cudaError_t render_fit(size_t smem, Fit* f) {
  return fit(render_kernel<kNee, kCount, kStage>, kRegenWarps * 32, smem, f, kMaxSharedCarveout);
}

// Launch render_kernel on a persistent grid: as many blocks as fit on the
// card at once (fewer for a small frame), with `smem` bytes of stage.
template <bool kNee, bool kCount, int kStage>
cudaError_t launch_render(const Params& p, size_t smem, cudaStream_t s) {
  const long long n_pix = (long long)p.width * p.height;
  // A path takes at least one bounce, and a warp's item indices (less than
  // 66 groups past its rebase) fit an int.
  if (p.cursor == nullptr || p.max_depth < 1 || n_pix > 0x7fffffffLL ||
      (long long)(64 + kRingRows) * 32 * p.spp > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Fit f;
  const cudaError_t e = render_fit<kNee, kCount, kStage>(smem, &f);
  if (e != cudaSuccess) return e;
  const long long wanted = ((n_pix + 31) / 32 + kRegenWarps - 1) / kRegenWarps;
  render_kernel<kNee, kCount, kStage>
      <<<grid_of(wanted, f.resident()), kRegenWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

// f(nee, count, stage) for the render_kernel instance of these run-time
// values, each as a std::integral_constant (`stage`: kGlobal, kSphereStage
// or kBvhStage; another is refused).
template <typename F>
cudaError_t with_render_instance(bool nee, bool count, int stage, F&& f) {
  const auto at = [&](auto k_stage) {
    return with_flags([&](auto k_nee, auto k_count) { return f(k_nee, k_count, k_stage); }, nee,
                      count);
  };
  if (stage == kGlobal) return at(std::integral_constant<int, kGlobal>{});
  if (stage == kSphereStage) return at(std::integral_constant<int, kSphereStage>{});
  if (stage == kBvhStage) return at(std::integral_constant<int, kBvhStage>{});
  return cudaErrorInvalidValue;
}

// The adaptive spp loop (K1f): `_adaptive_tools` and its two loops,
// megakernel.py:1659-1776, for each (tile_rows x 128) tile of the local
// frame.  The six state planes live in global memory and are the resume
// ABI: a tile continues at its carried count k0 (tile-constant; read at the
// tile's first pixel) and takes samples while
//   (k < min_spp) | ((k < spp) & (mean(m2)/max(k-1,1)/k > (mean(mlum) tol + 1e-4)^2))
// and k < k0 + chunk, the means taken over the tile's in-frame pixels (pad
// pixels outside the frame are neither traced nor counted).  A one-shot
// render is this loop from zero planes with chunk = spp, so a chunked run
// takes the same samples and ends in the same bits.  With `out` set it
// writes sum / k (the one-shot mean, megakernel.py:1776); `rays`
// accumulates per pixel.
//
// The TPU kernel runs a tile per grid step, all of its pixels in lockstep.
// The first port gave a tile one 256-thread block, each thread tracing 16
// of its pixels one after another and the block meeting at a barrier and a
// shared-memory tree every sample: a 32-sample tile kept one SM's share of
// 8 warps busy for the whole frame, lanes whose path had ended waited for
// their warp's deepest, and a 3-tile frame ran on 3 SMs.  Here:
//   - A tile is a thread block cluster of C blocks (1 to 16, on up to C
//     SMs; the launcher picks C from the tile count and the card's resident
//     blocks).  The cluster shares one pixel cursor in the
//     shared memory of its block 0 (distributed shared memory).
//   - Within a run of samples, warps regenerate paths as render_kernel's
//     do: a lane whose path has ended takes its pixel's next sample, and a
//     lane whose pixel is done takes the cursor's next pixel (one atomicAdd
//     on block 0's cursor by lane 0 for all the warp's idle lanes, handed
//     out in lane order).  The lane that finishes a sample does the pixel's
//     Welford update and its sums, so each pixel still adds its samples in
//     sample order, from 0.0f.
//   - The samples below min_spp need no decision (k < min_spp always means
//     "more"), so they run as one batch: a lane traces a pixel's batch back
//     to back, with no barrier between samples.  After them, one sample a
//     run, and between runs the cluster meets (cluster.sync(), after a
//     fence: the planes were written by other SMs, and the cluster reads
//     them through L2 only, ld/st.global.cg).  Block 0 then sums the tile:
//     partial t (t < 256) is the sum, in increasing q, of the in-frame
//     pixels q = t, t + 256, ... read back from the planes, the 256 partials
//     go through the fixed tree by halves, thread 0 decides, and the other
//     blocks read the decision from block 0's shared memory after a second
//     cluster.sync().  The sums, the decision, the image, the planes and the
//     ray counts are those of the one-block kernel bit for bit, whatever C
//     and whichever lane traced which sample.
// What bounds it on this card: the fixed kernel's arithmetic (the rays
// traced), plus one cluster barrier pair and a 256-thread tree per sample
// step after min_spp, and the tail of each run (the tile's deepest path
// when C blocks share 4,096 pixels).
constexpr int kAdaptiveThreads = 256;    // threads a block; partial sums a tile
constexpr int kMaxAdaptiveCluster = 16;  // blocks a tile (above 8: non-portable)

// The tile a block works on: its corner, width and in-frame pixel count
// (pixel q of the tile is column q mod cols of row q / cols).
struct AdaptiveTile {
  int x0, y0, cols, n_items;
};

// Samples k .. k + nb - 1 of every in-frame pixel of the tile, by this
// warp and the cluster's others, lanes taking pixels from `cursor` (block
// 0's, zero at the run's start).
template <bool kNee, bool kCount>
__device__ __forceinline__ void adaptive_samples(const Params& p, const Adaptive& a,
                                                 const AdaptiveTile& tile, int* cursor,
                                                 int k, int nb) {
  constexpr unsigned int kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned int lanes_below = (1u << lane) - 1u;
  const size_t plane = (size_t)p.width * p.height;
  float* const s_r = a.state;
  float* const s_g = a.state + plane;
  float* const s_b = a.state + 2 * plane;
  float* const s_ml = a.state + 4 * plane;
  float* const s_m2 = a.state + 5 * plane;
  Cam cm;
  load_cam(p.cam, cm);
  const unsigned int frame_hash = wgsl_hash(p.frame_seed);
  // Warp-uniform: whether the cursor ran out.  The lane's pixel (`have`
  // while it has samples left to trace), its next sample `sub`, and the
  // path in flight.
  bool exhausted = false, have = false, active = false;
  int sub = 0, i = 0, x = 0;
  unsigned int y = 0u, pid = 0u, base0 = 0u, seed = 0u, s_abs = 0u, rays = 0u;
  Tally<kCount> walk;
  size_t pix = 0;
  PathState st;
  while (true) {
    // Refill: the lanes without a pixel take the cursor's next ones.
    const unsigned int idle = __ballot_sync(kFull, !have);
    if (idle != 0u && !exhausted) {
      int first = 0;
      if (lane == 0) first = atomicAdd(cursor, __popc(idle));
      first = __shfl_sync(kFull, first, 0);
      exhausted = first + __popc(idle) >= tile.n_items;
      const int q = first + __popc(idle & lanes_below);
      if (!have && q < tile.n_items) {
        const int y_local = tile.y0 + q / tile.cols;
        x = tile.x0 + q % tile.cols;
        y = global_row(p, y_local);
        pid = y * (unsigned int)p.width + (unsigned int)x;
        base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
        pix = (size_t)y_local * p.width + x;
        have = true;
        sub = 0;
      }
    }
    if (__ballot_sync(kFull, have) == 0u) break;
    // Start the lane's next sample: a path, or a whole bounce-free AOV sample.
    bool done = false;
    Vec3 c = {0.0f, 0.0f, 0.0f};
    if (have && !active) {
      s_abs = p.sample_index + (unsigned int)(k + sub);
      rays = 0u;
      if (kCount) walk = Tally<kCount>();
      if (p.mode != PATH) {
        c = aov_sample<kCount>(p, cm, x, y, pid, base0, s_abs, rays, walk);
        done = true;
      } else {
        seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
        generate_ray(p.sampler, cm, x, y, seed, base0, s_abs, st.o, st.d);
        st.tr = st.tg = st.tb = 1.0f;
        st.r = st.g = st.b = 0.0f;
        st.prev_diffuse = false;
        st.prev_cos = 0.0f;
        i = 0;
        active = true;
      }
    }
    if (active) {
      const bool live =
          path_bounce<kNee, kCount>(p, st, seed, base0, s_abs, s_abs ^ frame_hash, i, rays,
                                    walk);
      if (!live || ++i >= p.max_depth) {
        clamp_sample(p, st.r, st.g, st.b);
        c = {st.r, st.g, st.b};
        active = false;
        done = true;
      }
    }
    if (done) {
      // Sample k + sub of the pixel: Welford update of its luminance
      // (megakernel.py:1676-1682; M2 as one fused multiply-add, as XLA:CPU
      // contracts it in the reference's run) and the raw sums.
      const float lum = (c.x + c.y + c.z) * (1.0f / 3.0f);
      const float ml = __ldcg(s_ml + pix);
      const float dl = lum - ml;
      const float ml1 = ml + dl / (float)(k + sub + 1);
      __stcg(s_m2 + pix, fmaf(dl, lum - ml1, __ldcg(s_m2 + pix)));
      __stcg(s_ml + pix, ml1);
      __stcg(s_r + pix, __ldcg(s_r + pix) + c.x);
      __stcg(s_g + pix, __ldcg(s_g + pix) + c.y);
      __stcg(s_b + pix, __ldcg(s_b + pix) + c.z);
      if (kCount) __stcg(p.rays + pix, __ldcg(p.rays + pix) + (float)rays);
      add_walks(p, pix, walk);
      if (++sub == nb) have = false;
    }
    __syncwarp();
  }
}

template <bool kNee, bool kCount>
__global__ void __launch_bounds__(kAdaptiveThreads, 2) render_adaptive_kernel(const Params p,
                                                                              const Adaptive a) {
  namespace cg = cooperative_groups;
  __shared__ float red_m2[kAdaptiveThreads];
  __shared__ float red_ml[kAdaptiveThreads];
  __shared__ int go;      // block 0's: the tile takes another sample
  __shared__ int cursor;  // block 0's: the run's next in-frame pixel
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  int* const cursor0 = cluster.map_shared_rank(&cursor, 0);
  int* const go0 = cluster.map_shared_rank(&go, 0);
  const int t = threadIdx.x;
  AdaptiveTile tile;
  tile.x0 = (int)(blockIdx.x / n_ranks) * 128;
  tile.y0 = blockIdx.y * a.tile_rows;
  const int rows = min(a.tile_rows, p.height - tile.y0);
  tile.cols = min(128, p.width - tile.x0);
  tile.n_items = rows * tile.cols;
  const float n_valid = fmaxf((float)tile.n_items, 1.0f);
  const size_t plane = (size_t)p.width * p.height;
  float* const s_r = a.state;
  float* const s_g = a.state + plane;
  float* const s_b = a.state + 2 * plane;
  float* const s_k = a.state + 3 * plane;
  float* const s_ml = a.state + 4 * plane;
  float* const s_m2 = a.state + 5 * plane;
  // Read before the first cluster barrier; the planes' counts are written
  // after the last.
  const int k0 = (int)s_k[(size_t)tile.y0 * p.width + tile.x0];
  if (rank == 0 && t == 0) cursor = 0;
  cluster.sync();
  int k = k0;
  const int batch = min(a.min_spp, k0 + a.chunk) - k0;
  if (batch > 0) {
    adaptive_samples<kNee, kCount>(p, a, tile, cursor0, k, batch);
    k += batch;
  }
  while (true) {
    __threadfence();
    cluster.sync();
    if (rank == 0) {
      if (t == 0) cursor = 0;
      // Partial t: the tile's in-frame pixels t, t + 256, ... in order.
      float pm2 = 0.0f, pml = 0.0f;
      for (int q = t; q < a.tile_rows * 128; q += kAdaptiveThreads) {
        const int row = q >> 7, col = q & 127;
        if (row >= rows || col >= tile.cols) continue;
        const size_t pix = (size_t)(tile.y0 + row) * p.width + (tile.x0 + col);
        pm2 = pm2 + __ldcg(s_m2 + pix);
        pml = pml + __ldcg(s_ml + pix);
      }
      red_m2[t] = pm2;
      red_ml[t] = pml;
      __syncthreads();
      for (int w = kAdaptiveThreads / 2; w > 0; w >>= 1) {
        if (t < w) {
          red_m2[t] = red_m2[t] + red_m2[t + w];
          red_ml[t] = red_ml[t] + red_ml[t + w];
        }
        __syncthreads();
      }
      if (t == 0) {
        const float kf = (float)k;
        const float stderr2 = red_m2[0] / n_valid / fmaxf(kf - 1.0f, 1.0f) / kf;
        const float scale = fmaf(red_ml[0] / n_valid, a.tol, 1e-4f);
        const bool more = (k < a.min_spp) | ((k < p.spp) & (stderr2 > scale * scale));
        go = more & (k < k0 + a.chunk);
      }
    }
    cluster.sync();
    if (!*go0) break;
    adaptive_samples<kNee, kCount>(p, a, tile, cursor0, k, 1);
    ++k;
  }
  const float kf = (float)k;
  for (int q = rank * kAdaptiveThreads + t; q < tile.n_items; q += n_ranks * kAdaptiveThreads) {
    const size_t pix = (size_t)(tile.y0 + q / tile.cols) * p.width + (tile.x0 + q % tile.cols);
    s_k[pix] = kf;
    if (p.out != nullptr) {
      p.out[pix * 3 + 0] = __ldcg(s_r + pix) / kf;
      p.out[pix * 3 + 1] = __ldcg(s_g + pix) / kf;
      p.out[pix * 3 + 2] = __ldcg(s_b + pix) / kf;
    }
  }
  // Block 0's shared memory outlives every read of it.
  cluster.sync();
}

// The adaptive kernel's blocks a tile: 0 lets the launcher choose; the
// size of the last launch's clusters (grt_adaptive_cluster).
int g_adaptive_cluster = 0;
int g_adaptive_cluster_used = 0;

// Launch render_adaptive_kernel on a grid of (tiles x C) blocks in
// clusters of C: the fewest blocks a tile (a power of two, at most 16) with
// which the frame's tiles fill the card's resident blocks, unless set.  A
// tile on more blocks finishes sooner, while its runs' tails (the deepest
// path of a sample, with 4,096 pixels over C x 256 lanes) and the blocks
// waiting for a slot grow with C: on the H100 the 230-tile main frame ran
// fastest on 2 blocks a tile and the 3-tile Cornell frame on 16 (PERF.md).
// A cluster that cannot be placed is an error, never a smaller grid.
template <bool kNee, bool kCount>
cudaError_t launch_adaptive(const Params& p, const Adaptive& a, cudaStream_t s) {
  const auto kernel = render_adaptive_kernel<kNee, kCount>;
  Fit f;
  cudaError_t e = fit(kernel, kAdaptiveThreads, 0, &f, kNonPortableCluster);
  if (e != cudaSuccess) return e;
  const int gx = (p.width + 127) / 128;
  const int gy = (p.height + a.tile_rows - 1) / a.tile_rows;
  int blocks = g_adaptive_cluster;
  if (blocks == 0) {
    blocks = 1;
    while (blocks < kMaxAdaptiveCluster && (long long)gx * gy * blocks < f.resident())
      blocks *= 2;
  }
  if (blocks < 1 || blocks > kMaxAdaptiveCluster) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(gx * blocks), (unsigned int)gy, 1);
  cfg.blockDim = dim3(kAdaptiveThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Fit placed;
  e = fit(kernel, kAdaptiveThreads, 0, &placed, kNonPortableCluster, &cfg);
  if (e != cudaSuccess) return e;
  if (placed.clusters < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, p, a);
  if (e != cudaSuccess) return e;
  g_adaptive_cluster_used = blocks;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wavefront engine's kernels (K2).  Replaces the Pallas TPU kernel
// gpu_ray_tracing_tpu/ops/pallas/wavefront.py `_wf_kernel` (launched by
// `render_wavefront`): one `path_bounce` for every ray of a compacted ray
// array, the state kept in device memory between launches.  The loop
// around them runs on the device too (wavefront.cu: the compaction and the
// loop's step; wavefront.cuh: the counts they share).
//
// One thread per ray slot over structure-of-arrays planes, (kWfPlanes,
// stride) f32 and (2-4, stride) i32, updated in place (a thread touches
// only its own slot).  A dead slot is skipped: the per-thread form of the
// TPU kernel's all-dead-tile passthrough.  The TPU kernel emitted radiance
// deltas per bounce; here a path carries its running radiance in its state,
// so every sum has the megakernel's order ((r + a) + b, never r + (a + b))
// and the image equals the megakernel's bit for bit, and writes its
// sample's total, clamped, into slot `pix [+ (sample - sample_base)
// n_pixels]` of `out` when it ends or exhausts max_depth.  Each (pixel,
// sample) ends exactly once, so the write is a plain store and the image is
// the same in every run; the host folds the samples in sample order
// (ops/cuda/wavefront.py).
//
// Driven by the device loop (`ctr` not null), a launch reads the array's
// slot count and buffer from the counts, does nothing once the loop is
// over, walks the slots with a card-filling grid (an empty launch costs
// microseconds), and adds its surviving rays to the live count: one
// atomicAdd of a block's sum, an integer, so the count is exact.
//
// What bounds it on this card: the same arithmetic as the megakernel's
// bounce (the sphere scan or BVH walk), plus the state traffic the
// megakernel keeps in registers: up to 15 planes read and written per live
// ray and bounce.  Compaction (wavefront.cu) keeps warps full of live rays.
// On the brute route most of that arithmetic is the sphere scan, and from
// device memory it costs five loads and the full root arithmetic for every
// (ray, sphere), where on the main frame 0.634% of the tests need a root.
// So a block stages the spheres in shared memory once a launch and skips
// the roots of missed spheres, as render_aov_kernel does
// (wavefront_bounce_kernel, kStaged).
struct Wavefront {
  float* f[2];      // two (kWfPlanes, stride) state buffers (the second: compactions)
  int* i[2];        // (2, stride) pid, pix; + sample (smp), + bounce (regeneration)
  int stride;       // slots a plane holds
  int n;            // slots this launch covers, when ctr is null
  int* ctr;         // the device loop's counts (wavefront.cuh), or null
  bool smp;         // each ray reads its sample from its plane
  unsigned int sample;  // else every ray's sample ...
  int bounce;           // ... and, without regeneration, its bounce
  unsigned int sample_base;  // with per-ray samples: the out slot's sample origin
  int n_pixels;              // ... and its stride, the frame's local pixels
  float* out;       // (slots, 3) finished samples
  float* rays_out;  // (slots,) rays each finished sample traced, or null
};

// One bounce of the ray in slot t, in place; returns whether it goes on.
template <bool kNee, bool kCount, bool kRegen, bool kStaged>
__device__ __forceinline__ bool wavefront_bounce_slot(const Params& p, const Wavefront& w,
                                                      float* fb, int* ib, int t) {
  float* const f = fb + t;
  const size_t ps = (size_t)w.stride;
  if (!(f[WLIVE * ps] > 0.5f)) return false;
  const unsigned int pid = (unsigned int)ib[WPID * ps + t];
  const unsigned int s_abs = (kRegen || w.smp) ? (unsigned int)ib[WSMP * ps + t] : w.sample;
  const int i = kRegen ? ib[WBNC * ps + t] : w.bounce;
  PathState st;
  st.o = {f[WOX * ps], f[WOY * ps], f[WOZ * ps]};
  st.d = {f[WDX * ps], f[WDY * ps], f[WDZ * ps]};
  st.tr = f[WTR * ps], st.tg = f[WTG * ps], st.tb = f[WTB * ps];
  st.r = f[WRR * ps], st.g = f[WRG * ps], st.b = f[WRB * ps];
  st.prev_diffuse = f[WPD * ps] > 0.5f;
  st.prev_cos = f[WPC * ps];
  const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
  const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
  const unsigned int pick_seed = s_abs ^ wgsl_hash(p.frame_seed);
  unsigned int rays = 0u;
  Tally<false> walk;  // the engine counts rays, not walks
  const bool live = path_bounce<kNee, kCount, kStaged ? kSphereStage : kGlobal>(
      p, st, seed, base0, s_abs, pick_seed, i, rays, walk);
  float n_rays = 0.0f;
  if (kCount) n_rays = f[WRAYS * ps] + (float)rays;
  if (kRegen) ib[WBNC * ps + t] = i + 1;
  if (!live || i + 1 >= p.max_depth) {
    // The sample is finished: clamp it and hand it to the image.
    clamp_sample(p, st.r, st.g, st.b);
    size_t slot = (size_t)ib[WPIX * ps + t];
    if (kRegen || w.smp) slot += (size_t)(s_abs - w.sample_base) * (size_t)w.n_pixels;
    w.out[slot * 3 + 0] = st.r;
    w.out[slot * 3 + 1] = st.g;
    w.out[slot * 3 + 2] = st.b;
    if (kCount) w.rays_out[slot] = n_rays;
    f[WLIVE * ps] = 0.0f;
    return false;
  }
  f[WOX * ps] = st.o.x, f[WOY * ps] = st.o.y, f[WOZ * ps] = st.o.z;
  f[WDX * ps] = st.d.x, f[WDY * ps] = st.d.y, f[WDZ * ps] = st.d.z;
  f[WTR * ps] = st.tr, f[WTG * ps] = st.tg, f[WTB * ps] = st.tb;
  f[WRR * ps] = st.r, f[WRG * ps] = st.g, f[WRB * ps] = st.b;
  f[WPD * ps] = st.prev_diffuse ? 1.0f : 0.0f;
  f[WPC * ps] = st.prev_cos;
  if (kCount) f[WRAYS * ps] = n_rays;
  return true;
}

// One bounce of every live ray.  kRegen reads sample and bounce per ray
// (rays of one launch mix them); without it the bounce is a launch scalar
// and the sample one too unless w.smp (a batch of samples in one array).
//
// kStaged (the brute route, grt_wavefront_bounce decides it from the scene
// before the launch): every thread of the block stages the scene's active
// spheres in the block's dynamic shared memory (wf_stage) once, before the
// slot loop, and each closest hit and shadow query of the launch scans the
// stage with the root skip (staged_scan, staged_any_hit) instead of five
// global loads and the full root arithmetic a sphere.  A block walks
// thousands of slots a launch, so one staging serves them all.  The done
// flag is the same for every thread, so a block returns whole or stages
// whole; threads without a slot stage too and meet every barrier.
template <bool kNee, bool kCount, bool kRegen, bool kStaged>
__global__ void __launch_bounds__(kStageThreads) wavefront_bounce_kernel(const Params p,
                                                                         const Wavefront w) {
  __shared__ int block_live[kStageWarps];
  __shared__ int s_warp[kStaged ? kStageWarps : 1];
  int n = w.n, cur = 0;
  if (w.ctr != nullptr) {
    if (w.ctr[kCtrDone]) return;
    n = w.ctr[kCtrN];
    cur = w.ctr[kCtrCur];
  }
  if (kStaged) {
    const int staged = stage_spheres(p.geo.scene, p.geo.n, 0, p.geo.n, wf_stage() + 1,
                                     wf_stage_index(p.geo.n), s_warp);
    if (threadIdx.x == 0) wf_stage_count() = staged;
    __syncthreads();
  }
  float* const fb = w.f[cur];
  int* const ib = w.i[cur];
  int live = 0;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n; t += gridDim.x * blockDim.x) {
    live += wavefront_bounce_slot<kNee, kCount, kRegen, kStaged>(p, w, fb, ib, t) ? 1 : 0;
  }
  if (w.ctr == nullptr) return;
  for (int off = 16; off > 0; off >>= 1) live += __shfl_xor_sync(0xffffffffu, live, off);
  if ((threadIdx.x & 31) == 0) block_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) sum += block_live[k];
    if (sum > 0) atomicAdd(&w.ctr[kCtrLive], sum);
  }
}

// Where wavefront_raygen_kernel writes primary rays: the slots [0, count)
// with their own pixel and sample (kFillSlots); or stream positions: slot j
// takes position j of the sample-major stream of p pixels (kFillStream,
// which also sets the counts of a new array), or under the device loop the
// next k positions from the cursor go to the dead slots in their order
// (kFillRefill: slot live + r after a compaction, else perm[live + r]).
enum FillMode { kFillSlots = 0, kFillStream = 1, kFillRefill = 2 };

struct WfFill {
  int mode;
  int count;                    // kFillSlots / kFillStream: slots
  int p, width;                 // the frame band's pixels and width ...
  unsigned int y_offset, row_stride;  // ... and rows in the whole frame
  unsigned int s0;              // the stream's first sample
  int* ctr;                     // kFillStream / kFillRefill
  WfSched sched;                // kFillRefill
  const int* perm;              // kFillRefill
  long long* stats;             // counts the launches that ran, or null
  unsigned int* bounds;         // reset with a new array's counts
};

// Primary rays (the megakernel's own ray generation, so a wavefront path
// starts from the same bits): throughput 1, no radiance, bounce 0, live
// unless the slot's pix is negative.  A slot's pixel is (pid mod
// total_width, pid / total_width) of the whole frame.  Replaces the XLA ray
// generation `render_wavefront` calls (wavefront.py:506, :682), the
// in-kernel one of megakernel.py:1507, and the refill's stream bookkeeping
// (:756-767).
__global__ void __launch_bounds__(256) wavefront_raygen_kernel(const Params p, const Wavefront w,
                                                               unsigned int total_width,
                                                               bool regen, const WfFill fl) {
  int count = fl.count, cur = 0, base_src = 0, live = 0;
  bool compact = false;
  if (fl.mode == kFillRefill) {
    const WfPlan pl = wf_plan(fl.ctr, fl.sched);
    if (!pl.refill) return;
    count = pl.k;
    compact = pl.compact;
    cur = pl.cur ^ (compact ? 1 : 0);
    base_src = pl.nxt;
    live = pl.live;
  }
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g == 0 && fl.mode != kFillSlots) {
    if (fl.stats != nullptr) fl.stats[kStatRaygen] += 1;
    if (fl.mode == kFillStream) {
      fl.ctr[kCtrN] = count, fl.ctr[kCtrLive] = 0, fl.ctr[kCtrCur] = 0;
      fl.ctr[kCtrNxt] = count, fl.ctr[kCtrDone] = 0, fl.ctr[kCtrEnter] = count;
      wf_reset_bounds(fl.bounds);
    }
  }
  float* const fb = w.f[cur];
  int* const ib = w.i[cur];
  const size_t ps = (size_t)w.stride;
  Cam cm;
  load_cam(p.cam, cm);
  for (int r = g; r < count; r += gridDim.x * blockDim.x) {
    int t = r;
    if (fl.mode == kFillRefill) t = compact ? live + r : fl.perm[live + r];
    if (fl.mode != kFillSlots) {
      // The slot's stream position: its pixel and sample.
      const int src = base_src + r;
      const int local = src % fl.p;
      ib[WPID * ps + t] = (int)(((unsigned int)(local / fl.width) * fl.row_stride + fl.y_offset) *
                                total_width + (unsigned int)(local % fl.width));
      ib[WPIX * ps + t] = local;
      ib[WSMP * ps + t] = (int)(fl.s0 + (unsigned int)(src / fl.p));
    }
    float* const f = fb + t;
    if (regen) ib[WBNC * ps + t] = 0;
    f[WRR * ps] = f[WRG * ps] = f[WRB * ps] = 0.0f;
    f[WPD * ps] = f[WPC * ps] = f[WRAYS * ps] = 0.0f;
    f[WTR * ps] = f[WTG * ps] = f[WTB * ps] = 1.0f;
    if (ib[WPIX * ps + t] < 0) {
      f[WOX * ps] = f[WOY * ps] = f[WOZ * ps] = 0.0f;
      f[WDX * ps] = f[WDY * ps] = f[WDZ * ps] = 0.0f;
      f[WLIVE * ps] = 0.0f;
      continue;
    }
    const unsigned int pid = (unsigned int)ib[WPID * ps + t];
    const unsigned int s_abs =
        (regen || w.smp) ? (unsigned int)ib[WSMP * ps + t] : w.sample;
    const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
    const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
    Vec3 o, d;
    generate_ray(p.sampler, cm, (int)(pid % total_width), pid / total_width, seed, base0,
                 s_abs, o, d);
    f[WOX * ps] = o.x, f[WOY * ps] = o.y, f[WOZ * ps] = o.z;
    f[WDX * ps] = d.x, f[WDY * ps] = d.y, f[WDZ * ps] = d.z;
    f[WLIVE * ps] = 1.0f;
  }
}

// The hashes the kernel draws, for a bit-exactness probe against ops/rng.py.
__global__ void hash_probe_kernel(const unsigned int* __restrict__ v, int n,
                                  const unsigned int* __restrict__ salts, int n_salts,
                                  unsigned int sample_index, unsigned int frame_seed,
                                  unsigned int* out_hash, unsigned int* out_seeds,
                                  unsigned int* out_hash2, float* out_uniform) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int x = v[i];
  out_hash[i] = wgsl_hash(x);
  out_seeds[i] = hash_pixel_seeds(x, sample_index, frame_seed);
  for (int k = 0; k < n_salts; ++k) {
    out_hash2[(size_t)k * n + i] = hash2(x, salts[k]);
    out_uniform[(size_t)k * n + i] = uniform_hash(x, salts[k]);
  }
}

// The sampler's remaps as the kernel draws them, for a bit-exactness probe
// against ops/rng.py: per (pixel id, absolute sample) the (salt 1, salt 2)
// draws remapped under each pair id.
__global__ void sampler_probe_kernel(const unsigned int* __restrict__ pids,
                                     const unsigned int* __restrict__ samples, int n,
                                     const unsigned int* __restrict__ salts, int n_salts,
                                     unsigned int frame_seed, Sampler sm, float* out_u1,
                                     float* out_u2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int pid = pids[i], s = samples[i];
  const unsigned int seed = hash_pixel_seeds(pid, s, frame_seed);
  const unsigned int base0 = hash_pixel_seeds(pid, 0u, frame_seed);
  for (int k = 0; k < n_salts; ++k) {
    float u1 = uniform_hash(seed, 1u), u2 = uniform_hash(seed, 2u);
    sampler_uniforms(sm, base0, s, salts[k], u1, u2);
    out_u1[(size_t)k * n + i] = u1;
    out_u2[(size_t)k * n + i] = u2;
  }
}

// The scene, light and sampler arguments every render entry point shares.
Params scene_params(const float* cam, const float* scene, int n, const float* sbvh,
                    int sbvh_m, const float* mesh, const float* faces, int n_tris,
                    int smooth, const float* mbvh, int mbvh_m, const float* lights, int n_lights, const float* tri_lights,
                    int n_tri_lights, int nee, int mis, int sampler, int kx, int ky,
                    int nbits) {
  Params p = {};
  p.cam = cam;
  p.geo.scene = scene;
  p.geo.n = n;
  p.geo.sphere_bvh = {reinterpret_cast<const float4*>(sbvh), sbvh_m};
  p.geo.mesh = mesh;
  p.geo.faces = reinterpret_cast<const float4*>(faces);
  p.geo.n_tris = n_tris;
  p.geo.smooth = smooth != 0;
  p.geo.mesh_bvh = {reinterpret_cast<const float4*>(mbvh), mbvh_m};
  p.lights = {lights, nee ? n_lights : 0, tri_lights, nee ? n_tri_lights : 0};
  p.mis = nee != 0 && mis != 0;
  p.sampler = {sampler, kx, ky, nbits};
  return p;
}

}  // namespace

// Plain C interface for ctypes (ops/cuda/build.py).  Each launcher enqueues
// on the given stream, does not synchronise, and returns cudaGetLastError()
// as an int (0 = launched).

// The geometry: (16, n) sphere planes; a sphere BVH, (sbvh_m, 2) float4
// node records (sbvh_m = 0: brute scan); a (n_tris, 32) mesh table, its
// (n_tris, 3) float4 face records and its BVH's (mbvh_m, 2) node records
// (n_tris = 0: no mesh).
// The lights: (8, n_lights) and (16, n_tri_lights) planes, read when nee.
// The sampler: kind 0 independent, 1 stratified (kx, ky), 2 Sobol (nbits).
// The outputs: `out` (height, width, 3), or (3, height, width, 3) in mode
// GUIDES (albedo, normal, depth), and, when not null, `rays` (height,
// width), the rays traced per pixel, and with `rays` `walks` (2, height,
// width) u32, to which the counting launch adds each pixel's BVH nodes
// visited and faces tested (zero them first).  With `state` (6, height,
// width) the adaptive loop runs (spp is its budget) and updates the state;
// `out` is then optional (the one-shot mean).  The path integrator's fixed
// loop needs `cursor`, one int in device memory set to 0, and reads the
// scene from a shared-memory stage when `stage` is the stage's bytes (0:
// the global arrays): on the brute route (no sphere BVH, no mesh) of at
// most kStageSpheres spheres the sphere stage, wf_stage_bytes(n); on a
// scene with a sphere BVH or a mesh the BVH stage, bvh_stage_bytes of the
// scene's counts, at most kBvhStageBytes.  Any other stage is refused.
extern "C" int grt_render(const float* cam, const float* scene, int n,
                          const float* sbvh, int sbvh_m, const float* mesh,
                          const float* faces, int n_tris, int smooth,
                          const float* mbvh, int mbvh_m, const float* lights, int n_lights, const float* tri_lights,
                          int n_tri_lights, int nee, int mis, int sampler, int kx, int ky,
                          int nbits, int width, int height, unsigned int sample_index,
                          unsigned int frame_seed, unsigned int y_offset,
                          unsigned int row_stride, int max_depth, float t_min,
                          float t_max, int mode, int rr_depth, float sky_intensity,
                          float clamp, int spp, float* out, float* rays,
                          unsigned int* walks, float* state,
                          int tile_rows, int min_spp, int chunk, float tol, int* cursor,
                          int stage, void* stream) {
  Params p = scene_params(cam, scene, n, sbvh, sbvh_m, mesh, faces, n_tris, smooth,
                          mbvh, mbvh_m, lights, n_lights, tri_lights,
                          n_tri_lights, nee, mis, sampler, kx, ky, nbits);
  p.width = width;
  p.height = height;
  p.sample_index = sample_index;
  p.frame_seed = frame_seed;
  p.y_offset = y_offset;
  p.row_stride = row_stride;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.t_max = t_max;
  p.mode = mode;
  p.rr_depth = rr_depth;
  p.sky_intensity = sky_intensity;
  p.clamp = clamp;
  p.spp = spp;
  p.out = out;
  p.rays = rays;
  p.cursor = cursor;
  p.walks = walks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool count = rays != nullptr;
  if (walks != nullptr && !count)
    return static_cast<int>(cudaErrorInvalidValue);  // only the counting instances add walks
  const bool brute = sbvh_m == 0 && n_tris == 0;
  if (stage != 0 &&
      (state != nullptr || mode != PATH ||
       (brute ? n > kStageSpheres || (size_t)stage != wf_stage_bytes(n)
              : stage > kBvhStageBytes ||
                    (size_t)stage != bvh_stage_bytes(n, sbvh_m, n_tris, mbvh_m))))
    return static_cast<int>(cudaErrorInvalidValue);  // the path loop on a small scene only
  if (state != nullptr) {
    if (mode == GUIDES) return static_cast<int>(cudaErrorInvalidValue);  // one plane a loop
    const Adaptive a = {state, tile_rows, min_spp, chunk, tol};
    return static_cast<int>(with_flags([&](auto k_nee, auto k_count) {
      return launch_adaptive<decltype(k_nee)::value, decltype(k_count)::value>(p, a, s);
    }, nee != 0, count));
  }
  if (mode != PATH) {
    const dim3 block(32, kStageThreads / 32);
    const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
    return static_cast<int>(with_flags([&](auto k_count, auto k_brute) {
      render_aov_kernel<decltype(k_count)::value, decltype(k_brute)::value>
          <<<grid, block, 0, s>>>(p);
      return cudaGetLastError();
    }, count, brute));
  }
  const int kind = stage == 0 ? kGlobal : brute ? kSphereStage : kBvhStage;
  return static_cast<int>(
      with_render_instance(nee != 0, count, kind, [&](auto k_nee, auto k_count, auto k_stage) {
        return launch_render<decltype(k_nee)::value, decltype(k_count)::value,
                             decltype(k_stage)::value>(p, (size_t)stage, s);
      }));
}

// The blocks an SM of render_kernel<nee, count, stage> holds with `smem`
// bytes of stage, into *per_sm: the figure its launch sizes the grid by
// (for measurement); `stage` is 0 (kGlobal), 1 (kSphereStage) or 2
// (kBvhStage).  Returns the CUDA error.
extern "C" int grt_render_occupancy(int nee, int count, int stage, int smem, int* per_sm) {
  Fit f;
  const auto query = [&](auto k_nee, auto k_count, auto k_stage) {
    return render_fit<decltype(k_nee)::value, decltype(k_count)::value, decltype(k_stage)::value>(
        (size_t)smem, &f);
  };
  const cudaError_t e = with_render_instance(nee != 0, count != 0, stage, query);
  if (e == cudaSuccess) *per_sm = f.per_sm;
  return static_cast<int>(e);
}

// One wavefront bounce over the ray array in (f0, i0) ((16, stride) f32 and
// (2-4, stride) i32 planes), in place: slots [0, n), or under the device
// loop (`ctr` not null) the slots and the buffer ((f0, i0) or (f1, i1))
// its counts name, adding the surviving rays to them.  The scene arguments
// are grt_render's.  With `regen` each ray reads its own sample and bounce
// (i32 rows 2 and 3), with `smp` its own sample; a finished sample then
// goes to slot pix + (sample - sample_base) n_pixels of `out`, else to pix,
// with the launch scalars `sample` and `bounce`.  `rays_out`, when not
// null, receives the rays each finished sample traced.  `staged` scans the
// spheres from a stage in shared memory (wavefront_bounce_kernel): only on
// the brute route (no sphere BVH) of a scene of at most kStageSpheres
// spheres; asked for on another scene the launch is refused.
extern "C" int grt_wavefront_bounce(
    const float* scene, int n, const float* sbvh, int sbvh_m, const float* mesh,
    const float* faces, int n_tris, int smooth, const float* mbvh, int mbvh_m,
    const float* lights, int n_lights, const float* tri_lights,
    int n_tri_lights, int nee, int mis, int sampler, int kx, int ky, int nbits,
    unsigned int frame_seed, int max_depth, float t_min, float t_max, int rr_depth,
    float sky_intensity, float clamp, float* f0, float* f1, int* i0, int* i1, int stride,
    int n_slots, int* ctr, int smp, int regen, unsigned int sample, int bounce,
    unsigned int sample_base, int n_pixels, float* out, float* rays_out, int staged,
    void* stream) {
  if (staged && (sbvh_m > 0 || n > kStageSpheres)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = scene_params(nullptr, scene, n, sbvh, sbvh_m, mesh, faces, n_tris, smooth,
                          mbvh, mbvh_m, lights, n_lights, tri_lights,
                          n_tri_lights, nee, mis, sampler, kx, ky, nbits);
  p.frame_seed = frame_seed;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.t_max = t_max;
  p.mode = PATH;
  p.rr_depth = rr_depth;
  p.sky_intensity = sky_intensity;
  p.clamp = clamp;
  const Wavefront w = {{f0, f1}, {i0, i1}, stride, n_slots, ctr, smp != 0, sample, bounce,
                       sample_base, n_pixels, out, rays_out};
  const int slots = ctr != nullptr ? stride : n_slots;
  if (slots <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool count = rays_out != nullptr;
  const size_t smem = staged ? wf_stage_bytes(n) : 0;
  return static_cast<int>(with_flags([&](auto k_nee, auto k_count, auto k_regen, auto k_staged) {
    const auto kernel =
        wavefront_bounce_kernel<decltype(k_nee)::value, decltype(k_count)::value,
                                decltype(k_regen)::value, decltype(k_staged)::value>;
    Fit f;
    const cudaError_t e = fit(kernel, kStageThreads, smem, &f);
    if (e != cudaSuccess) return e;
    const long long need = (slots + kStageThreads - 1) / kStageThreads;
    kernel<<<grid_of(need, f.resident()), kStageThreads, smem, s>>>(p, w);
    return cudaGetLastError();
  }, nee != 0, count, regen != 0, staged != 0));
}

// Primary rays into the ray array (see wavefront_raygen_kernel): `mode` 0
// the slots [0, count) with their own pid and pix (and sample: `smp` or
// `regen`; else `sample`), 1 the first `count` positions of the stream of
// `pool` pixels (width `width`, rows y_offset + r row_stride of the frame)
// from sample s0, setting the counts `ctr` of a new array, 2 the refill
// the counts call for (the schedule's thresholds, stream length `total`,
// the dead slots' order in `perm`).  `stats`, when not null, counts the
// launches of modes 1 and 2 that ran.
extern "C" int grt_wavefront_raygen(const float* cam, int sampler, int kx, int ky, int nbits,
                                    unsigned int frame_seed, unsigned int total_width,
                                    float* f0, float* f1, int* i0, int* i1, int stride,
                                    int smp, int regen, unsigned int sample, int mode, int count,
                                    int pool, int width, unsigned int y_offset,
                                    unsigned int row_stride, unsigned int s0, int* ctr,
                                    double compact_threshold, double refill_threshold,
                                    int total, const int* perm, long long* stats,
                                    unsigned int* bounds, void* stream) {
  if (mode < kFillSlots || mode > kFillRefill) return 1;
  if (mode != kFillSlots && (ctr == nullptr || pool <= 0 || width <= 0)) return 1;
  Params p = {};
  p.cam = cam;
  p.sampler = {sampler, kx, ky, nbits};
  p.frame_seed = frame_seed;
  const Wavefront w = {{f0, f1}, {i0, i1}, stride, count, ctr, smp != 0, sample, 0, 0u, 0,
                       nullptr, nullptr};
  const WfFill fl = {mode, count, pool, width, y_offset, row_stride, s0, ctr,
                     {compact_threshold, refill_threshold, total, pool, 1, 0}, perm, stats,
                     bounds};
  const int slots = mode == kFillRefill ? stride : count;
  if (slots <= 0) return 0;
  Fit f;
  const cudaError_t e = fit(wavefront_raygen_kernel, 256, 0, &f);
  if (e != cudaSuccess) return static_cast<int>(e);
  wavefront_raygen_kernel<<<grid_of((slots + 255) / 256, f.resident()), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(p, w, total_width, regen != 0, fl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grt_hash_probe(const unsigned int* v, int n, const unsigned int* salts,
                              int n_salts, unsigned int sample_index,
                              unsigned int frame_seed, unsigned int* out_hash,
                              unsigned int* out_seeds, unsigned int* out_hash2,
                              float* out_uniform, void* stream) {
  const int block = 256;
  hash_probe_kernel<<<(n + block - 1) / block, block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      v, n, salts, n_salts, sample_index, frame_seed, out_hash, out_seeds,
      out_hash2, out_uniform);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grt_sampler_probe(const unsigned int* pids, const unsigned int* samples,
                                 int n, const unsigned int* salts, int n_salts,
                                 unsigned int frame_seed, int sampler, int kx, int ky,
                                 int nbits, float* out_u1, float* out_u2, void* stream) {
  const int block = 256;
  const Sampler sm = {sampler, kx, ky, nbits};
  sampler_probe_kernel<<<(n + block - 1) / block, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pids, samples, n, salts, n_salts, frame_seed, sm, out_u1, out_u2);
  return static_cast<int>(cudaGetLastError());
}

// The adaptive kernel's blocks a tile, for measurement: `blocks` > 0 sets
// the cluster size of later launches (1-16), 0 returns the choice to the
// launcher, < 0 changes nothing.  Returns the size the last adaptive launch
// used (0 before the first).
extern "C" int grt_adaptive_cluster(int blocks) {
  if (blocks >= 0) g_adaptive_cluster = blocks;
  return g_adaptive_cluster_used;
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
