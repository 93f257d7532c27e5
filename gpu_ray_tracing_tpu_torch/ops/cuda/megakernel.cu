// Path-tracing megakernel for Hopper (sm_90a): one thread per pixel, or one
// block per tile for the adaptive spp loop.
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
// ray counters (K1f).  In the fixed loop each thread runs ray generation,
// the bounce loop and the spp mean for its pixel and writes one RGB triple
// (and its ray count); the adaptive loop keeps its six state planes in
// device memory (render_adaptive_kernel below).
//
// What bounds it on this card: arithmetic on small scenes, scattered loads
// on large ones.  The brute scan tests every sphere (~25 flops each, N = 197
// for the One-Weekend scene); the scene is a few KB that every thread of a
// warp reads at the same address, so loads are broadcasts out of L1.  A BVH
// walk is one cursor per thread (the TPU walked one per tile and descended
// when any lane overlapped): threads of a warp visit different nodes, so
// node and triangle loads scatter through L1/L2 (a 81,920-face mesh table
// is 10 MB, inside the 50 MB L2).  NEE adds one shadow query per light and
// diffuse vertex; it ends at the first blocker, and only threads whose
// sample is otherwise valid start one.  Divergence is the other cost: a
// thread whose path ended idles until its warp's deepest path ends.  This
// version is simple: it stages nothing in shared memory and is built with
// -fmad=false and without fast math, so the compiler contracts nothing on
// its own.  Fused multiply-adds appear only where written (fmaf), where the
// reference's own rounding (XLA:CPU contracts a*b+c, and the goldens carry
// that) decides grazing hits, self-intersections and shadow rays: the ray
// generation, the sphere quadratic, Moller-Trumbore, hit points and the
// NEE sample directions, as the plain version (ops/integrators.py) writes
// them.
//
// Counter-based RNG: every draw is a pure function of (global pixel id,
// sample index, frame seed, salt), bit-exact with ops/rng.py.

#include <cuda_runtime.h>

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

enum Mode { PATH = 0, NORMAL = 1, ALBEDO = 2, DEPTH = 3 };

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

// The threaded BVH planes of ops/cuda/megakernel.py::bvh_planes: (8, M) f32
// bounds and (4, M) i32 links.
enum BvhRow { BMINX = 0, BMINY, BMINZ, BMAXX, BMAXY, BMAXZ };
enum BvhLink { LMISS = 0, LSTART, LCOUNT };

struct Bvh {
  const float* f;  // (8, m)
  const int* i;    // (4, m)
  int m;           // node count; 0 when absent
};

// Slots of a (F, 32) mesh table row (megakernel.py::mesh_table).
enum TriSlot {
  TV0 = 0, TE1 = 3, TE2 = 6, TN0 = 9, TN1 = 12, TN2 = 15, TALB = 18, TKIND = 21,
  TPARAM = 22, TLID = 23
};
constexpr int kTriSlots = 32;

// Stackless walk of a threaded BVH (`_traverse_bvh`, megakernel.py:273),
// one cursor per thread: a node whose slab interval overlaps the thread's
// window (t_min, tb) descends to node + 1, or runs `leaf(start, count)` if
// it is a leaf; otherwise the cursor follows the miss link, and -1 ends the
// walk.  `tb` is read at every node, so the window shrinks as leaves find
// hits; a leaf that returns true ends the walk (the any-hit query).  The
// entry test clamps tn to t_min first (megakernel.py:316-317).
template <class Leaf>
__device__ __forceinline__ void walk_bvh(const Bvh& b, Vec3 o, Vec3 inv, float t_min,
                                         const float& tb, Leaf leaf) {
  int node = 0;
  while (node >= 0) {
    const float t0x = (__ldg(b.f + BMINX * b.m + node) - o.x) * inv.x;
    const float t0y = (__ldg(b.f + BMINY * b.m + node) - o.y) * inv.y;
    const float t0z = (__ldg(b.f + BMINZ * b.m + node) - o.z) * inv.z;
    const float t1x = (__ldg(b.f + BMAXX * b.m + node) - o.x) * inv.x;
    const float t1y = (__ldg(b.f + BMAXY * b.m + node) - o.y) * inv.y;
    const float t1z = (__ldg(b.f + BMAXZ * b.m + node) - o.z) * inv.z;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const float tn_eff = fmaxf(tn, t_min);
    const bool enter = (tf >= tn_eff) & (tn_eff < tb);
    const int start = __ldg(b.i + LSTART * b.m + node);
    if (enter & (start >= 0)) {
      if (leaf(start, __ldg(b.i + LCOUNT * b.m + node))) return;
    }
    node = (enter & (start < 0)) ? node + 1 : __ldg(b.i + LMISS * b.m + node);
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

// Moller-Trumbore on face j of the mesh table (`_tri_intersect`,
// megakernel.py:439-470): determinant guard 1e-12, u, v >= 0, u + v <= 1,
// t_min < t < tb.  The cross and inner products round as fused
// multiply-adds, as the reference renders them (ops/rounding.py::cross,
// dot3).  A winner keeps its barycentrics for the smooth normal.
__device__ __forceinline__ bool tri_test(const float* __restrict__ tbl, int j, float t_min,
                                         Vec3 o, Vec3 d, float tb, float& t_out,
                                         float& u_out, float& v_out) {
  const float4* row = reinterpret_cast<const float4*>(tbl + (size_t)j * kTriSlots);
  const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
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

__device__ __forceinline__ void tri_scan(const float* __restrict__ tbl, int j0, int j1,
                                         float t_min, Vec3 o, Vec3 d, float& tb, int& best,
                                         float& bu, float& bv) {
  for (int j = j0; j < j1; ++j) {
    float t, u, v;
    if (tri_test(tbl, j, t_min, o, d, tb, t, u, v)) {
      tb = t;
      best = j;
      bu = u;
      bv = v;
    }
  }
}

struct Geometry {
  const float* scene;  // (16, n) sphere planes
  int n;
  Bvh sphere_bvh;      // over the reordered spheres, or m = 0: brute scan
  const float* mesh;   // (n_tris, 32) table, or null
  int n_tris;
  bool smooth;
  Bvh mesh_bvh;
};

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

__device__ Hit closest_hit(const Geometry& g, float t_min, float t_max, Vec3 o, Vec3 d) {
  const SphereRay sr = sphere_ray(o, d);
  float tb = t_max;
  int best = -1;
  const float* sc = g.scene;
  const int n = g.n;
  const Vec3 inv = safe_inverse(d);
  if (g.sphere_bvh.m > 0) {
    walk_bvh(g.sphere_bvh, o, inv, t_min, tb, [&](int start, int count) {
      sphere_scan(sc, n, start, start + count, t_min, o, d, sr, tb, best);
      return false;
    });
  } else {
    sphere_scan(sc, n, 0, n, t_min, o, d, sr, tb, best);
  }
  int tri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (g.n_tris > 0) {
    walk_bvh(g.mesh_bvh, o, inv, t_min, tb, [&](int start, int count) {
      tri_scan(g.mesh, start, start + count, t_min, o, d, tb, tri, bu, bv);
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
__device__ bool occluded(const Geometry& g, float t_min, Vec3 o, Vec3 w, float window) {
  if (!(window > t_min)) return false;
  const SphereRay sr = sphere_ray(o, w);
  const float* sc = g.scene;
  const int n = g.n;
  bool blocked = false;
  const auto spheres = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      float root;
      if (sphere_root(sc, n, j, t_min, o, w, sr, window, root)) return true;
    }
    return false;
  };
  const Vec3 inv = safe_inverse(w);
  if (g.sphere_bvh.m > 0) {
    walk_bvh(g.sphere_bvh, o, inv, t_min, window, [&](int start, int count) {
      blocked = spheres(start, start + count);
      return blocked;
    });
  } else {
    blocked = spheres(0, n);
  }
  if (!blocked && g.n_tris > 0) {
    walk_bvh(g.mesh_bvh, o, inv, t_min, window, [&](int start, int count) {
      for (int j = start; j < start + count; ++j) {
        float t, u, v;
        if (tri_test(g.mesh, j, t_min, o, w, window, t, u, v)) {
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
  float* out;  // (height, width, 3), or null (adaptive resume)
  float* rays;  // (height, width) rays-traced plane, or null
};

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
// light sample is valid, counted before its visibility test.
template <bool kNee, bool kCount>
__device__ __forceinline__ bool path_bounce(const Params& p, PathState& st,
                                            unsigned int seed, unsigned int base0,
                                            unsigned int s_abs, unsigned int pick_seed,
                                            int i, unsigned int& rays) {
  const Sampler& sm = p.sampler;
  const LightSet& ls = p.lights;
  const int n_lights = ls.L + ls.T;
  const Vec3 o = st.o, d = st.d;
  if (kCount) ++rays;
  const Hit h = closest_hit(p.geo, p.t_min, p.t_max, o, d);
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
      if (occluded(p.geo, p.t_min, h.p, ln.w, ln.reach * 0.999f)) continue;
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

// One sample of pixel (x, global row y): ray generation, then one closest
// hit (AOV modes) or the bounce loop, then the clamp; returns its RGB.  An
// AOV sample traces one ray.
template <bool kNee, bool kCount>
__device__ __forceinline__ Vec3 trace_sample(const Params& p, const Cam& cm, int x,
                                             unsigned int y, unsigned int pid,
                                             unsigned int base0, unsigned int s_abs,
                                             unsigned int& rays) {
  const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
  PathState st;
  generate_ray(p.sampler, cm, x, y, seed, base0, s_abs, st.o, st.d);
  if (p.mode != PATH) {
    // Bounce-free AOV modes (megakernel.py:1550-1576).
    const Vec3 o = st.o, d = st.d;
    float r, g, b;
    if (kCount) ++rays;
    const Hit h = closest_hit(p.geo, p.t_min, p.t_max, o, d);
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
  // The bounce loop.  The thread leaves it when its path ends: the
  // per-thread form of the tile early exit (megakernel.py:1609-1614).  A
  // path that exhausts max_depth contributes what it gathered so far
  // (black for the exhausted segment).
  st.tr = st.tg = st.tb = 1.0f;
  st.r = st.g = st.b = 0.0f;
  st.prev_diffuse = false;
  st.prev_cos = 0.0f;
  const unsigned int pick_seed = s_abs ^ wgsl_hash(p.frame_seed);
  for (int i = 0; i < p.max_depth; ++i)
    if (!path_bounce<kNee, kCount>(p, st, seed, base0, s_abs, pick_seed, i, rays)) break;
  clamp_sample(p, st.r, st.g, st.b);
  return {st.r, st.g, st.b};
}

// Global row and pixel id of a local pixel (megakernel.py:1492-1505): the
// stream keys on the global id, so a row band renders exactly its rows of
// the frame.
__device__ __forceinline__ unsigned int global_row(const Params& p, int y_local) {
  return (unsigned int)y_local * p.row_stride + p.y_offset;
}

// The fixed spp loop: one thread per pixel, the mean of p.spp samples.
template <bool kNee, bool kCount>
__global__ void __launch_bounds__(256) render_kernel(const Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_local = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y_local >= p.height) return;
  const unsigned int y = global_row(p, y_local);
  const unsigned int pid = y * (unsigned int)p.width + (unsigned int)x;
  // The sample-0 seed keys the sampler's per-(pixel, frame, pair) remaps.
  const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
  Cam cm;
  load_cam(p.cam, cm);
  unsigned int rays = 0u;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < p.spp; ++s) {
    const Vec3 c = trace_sample<kNee, kCount>(p, cm, x, y, pid, base0,
                                              p.sample_index + (unsigned int)s, rays);
    acc_r = acc_r + c.x;
    acc_g = acc_g + c.y;
    acc_b = acc_b + c.z;
  }
  const float inv = (float)p.spp;  // the mean is sum / spp (megakernel.py:1789)
  const size_t pix = (size_t)y_local * p.width + x;
  float* out = p.out + pix * 3;
  out[0] = acc_r / inv;
  out[1] = acc_g / inv;
  out[2] = acc_b / inv;
  if (kCount) p.rays[pix] = (float)rays;
}

constexpr int kAdaptiveThreads = 256;

// The adaptive spp loop (`_adaptive_tools` and its two loops,
// megakernel.py:1659-1776), one block per (tile_rows x 128) tile of the
// local frame.  Thread t owns the tile's pixels t, t + 256, ... in
// row-major order, so a warp traces neighbouring pixels of one row; pad
// pixels outside the frame are neither traced nor counted.  The six state
// planes live in global memory and are the resume ABI: the tile continues
// at its carried count k0 (tile-constant; read at the tile's first pixel)
// and takes samples while
//   (k < min_spp) | ((k < spp) & (mean(m2)/max(k-1,1)/k > (mean(mlum) tol + 1e-4)^2))
// and k < k0 + chunk, the means taken over the tile's in-frame pixels.  A
// one-shot render is this loop from zero planes with chunk = spp, so a
// chunked run takes the same samples and ends in the same bits.  The tile
// sums are a fixed-order tree in shared memory, with no atomics, so a tile
// stops at the same sample in every run.  Thread 0 decides and broadcasts
// through shared memory: the trip count is uniform in the block, which
// keeps __syncthreads() legal.  With `out` set it writes sum / k (the
// one-shot mean, megakernel.py:1776); `rays` accumulates per pixel.
template <bool kNee, bool kCount>
__global__ void __launch_bounds__(kAdaptiveThreads) render_adaptive_kernel(const Params p,
                                                                           const Adaptive a) {
  __shared__ float red_m2[kAdaptiveThreads];
  __shared__ float red_ml[kAdaptiveThreads];
  __shared__ int go;
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * 128;
  const int y0 = blockIdx.y * a.tile_rows;
  const size_t plane = (size_t)p.width * p.height;
  float* const s_r = a.state;
  float* const s_g = a.state + plane;
  float* const s_b = a.state + 2 * plane;
  float* const s_k = a.state + 3 * plane;
  float* const s_ml = a.state + 4 * plane;
  float* const s_m2 = a.state + 5 * plane;
  const int rows = min(a.tile_rows, p.height - y0);
  const int cols = min(128, p.width - x0);
  const float n_valid = fmaxf((float)(rows * cols), 1.0f);
  const int k0 = (int)s_k[(size_t)y0 * p.width + x0];
  Cam cm;
  load_cam(p.cam, cm);

  // Partial sums of the thread's in-frame pixels, in a fixed order.
  float pm2 = 0.0f, pml = 0.0f;
  for (int q = t; q < a.tile_rows * 128; q += kAdaptiveThreads) {
    const int row = q >> 7, col = q & 127;
    if (row >= rows || col >= cols) continue;
    const size_t pix = (size_t)(y0 + row) * p.width + (x0 + col);
    pm2 = pm2 + s_m2[pix];
    pml = pml + s_ml[pix];
  }
  int k = k0;
  while (true) {
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
    __syncthreads();
    if (!go) break;
    // Sample k of every in-frame pixel: Welford update of the pixel's
    // luminance (megakernel.py:1676-1682) and the raw sums.
    const unsigned int s_abs = p.sample_index + (unsigned int)k;
    const float k1f = (float)(k + 1);
    pm2 = 0.0f;
    pml = 0.0f;
    for (int q = t; q < a.tile_rows * 128; q += kAdaptiveThreads) {
      const int row = q >> 7, col = q & 127;
      if (row >= rows || col >= cols) continue;
      const int x = x0 + col, y_local = y0 + row;
      const unsigned int y = global_row(p, y_local);
      const unsigned int pid = y * (unsigned int)p.width + (unsigned int)x;
      const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
      unsigned int rays = 0u;
      const Vec3 c = trace_sample<kNee, kCount>(p, cm, x, y, pid, base0, s_abs, rays);
      const size_t pix = (size_t)y_local * p.width + x;
      const float lum = (c.x + c.y + c.z) * (1.0f / 3.0f);
      const float ml = s_ml[pix];
      const float dl = lum - ml;
      const float ml1 = ml + dl / k1f;
      // M2 rounds as one fused multiply-add: XLA:CPU contracts it in the
      // reference's run.
      const float m21 = fmaf(dl, lum - ml1, s_m2[pix]);
      s_ml[pix] = ml1;
      s_m2[pix] = m21;
      s_r[pix] = s_r[pix] + c.x;
      s_g[pix] = s_g[pix] + c.y;
      s_b[pix] = s_b[pix] + c.z;
      if (kCount) p.rays[pix] = p.rays[pix] + (float)rays;
      pm2 = pm2 + m21;
      pml = pml + ml1;
    }
    ++k;
  }
  const float kf = (float)k;
  for (int q = t; q < a.tile_rows * 128; q += kAdaptiveThreads) {
    const int row = q >> 7, col = q & 127;
    if (row >= rows || col >= cols) continue;
    const size_t pix = (size_t)(y0 + row) * p.width + (x0 + col);
    s_k[pix] = kf;
    if (p.out != nullptr) {
      p.out[pix * 3 + 0] = s_r[pix] / kf;
      p.out[pix * 3 + 1] = s_g[pix] / kf;
      p.out[pix * 3 + 2] = s_b[pix] / kf;
    }
  }
}

// ---------------------------------------------------------------------------
// The wavefront engine's kernels (K2).  Replaces the Pallas TPU kernel
// gpu_ray_tracing_tpu/ops/pallas/wavefront.py `_wf_kernel` (launched by
// `render_wavefront`): one `path_bounce` for every ray of a compacted ray
// array, the state kept in device memory between launches.
//
// One thread per ray slot over structure-of-arrays planes, (kWfPlanes,
// stride) f32 and (2 or 4, stride) i32, updated in place (a thread touches
// only its own slot, so nothing is double-buffered).  A dead slot returns at
// once: the per-thread form of the TPU kernel's all-dead-tile passthrough.
// The TPU kernel emitted radiance deltas per bounce; here a path carries its
// running radiance in its state, so every sum has the megakernel's order
// ((r + a) + b, never r + (a + b)) and the image equals the megakernel's bit
// for bit, and writes its sample's total, clamped, into slot
// `pix [+ (sample - sample_base) n_pixels]` of `out` when it ends or
// exhausts max_depth.  Each (pixel, sample) ends exactly once, so the write
// is a plain store and the image is the same in every run; the host folds
// the samples in sample order (ops/cuda/wavefront.py).
//
// What bounds it on this card: the same arithmetic as the megakernel's
// bounce (the sphere scan or BVH walk), plus the state traffic the
// megakernel keeps in registers: up to 15 planes read and written per live
// ray and bounce.  Compaction (host side) keeps warps full of live rays.
enum WfPlane {
  WOX = 0, WOY, WOZ, WDX, WDY, WDZ, WTR, WTG, WTB, WRR, WRG, WRB, WPD, WPC, WLIVE, WRAYS,
  kWfPlanes
};
enum WfInt { WPID = 0, WPIX, WSMP, WBNC };

struct Wavefront {
  float* f;         // (kWfPlanes, stride) state planes
  int* i;           // (2, stride) pid, pix; under regeneration (4, stride): + sample, bounce
  int stride;       // slots a plane holds
  int n;            // slots this launch covers
  unsigned int sample;  // without regeneration: every ray's sample ...
  int bounce;           // ... and bounce
  unsigned int sample_base;  // under regeneration: the flush slot's sample origin
  int n_pixels;              // ... and its stride, the frame's local pixels
  float* out;       // (slots, 3) finished samples
  float* rays_out;  // (slots,) rays each finished sample traced, or null
};

// One bounce of every live ray.  kRegen reads sample and bounce per ray
// (rays of one launch mix them), else both are launch scalars.
template <bool kNee, bool kCount, bool kRegen>
__global__ void __launch_bounds__(256) wavefront_bounce_kernel(const Params p,
                                                               const Wavefront w) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w.n) return;
  float* const f = w.f + t;
  const size_t ps = (size_t)w.stride;
  if (!(f[WLIVE * ps] > 0.5f)) return;
  const unsigned int pid = (unsigned int)w.i[WPID * ps + t];
  const unsigned int s_abs = kRegen ? (unsigned int)w.i[WSMP * ps + t] : w.sample;
  const int i = kRegen ? w.i[WBNC * ps + t] : w.bounce;
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
  const bool live = path_bounce<kNee, kCount>(p, st, seed, base0, s_abs, pick_seed, i, rays);
  float n_rays = 0.0f;
  if (kCount) n_rays = f[WRAYS * ps] + (float)rays;
  if (kRegen) w.i[WBNC * ps + t] = i + 1;
  if (!live || i + 1 >= p.max_depth) {
    // The sample is finished: clamp it and hand it to the image.
    clamp_sample(p, st.r, st.g, st.b);
    size_t slot = (size_t)w.i[WPIX * ps + t];
    if (kRegen) slot += (size_t)(s_abs - w.sample_base) * (size_t)w.n_pixels;
    w.out[slot * 3 + 0] = st.r;
    w.out[slot * 3 + 1] = st.g;
    w.out[slot * 3 + 2] = st.b;
    if (kCount) w.rays_out[slot] = n_rays;
    f[WLIVE * ps] = 0.0f;
    return;
  }
  f[WOX * ps] = st.o.x, f[WOY * ps] = st.o.y, f[WOZ * ps] = st.o.z;
  f[WDX * ps] = st.d.x, f[WDY * ps] = st.d.y, f[WDZ * ps] = st.d.z;
  f[WTR * ps] = st.tr, f[WTG * ps] = st.tg, f[WTB * ps] = st.tb;
  f[WRR * ps] = st.r, f[WRG * ps] = st.g, f[WRB * ps] = st.b;
  f[WPD * ps] = st.prev_diffuse ? 1.0f : 0.0f;
  f[WPC * ps] = st.prev_cos;
  if (kCount) f[WRAYS * ps] = n_rays;
}

// Primary rays for the slots of a ray array (all, or those `take` flags):
// the megakernel's own ray generation, so a wavefront path starts from the
// same bits.  A slot's pixel is (pid mod total_width, pid / total_width) of
// the whole frame; a slot whose pix is negative holds no ray and is born
// dead.  Replaces the XLA ray generation `render_wavefront` calls
// (wavefront.py:506, :682) and the in-kernel one of megakernel.py:1507.
__global__ void __launch_bounds__(256) wavefront_raygen_kernel(const Params p,
                                                               const Wavefront w,
                                                               unsigned int total_width,
                                                               bool regen,
                                                               const int* __restrict__ take) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w.n) return;
  if (take != nullptr && take[t] == 0) return;
  float* const f = w.f + t;
  const size_t ps = (size_t)w.stride;
  if (regen) w.i[WBNC * ps + t] = 0;
  f[WRR * ps] = f[WRG * ps] = f[WRB * ps] = 0.0f;
  f[WPD * ps] = f[WPC * ps] = f[WRAYS * ps] = 0.0f;
  f[WTR * ps] = f[WTG * ps] = f[WTB * ps] = 1.0f;
  if (w.i[WPIX * ps + t] < 0) {
    f[WOX * ps] = f[WOY * ps] = f[WOZ * ps] = 0.0f;
    f[WDX * ps] = f[WDY * ps] = f[WDZ * ps] = 0.0f;
    f[WLIVE * ps] = 0.0f;
    return;
  }
  const unsigned int pid = (unsigned int)w.i[WPID * ps + t];
  const unsigned int s_abs = regen ? (unsigned int)w.i[WSMP * ps + t] : w.sample;
  const unsigned int seed = hash_pixel_seeds(pid, s_abs, p.frame_seed);
  const unsigned int base0 = hash_pixel_seeds(pid, 0u, p.frame_seed);
  Cam cm;
  load_cam(p.cam, cm);
  Vec3 o, d;
  generate_ray(p.sampler, cm, (int)(pid % total_width), pid / total_width, seed, base0,
               s_abs, o, d);
  f[WOX * ps] = o.x, f[WOY * ps] = o.y, f[WOZ * ps] = o.z;
  f[WDX * ps] = d.x, f[WDY * ps] = d.y, f[WDZ * ps] = d.z;
  f[WLIVE * ps] = 1.0f;
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
Params scene_params(const float* cam, const float* scene, int n, const float* sbvh_f,
                    const int* sbvh_i, int sbvh_m, const float* mesh, int n_tris,
                    int smooth, const float* mbvh_f, const int* mbvh_i, int mbvh_m,
                    const float* lights, int n_lights, const float* tri_lights,
                    int n_tri_lights, int nee, int mis, int sampler, int kx, int ky,
                    int nbits) {
  Params p = {};
  p.cam = cam;
  p.geo.scene = scene;
  p.geo.n = n;
  p.geo.sphere_bvh = {sbvh_f, sbvh_i, sbvh_m};
  p.geo.mesh = mesh;
  p.geo.n_tris = n_tris;
  p.geo.smooth = smooth != 0;
  p.geo.mesh_bvh = {mbvh_f, mbvh_i, mbvh_m};
  p.lights = {lights, nee ? n_lights : 0, tri_lights, nee ? n_tri_lights : 0};
  p.mis = nee != 0 && mis != 0;
  p.sampler = {sampler, kx, ky, nbits};
  return p;
}

}  // namespace

// Plain C interface for ctypes (ops/cuda/build.py).  Each launcher enqueues
// on the given stream, does not synchronise, and returns cudaGetLastError()
// as an int (0 = launched).

// The geometry: (16, n) sphere planes; a sphere BVH (sbvh_m = 0: brute
// scan); a (n_tris, 32) mesh table with its BVH (n_tris = 0: no mesh).
// The lights: (8, n_lights) and (16, n_tri_lights) planes, read when nee.
// The sampler: kind 0 independent, 1 stratified (kx, ky), 2 Sobol (nbits).
// The outputs: `out` (height, width, 3) and, when not null, `rays`
// (height, width), the rays traced per pixel.  With `state` (6, height,
// width) the adaptive loop runs (spp is its budget) and updates the state;
// `out` is then optional (the one-shot mean).
extern "C" int grt_render(const float* cam, const float* scene, int n,
                          const float* sbvh_f, const int* sbvh_i, int sbvh_m,
                          const float* mesh, int n_tris, int smooth,
                          const float* mbvh_f, const int* mbvh_i, int mbvh_m,
                          const float* lights, int n_lights, const float* tri_lights,
                          int n_tri_lights, int nee, int mis, int sampler, int kx, int ky,
                          int nbits, int width, int height, unsigned int sample_index,
                          unsigned int frame_seed, unsigned int y_offset,
                          unsigned int row_stride, int max_depth, float t_min,
                          float t_max, int mode, int rr_depth, float sky_intensity,
                          float clamp, int spp, float* out, float* rays, float* state,
                          int tile_rows, int min_spp, int chunk, float tol, void* stream) {
  Params p = scene_params(cam, scene, n, sbvh_f, sbvh_i, sbvh_m, mesh, n_tris, smooth,
                          mbvh_f, mbvh_i, mbvh_m, lights, n_lights, tri_lights,
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool count = rays != nullptr;
  if (state != nullptr) {
    const Adaptive a = {state, tile_rows, min_spp, chunk, tol};
    const dim3 grid((width + 127) / 128, (height + tile_rows - 1) / tile_rows);
    const int block = kAdaptiveThreads;
    if (nee) {
      if (count) render_adaptive_kernel<true, true><<<grid, block, 0, s>>>(p, a);
      else render_adaptive_kernel<true, false><<<grid, block, 0, s>>>(p, a);
    } else {
      if (count) render_adaptive_kernel<false, true><<<grid, block, 0, s>>>(p, a);
      else render_adaptive_kernel<false, false><<<grid, block, 0, s>>>(p, a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  if (nee) {
    if (count) render_kernel<true, true><<<grid, block, 0, s>>>(p);
    else render_kernel<true, false><<<grid, block, 0, s>>>(p);
  } else {
    if (count) render_kernel<false, true><<<grid, block, 0, s>>>(p);
    else render_kernel<false, false><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// One wavefront bounce over slots [0, n) of the state planes (`state_f`
// (16, stride) f32, `state_i` (2 or 4, stride) i32), in place.  The scene
// arguments are grt_render's.  With `regen` each ray reads its own sample
// and bounce (state_i rows 2 and 3) and a finished sample goes to slot
// pix + (sample - sample_base) n_pixels of `out`; without it the launch
// scalars `sample` and `bounce` apply and the slot is pix.  `rays_out`, when
// not null, receives the rays each finished sample traced.
extern "C" int grt_wavefront_bounce(
    const float* scene, int n, const float* sbvh_f, const int* sbvh_i, int sbvh_m,
    const float* mesh, int n_tris, int smooth, const float* mbvh_f, const int* mbvh_i,
    int mbvh_m, const float* lights, int n_lights, const float* tri_lights,
    int n_tri_lights, int nee, int mis, int sampler, int kx, int ky, int nbits,
    unsigned int frame_seed, int max_depth, float t_min, float t_max, int rr_depth,
    float sky_intensity, float clamp, float* state_f, int* state_i, int stride, int n_slots,
    int regen, unsigned int sample, int bounce, unsigned int sample_base, int n_pixels,
    float* out, float* rays_out, void* stream) {
  Params p = scene_params(nullptr, scene, n, sbvh_f, sbvh_i, sbvh_m, mesh, n_tris, smooth,
                          mbvh_f, mbvh_i, mbvh_m, lights, n_lights, tri_lights,
                          n_tri_lights, nee, mis, sampler, kx, ky, nbits);
  p.frame_seed = frame_seed;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.t_max = t_max;
  p.mode = PATH;
  p.rr_depth = rr_depth;
  p.sky_intensity = sky_intensity;
  p.clamp = clamp;
  const Wavefront w = {state_f, state_i, stride, n_slots, sample, bounce, sample_base,
                       n_pixels, out, rays_out};
  if (n_slots <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = 256;
  const int grid = (n_slots + block - 1) / block;
  const bool count = rays_out != nullptr;
#define GRT_WF_LAUNCH(NEE, COUNT, REGEN) \
  wavefront_bounce_kernel<NEE, COUNT, REGEN><<<grid, block, 0, s>>>(p, w)
  if (nee) {
    if (count) {
      if (regen) GRT_WF_LAUNCH(true, true, true); else GRT_WF_LAUNCH(true, true, false);
    } else {
      if (regen) GRT_WF_LAUNCH(true, false, true); else GRT_WF_LAUNCH(true, false, false);
    }
  } else {
    if (count) {
      if (regen) GRT_WF_LAUNCH(false, true, true); else GRT_WF_LAUNCH(false, true, false);
    } else {
      if (regen) GRT_WF_LAUNCH(false, false, true); else GRT_WF_LAUNCH(false, false, false);
    }
  }
#undef GRT_WF_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Primary rays into slots [0, n) of the wavefront state (those `take`
// flags when it is not null): see wavefront_raygen_kernel.
extern "C" int grt_wavefront_raygen(const float* cam, int sampler, int kx, int ky, int nbits,
                                    unsigned int frame_seed, unsigned int total_width,
                                    float* state_f, int* state_i, int stride, int n_slots,
                                    int regen, unsigned int sample, const int* take,
                                    void* stream) {
  Params p = {};
  p.cam = cam;
  p.sampler = {sampler, kx, ky, nbits};
  p.frame_seed = frame_seed;
  const Wavefront w = {state_f, state_i, stride, n_slots, sample, 0, 0u, 0, nullptr, nullptr};
  if (n_slots <= 0) return 0;
  const int block = 256;
  wavefront_raygen_kernel<<<(n_slots + block - 1) / block, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(p, w, total_width,
                                                                 regen != 0, take);
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

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
