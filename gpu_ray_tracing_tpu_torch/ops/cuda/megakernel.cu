// Path-tracing megakernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the Pallas TPU kernel gpu_ray_tracing_tpu/ops/pallas/megakernel.py
// `_kernel` (launched by `render_pallas`) on its K1a, K1c and K1d paths:
// spheres by the brute-force closest-hit scan (K1a) or through a sphere BVH
// (K1c), triangle meshes behind a threaded BVH, flat or smooth shaded (K1d);
// the independent hash sampler, no NEE/MIS, the fixed spp loop, the
// normal/albedo/depth AOV modes, Russian roulette and the per-sample clamp.
// Each thread runs ray generation, the bounce loop and the spp mean for its
// pixel and writes one RGB triple; nothing else touches device memory.
//
// What bounds it on this card: arithmetic on small scenes, scattered loads
// on large ones.  The brute scan tests every sphere (~25 flops each, N = 197
// for the One-Weekend scene); the scene is a few KB that every thread of a
// warp reads at the same address, so loads are broadcasts out of L1.  A BVH
// walk is one cursor per thread (the TPU walked one per tile and descended
// when any lane overlapped): threads of a warp visit different nodes, so
// node and triangle loads scatter through L1/L2 (a 81,920-face mesh table
// is 10 MB, inside the 50 MB L2).  Divergence is the other cost: a thread
// whose path ended idles until its warp's deepest path ends.  This version
// is simple: it stages nothing in shared memory and is built with
// -fmad=false and without fast math, so the compiler contracts nothing on
// its own.  Fused multiply-adds appear only where written (fmaf): in the ray
// generation, the sphere quadratic and Moller-Trumbore, where the
// reference's own rounding (XLA:CPU contracts a*b+c, and the goldens carry
// that) decides grazing hits and self-intersections.
//
// Counter-based RNG: every draw is a pure function of (global pixel id,
// sample index, frame seed, salt), bit-exact with ops/rng.py.

#include <cuda_runtime.h>

namespace {

// Rows of the (16, N) scene planes (ops/cuda/megakernel.py::scene_planes).
enum SceneRow { CX = 0, CY, CZ, RAD, C2R2, ALR, ALG, ALB, KIND, PARAM, ACTIVE };

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
// hits.  The entry test clamps tn to t_min first (megakernel.py:316-317).
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
    if (enter & (start >= 0)) leaf(start, __ldg(b.i + LCOUNT * b.m + node));
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
__device__ __forceinline__ void sphere_scan(const float* __restrict__ sc, int n, int j0,
                                            int j1, float t_min, Vec3 o, Vec3 d,
                                            const SphereRay& r, float& tb, int& best) {
  for (int j = j0; j < j1; ++j) {
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
    if ((disc >= 0.0f) & (nok | fok) & (__ldg(sc + ACTIVE * n + j) > 0.0f)) {
      tb = nok ? rn : rf;
      best = j;
    }
  }
}

// Moller-Trumbore over faces [j0, j1) of the mesh table (`_tri_intersect`,
// megakernel.py:439-470): determinant guard 1e-12, u, v >= 0, u + v <= 1,
// t_min < t < tb.  The cross and inner products round as fused
// multiply-adds, as the reference renders them (ops/rounding.py::cross,
// dot3).  A winner keeps its barycentrics for the smooth normal.
__device__ __forceinline__ void tri_scan(const float* __restrict__ tbl, int j0, int j1,
                                         float t_min, Vec3 o, Vec3 d, float& tb, int& best,
                                         float& bu, float& bv) {
  for (int j = j0; j < j1; ++j) {
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
    if (!near_parallel & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > t_min) &
        (t < tb)) {
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
__device__ Hit closest_hit(const Geometry& g, float t_min, float t_max, Vec3 o, Vec3 d) {
  SphereRay sr;
  sr.a = fdot3(d.x, d.y, d.z, d.x, d.y, d.z);
  sr.inv_a = 1.0f / sr.a;
  sr.od = fdot3(o.x, o.y, o.z, d.x, d.y, d.z);
  sr.oo = fdot3(o.x, o.y, o.z, o.x, o.y, o.z);
  float tb = t_max;
  int best = -1;
  const float* sc = g.scene;
  const int n = g.n;
  const Vec3 inv = safe_inverse(d);
  if (g.sphere_bvh.m > 0) {
    walk_bvh(g.sphere_bvh, o, inv, t_min, tb, [&](int start, int count) {
      sphere_scan(sc, n, start, start + count, t_min, o, d, sr, tb, best);
    });
  } else {
    sphere_scan(sc, n, 0, n, t_min, o, d, sr, tb, best);
  }
  int tri = -1;
  float bu = 0.0f, bv = 0.0f;
  if (g.n_tris > 0) {
    walk_bvh(g.mesh_bvh, o, inv, t_min, tb, [&](int start, int count) {
      tri_scan(g.mesh, start, start + count, t_min, o, d, tb, tri, bu, bv);
    });
  }

  Hit r;
  r.hit = tb < t_max;
  r.t = r.hit ? tb : 1.0f;  // a benign t for misses
  r.p = {o.x + r.t * d.x, o.y + r.t * d.y, o.z + r.t * d.z};
  r.ar = r.ag = r.ab = r.kind = r.param = 0.0f;
  Vec3 nrm;
  if (tri >= 0) {
    const float* f = g.mesh + (size_t)tri * kTriSlots;
    r.ar = __ldg(f + TALB);
    r.ag = __ldg(f + TALB + 1);
    r.ab = __ldg(f + TALB + 2);
    r.kind = __ldg(f + TKIND);
    r.param = __ldg(f + TPARAM);
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

// Vertical white->blue gradient (wgsl:293-296), `_sky` (megakernel.py:764).
__device__ __forceinline__ Vec3 sky(Vec3 d) {
  const float inv_len = rsqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  const float a = 0.5f * (d.y * inv_len + 1.0f);
  return {1.0f - 0.5f * a, 1.0f - 0.3f * a, 1.0f};
}

// Three-material scatter, `_scatter` (megakernel.py:780-866): salts
// salt_base, +1, +2.  Only the hit material's BSDF is evaluated; the draws
// are pure functions of (seed, salt), so skipping unused ones changes
// nothing.  Returns false when the ray is absorbed.
__device__ __forceinline__ bool scatter(const Hit& h, Vec3 d, unsigned int seed,
                                        unsigned int salt_base, Vec3* out,
                                        Vec3* att) {
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
  const float u1 = uniform_hash(seed, salt_base);
  const float u2 = uniform_hash(seed, salt_base + 1u);
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

struct Params {
  const float* cam;  // (24,)
  Geometry geo;
  int width, height;
  unsigned int sample_index, frame_seed, y_offset, row_stride;
  int max_depth;
  float t_min, t_max;
  int mode;
  int rr_depth;
  float sky_intensity;
  float clamp;
  int spp;
  float* out;  // (height, width, 3)
};

__global__ void __launch_bounds__(256) render_kernel(const Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_local = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y_local >= p.height) return;
  // Global row and pixel id (megakernel.py:1492-1505): the stream keys on
  // the global id, so a row band renders exactly its rows of the frame.
  const unsigned int y = (unsigned int)y_local * p.row_stride + p.y_offset;
  const unsigned int pid = y * (unsigned int)p.width + (unsigned int)x;

  float cam[19];
#pragma unroll
  for (int k = 0; k < 19; ++k) cam[k] = __ldg(p.cam + k);
  const bool lens = cam[DEFOCUS_ANGLE] > 0.0f;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < p.spp; ++s) {
    const unsigned int seed =
        hash_pixel_seeds(pid, p.sample_index + (unsigned int)s, p.frame_seed);
    // Ray generation (megakernel.py:1507-1548): jitter from salts 1-2,
    // uniform-disk lens point from salts 3-4, direction not normalized.
    const float jx = uniform_hash(seed, 1u) - 0.5f;
    const float jy = uniform_hash(seed, 2u) - 0.5f;
    // The pixel center and lens point round as the reference renders them
    // (fused multiply-adds, cos/sin rounded from double; ops/rays.py): a
    // ray one ulp off can graze a sphere differently.
    const float fx = (float)x + 0.5f + jx;
    const float fy = (float)y + 0.5f + jy;
    Vec3 pc;
    pc.x = fmaf(cam[PDV + 0], fy, fmaf(cam[PDU + 0], fx, cam[UPPER_LEFT + 0]));
    pc.y = fmaf(cam[PDV + 1], fy, fmaf(cam[PDU + 1], fx, cam[UPPER_LEFT + 1]));
    pc.z = fmaf(cam[PDV + 2], fy, fmaf(cam[PDU + 2], fx, cam[UPPER_LEFT + 2]));
    Vec3 o = {cam[CENTER + 0], cam[CENTER + 1], cam[CENTER + 2]};
    if (lens) {
      const float radius = sqrtf(uniform_hash(seed, 3u));
      const double ang = (double)(kTwoPi * uniform_hash(seed, 4u));
      const float pxd = radius * (float)cos(ang);
      const float pyd = radius * (float)sin(ang);
      o.x = fmaf(pyd, cam[DISK_V + 0], fmaf(pxd, cam[DISK_U + 0], o.x));
      o.y = fmaf(pyd, cam[DISK_V + 1], fmaf(pxd, cam[DISK_U + 1], o.y));
      o.z = fmaf(pyd, cam[DISK_V + 2], fmaf(pxd, cam[DISK_U + 2], o.z));
    }
    Vec3 d = {pc.x - o.x, pc.y - o.y, pc.z - o.z};

    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (p.mode != PATH) {
      // Bounce-free AOV modes (megakernel.py:1550-1576).
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
    } else {
      // The bounce loop of `_path_bounce` (megakernel.py:874-1417) with no
      // lights.  The thread leaves the loop when its path ends: the
      // per-thread form of the tile early exit (megakernel.py:1609-1614).
      float tr = 1.0f, tg = 1.0f, tb = 1.0f;
      for (int i = 0; i < p.max_depth; ++i) {
        const Hit h = closest_hit(p.geo, p.t_min, p.t_max, o, d);
        if (!h.hit) {
          const Vec3 sk = sky(d);
          r = r + tr * sk.x * p.sky_intensity;
          g = g + tg * sk.y * p.sky_intensity;
          b = b + tb * sk.z * p.sky_intensity;
          break;
        }
        if (h.kind >= 2.5f) {  // emissive: radiate albedo * param, end the path
          r = r + tr * h.ar * h.param;
          g = g + tg * h.ag * h.param;
          b = b + tb * h.ab * h.param;
          break;
        }
        Vec3 nd, att;
        if (!scatter(h, d, seed, 16u + 3u * (unsigned int)i, &nd, &att)) break;
        tr = tr * att.x;
        tg = tg * att.y;
        tb = tb * att.z;
        o = h.p;
        d = nd;
        if (p.rr_depth > 0 && i >= p.rr_depth) {
          // Russian roulette, salt 1000+i (megakernel.py:1397-1408).
          const float u_rr = uniform_hash(seed, 1000u + (unsigned int)i);
          const float pmax = fminf(fmaxf(fmaxf(tr, fmaxf(tg, tb)), 0.05f), 1.0f);
          if (!(u_rr < pmax)) break;
          const float inv_p = 1.0f + (1.0f / pmax - 1.0f);
          tr = tr * inv_p;
          tg = tg * inv_p;
          tb = tb * inv_p;
        }
      }
      // A path that exhausts max_depth contributes what it gathered so far
      // (black for the exhausted segment).
      if (p.clamp > 0.0f) {  // per-sample clamp (megakernel.py:1647-1654)
        const float m = fmaxf(r, fmaxf(g, b));
        const float scale = fminf(1.0f, p.clamp / fmaxf(m, 1e-12f));
        r = r * scale, g = g * scale, b = b * scale;
      }
    }
    acc_r = acc_r + r;
    acc_g = acc_g + g;
    acc_b = acc_b + b;
  }
  const float inv = (float)p.spp;  // the mean is sum / spp (megakernel.py:1789)
  float* out = p.out + ((size_t)y_local * p.width + x) * 3;
  out[0] = acc_r / inv;
  out[1] = acc_g / inv;
  out[2] = acc_b / inv;
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

}  // namespace

// Plain C interface for ctypes (ops/cuda/build.py).  Each launcher enqueues
// on the given stream, does not synchronise, and returns cudaGetLastError()
// as an int (0 = launched).

// The geometry: (16, n) sphere planes; a sphere BVH (sbvh_m = 0: brute
// scan); a (n_tris, 32) mesh table with its BVH (n_tris = 0: no mesh).
extern "C" int grt_render(const float* cam, const float* scene, int n,
                          const float* sbvh_f, const int* sbvh_i, int sbvh_m,
                          const float* mesh, int n_tris, int smooth,
                          const float* mbvh_f, const int* mbvh_i, int mbvh_m,
                          int width, int height, unsigned int sample_index,
                          unsigned int frame_seed, unsigned int y_offset,
                          unsigned int row_stride, int max_depth, float t_min,
                          float t_max, int mode, int rr_depth, float sky_intensity,
                          float clamp, int spp, float* out, void* stream) {
  Params p;
  p.cam = cam;
  p.geo.scene = scene;
  p.geo.n = n;
  p.geo.sphere_bvh = {sbvh_f, sbvh_i, sbvh_m};
  p.geo.mesh = mesh;
  p.geo.n_tris = n_tris;
  p.geo.smooth = smooth != 0;
  p.geo.mesh_bvh = {mbvh_f, mbvh_i, mbvh_m};
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
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  render_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
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

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
