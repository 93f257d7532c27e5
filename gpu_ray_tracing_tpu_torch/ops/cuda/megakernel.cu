// Path-tracing megakernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the Pallas TPU kernel gpu_ray_tracing_tpu/ops/pallas/megakernel.py
// `_kernel` (launched by `render_pallas`) on its K1a path: spheres only, the
// brute-force closest-hit scan, the independent hash sampler, no NEE/MIS, the
// fixed spp loop, the normal/albedo/depth AOV modes, Russian roulette and the
// per-sample clamp.  Each thread runs ray generation, the bounce loop and the
// spp mean for its pixel and writes one RGB triple; nothing else touches
// device memory.
//
// What bounds it on this card: arithmetic.  Per bounce a thread tests every
// sphere (~25 flops each, N = 197 for the One-Weekend scene) and the scene is
// a few KB that every thread of a warp reads at the same address, so loads are
// broadcasts out of L1.  Divergence is the other cost: a thread whose path
// ended idles until its warp's deepest path ends (the per-thread form of the
// TPU tile's early exit).  This first version is simple: it stages nothing
// in shared memory and is built with -fmad=false and without fast math, so
// the compiler contracts nothing on its own.  Fused multiply-adds appear
// only where written (fmaf): in the ray generation and the sphere quadratic,
// where the reference's own rounding (XLA:CPU contracts a*b+c, and the
// goldens carry that) decides grazing hits and self-intersections.
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

// Brute-force shrinking-window scan over all N spheres (wgsl:164-221): the
// quadratic of `_sphere_root` (megakernel.py:530) with its far-root fallback,
// then the hit record of `_closest_hit` (megakernel.py:660-761).  A ray that
// leaves a surface starts with |o - c|^2 - r^2 near 0, so the last bits of
// this quadratic decide self-intersections; its inner products and
// discriminant round as fused multiply-adds, like the reference renders
// (ops/intersect.py::_sphere_roots), and it forms |c|^2 - r^2 in-kernel the
// same way instead of reading the C2R2 row.
__device__ Hit closest_hit(const float* __restrict__ sc, int n, float t_min,
                           float t_max, Vec3 o, Vec3 d) {
  const float a = fdot3(d.x, d.y, d.z, d.x, d.y, d.z);
  const float inv_a = 1.0f / a;
  const float od = fdot3(o.x, o.y, o.z, d.x, d.y, d.z);
  const float oo = fdot3(o.x, o.y, o.z, o.x, o.y, o.z);
  float tb = t_max;
  int best = -1;
  for (int j = 0; j < n; ++j) {
    const float cx = __ldg(sc + CX * n + j);
    const float cy = __ldg(sc + CY * n + j);
    const float cz = __ldg(sc + CZ * n + j);
    const float rj = __ldg(sc + RAD * n + j);
    const float c2r2 = fdot3(cx, cy, cz, cx, cy, cz) - rj * rj;
    const float h = fdot3(d.x, d.y, d.z, cx, cy, cz) - od;
    const float cc = c2r2 - 2.0f * fdot3(o.x, o.y, o.z, cx, cy, cz) + oo;
    const float disc = fmaf(h, h, -(a * cc));
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float rn = (h - sq) * inv_a;
    const float rf = (h + sq) * inv_a;
    const bool nok = (rn > t_min) & (rn < tb);
    const bool fok = (rf > t_min) & (rf < tb);
    if ((disc >= 0.0f) & (nok | fok) & (__ldg(sc + ACTIVE * n + j) > 0.0f)) {
      tb = nok ? rn : rf;
      best = j;
    }
  }
  Hit r;
  r.hit = tb < t_max;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, rad = 0.0f;
  r.ar = r.ag = r.ab = r.kind = r.param = 0.0f;
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
  // The hit point, then the outward normal (p - c) / r (wgsl:206).
  r.t = r.hit ? tb : 1.0f;
  r.p = {o.x + r.t * d.x, o.y + r.t * d.y, o.z + r.t * d.z};
  const float rs = rad != 0.0f ? rad : 1.0f;
  const Vec3 nrm = {(r.p.x - cx) / rs, (r.p.y - cy) / rs, (r.p.z - cz) / rs};
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
  const float* cam;    // (24,)
  const float* scene;  // (16, n)
  int n;
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
      const Hit h = closest_hit(p.scene, p.n, p.t_min, p.t_max, o, d);
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
        const Hit h = closest_hit(p.scene, p.n, p.t_min, p.t_max, o, d);
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

extern "C" int grt_render(const float* cam, const float* scene, int n, int width,
                          int height, unsigned int sample_index,
                          unsigned int frame_seed, unsigned int y_offset,
                          unsigned int row_stride, int max_depth, float t_min,
                          float t_max, int mode, int rr_depth, float sky_intensity,
                          float clamp, int spp, float* out, void* stream) {
  Params p;
  p.cam = cam;
  p.scene = scene;
  p.n = n;
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
