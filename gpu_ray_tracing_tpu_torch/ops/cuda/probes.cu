// Arithmetic probes for Hopper (sm_90a): what this card sustains on the
// path tracer's instruction mixes, outside any render.
//
// K3, `fma_peak_kernel`, replaces the Pallas TPU probe of
// benchmarks/vpu_roofline.py (`_peak_kernel_factory`, launched by
// `measure_peak`): `rounds` loop-carried bundles of either the BVH slab
// test's mix (sub, mul, a min/max tree, one compare, blends) or pure
// multiply-add chains, on 1, 2 or 4 independent (a, b, c) triples per
// thread, summed into one output so that nothing folds away.  It reads 4
// bytes and writes 4 bytes per thread and runs thousands of dependent
// operations between: it is bound by the FP32 pipes, which is the point,
// and the grid fills the card (the wrapper launches several waves of 2,048
// threads per SM).  The source is built like the render kernels, without
// fast math and with -fmad=false, so the slab mix runs as separate
// multiplies and adds, as the megakernel's traversal does; the multiply-add
// mix is written with fmaf.
//
// K4, `slab_kernel<bf16, compare, vector>`, replaces the Pallas TPU probe of
// benchmarks/bf16_probe.py (`kern`, launched by `main`): slab-test-shaped
// elementwise math (sub, add, mul, min, max), 2,048 loop-carried rounds in
// the original, in float and in packed __nv_bfloat162 (every operation
// rounded to bf16, no fused multiply-add), plus the compare form
// `acc + (tf >= tn) * tn`, which the TPU's compiler refused for packed bf16
// and Hopper has (__hge2).  Bound by instruction issue: a round is 9
// instructions an element in float (7 on the FP32 pipes, the min and max
// at half their rate), 4.5 in packed bf16, none of them fused, so the
// card's 128 instructions a clock an SM, not its 2-flop FMA peak, set the
// least time (utils/roofline.slab_bound_ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

enum Mix { SLAB = 0, FMA = 1 };

// One bundle of the traversal mix (vpu_roofline.py:102-112).
__device__ __forceinline__ void slab_bundle(float& a, float& b, float& c) {
  const float t0 = (a - c) * b;
  const float t1 = (b - c) * a;
  const float t2 = (a - b) * c;
  const float tn = fmaxf(fminf(t0, t1), fminf(t1, t2));
  const float tf = fminf(fmaxf(t0, t1), fmaxf(t1, t2));
  const float m = tf >= tn ? 1.0f : 0.0f;
  a = m * tn + (1.0f - m) * a + 1e-6f;
  b = m * tf + (1.0f - m) * b;
  c = c + a * 1e-7f;
}

// One bundle of the multiply-add chains (vpu_roofline.py:116-120), each
// a * k + b one fused multiply-add.
__device__ __forceinline__ void fma_bundle(float& a, float& b, float& c) {
  a = fmaf(a, 1.000001f, b);
  b = fmaf(b, 0.999999f, c);
  c = fmaf(c, 1.000002f, a * 1e-8f);
}

template <int kMix, int kChains>
__global__ void __launch_bounds__(256) fma_peak_kernel(const float* __restrict__ x,
                                                       float* __restrict__ out, int n,
                                                       int rounds) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float v = x[t];
  float a[kChains], b[kChains], c[kChains];
#pragma unroll
  for (int g = 0; g < kChains; ++g) {
    a[g] = v + 0.1f * (float)g;
    b[g] = v * 0.5f + 0.25f + 0.05f * (float)g;
    c[g] = v * 0.25f + 0.5f;
  }
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int g = 0; g < kChains; ++g) {
      if (kMix == SLAB) slab_bundle(a[g], b[g], c[g]);
      else fma_bundle(a[g], b[g], c[g]);
    }
  }
  // The carry summed in its own order: a0, b0, c0, a1, ...
  float acc = a[0];
  acc = acc + b[0];
  acc = acc + c[0];
#pragma unroll
  for (int g = 1; g < kChains; ++g) {
    acc = acc + a[g];
    acc = acc + b[g];
    acc = acc + c[g];
  }
  out[t] = acc;
}

// K4's kernels give each thread a group of 4 adjacent elements, loaded and
// stored as one float4 (16 bytes) where the array is 16-byte aligned: four
// independent f32 chains, or two packed bf16 chains, so that no chain's
// latency sets the pace.  The grid holds one group per thread up to what
// the card runs at once and walks the rest, so at the card-filling size
// both forms fill exactly one wave.  The rounds
// are unrolled by 4, so that the loop's counter and branch cost a quarter
// of an instruction a round.  Each element's operations are those of
// bf16_probe.py's body, in its order: the output is the plain version's
// bit for bit.
constexpr int kSlabGroup = 4;
constexpr int kSlabUnroll = 4;

// One round of bf16_probe.py's body in float.
template <bool kCompare>
__device__ __forceinline__ void slab_round(float& v, float& acc) {
  const float c1 = 1.0009765625f;
  const float t0 = (v - c1) * v;
  const float t1 = (v + c1) * v;
  const float tn = fminf(t0, t1);
  const float tf = fmaxf(t0, t1);
  if (kCompare) acc = acc + (tf >= tn ? 1.0f : 0.0f) * tn;
  else acc = acc + tf * tn;
  v = v * c1;
}

// The same round in packed bf16: every operation rounded to bf16 (round
// to nearest even), the product and the sum of the accumulation kept
// apart.
template <bool kCompare>
__device__ __forceinline__ void slab_round(__nv_bfloat162& v, __nv_bfloat162& acc) {
  const __nv_bfloat162 c1 = __float2bfloat162_rn(1.0009765625f);
  const __nv_bfloat162 t0 = __hmul2(__hsub2(v, c1), v);
  const __nv_bfloat162 t1 = __hmul2(__hadd2(v, c1), v);
  const __nv_bfloat162 tn = __hmin2(t0, t1);
  const __nv_bfloat162 tf = __hmax2(t0, t1);
  if (kCompare) acc = __hadd2(acc, __hmul2(__hge2(tf, tn), tn));
  else acc = __hadd2(acc, __hmul2(tf, tn));
  v = __hmul2(v, c1);
}

// `rounds` rounds on the group's elements e[0..k) in float (kBf16 false)
// or as k / 2 packed pairs; the results overwrite e.
template <bool kBf16, bool kCompare>
__device__ __forceinline__ void slab_group(float (&e)[kSlabGroup], int rounds) {
  if (kBf16) {
    __nv_bfloat162 v[kSlabGroup / 2], acc[kSlabGroup / 2];
#pragma unroll
    for (int g = 0; g < kSlabGroup / 2; ++g) {
      v[g] = __floats2bfloat162_rn(e[2 * g], e[2 * g + 1]);
      acc[g] = __float2bfloat162_rn(0.0f);
    }
#pragma unroll kSlabUnroll
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int g = 0; g < kSlabGroup / 2; ++g) slab_round<kCompare>(v[g], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kSlabGroup / 2; ++g) {
      e[2 * g] = __low2float(acc[g]);
      e[2 * g + 1] = __high2float(acc[g]);
    }
  } else {
    float acc[kSlabGroup];
#pragma unroll
    for (int g = 0; g < kSlabGroup; ++g) acc[g] = 0.0f;
#pragma unroll kSlabUnroll
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int g = 0; g < kSlabGroup; ++g) slab_round<kCompare>(e[g], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kSlabGroup; ++g) e[g] = acc[g];
  }
}

// bf16_probe.py's body over x (n f32, n even) into out: groups of 4
// elements, float4 loads and stores when both arrays are 16-byte aligned
// (kVector), scalar ones for a group cut by the array's end.
template <bool kBf16, bool kCompare, bool kVector>
__global__ void __launch_bounds__(256) slab_kernel(const float* __restrict__ x,
                                                   float* __restrict__ out, int n, int rounds) {
  const int groups = (n + kSlabGroup - 1) / kSlabGroup;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < groups; q += gridDim.x * blockDim.x) {
    const int base = q * kSlabGroup;
    const int k = n - base < kSlabGroup ? n - base : kSlabGroup;
    float e[kSlabGroup];
    if (kVector && k == kSlabGroup) {
      const float4 v = reinterpret_cast<const float4*>(x)[q];
      e[0] = v.x, e[1] = v.y, e[2] = v.z, e[3] = v.w;
    } else {
#pragma unroll
      for (int g = 0; g < kSlabGroup; ++g) e[g] = g < k ? x[base + g] : 1.0f;
    }
    slab_group<kBf16, kCompare>(e, rounds);
    if (kVector && k == kSlabGroup) {
      reinterpret_cast<float4*>(out)[q] = make_float4(e[0], e[1], e[2], e[3]);
    } else {
#pragma unroll
      for (int g = 0; g < kSlabGroup; ++g) {
        if (g < k) out[base + g] = e[g];
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes (ops/cuda/build.py).  Each launcher enqueues
// on the given stream, does not synchronise, and returns cudaGetLastError()
// as an int (0 = launched; 1, cudaErrorInvalidValue, for an argument the
// kernels do not take).

// K3: `rounds` bundles of mix (0 slab, 1 multiply-add) on `chains` (1, 2
// or 4) triples per element of x (n f32) into out (n f32).
extern "C" int grt_fma_peak(const float* x, float* out, int n, int rounds, int mix,
                            int chains, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = 256;
  const int grid = (n + block - 1) / block;
  if (n <= 0) return 0;
#define GRT_PEAK(MIX, CHAINS) \
  fma_peak_kernel<MIX, CHAINS><<<grid, block, 0, s>>>(x, out, n, rounds)
  if (mix == SLAB && chains == 1) GRT_PEAK(SLAB, 1);
  else if (mix == SLAB && chains == 2) GRT_PEAK(SLAB, 2);
  else if (mix == SLAB && chains == 4) GRT_PEAK(SLAB, 4);
  else if (mix == FMA && chains == 1) GRT_PEAK(FMA, 1);
  else if (mix == FMA && chains == 2) GRT_PEAK(FMA, 2);
  else if (mix == FMA && chains == 4) GRT_PEAK(FMA, 4);
  else return 1;
#undef GRT_PEAK
  return static_cast<int>(cudaGetLastError());
}

// K4: `rounds` of the slab-shaped body on x (n f32, n even) into out (n
// f32), in float (bf16 = 0) or packed bf16, with the product form
// (compare = 0) or the compare form.
extern "C" int grt_slab_dtype(const float* x, float* out, int n, int rounds, int bf16,
                              int compare, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n % 2) return 1;
  const bool vec = (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16 == 0;
  return static_cast<int>(with_flags([&](auto k_bf16, auto k_compare, auto k_vec) {
    const auto kernel =
        slab_kernel<decltype(k_bf16)::value, decltype(k_compare)::value, decltype(k_vec)::value>;
    Fit f;
    const cudaError_t e = fit(kernel, 256, 0, &f);
    if (e != cudaSuccess) return e;
    // Blocks of 256 threads, one a group of kSlabGroup elements, at most 8
    // blocks an SM (2,048 threads: what an SM holds at once).
    kernel<<<grid_of(((n + kSlabGroup - 1) / kSlabGroup + 255) / 256, 8LL * f.sms), 256, 0, s>>>(
        x, out, n, rounds);
    return cudaGetLastError();
  }, bf16 != 0, compare != 0, vec));
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
