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
// K4, `slab_f32_kernel` and `slab_bf16_kernel`, replaces the Pallas TPU probe of
// benchmarks/bf16_probe.py (`kern`, launched by `main`): slab-test-shaped
// elementwise math (sub, add, mul, min, max), 2,048 loop-carried rounds in
// the original, in float and in packed __nv_bfloat162 (two values a thread,
// every operation rounded to bf16, no fused multiply-add), plus the compare
// form `acc + (tf >= tn) * tn`, which the TPU's compiler refused for packed
// bf16 and Hopper has (__hge2).  Bound by the FP32 (or packed bf16) pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// bf16_probe.py's body in float: one element a thread.
template <bool kCompare>
__global__ void __launch_bounds__(256) slab_f32_kernel(const float* __restrict__ x,
                                                       float* __restrict__ out, int n,
                                                       int rounds) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float v = x[t];
  const float c1 = 1.0009765625f;
  float acc = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    const float t0 = (v - c1) * v;
    const float t1 = (v + c1) * v;
    const float tn = fminf(t0, t1);
    const float tf = fmaxf(t0, t1);
    if (kCompare) acc = acc + (tf >= tn ? 1.0f : 0.0f) * tn;
    else acc = acc + tf * tn;
    v = v * c1;
  }
  out[t] = acc;
}

// The same body in packed bf16: two elements a thread, every operation
// rounded to bf16 (round to nearest even), the product and the sum of the
// accumulation kept apart.  n is even.
template <bool kCompare>
__global__ void __launch_bounds__(256) slab_bf16_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int n,
                                                        int rounds) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (2 * t >= n) return;
  __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * t], x[2 * t + 1]);
  const __nv_bfloat162 c1 = __float2bfloat162_rn(1.0009765625f);
  __nv_bfloat162 acc = __float2bfloat162_rn(0.0f);
  for (int r = 0; r < rounds; ++r) {
    const __nv_bfloat162 t0 = __hmul2(__hsub2(v, c1), v);
    const __nv_bfloat162 t1 = __hmul2(__hadd2(v, c1), v);
    const __nv_bfloat162 tn = __hmin2(t0, t1);
    const __nv_bfloat162 tf = __hmax2(t0, t1);
    if (kCompare) acc = __hadd2(acc, __hmul2(__hge2(tf, tn), tn));
    else acc = __hadd2(acc, __hmul2(tf, tn));
    v = __hmul2(v, c1);
  }
  out[2 * t] = __low2float(acc);
  out[2 * t + 1] = __high2float(acc);
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
  const int block = 256;
  if (n <= 0) return 0;
  if (n % 2) return 1;
  if (bf16) {
    const int grid = (n / 2 + block - 1) / block;
    if (compare) slab_bf16_kernel<true><<<grid, block, 0, s>>>(x, out, n, rounds);
    else slab_bf16_kernel<false><<<grid, block, 0, s>>>(x, out, n, rounds);
  } else {
    const int grid = (n + block - 1) / block;
    if (compare) slab_f32_kernel<true><<<grid, block, 0, s>>>(x, out, n, rounds);
    else slab_f32_kernel<false><<<grid, block, 0, s>>>(x, out, n, rounds);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
