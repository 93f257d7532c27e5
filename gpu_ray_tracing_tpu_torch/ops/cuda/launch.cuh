// How every launcher of ops/cuda/*.cu sizes its grid and picks its
// template instance (megakernel.cu, wavefront.cu and probes.cu include it).
//
// fit() asks the CUDA runtime what a kernel's grid depends on (the SM count and
// the blocks of the kernel an SM holds at `threads` and `smem` bytes of
// dynamic shared memory; for a cluster launch also the clusters the card
// places) once per (kernel, threads, smem, cluster size, device) in a process,
// and keeps the answer.  The same first call sets the kernel's attributes:
// the shared-memory carve-out and the cluster permission the caller names,
// and the dynamic shared-memory limit wherever `smem` exceeds it (the
// limit only grows, so a launch with less is never refused after one with
// more).  Every later launch is a lookup under a mutex: ctypes releases
// the GIL during a call, so two threads may launch at once.
//
// with_flags() maps run-time flags to a template instance: it calls its
// function with one std::bool_constant a flag, and so instantiates every
// combination of the flags it is given.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

// Attributes fit() sets before its first query of a kernel.
enum LaunchAttr : unsigned int {
  kMaxSharedCarveout = 1u,   // the largest shared-memory carve-out
  kNonPortableCluster = 2u,  // clusters of more than 8 blocks
};

struct Fit {
  int sms;       // SMs of the device
  int per_sm;    // blocks of the kernel an SM holds at once
  int clusters;  // clusters the card places at once (a cluster query; else 0)

  // Blocks of the kernel the card holds at once, at least one an SM.
  long long resident() const { return (long long)sms * std::max(per_sm, 1); }
};

inline std::mutex g_launch_mutex;
inline std::map<std::tuple<const void*, int, size_t, int, int>, Fit> g_fits;

// What the grid of `kernel` at (threads, smem) depends on, into *out;
// with `launch`, a cluster launch's configuration (its first attribute the
// cluster dimension), also the clusters of that size the card places.
template <typename Kernel>
cudaError_t fit(Kernel kernel, int threads, size_t smem, Fit* out, unsigned int attrs = 0,
                const cudaLaunchConfig_t* launch = nullptr) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int cluster = launch != nullptr ? (int)launch->attrs[0].val.clusterDim.x : 0;
  const auto key = std::make_tuple(fn, threads, smem, cluster, dev);
  std::lock_guard<std::mutex> lock(g_launch_mutex);
  const auto it = g_fits.find(key);
  if (it != g_fits.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  Fit f = {0, 0, 0};
  cudaFuncAttributes fa = {};
  e = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && (attrs & kMaxSharedCarveout))
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && (attrs & kNonPortableCluster))
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess && (size_t)fa.maxDynamicSharedSizeBytes < smem)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, fn, threads, smem);
  if (e == cudaSuccess && launch != nullptr)
    e = cudaOccupancyMaxActiveClusters(&f.clusters, fn, launch);
  if (e != cudaSuccess) return e;
  g_fits.emplace(key, f);
  *out = f;
  return cudaSuccess;
}

// A grid for `need` blocks of work on a card that holds `resident` at
// once: the work's own count when smaller (the kernels walk the rest),
// never 0.
inline int grid_of(long long need, long long resident) {
  return (int)std::max(1LL, std::min(need, resident));
}

template <typename F>
auto with_flags(F&& f) {
  return f();
}

// f(std::bool_constant<b>...) for the run-time flags b..., in order.
template <typename F, typename... Flags>
auto with_flags(F&& f, bool b, Flags... rest) {
  if (b) return with_flags([&](auto... c) { return f(std::true_type{}, c...); }, rest...);
  return with_flags([&](auto... c) { return f(std::false_type{}, c...); }, rest...);
}

}  // namespace
