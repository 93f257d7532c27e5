// Native BVH builder: binned-SAH construction with threaded DFS emission.
//
// The port's own copy of the JAX package's builder (the two packages share
// no file): the build step for the threaded traversal layout defined in
// gpu_ray_tracing_tpu_torch/ops/bvh.py, which the CUDA kernels walk:
//
//   - nodes in depth-first order (hit-successor of an inner node is node+1)
//   - per-node miss_link (the DFS escape edge), -1 terminates traversal
//   - leaves reference a contiguous range of reordered primitives
//
// Construction is surface-area-heuristic over 16 centroid bins per axis --
// better trees than the Python median-split fallback, and C++ speed for
// large meshes.  Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC bvh_builder.cpp -o libbvh_builder.so

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Aabb {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void grow(const float* lo, const float* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
  void grow(const Aabb& o) { grow(o.mn, o.mx); }
  float half_area() const {
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  Aabb bounds;
  int left = -1;   // pool index; -1 for leaves
  int right = -1;
  int first = 0;   // primitive range [first, first+count) in `order`
  int count = 0;   // 0 for inner nodes
};

struct Builder {
  const float* cent;
  const float* bmin;
  const float* bmax;
  int leaf_size;
  std::vector<int> order;        // primitive permutation (built in place)
  std::vector<BuildNode> pool;

  Aabb prim_bounds(int i) const {
    Aabb b;
    b.grow(bmin + 3 * i, bmax + 3 * i);
    return b;
  }

  // Iterative DFS build over order[0, n); returns the root pool index.
  // Explicit job stack rather than recursion: SAH can peel one primitive
  // per level, so recursion depth is O(n) on adversarial geometry and the
  // ~1KB bin arrays per frame would overflow the C stack (and SIGSEGV the
  // host interpreter) around ~10k depth.  Jobs are popped left-first, so
  // the pool keeps the recursive parents-before-children DFS order that
  // linearize()'s flat_size pass relies on.
  struct Job {
    int lo, hi, parent, slot;  // slot: 0 = left child, 1 = right child
  };

  int build(int n) {
    std::vector<Job> jobs{{0, n, -1, 0}};
    int root = -1;
    while (!jobs.empty()) {
      Job j = jobs.back();
      jobs.pop_back();
      int node = (int)pool.size();
      pool.emplace_back();
      if (j.parent < 0) {
        root = node;
      } else if (j.slot) {
        pool[j.parent].right = node;
      } else {
        pool[j.parent].left = node;
      }
      int lo = j.lo, hi = j.hi;
      Aabb bounds, cbounds;
      for (int k = lo; k < hi; ++k) {
        int p = order[k];
        bounds.grow(bmin + 3 * p, bmax + 3 * p);
        cbounds.grow(cent + 3 * p, cent + 3 * p);
      }
      pool[node].bounds = bounds;
      int count = hi - lo;
      if (count <= leaf_size) {
        pool[node].first = lo;
        pool[node].count = count;
        continue;
      }

    // Binned SAH over each axis; fall back to median when degenerate.
    int best_axis = -1, best_bin = -1;
    float best_cost = FLT_MAX;
    float ext[3], lo3[3];
    for (int a = 0; a < 3; ++a) {
      lo3[a] = cbounds.mn[a];
      ext[a] = cbounds.mx[a] - cbounds.mn[a];
    }
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] <= 1e-12f) continue;
      Aabb bins[kNumBins];
      int nprim[kNumBins] = {0};
      float scale = kNumBins / ext[axis];
      for (int k = lo; k < hi; ++k) {
        int p = order[k];
        int b = std::min(kNumBins - 1,
                         (int)((cent[3 * p + axis] - lo3[axis]) * scale));
        nprim[b]++;
        bins[b].grow(bmin + 3 * p, bmax + 3 * p);
      }
      // Sweep: cost(split after bin s) = A_L*N_L + A_R*N_R.
      Aabb right_acc[kNumBins];
      Aabb acc;
      int nright[kNumBins];
      int nr = 0;
      for (int b = kNumBins - 1; b >= 1; --b) {
        acc.grow(bins[b]);
        nr += nprim[b];
        right_acc[b] = acc;
        nright[b] = nr;
      }
      Aabb left_acc;
      int nl = 0;
      for (int s = 1; s < kNumBins; ++s) {
        left_acc.grow(bins[s - 1]);
        nl += nprim[s - 1];
        if (nl == 0 || nright[s] == 0) continue;
        float cost = left_acc.half_area() * nl + right_acc[s].half_area() * nright[s];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = s;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate centroids: median split on the longest axis by sort.
      int axis = 0;
      for (int a = 1; a < 3; ++a)
        if (ext[a] > ext[axis]) axis = a;
      std::stable_sort(order.begin() + lo, order.begin() + hi,
                       [&](int x, int y) {
                         return cent[3 * x + axis] < cent[3 * y + axis];
                       });
      mid = lo + count / 2;
    } else {
      float scale = kNumBins / ext[best_axis];
      auto it = std::stable_partition(
          order.begin() + lo, order.begin() + hi, [&](int p) {
            int b = std::min(kNumBins - 1,
                             (int)((cent[3 * p + best_axis] - lo3[best_axis]) * scale));
            return b < best_bin;
          });
      mid = (int)(it - order.begin());
      if (mid == lo || mid == hi) {  // SAH degenerated; force median
        std::stable_sort(order.begin() + lo, order.begin() + hi,
                         [&](int x, int y) {
                           return cent[3 * x + best_axis] < cent[3 * y + best_axis];
                         });
        mid = lo + count / 2;
      }
    }

      jobs.push_back({mid, hi, node, 1});
      jobs.push_back({lo, mid, node, 0});
    }
    return root;
  }
};

// Linearize the pool depth-first with miss links.
void linearize(const std::vector<BuildNode>& pool, int root,
               float* node_bmin, float* node_bmax, int32_t* miss_link,
               int32_t* leaf_start, int32_t* leaf_count, int32_t* n_nodes_out) {
  struct Item {
    int pool_id;
    int escape;
  };
  std::vector<Item> stack{{root, -1}};
  int out = 0;
  // Pre-compute flat sizes of each subtree so left's escape (the right
  // subtree's flat root) is known before emitting it.
  std::vector<int> flat_size(pool.size(), 1);
  // Pool is built parents-before-children, so reverse order accumulates.
  for (int i = (int)pool.size() - 1; i >= 0; --i) {
    if (pool[i].left >= 0)
      flat_size[i] = 1 + flat_size[pool[i].left] + flat_size[pool[i].right];
  }
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const BuildNode& n = pool[it.pool_id];
    std::memcpy(node_bmin + 3 * out, n.bounds.mn, 3 * sizeof(float));
    std::memcpy(node_bmax + 3 * out, n.bounds.mx, 3 * sizeof(float));
    miss_link[out] = it.escape;
    if (n.count > 0) {
      leaf_start[out] = n.first;
      leaf_count[out] = n.count;
    } else {
      leaf_start[out] = -1;
      leaf_count[out] = 0;
      int right_flat_root = out + 1 + flat_size[n.left];
      stack.push_back({n.right, it.escape});
      stack.push_back({n.left, right_flat_root});
    }
    ++out;
  }
  *n_nodes_out = out;
}

}  // namespace

extern "C" {

// Returns 0 on success.  Output buffers must hold 2*n - 1 nodes (worst case:
// every leaf has 1 primitive); `order` holds n ints.
int build_bvh_sah(const float* centroids, const float* bounds_min,
                  const float* bounds_max, int32_t n, int32_t leaf_size,
                  float* node_bmin, float* node_bmax, int32_t* miss_link,
                  int32_t* leaf_start, int32_t* leaf_count, int32_t* order,
                  int32_t* n_nodes_out) {
  if (n <= 0 || leaf_size <= 0) return 1;
  Builder b;
  b.cent = centroids;
  b.bmin = bounds_min;
  b.bmax = bounds_max;
  b.leaf_size = leaf_size;
  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  b.pool.reserve(2 * (size_t)n);
  int root = b.build(n);
  linearize(b.pool, root, node_bmin, node_bmax, miss_link, leaf_start,
            leaf_count, n_nodes_out);
  std::memcpy(order, b.order.data(), n * sizeof(int32_t));
  return 0;
}

}  // extern "C"
