// Native SAH BVH builder (C ABI, loaded via ctypes by ops/bvh.py).
//
// The port's own copy of the JAX package's native/bvh_builder.cpp (its
// rtx_build_bvh; the PPM encoder beside it there is not needed here). The
// reference builds its BVH in native C++ with sampled SAH (BVHNode.cpp:
// 168-254: 16 candidate split positions per axis over the centroid bounds,
// cost = T + P_l*N_l*I + P_r*N_r*I with T=1, I=2, leaf size <= 4, spatial-
// median fallback) and flattens it to a node array for iterative traversal
// (:322-383); this emits the flat arrays FlatScene's bvh_* fields hold.
// A numpy builder with the same semantics lives in ops/bvh.py.
//
// Build: ops/bvh.py compiles this file at first use with g++ into
// build/bvh/ (git-ignored), with the JAX package's exact flags
// (-O3 -march=native -shared -fPIC -std=c++17, native/__init__.py). The
// flags are part of the result: the SAH sums are float32, and other flags
// (without -march=native, the compiler contracts a*b+c differently) give
// another tree on bouncing_spheres and the 32,768-sphere grid. With the
// same flags the tree is the JAX package's, node for node.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kMaxLeaf = 4;        // BVHNode.hpp:167
constexpr int kSahSamples = 16;    // BVHNode.hpp:168
constexpr float kCostTraverse = 1.0f;
constexpr float kCostIntersect = 2.0f;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float axis_of(const V3& v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

inline float half_area(const V3& lo, const V3& hi) {
  float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
  return ex * ey + ey * ez + ez * ex;
}

struct Builder {
  const V3* bb_min;
  const V3* bb_max;
  std::vector<V3> centroid;
  // outputs
  float* node_min;
  float* node_max;
  int32_t* left;
  int32_t* right;
  int32_t* axis;
  uint8_t* leaf;
  int32_t* prims;
  int n_nodes = 0;
  int n_order = 0;
  int max_nodes;

  int alloc_node() { return n_nodes++; }

  void range_bounds(const int32_t* ids, int n, V3* lo, V3* hi,
                    V3* clo, V3* chi) const {
    V3 l = bb_min[ids[0]], h = bb_max[ids[0]];
    V3 cl = centroid[ids[0]], ch = centroid[ids[0]];
    for (int i = 1; i < n; ++i) {
      l = vmin(l, bb_min[ids[i]]);
      h = vmax(h, bb_max[ids[i]]);
      cl = vmin(cl, centroid[ids[i]]);
      ch = vmax(ch, centroid[ids[i]]);
    }
    *lo = l; *hi = h; *clo = cl; *chi = ch;
  }

  // Best sampled-SAH split; returns true and fills (axis, thr) or false for
  // the median fallback (degenerate SAH, BVHNode.cpp:60-77).
  bool sah_split(const int32_t* ids, int n, const V3& lo, const V3& hi,
                 const V3& clo, const V3& chi, int* best_axis,
                 float* best_thr) const {
    float area = 2.0f * half_area(lo, hi);
    if (area <= 0.0f) return false;
    float best_cost = std::numeric_limits<float>::infinity();
    bool found = false;
    for (int a = 0; a < 3; ++a) {
      float c0 = axis_of(clo, a), c1 = axis_of(chi, a);
      if (c1 - c0 < 1e-12f) continue;
      for (int k = 1; k <= kSahSamples; ++k) {
        float thr = c0 + (c1 - c0) * k / (kSahSamples + 1);
        V3 llo{0, 0, 0}, lhi{0, 0, 0}, rlo{0, 0, 0}, rhi{0, 0, 0};
        int nl = 0, nr = 0;
        for (int i = 0; i < n; ++i) {
          int id = ids[i];
          if (axis_of(centroid[id], a) < thr) {
            if (nl++ == 0) { llo = bb_min[id]; lhi = bb_max[id]; }
            else { llo = vmin(llo, bb_min[id]); lhi = vmax(lhi, bb_max[id]); }
          } else {
            if (nr++ == 0) { rlo = bb_min[id]; rhi = bb_max[id]; }
            else { rlo = vmin(rlo, bb_min[id]); rhi = vmax(rhi, bb_max[id]); }
          }
        }
        if (nl == 0 || nr == 0) continue;
        float cost = kCostTraverse +
                     2.0f * half_area(llo, lhi) / area * nl * kCostIntersect +
                     2.0f * half_area(rlo, rhi) / area * nr * kCostIntersect;
        if (cost < best_cost) {
          best_cost = cost;
          *best_axis = a;
          *best_thr = thr;
          found = true;
        }
      }
    }
    return found && best_cost < n * kCostIntersect;
  }

  int build(std::vector<int32_t>& ids) {
    int node = alloc_node();
    if (node >= max_nodes) return -1;
    int n = static_cast<int>(ids.size());
    V3 lo{0, 0, 0}, hi{0, 0, 0}, clo{0, 0, 0}, chi{0, 0, 0};
    if (n > 0) range_bounds(ids.data(), n, &lo, &hi, &clo, &chi);
    node_min[3 * node] = lo.x; node_min[3 * node + 1] = lo.y;
    node_min[3 * node + 2] = lo.z;
    node_max[3 * node] = hi.x; node_max[3 * node + 1] = hi.y;
    node_max[3 * node + 2] = hi.z;

    if (n <= kMaxLeaf) {
      left[node] = n_order;
      right[node] = n;
      axis[node] = 0;
      leaf[node] = 1;
      for (int i = 0; i < n; ++i) prims[n_order++] = ids[i];
      return node;
    }

    int a = 0;
    float thr = 0.0f;
    std::vector<int32_t> l_ids, r_ids;
    if (sah_split(ids.data(), n, lo, hi, clo, chi, &a, &thr)) {
      for (int32_t id : ids)
        (axis_of(centroid[id], a) < thr ? l_ids : r_ids).push_back(id);
    } else {
      // spatial median on the longest axis, stable centroid sort
      V3 e{hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
      a = (e.x >= e.y && e.x >= e.z) ? 0 : (e.y >= e.z ? 1 : 2);
      std::stable_sort(ids.begin(), ids.end(), [&](int32_t p, int32_t q) {
        return axis_of(centroid[p], a) < axis_of(centroid[q], a);
      });
      l_ids.assign(ids.begin(), ids.begin() + n / 2);
      r_ids.assign(ids.begin() + n / 2, ids.end());
    }
    ids.clear();
    ids.shrink_to_fit();

    int li = build(l_ids);
    int ri = build(r_ids);
    if (li < 0 || ri < 0) return -1;
    left[node] = li;
    right[node] = ri;
    axis[node] = a;
    leaf[node] = 0;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes written, or -1 if max_nodes was insufficient.
// Arrays: bb_min/bb_max row-major (n_prims, 3); active (n_prims,);
// node_* sized max_nodes(+3 per vec); prims sized n_prims.
int32_t rtx_build_bvh(const float* bb_min, const float* bb_max,
                      const uint8_t* active, int32_t n_prims,
                      float* node_min, float* node_max, int32_t* left,
                      int32_t* right, int32_t* axis, uint8_t* leaf,
                      int32_t* prims, int32_t* n_prims_out,
                      int32_t max_nodes) {
  Builder b;
  b.bb_min = reinterpret_cast<const V3*>(bb_min);
  b.bb_max = reinterpret_cast<const V3*>(bb_max);
  b.centroid.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.centroid[i] = {0.5f * (bb_min[3 * i] + bb_max[3 * i]),
                     0.5f * (bb_min[3 * i + 1] + bb_max[3 * i + 1]),
                     0.5f * (bb_min[3 * i + 2] + bb_max[3 * i + 2])};
  }
  b.node_min = node_min;
  b.node_max = node_max;
  b.left = left;
  b.right = right;
  b.axis = axis;
  b.leaf = leaf;
  b.prims = prims;
  b.max_nodes = max_nodes;

  std::vector<int32_t> ids;
  ids.reserve(n_prims);
  for (int i = 0; i < n_prims; ++i)
    if (active[i]) ids.push_back(i);
  if (ids.empty()) {
    // single empty leaf
    std::memset(node_min, 0, 3 * sizeof(float));
    std::memset(node_max, 0, 3 * sizeof(float));
    left[0] = 0; right[0] = 0; axis[0] = 0; leaf[0] = 1;
    *n_prims_out = 0;
    return 1;
  }
  if (b.build(ids) < 0) return -1;
  *n_prims_out = b.n_order;
  return b.n_nodes;
}

}  // extern "C"
