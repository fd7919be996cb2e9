// Native BVH builder of crucible_tpu_torch: the C++ counterpart of
// ops/bvh.py's Python builder, which stays as its plain version. Two C
// entry points, each a top-down build into the flat DFS / skip-link layout
// of ops/bvh.FlatBVH (left child = i + 1, miss = the node after the
// subtree, primitives permuted into leaf order):
//
//   crucible_build_bvh      median split on the longest axis of the span's
//                           enclosing box, the span stable-sorted by
//                           bbox-min along it;
//   crucible_build_bvh_sah  the binned surface-area heuristic, the split
//                           count snapped to a multiple of the leaf size.
//
// Every choice is made in the Python builder's arithmetic and order (float
// centroids and bin indices, double bin boxes and costs, the first minimum
// in (axis, bin) order, stable sorts, halves rounded up), so the two give
// the same trees bit for bit (tests/test_torch_native_bvh.py).
//
// Build (crucible_tpu_torch.native does it at first use):
//   g++ -O2 -shared -fPIC -ffp-contract=off -o libbvh_builder.so bvh_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Frame {
  int64_t lo, hi;       // span into perm[]
  int32_t parent;       // parent node index (-1 root)
  int8_t state;         // 0 = enter, 1 = exit (children built)
  int32_t node;         // node index (valid in exit state)
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on capacity overflow.
// Output arrays must hold at least 4*m + 2 entries (node_*), m (perm).
int64_t crucible_build_bvh(const float* bb_min, const float* bb_max,
                           int64_t m, int64_t leaf_size,
                           float* node_min, float* node_max,
                           int32_t* node_first, int32_t* node_count,
                           int32_t* node_miss, int32_t* node_parent,
                           int32_t* perm) {
  if (m <= 0) return -1;
  const int64_t cap = 4 * m + 2;

  std::vector<int32_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = static_cast<int32_t>(i);

  std::vector<Frame> stack;
  stack.reserve(128);
  stack.push_back({0, m, -1, 0, -1});

  int64_t num_nodes = 0;
  int64_t perm_len = 0;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();

    if (f.state == 1) {
      // Subtree finished: miss link = first node after the subtree.
      node_miss[f.node] = static_cast<int32_t>(num_nodes);
      continue;
    }

    if (num_nodes >= cap) return -1;
    const int32_t idx = static_cast<int32_t>(num_nodes++);

    // Enclosing box of the span.
    float lo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float hi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = f.lo; i < f.hi; ++i) {
      const int32_t p = order[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], bb_min[3 * p + a]);
        hi[a] = std::max(hi[a], bb_max[3 * p + a]);
      }
    }
    std::memcpy(node_min + 3 * idx, lo, sizeof lo);
    std::memcpy(node_max + 3 * idx, hi, sizeof hi);
    node_parent[idx] = f.parent;

    const int64_t span = f.hi - f.lo;
    if (span <= leaf_size) {
      node_first[idx] = static_cast<int32_t>(perm_len);
      node_count[idx] = static_cast<int32_t>(span);
      node_miss[idx] = static_cast<int32_t>(num_nodes);  // i + 1 for leaves
      for (int64_t i = f.lo; i < f.hi; ++i) perm[perm_len++] = order[i];
      // miss will be finalized as num_nodes below for leaves: already num_nodes
      // (no children), which equals subtree end.
      continue;
    }

    node_first[idx] = 0;
    node_count[idx] = 0;

    // Longest axis of the enclosing box (the first of equal extents).
    int axis = 0;
    float best = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a) {
      const float ext = hi[a] - lo[a];
      if (ext > best) { best = ext; axis = a; }
    }
    std::stable_sort(order.begin() + f.lo, order.begin() + f.hi,
                     [bb_min, axis](int32_t x, int32_t y) {
                       return bb_min[3 * x + axis] < bb_min[3 * y + axis];
                     });
    const int64_t mid = f.lo + span / 2;

    // Exit frame first (LIFO), then right, then left so left is emitted
    // immediately after this node (DFS: left = idx + 1).
    stack.push_back({0, 0, -1, 1, idx});
    stack.push_back({mid, f.hi, idx, 0, -1});
    stack.push_back({f.lo, mid, idx, 0, -1});
  }
  return num_nodes;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Binned SAH build (ops/bvh.py::_sah_split): the (axis, plane) minimizing
// N_L*Area_L + N_R*Area_R over 16 centroid bins per axis, the span sorted
// by centroid along that axis and the split count snapped to the nearest
// multiple of leaf_size, so that every leaf is full but one ragged tail a
// subtree. Where every centroid coincides, a longest-axis median.
// ---------------------------------------------------------------------------

namespace {

constexpr int kSahBins = 16;

int64_t snap_count(int64_t k, int64_t n, int64_t leaf_size) {
  // Round to the nearest multiple of leaf_size within (0, n), halves up.
  double r = static_cast<double>(k) / static_cast<double>(leaf_size);
  int64_t kk = static_cast<int64_t>(r + 0.5) * leaf_size;
  int64_t hi = ((n - 1) / leaf_size) * leaf_size;
  return std::max(leaf_size, std::min(kk, hi));
}

}  // namespace

extern "C" {

int64_t crucible_build_bvh_sah(const float* bb_min, const float* bb_max,
                               int64_t m, int64_t leaf_size,
                               float* node_min, float* node_max,
                               int32_t* node_first, int32_t* node_count,
                               int32_t* node_miss, int32_t* node_parent,
                               int32_t* perm) {
  if (m <= 0 || leaf_size <= 0) return -1;
  const int64_t cap = 4 * m + 2;

  std::vector<float> cx(3 * m);  // centroids
  for (int64_t i = 0; i < m; ++i)
    for (int a = 0; a < 3; ++a)
      cx[3 * i + a] = 0.5f * (bb_min[3 * i + a] + bb_max[3 * i + a]);

  std::vector<int32_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = static_cast<int32_t>(i);

  std::vector<Frame> stack;
  stack.reserve(128);
  stack.push_back({0, m, -1, 0, -1});

  int64_t num_nodes = 0;
  int64_t perm_len = 0;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    if (f.state == 1) {
      node_miss[f.node] = static_cast<int32_t>(num_nodes);
      continue;
    }
    if (num_nodes >= cap) return -1;
    const int32_t idx = static_cast<int32_t>(num_nodes++);

    float lo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float hi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    float clo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float chi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = f.lo; i < f.hi; ++i) {
      const int32_t p = order[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], bb_min[3 * p + a]);
        hi[a] = std::max(hi[a], bb_max[3 * p + a]);
        clo[a] = std::min(clo[a], cx[3 * p + a]);
        chi[a] = std::max(chi[a], cx[3 * p + a]);
      }
    }
    std::memcpy(node_min + 3 * idx, lo, sizeof lo);
    std::memcpy(node_max + 3 * idx, hi, sizeof hi);
    node_parent[idx] = f.parent;

    const int64_t span = f.hi - f.lo;
    if (span <= leaf_size) {
      node_first[idx] = static_cast<int32_t>(perm_len);
      node_count[idx] = static_cast<int32_t>(span);
      node_miss[idx] = static_cast<int32_t>(num_nodes);
      for (int64_t i = f.lo; i < f.hi; ++i) perm[perm_len++] = order[i];
      continue;
    }
    node_first[idx] = 0;
    node_count[idx] = 0;

    // Binned SAH over the three axes.
    double best_cost = -1.0;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; ++axis) {
      const float extent = chi[axis] - clo[axis];
      if (extent <= 0.0f) continue;
      const float scale = kSahBins / extent;
      int64_t counts[kSahBins] = {0};
      double blo[kSahBins][3], bhi[kSahBins][3];
      for (int b = 0; b < kSahBins; ++b)
        for (int a = 0; a < 3; ++a) { blo[b][a] = 1e300; bhi[b][a] = -1e300; }
      for (int64_t i = f.lo; i < f.hi; ++i) {
        const int32_t p = order[i];
        int b = static_cast<int>((cx[3 * p + axis] - clo[axis]) * scale);
        b = std::min(b, kSahBins - 1);
        ++counts[b];
        for (int a = 0; a < 3; ++a) {
          blo[b][a] = std::min(blo[b][a], (double)bb_min[3 * p + a]);
          bhi[b][a] = std::max(bhi[b][a], (double)bb_max[3 * p + a]);
        }
      }
      // prefix/suffix sweeps
      double llo[kSahBins][3], lhi[kSahBins][3], rlo[kSahBins][3], rhi[kSahBins][3];
      for (int a = 0; a < 3; ++a) {
        llo[0][a] = blo[0][a]; lhi[0][a] = bhi[0][a];
        rlo[kSahBins - 1][a] = blo[kSahBins - 1][a];
        rhi[kSahBins - 1][a] = bhi[kSahBins - 1][a];
      }
      for (int b = 1; b < kSahBins; ++b)
        for (int a = 0; a < 3; ++a) {
          llo[b][a] = std::min(llo[b - 1][a], blo[b][a]);
          lhi[b][a] = std::max(lhi[b - 1][a], bhi[b][a]);
        }
      for (int b = kSahBins - 2; b >= 0; --b)
        for (int a = 0; a < 3; ++a) {
          rlo[b][a] = std::min(rlo[b + 1][a], blo[b][a]);
          rhi[b][a] = std::max(rhi[b + 1][a], bhi[b][a]);
        }
      auto area = [](const double* alo, const double* ahi) {
        double d0 = std::max(ahi[0] - alo[0], 0.0);
        double d1 = std::max(ahi[1] - alo[1], 0.0);
        double d2 = std::max(ahi[2] - alo[2], 0.0);
        return d0 * d1 + d1 * d2 + d2 * d0;
      };
      int64_t n_l = 0;
      for (int b = 0; b < kSahBins - 1; ++b) {
        n_l += counts[b];
        const int64_t n_r = span - n_l;
        if (n_l == 0 || n_r == 0) continue;
        const double cost =
            n_l * area(llo[b], lhi[b]) + n_r * area(rlo[b + 1], rhi[b + 1]);
        if (best_axis < 0 || cost < best_cost) {
          best_cost = cost; best_axis = axis; best_bin = b;
        }
      }
    }

    int64_t k;
    if (best_axis < 0) {
      // Degenerate (all centroids coincident): median on the longest node
      // axis, sorted by bbox-min.
      int axis = 0;
      float best = hi[0] - lo[0];
      for (int a = 1; a < 3; ++a)
        if (hi[a] - lo[a] > best) { best = hi[a] - lo[a]; axis = a; }
      std::stable_sort(order.begin() + f.lo, order.begin() + f.hi,
                       [bb_min, axis](int32_t x, int32_t y) {
                         return bb_min[3 * x + axis] < bb_min[3 * y + axis];
                       });
      k = snap_count(span / 2, span, leaf_size);
    } else {
      const int axis = best_axis;
      const float scale = kSahBins / (chi[axis] - clo[axis]);
      const float corigin = clo[axis];
      std::stable_sort(order.begin() + f.lo, order.begin() + f.hi,
                       [&cx, axis](int32_t x, int32_t y) {
                         return cx[3 * x + axis] < cx[3 * y + axis];
                       });
      int64_t n_l = 0;
      for (int64_t i = f.lo; i < f.hi; ++i) {
        const int32_t p = order[i];
        int b = static_cast<int>((cx[3 * p + axis] - corigin) * scale);
        if (std::min(b, kSahBins - 1) <= best_bin) ++n_l;
      }
      k = snap_count(n_l, span, leaf_size);
    }
    const int64_t mid = f.lo + k;
    stack.push_back({0, 0, -1, 1, idx});
    stack.push_back({mid, f.hi, idx, 0, -1});
    stack.push_back({f.lo, mid, idx, 0, -1});
  }
  return num_nodes;
}

}  // extern "C"
