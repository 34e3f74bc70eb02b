// Native BVH builder: binned SAH over world-space triangles. The port's own
// copy of native/bvh_builder.cpp, so that both packages build the same tree.
//
// This is the equivalent of the reference's native acceleration-structure
// build (LuisaCompute/OptiX `accel.update()`, render.py:127): the build runs
// on host once per scene, so it lives in C++ for speed and tree quality
// (binned SAH beats the Python median-split builder on incoherent meshes);
// the traversal runs on the device (kernels/csrc/trace.cuh).
//
// Layout contract (must match zdr_tpu_torch/accel/bvh.py BVHArrays):
//   * nodes: lo/hi AABB, left/right child indices; leaves store
//     (left = first slot in tri_perm, right = leaf_size) and is_leaf = 1.
//   * every leaf owns exactly `leaf_size` consecutive tri_perm slots,
//     padded with -1, so the device traversal is fixed-shape.
//
// Built as a shared library with g++ at first use; loaded via ctypes
// (zdr_tpu_torch/accel/native.py).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
  Vec3 center() const {
    return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
  }
};

constexpr int kNumBins = 16;

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  int leaf_size;
  std::vector<AABB> tri_bounds;
  std::vector<Vec3> tri_center;

  std::vector<float> node_lo, node_hi;
  std::vector<int32_t> node_left, node_right;
  std::vector<uint8_t> node_is_leaf;
  std::vector<int32_t> tri_perm;

  int new_node() {
    node_lo.insert(node_lo.end(), {0, 0, 0});
    node_hi.insert(node_hi.end(), {0, 0, 0});
    node_left.push_back(0);
    node_right.push_back(0);
    node_is_leaf.push_back(0);
    return static_cast<int>(node_is_leaf.size()) - 1;
  }

  void set_bounds(int nid, const AABB& b) {
    node_lo[nid * 3 + 0] = b.lo.x;
    node_lo[nid * 3 + 1] = b.lo.y;
    node_lo[nid * 3 + 2] = b.lo.z;
    node_hi[nid * 3 + 0] = b.hi.x;
    node_hi[nid * 3 + 1] = b.hi.y;
    node_hi[nid * 3 + 2] = b.hi.z;
  }

  void make_leaf(int nid, int32_t* idx, int count) {
    int start = static_cast<int>(tri_perm.size());
    for (int i = 0; i < count; ++i) tri_perm.push_back(idx[i]);
    for (int i = count; i < leaf_size; ++i) tri_perm.push_back(-1);
    node_left[nid] = start;
    node_right[nid] = leaf_size;
    node_is_leaf[nid] = 1;
  }

  // binned SAH split; returns false if no good split (make a leaf instead)
  bool split(int32_t* idx, int count, const AABB& bounds, int* out_mid) {
    AABB cbounds;
    for (int i = 0; i < count; ++i) cbounds.grow(tri_center[idx[i]]);
    float ext[3] = {cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                    cbounds.hi.z - cbounds.lo.z};
    int best_axis = -1;
    int best_bin = -1;
    float best_cost = FLT_MAX;
    float leaf_cost = static_cast<float>(count);
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] <= 1e-12f) continue;
      float lo = axis == 0 ? cbounds.lo.x : axis == 1 ? cbounds.lo.y : cbounds.lo.z;
      float scale = kNumBins / ext[axis];
      AABB bin_bounds[kNumBins];
      int bin_count[kNumBins] = {0};
      for (int i = 0; i < count; ++i) {
        const Vec3& c = tri_center[idx[i]];
        float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
        int b = std::min(kNumBins - 1, static_cast<int>((v - lo) * scale));
        bin_count[b]++;
        bin_bounds[b].grow(tri_bounds[idx[i]]);
      }
      // sweep
      AABB right_acc[kNumBins];
      AABB acc;
      for (int b = kNumBins - 1; b >= 1; --b) {
        acc.grow(bin_bounds[b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int left_n = 0;
      for (int b = 0; b < kNumBins - 1; ++b) {
        left_acc.grow(bin_bounds[b]);
        left_n += bin_count[b];
        int right_n = count - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = (left_acc.half_area() * left_n +
                      right_acc[b + 1].half_area() * right_n) /
                     std::max(bounds.half_area(), 1e-20f);
        cost += 0.125f;  // traversal cost constant
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }
    if (best_axis < 0 || (count <= leaf_size && best_cost >= leaf_cost)) {
      return false;
    }
    // partition by chosen bin
    float lo = best_axis == 0   ? cbounds.lo.x
               : best_axis == 1 ? cbounds.lo.y
                                : cbounds.lo.z;
    float scale = kNumBins / ext[best_axis];
    int32_t* mid = std::partition(idx, idx + count, [&](int32_t t) {
      const Vec3& c = tri_center[t];
      float v = best_axis == 0 ? c.x : best_axis == 1 ? c.y : c.z;
      int b = std::min(kNumBins - 1, static_cast<int>((v - lo) * scale));
      return b <= best_bin;
    });
    int m = static_cast<int>(mid - idx);
    if (m == 0 || m == count) m = count / 2;  // degenerate: median fallback
    *out_mid = m;
    return true;
  }

  void build(int32_t* idx, int count, int nid) {
    AABB bounds;
    for (int i = 0; i < count; ++i) bounds.grow(tri_bounds[idx[i]]);
    set_bounds(nid, bounds);
    int mid;
    if (count <= leaf_size || !split(idx, count, bounds, &mid)) {
      if (count <= leaf_size) {
        make_leaf(nid, idx, count);
        return;
      }
      mid = count / 2;  // forced split for oversized leaves
    }
    int l = new_node();
    int r = new_node();
    node_left[nid] = l;
    node_right[nid] = r;
    node_is_leaf[nid] = 0;
    build(idx, mid, l);
    build(idx + mid, count - mid, r);
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller allocates:
//   node_lo/node_hi: 3 * max_nodes floats, node_left/right: max_nodes ints,
//   node_is_leaf: max_nodes bytes, tri_perm: max_perm ints,
// with max_nodes >= 4 * ceil(n/leaf_size) + 8 and max_perm >= 2*n*leaf_size.
int zdr_build_bvh(const float* v0, const float* v1, const float* v2,
                  int n_tris, int leaf_size, float* node_lo, float* node_hi,
                  int32_t* node_left, int32_t* node_right,
                  uint8_t* node_is_leaf, int32_t* tri_perm,
                  int32_t max_nodes, int32_t max_perm, int32_t* out_n_nodes,
                  int32_t* out_n_perm) {
  Builder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.leaf_size = leaf_size;
  b.tri_bounds.resize(n_tris);
  b.tri_center.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    AABB box;
    box.grow(Vec3{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]});
    box.grow(Vec3{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]});
    box.grow(Vec3{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]});
    b.tri_bounds[i] = box;
    b.tri_center[i] = box.center();
  }
  std::vector<int32_t> idx(n_tris);
  for (int i = 0; i < n_tris; ++i) idx[i] = i;
  int root = b.new_node();
  b.build(idx.data(), n_tris, root);

  int n_nodes = static_cast<int>(b.node_is_leaf.size());
  int n_perm = static_cast<int>(b.tri_perm.size());
  if (n_nodes > max_nodes || n_perm > max_perm) return 1;
  std::memcpy(node_lo, b.node_lo.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(node_hi, b.node_hi.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(node_left, b.node_left.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(node_right, b.node_right.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(node_is_leaf, b.node_is_leaf.data(), n_nodes);
  std::memcpy(tri_perm, b.tri_perm.data(), sizeof(int32_t) * n_perm);
  *out_n_nodes = n_nodes;
  *out_n_perm = n_perm;
  return 0;
}
}
