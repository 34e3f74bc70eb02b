// Host build of the trace kernels' per-ray code (trace.cuh) with g++, one ray
// after the other: the dense sweep over the whole table and the ordered BVH
// walk, closest and any hit. It runs the kernels' own code on the CPU so that
// tests without a card can hold it against the plain PyTorch version
// (accel/trace.py) and the JAX package. Not used by the renderer.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include "trace.cuh"

namespace {

zdr::V3 ray_vec(const float* v, long i) { return zdr::v3(v[3 * i], v[3 * i + 1], v[3 * i + 2]); }

}  // namespace

extern "C" {

// zdr_trace_closest (accel.cu) without the stream.
int zdr_trace_closest_host(int bvh_mode, const float* geom, int n_rows, const float* nodes,
                           int n_nodes, const float* o, const float* d, const float* t_min,
                           const float* t_max, float* t, float* u, float* v, int* prim,
                           unsigned long long* counts, int n) {
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  zdr::TraceCount c = {0, 0};
  for (long i = 0; i < n; ++i) {
    float best_t = t_max[i], bu = 0.0f, bv = 0.0f;
    int p = -1;
    if (bvh_mode) {
      p = zdr::bvh_closest(bvh, ray_vec(o, i), ray_vec(d, i), t_min[i], best_t, bu, bv, &c);
    } else {
      zdr::dense_closest(geom, n_rows, 0, ray_vec(o, i), ray_vec(d, i), t_min[i], best_t, bu,
                         bv, p);
      c.tests += (unsigned long long)n_rows;
    }
    t[i] = best_t;
    u[i] = bu;
    v[i] = bv;
    prim[i] = p;
  }
  counts[0] += c.tests;
  counts[1] += c.visits;
  return 0;
}

// zdr_trace_any (accel.cu) without the stream.
int zdr_trace_any_host(int bvh_mode, const float* geom, int n_rows, const float* nodes,
                       int n_nodes, const float* o, const float* d, const float* t_min,
                       const float* t_max, int* occ, unsigned long long* counts, int n) {
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  zdr::TraceCount c = {0, 0};
  for (long i = 0; i < n; ++i) {
    bool hit;
    if (bvh_mode) {
      hit = zdr::bvh_any(bvh, ray_vec(o, i), ray_vec(d, i), t_min[i], t_max[i], &c);
    } else {
      int k = zdr::dense_any(geom, n_rows, ray_vec(o, i), ray_vec(d, i), t_min[i], t_max[i]);
      hit = k > 0;
      c.tests += (unsigned long long)(hit ? k : -k);
    }
    occ[i] = hit ? 1 : 0;
  }
  counts[0] += c.tests;
  counts[1] += c.visits;
  return 0;
}

}  // extern "C"
