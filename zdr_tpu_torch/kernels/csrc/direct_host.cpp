// Host build of the direct integrator's per-lane code (direct_step.cuh) with
// g++, one lane after the other, in forward and in tap mode (whose scatter
// is then a serial add), over the compact tables or through the BVH, and of
// trace_interact. It runs the kernels' own
// code on the CPU so that tests without a card can hold it against the
// plain PyTorch version. Not used by the renderer: on the CPU the renderer
// runs the plain version.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include <vector>

#include "direct_step.cuh"

namespace {

// The kernels' compact shared-memory copy of the first n floats.
std::vector<float> compact(const float* tables, const zdr::LoopParams& q, int n) {
  std::vector<float> out(n);
  for (int k = 0; k < n; ++k) out[k] = zdr::compact_at(tables, q, k);
  return out;
}

template <class Tracer>
void direct_lanes(const zdr::Tables& tb, const zdr::LoopParams& q, const Tracer& tr,
                  const int* lanes, const float* le_grad, float* acc, float* grad,
                  unsigned long long* counts, int n) {
  zdr::TraceCount c = {0, 0};
  for (long lane = 0; lane < n; ++lane) {
    zdr::LaneConst lc =
        zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane], q.seed, q);
    zdr::V3 a;
    if (le_grad) {
      zdr::DirectTaps dt;
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = grad;
      a = zdr::direct_lane<true>(tb, q, lc, &dt, c, tr);
    } else {
      a = zdr::direct_lane<false>(tb, q, lc, nullptr, c, tr);
    }
    acc[lane] = a.x;
    acc[n + lane] = a.y;
    acc[2L * n + lane] = a.z;
  }
  counts[0] += c.tests;
  if (Tracer::kBvh) counts[1] += c.visits;
}

}  // namespace

extern "C" {

// zdr_trace_interact (direct.cu) without the stream.
int zdr_trace_interact_host(const int* params, const float* tables, int tables_n,
                            const float* rays, const int* active, float* f_out, int* i_out,
                            int n, int lite) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != q.n_tris * zdr::kSceneCols) return 1;
  std::vector<float> geom = compact(tables, q, q.n_tris * zdr::kGeomCols);
  zdr::Tables tb = zdr::compact_tables(geom.data(), tables, nullptr, nullptr, q);
  for (long lane = 0; lane < n; ++lane)
    zdr::trace_interact_lane(tb, q, rays, active, f_out, i_out, lane, n, lite != 0);
  return 0;
}

// zdr_direct and zdr_direct_grad (direct.cu) without the stream; le_grad
// and grad are null for the forward; counts: one uint64, the tests.
int zdr_direct_host(const int* params, const float* tables, int tables_n, const float* bn,
                    const float* material, const int* lanes, const float* le_grad,
                    float* acc, float* grad, unsigned long long* counts, int n) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  std::vector<float> small = compact(tables, q, zdr::compact_size(q));
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
  direct_lanes(tb, q, zdr::DenseSweep<zdr::kGeomCols>(), lanes, le_grad, acc, grad, counts, n);
  return 0;
}

// zdr_direct_bvh (direct.cu) without the stream; counts: tests and node
// visits; small_shared 0 reads the small tables where the packed tables
// hold them, 1 from a copy.
int zdr_direct_bvh_host(const int* params, const float* tables, int tables_n,
                        int small_shared, const float* bn,
                        const float* material, const int* lanes, const float* le_grad,
                        float* acc, float* grad, const float* nodes, const float* geom,
                        int n_nodes, int n_rows,
                        unsigned long long* counts, int n) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
  std::vector<float> copy(small, small + zdr::small_size(q));
  zdr::Tables tb = zdr::bvh_tables(small_shared ? copy.data() : small, tables, bn, material, q);
  zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
  direct_lanes(tb, q, tr, lanes, le_grad, acc, grad, counts, n);
  return 0;
}

}  // extern "C"
