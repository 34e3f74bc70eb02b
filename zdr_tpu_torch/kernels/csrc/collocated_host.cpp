// Host build of the collocated integrator's per-lane code
// (collocated_step.cuh) with g++, one lane after the other, in forward and
// in tap mode (whose scatter is then a serial add), over the compact tables
// or through the BVH. It runs the kernels' own code on the CPU so that tests
// without a card can hold it against the plain PyTorch version. Not used by
// the renderer: on the CPU the renderer runs the plain version.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include <vector>

#include "collocated_step.cuh"

namespace {

template <class Tracer>
void collocated_lanes(const zdr::Tables& tb, const zdr::LoopParams& q, const Tracer& tr,
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
      a = zdr::collocated_lane<true>(tb, q, lc, &dt, c, tr);
    } else {
      a = zdr::collocated_lane<false>(tb, q, lc, nullptr, c, tr);
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

// zdr_collocated (collocated.cu) without the stream, the block and the
// plan, or, with nodes or n_rows set, zdr_collocated_bvh without the stream
// and with the small tables where the packed tables hold them; le_grad and
// grad are null for the forward; counts: tests and node visits.
int zdr_collocated_host(const int* params, const float* tables, int tables_n, const float* bn,
                        const float* material, const int* lanes, const float* le_grad,
                        float* acc, float* grad, unsigned long long* counts, int n,
                        const float* nodes, const float* geom, int n_nodes, int n_rows) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  if (nodes || n_rows) {
    const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
    zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
    collocated_lanes(tb, q, tr, lanes, le_grad, acc, grad, counts, n);
    return 0;
  }
  std::vector<float> small(zdr::compact_size(q));
  for (int k = 0; k < (int)small.size(); ++k) small[k] = zdr::compact_at(tables, q, k);
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
  collocated_lanes(tb, q, zdr::CompactSweep<false>(), lanes, le_grad, acc, grad, counts, n);
  return 0;
}

}  // extern "C"
