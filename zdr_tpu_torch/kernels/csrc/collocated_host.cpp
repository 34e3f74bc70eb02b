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

// Whether the params' splat is packed (splat.cuh SplatKnobs).
bool packed_of(const int* params) { return zdr::splat_knobs(params).packed != 0; }

// Every lane's samples, forward (le_grad null) or tap mode; the packed tap
// mode group by group, as direct_host.cpp's direct_lanes.
template <class Tracer>
void collocated_lanes(const zdr::Tables& tb, const zdr::LoopParams& q, bool packed,
                      const Tracer& tr, const int* lanes, const float* le_grad, float* acc,
                      float* grad, unsigned long long* counts, int n) {
  zdr::TraceCount c = {0, 0};
  zdr::with_gen(q, [&](auto gen) {
    constexpr bool kGen = decltype(gen)::value;
    auto taps = [&](long lane, float* g) {
      zdr::DirectTaps dt;
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = g;
      return dt;
    };
    auto lane_const = [&](long lane) {
      return zdr::lane_const<kGen>(lanes[lane], lanes[n + lane], lanes[2L * n + lane], q.seed,
                                   q);
    };
    if (le_grad && packed) {
      int samples = 0;
      for (long lane = 0; lane < n; ++lane)
        samples = lanes[2L * n + lane] > samples ? lanes[2L * n + lane] : samples;
      for (long k = 0; k < 3L * n; ++k) acc[k] = 0.0f;
      zdr::host_packed_groups(samples, grad, 4L * q.tex_h * q.tex_w,
                              [&](int first, float* scratch) {
        for (long lane = 0; lane < n; ++lane) {
          zdr::LaneConst lc = lane_const(lane);
          zdr::DirectTaps dt = taps(lane, scratch);
          zdr::V3 a0 = {acc[lane], acc[n + lane], acc[2L * n + lane]};
          zdr::V3 a = zdr::collocated_lane<true, Tracer, kGen, true>(tb, q, lc, &dt, c, tr, a0,
                                                                     first);
          acc[lane] = a.x;
          acc[n + lane] = a.y;
          acc[2L * n + lane] = a.z;
        }
      });
      return;
    }
    for (long lane = 0; lane < n; ++lane) {
      zdr::LaneConst lc = lane_const(lane);
      zdr::V3 a;
      if (le_grad) {
        zdr::DirectTaps dt = taps(lane, grad);
        a = zdr::collocated_lane<true, Tracer, kGen>(tb, q, lc, &dt, c, tr);
      } else {
        a = zdr::collocated_lane<false, Tracer, kGen>(tb, q, lc, nullptr, c, tr);
      }
      acc[lane] = a.x;
      acc[n + lane] = a.y;
      acc[2L * n + lane] = a.z;
    }
  });
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
    collocated_lanes(tb, q, packed_of(params), tr, lanes, le_grad, acc, grad, counts, n);
    return 0;
  }
  std::vector<float> small(zdr::compact_size(q));
  for (int k = 0; k < (int)small.size(); ++k) small[k] = zdr::compact_at(tables, q, k);
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
  collocated_lanes(tb, q, packed_of(params), zdr::CompactSweep<false>(), lanes, le_grad, acc,
                   grad, counts, n);
  return 0;
}

}  // extern "C"
