// Host build of the direct integrator's per-lane code (direct_step.cuh) with
// g++, one lane after the other, in forward and in tap mode (whose scatter
// is then a serial add), and of trace_interact. It runs the kernels' own
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
// and grad are null for the forward.
int zdr_direct_host(const int* params, const float* tables, int tables_n, const float* bn,
                    const float* material, const int* lanes, const float* le_grad,
                    float* acc, float* grad, unsigned long long* tests, int n) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  std::vector<float> small = compact(tables, q, zdr::compact_size(q));
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
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
      a = zdr::direct_lane<true>(tb, q, lc, &dt, *tests);
    } else {
      a = zdr::direct_lane<false>(tb, q, lc, nullptr, *tests);
    }
    acc[lane] = a.x;
    acc[n + lane] = a.y;
    acc[2L * n + lane] = a.z;
  }
  return 0;
}

}  // extern "C"
