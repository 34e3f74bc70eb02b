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

// Whether the params' splat is packed (splat.cuh SplatKnobs).
bool packed_of(const int* params) { return zdr::splat_knobs(params).packed != 0; }

// The largest stop of n lanes: the samples of the longest lane.
int max_stop(const int* lanes, int n) {
  int m = 0;
  for (long lane = 0; lane < n; ++lane) m = lanes[2L * n + lane] > m ? lanes[2L * n + lane] : m;
  return m;
}

// Every lane's samples, forward (le_grad null) or tap mode; where the
// splat is packed, the tap mode runs the kPacked instantiation one
// group of samples after the other, as the card's launches do
// (zdr::host_packed_groups).
template <class Tracer, bool kEnv = false>
void direct_lanes(const zdr::Tables& tb, const zdr::LoopParams& q, bool packed,
                  const Tracer& tr, const int* lanes, const float* le_grad, float* acc,
                  float* grad, unsigned long long* counts, int n, const float* light_rows,
                  const zdr::EnvTables* env = nullptr) {
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
      for (long k = 0; k < 3L * n; ++k) acc[k] = 0.0f;
      zdr::host_packed_groups(max_stop(lanes, n), grad, 4L * q.tex_h * q.tex_w,
                              [&](int first, float* scratch) {
        for (long lane = 0; lane < n; ++lane) {
          zdr::LaneConst lc = lane_const(lane);
          zdr::DirectTaps dt = taps(lane, scratch);
          zdr::V3 a0 = {acc[lane], acc[n + lane], acc[2L * n + lane]};
          zdr::V3 a = zdr::direct_lane<true, kEnv, Tracer, kGen, true>(tb, q, lc, &dt, c, tr,
                                                                       env, light_rows, a0,
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
        a = zdr::direct_lane<true, kEnv, Tracer, kGen>(tb, q, lc, &dt, c, tr, env, light_rows);
      } else {
        a = zdr::direct_lane<false, kEnv, Tracer, kGen>(tb, q, lc, nullptr, c, tr, env,
                                                        light_rows);
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

// One sweep a ray over n_tris rows of kGeomCols floats: the direct
// kernels' CompactSweep without the early out (early 0) or with it (1),
// closest hit (any 0), the shadow test (any 1) or the bounce's any-hit
// from 0 (any 2, bounce_any). rays: (7, n) float32 o3 d3 and t_max (the
// closest sweep's best t coming in, the any-hits' end); f_out: (3, n) t,
// u, v (t_max, 0, 0 on a miss; closest only);
// i_out: (n,) the hit triangle (-1: none) or the occlusion; counts: one
// uint64, the tests.
int zdr_sweep_host(const float* rows, int n_tris, const float* rays, int n, int any, int early,
                   float* f_out, int* i_out, unsigned long long* counts) {
  zdr::LoopParams q{};
  q.n_tris = n_tris;
  zdr::Tables tb{};
  tb.scene = rows;
  zdr::TraceCount c = {0, 0};
  for (long k = 0; k < n; ++k) {
    zdr::V3 o = zdr::v3(rays[k], rays[n + k], rays[2L * n + k]);
    zdr::V3 d = zdr::v3(rays[3L * n + k], rays[4L * n + k], rays[5L * n + k]);
    float t = rays[6L * n + k], u = 0.0f, v = 0.0f;
    if (any == 2) {
      i_out[k] = early ? zdr::CompactSweep<true>().bounce_any(tb, q, o, d, t, &c)
                       : zdr::CompactSweep<false>().bounce_any(tb, q, o, d, t, &c);
      continue;
    }
    if (any) {
      i_out[k] = early ? zdr::CompactSweep<true>().any(tb, q, o, d, t, &c)
                       : zdr::CompactSweep<false>().any(tb, q, o, d, t, &c);
      continue;
    }
    i_out[k] = early ? zdr::CompactSweep<true>().closest(tb, q, o, d, t, u, v, &c)
                     : zdr::CompactSweep<false>().closest(tb, q, o, d, t, u, v, &c);
    f_out[k] = t;
    f_out[n + k] = u;
    f_out[2L * n + k] = v;
  }
  counts[0] += c.tests;
  return 0;
}

// zdr_direct (direct.cu) without the stream, the block and the plan; le_grad
// and grad are null for the forward; counts: one uint64, the tests.
int zdr_direct_host(const int* params, const float* tables, int tables_n, const float* bn,
                    const float* material, const int* lanes, const float* le_grad,
                    float* acc, float* grad, unsigned long long* counts, int n, int early) {
  zdr::LoopParams q = zdr::params_from(params);
  const float* lrows;
  if (!zdr::light_rows_of(params, q, tables, tables_n, lrows)) return 1;
  std::vector<float> small = compact(tables, q, zdr::compact_size(q));
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
  if (early)
    direct_lanes(tb, q, packed_of(params), zdr::CompactSweep<true>(), lanes, le_grad, acc, grad,
                 counts, n, lrows);
  else
    direct_lanes(tb, q, packed_of(params), zdr::CompactSweep<false>(), lanes, le_grad, acc, grad,
                 counts, n, lrows);
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
  const float* lrows;
  if (!zdr::light_rows_of(params, q, tables, tables_n, lrows)) return 1;
  const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
  std::vector<float> copy(small, small + zdr::small_size(q));
  zdr::Tables tb = zdr::bvh_tables(small_shared ? copy.data() : small, tables, bn, material, q);
  zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
  direct_lanes(tb, q, packed_of(params), tr, lanes, le_grad, acc, grad, counts, n, lrows);
  return 0;
}

// zdr_direct_env (direct.cu) without the stream, the block and the plan,
// or, with nodes set, zdr_direct_env_bvh without the stream and with the
// small tables where the packed tables hold them: the direct samples under
// the environment light of env_tex (env_h, env_w, 4), env_prob, env_alias
// and env_pdf; counts: tests and node visits.
int zdr_direct_env_host(const int* params, const float* tables, int tables_n, const float* bn,
                        const float* material, const int* lanes, const float* le_grad,
                        float* acc, float* grad, unsigned long long* counts, int n, int early,
                        const float* env_tex, int env_h, int env_w, const float* env_prob,
                        const int* env_alias, const float* env_pdf, const float* nodes,
                        const float* geom, int n_nodes, int n_rows) {
  zdr::LoopParams q = zdr::params_from(params);
  const float* lrows;
  if (!zdr::light_rows_of(params, q, tables, tables_n, lrows) || q.n_env != 1) return 1;
  zdr::EnvTables env =
      zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf);
  if (nodes || n_rows) {
    const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
    zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
    direct_lanes<zdr::BvhTrace, true>(tb, q, packed_of(params), tr, lanes, le_grad, acc, grad,
                                      counts, n, lrows, &env);
    return 0;
  }
  std::vector<float> small = compact(tables, q, zdr::compact_size(q));
  zdr::Tables tb = zdr::compact_tables(small.data(), tables, bn, material, q);
  if (early)
    direct_lanes<zdr::CompactSweep<true>, true>(tb, q, packed_of(params),
                                                zdr::CompactSweep<true>(), lanes, le_grad, acc,
                                                grad, counts, n, lrows, &env);
  else
    direct_lanes<zdr::CompactSweep<false>, true>(tb, q, packed_of(params),
                                                 zdr::CompactSweep<false>(), lanes, le_grad, acc,
                                                 grad, counts, n, lrows, &env);
  return 0;
}

}  // extern "C"
