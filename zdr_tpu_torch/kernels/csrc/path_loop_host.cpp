// Host build of the path-loop step (path_loop_step.cuh) with g++, one lane
// after the other, in forward and in tap mode (whose scatter is then a
// serial add, and whose replay each lane runs for itself), over the dense
// tables or through the BVH (trace.cuh). It runs the kernels' own per-lane code on the CPU so that
// tests without a card can hold it against the plain PyTorch version. Not
// used by the renderer: on the CPU the renderer runs the plain version.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include <vector>

#include "trace.cuh"

namespace {

// The tap-mode state of host lane `lane`: its adjoint, its first k_near
// rows in `near` (the kernel's shared-memory rows, here (k_near,
// kRowPlanes, n), or kRowPlanes + 1 planes where the params merge), the
// rest in `far`.
zdr::GradLane host_grad_lane(const float* le_grad, long lane, int n, float* near, int k_near,
                             float* far, float* grad) {
  zdr::GradLane gl;
  gl.lg[0] = le_grad[lane];
  gl.lg[1] = le_grad[n + lane];
  gl.lg[2] = le_grad[2L * n + lane];
  gl.near = near;
  gl.near_stride = n;
  gl.k_near = k_near;
  gl.col = (int)lane;
  gl.far = far;
  gl.far_stride = n;
  gl.lane = lane;
  gl.grad = grad;
  return gl;
}

// The floats of k_near rows of n lanes, at the row planes of the splat's
// merge.
size_t near_floats(int merge, int k_near, int n) {
  int planes = merge > 1 ? zdr::row_planes<true>() : zdr::kRowPlanes;
  return (size_t)k_near * planes * n;
}

}  // namespace

extern "C" {

// 1 where the params run the kernels' kGen instantiations (zdr::gen_sampler),
// else 0: the pick that every launch makes, for the tests.
int zdr_gen_sampler_host(const int* params) {
  return zdr::gen_sampler(zdr::params_from(params)) ? 1 : 0;
}

int zdr_path_loop_host(const int* params, const float* tables, int tables_n,
                       const float* bn, const float* material, const int* lanes,
                       const float* f_in, const int* i_in, float* f_out, int* i_out,
                       int n, int n_steps) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  zdr::Tables tb = zdr::tables_at(tables, bn, material, q);
  zdr::with_gen(q, [&](auto gen) {
    constexpr bool kGen = decltype(gen)::value;
    for (long lane = 0; lane < n; ++lane) {
      zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                                lanes[2L * n + lane], q.seed, q);
      zdr::LaneState s;
      zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
      zdr::run_lane<false, zdr::DenseSweep<>, false, kGen>(s, lc, tb, q, n_steps);
      zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
    }
  });
  return 0;
}

// zdr_path_loop_grad (path_loop_grad.cu) without the stream and the
// replay's counts; each lane replays its own rows (merged where the params'
// splat merge passes 1, the kMerge instantiation; far then has kRowPlanes
// + 1 planes).
int zdr_path_loop_grad_host(const int* params, const float* tables, int tables_n,
                            const float* bn, const float* material, const int* lanes,
                            const float* le_grad, const float* f_in, const int* i_in,
                            float* f_out, int* i_out, float* far, float* grad, int n,
                            int n_steps, int k_near) {
  zdr::LoopParams q = zdr::params_from(params);
  int merge = zdr::splat_knobs(params).merge;
  if (tables_n != zdr::tables_size(q) || k_near < 0) return 1;
  zdr::Tables tb = zdr::tables_at(tables, bn, material, q);
  std::vector<float> near(near_floats(merge, k_near, n));
  zdr::with_gen(q, [&](auto gen) {
    zdr::with_merge(merge, [&](auto kmerge) {
      constexpr bool kGen = decltype(gen)::value, kMerge = decltype(kmerge)::value;
      for (long lane = 0; lane < n; ++lane) {
        zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                                  lanes[2L * n + lane], q.seed, q);
        zdr::GradLane gl = host_grad_lane(le_grad, lane, n, near.data(), k_near, far, grad);
        zdr::LaneState s;
        zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
        zdr::run_lane<true, zdr::DenseSweep<>, false, kGen, kMerge>(
            s, lc, tb, q, n_steps, &gl, zdr::DenseSweep<>(), nullptr, nullptr, merge);
        zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
      }
    });
  });
  return 0;
}

// zdr_path_loop_bvh and zdr_path_loop_grad_bvh (path_loop.cu,
// path_loop_grad.cu) without the stream; le_grad null runs the forward, and
// far, grad and k_near are then unused; small_shared 0 reads the small
// tables where the packed tables hold them, as the kernels do past shared
// memory, 1 from a copy.
int zdr_path_loop_bvh_host(const int* params, const float* tables, int tables_n,
                           int small_shared, const float* bn, const float* material,
                           const int* lanes, const float* le_grad, const float* f_in,
                           const int* i_in, float* f_out, int* i_out, float* far, float* grad,
                           int n, int n_steps, int k_near, const float* nodes, const float* geom,
                           int n_nodes, int n_rows,
                           unsigned long long* counts) {
  zdr::LoopParams q = zdr::params_from(params);
  int merge = zdr::splat_knobs(params).merge;
  if (tables_n != zdr::tables_size(q) || k_near < 0) return 1;
  const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
  std::vector<float> copy(small, small + zdr::small_size(q));
  zdr::Tables tb = zdr::bvh_tables(small_shared ? copy.data() : small, tables, bn, material, q);
  zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
  zdr::TraceCount c = {0, 0};
  std::vector<float> near(le_grad ? near_floats(merge, k_near, n) : 0);
  zdr::with_gen(q, [&](auto gen) {
    zdr::with_merge(merge, [&](auto kmerge) {
      constexpr bool kGen = decltype(gen)::value, kMerge = decltype(kmerge)::value;
      for (long lane = 0; lane < n; ++lane) {
        zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                                  lanes[2L * n + lane], q.seed, q);
        zdr::LaneState s;
        zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
        if (le_grad) {
          zdr::GradLane gl = host_grad_lane(le_grad, lane, n, near.data(), k_near, far, grad);
          zdr::run_lane<true, zdr::BvhTrace, false, kGen, kMerge>(s, lc, tb, q, n_steps, &gl,
                                                                  tr, &c, nullptr, merge);
        } else {
          zdr::run_lane<false, zdr::BvhTrace, false, kGen>(s, lc, tb, q, n_steps, nullptr, tr,
                                                           &c);
        }
        zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
      }
    });
  });
  counts[0] += c.tests;
  counts[1] += c.visits;
  return 0;
}

// The kEnv instantiations of the path-loop kernels (zdr_path_loop_env,
// zdr_path_loop_grad_env and their _bvh entries) without the stream, the
// block and the plan, each lane after the other: the forward where le_grad
// is null (far, grad and k_near unused), else the tap mode; the dense sweep
// where nodes is null and n_rows 0, else the BVH walk with the small tables
// from a copy (small_shared 1) or from the packed tables (0); counts: the
// tests and node visits; the env's tables as zdr_path_loop_env's.
int zdr_path_loop_env_host(const int* params, const float* tables, int tables_n,
                           int small_shared, const float* bn, const float* material,
                           const int* lanes, const float* le_grad, const float* f_in,
                           const int* i_in, float* f_out, int* i_out, float* far, float* grad,
                           int n, int n_steps, int k_near, const float* nodes,
                           const float* geom, int n_nodes, int n_rows,
                           unsigned long long* counts, const float* env_tex, int env_h,
                           int env_w, const float* env_prob, const int* env_alias,
                           const float* env_pdf) {
  zdr::LoopParams q = zdr::params_from(params);
  int merge = zdr::splat_knobs(params).merge;
  if (tables_n != zdr::tables_size(q) || k_near < 0 || q.n_env != 1) return 1;
  zdr::EnvTables env =
      zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf);
  bool bvh = nodes || n_rows;
  const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
  std::vector<float> copy(small, small + zdr::small_size(q));
  zdr::Tables tb = bvh ? zdr::bvh_tables(small_shared ? copy.data() : small, tables, bn,
                                         material, q)
                       : zdr::tables_at(tables, bn, material, q);
  zdr::BvhTrace tr{zdr::Bvh{nodes, geom, n_nodes, n_rows}};
  zdr::TraceCount c = {0, 0};
  std::vector<float> near(le_grad ? near_floats(merge, k_near, n) : 0);
  zdr::with_gen(q, [&](auto gen) {
    zdr::with_merge(merge, [&](auto kmerge) {
      constexpr bool kGen = decltype(gen)::value, kMerge = decltype(kmerge)::value;
      const zdr::DenseSweep<> dense;
      for (long lane = 0; lane < n; ++lane) {
        zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                                  lanes[2L * n + lane], q.seed, q);
        zdr::LaneState s;
        zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
        zdr::GradLane gl;
        if (le_grad) gl = host_grad_lane(le_grad, lane, n, near.data(), k_near, far, grad);
        const zdr::GradLane* g = le_grad ? &gl : nullptr;
        if (bvh && le_grad)
          zdr::run_lane<true, zdr::BvhTrace, true, kGen, kMerge>(s, lc, tb, q, n_steps, g, tr,
                                                                 &c, &env, merge);
        else if (bvh)
          zdr::run_lane<false, zdr::BvhTrace, true, kGen>(s, lc, tb, q, n_steps, g, tr, &c,
                                                          &env);
        else if (le_grad)
          zdr::run_lane<true, zdr::DenseSweep<>, true, kGen, kMerge>(s, lc, tb, q, n_steps, g,
                                                                     dense, &c, &env, merge);
        else
          zdr::run_lane<false, zdr::DenseSweep<>, true, kGen>(s, lc, tb, q, n_steps, g, dense,
                                                              &c, &env);
        zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
      }
    });
  });
  counts[0] += c.tests;
  counts[1] += c.visits;
  return 0;
}

int zdr_sampler_probe_host(const int* params, const float* bn, const int* lanes, int n,
                           int k, float* out) {
  zdr::LoopParams q = zdr::params_from(params);
  zdr::with_gen(q, [&](auto gen) {
    for (long lane = 0; lane < n; ++lane)
      zdr::sampler_probe_lane<decltype(gen)::value>(
          q, bn, lanes[lane], lanes[n + lane], (uint32_t)lanes[2L * n + lane],
          (uint32_t)lanes[3L * n + lane], k, out, lane, n);
  });
  return 0;
}

// The kernels' bf16 rounding (splat.cuh round_bf16) of n floats x -> out.
int zdr_round_bf16_host(const float* x, float* out, int n) {
  for (long k = 0; k < n; ++k) out[k] = zdr::round_bf16(x[k]);
  return 0;
}

// The kernels' roughness derivative of ggx_brdf, one direction pair a row:
// wo, wi (n, 3) float32 local directions, rough and g_spec (n,), the
// cotangent on spec -> out (n,) = ggx_spec_droughness.
int zdr_ggx_droughness_host(const float* wo, const float* wi, const float* rough,
                            const float* g_spec, float* out, int n) {
  for (long k = 0; k < n; ++k)
    out[k] = zdr::ggx_spec_droughness(zdr::v3(wo[3 * k], wo[3 * k + 1], wo[3 * k + 2]),
                                      zdr::v3(wi[3 * k], wi[3 * k + 1], wi[3 * k + 2]),
                                      rough[k], g_spec[k]);
  return 0;
}

}  // extern "C"
