// Host build of the path-loop step (path_loop_step.cuh) with g++, one lane
// after the other, in forward and in tap mode (whose scatter is then a
// serial add). It runs the kernels' own per-lane code on the CPU so that
// tests without a card can hold it against the plain PyTorch version. Not
// used by the renderer: on the CPU the renderer runs the plain version.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include "path_loop_step.cuh"

extern "C" {

int zdr_path_loop_host(const int* params, const float* tables, int tables_n,
                       const float* bn, const float* material, const int* lanes,
                       const float* f_in, const int* i_in, float* f_out, int* i_out,
                       int n, int n_steps) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  zdr::Tables tb = zdr::tables_at(tables, bn, material, q);
  for (long lane = 0; lane < n; ++lane) {
    zdr::LaneConst lc =
        zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane], q.seed, q);
    zdr::LaneState s;
    zdr::load_lane(s, f_in, i_in, lane, n);
    zdr::run_lane(s, lc, tb, q, n_steps);
    zdr::store_lane(s, f_out, i_out, lane, n);
  }
  return 0;
}

// zdr_path_loop_grad (path_loop_grad.cu) without the stream.
int zdr_path_loop_grad_host(const int* params, const float* tables, int tables_n,
                            const float* bn, const float* material, const int* lanes,
                            const float* le_grad, const float* f_in, const int* i_in,
                            float* f_out, int* i_out, float* scratch, float* grad, int n,
                            int n_steps) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return 1;
  zdr::Tables tb = zdr::tables_at(tables, bn, material, q);
  for (long lane = 0; lane < n; ++lane) {
    zdr::LaneConst lc =
        zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane], q.seed, q);
    zdr::GradLane gl;
    gl.lg[0] = le_grad[lane];
    gl.lg[1] = le_grad[n + lane];
    gl.lg[2] = le_grad[2L * n + lane];
    gl.rows = scratch + lane;
    gl.n = n;
    gl.grad = grad;
    zdr::LaneState s;
    zdr::load_lane(s, f_in, i_in, lane, n);
    zdr::run_lane<true>(s, lc, tb, q, n_steps, &gl);
    zdr::store_lane(s, f_out, i_out, lane, n);
  }
  return 0;
}

int zdr_sampler_probe_host(const int* params, const float* bn, const int* lanes, int n,
                           int k, float* out) {
  zdr::LoopParams q = zdr::params_from(params);
  for (long lane = 0; lane < n; ++lane)
    zdr::sampler_probe_lane(q, bn, lanes[lane], lanes[n + lane],
                            (uint32_t)lanes[2L * n + lane], (uint32_t)lanes[3L * n + lane],
                            k, out, lane, n);
  return 0;
}

}  // extern "C"
