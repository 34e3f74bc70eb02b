// The path-loop kernel: the whole forward render of the path integrator.
//
// Replaces zdr_tpu/integrators/pallas_loop.py::_loop_kernel (forward mode)
// together with the XLA bilinear fetch (pallas_bounce.read_quads_planes) and
// the while_loop around them (render_path_loop). The TPU kernel ran once per
// bounce over (rows, 512) planes; here one thread owns one pixel lane and
// stays resident for the whole render, stepping its lane until its samples
// are done (persistent over the window).
//
// What bounds it on an H100 (studies/loop_split.py; PERF.md): the issue of
// its instructions, and the latency of their chains with too few warps to
// hide it; not bytes. A step is ~1,700 FP32 operations (two brute-force
// sweeps over the shared-memory scene, ~22 ray-triangle tests, and the
// shading) and ~430 integer ones (the sampler's 6 draws); counted, the
// flagship's 48.8 M steps need at least ~3 ms of issue (chip_smoke.py's
// bound), and the sweeps take ~40% of the kernel's time, the sampler ~18%,
// the restart branch ~7%, the material's four texel loads (from L2) a few.
// Lanes stay together (29.8 of 32 active at a step's head) and a lane's 64
// samples take 186 +- 8 steps, so blocks take near equal times and the
// launch runs in rounds of resident blocks, idle at its end for ~3% of the
// SMs' time. So the design:
//   - the sampler's lane-constant work is done once a lane (the hash's
//     rounds over the pixel: LaneConst::hash_xy) or once a launch (a mask for
//     a power-of-two blue-noise count, a product by 2^-k for / spp, the
//     camera's scales: LoopParams); the point seeds are selects, not a table
//     in local memory, sobol2 four shifted xors and the bit reversal one
//     instruction: the same bits;
//   - the kernels are compiled at 64 registers, 32 warps an SM, and spill to
//     L1 (~200 bytes a thread): the more resident warps hide more latency
//     than the spills cost (128 registers, 16 warps: 12.7-12.9 ms; 80, 24
//     warps: 11.4-11.9; 64: 10.9-11.7; 48: 12.2-12.7);
//   - the launch picks the block from the SM count and the occupancy the
//     build reports (launch, below), so a small render spreads over the SMs
//     (128x128: 2.36 ms at 128 threads against 3.30 at 512). The
//     dense route's blocks go up to 512 threads (a block's
//     neighbouring pixels share texels and blue noise in L1: 10.9 ms at 512
//     against 11.6 at 256), the BVH route's to 256 (its walks vary more in
//     length, and a block holds its SM's slots until its slowest lane; at
//     128 registers 256 threads cost 13% over 128 on the big mesh).
// The sweeps themselves (and the divergence of a step's branches) are what
// is left. A step's two walks in one loop (the env forwards' NEE shadow ray
// and next ray, each its own ordered walk, both rays' loads issued before
// either visit; the dense sweep reading a row once for both) kept the bits
// and the counts but measured slower (studies/env_split.py,
// studies/iteration_ab.py; PERF.md): through the BVH +18-24% (two walks'
// state spills: 840 bytes of local memory a thread at 64 registers, 768 at
// 80), dense +1.5% to -0.5%; the serial walks stay. The BVH env forward
// at blocks of 128 (8 an SM, the same code) ran tools/bench_round3.py's
// env_scene 12-14% faster and the big mesh 4-5% slower than at 256; the
// launch keeps its pick of 256 (studies/env_block.py maps both blocks over
// tree sizes and scene layouts).
//
// Under an environment map the same kernels run their kEnv instantiations
// (path_loop_env, path_loop_env_bvh): the port of the JAX package's route
// for path + env, path_fused.py's chain of pallas_bounce.py's B3 and
// _shade_kernel around the env glue (fused_glue.py). The env tables ride
// as a kernel argument in device memory, read through the read-only path;
// the instantiations without the env never read it, and compile to the
// code they had before it.
//
// The samplers that need more than the flagship's (corrmj, and pmj02bn at a
// spp that is no power of two: zdr::gen_sampler) run the kGen
// instantiations of the same kernels: a third sampler word in the carry,
// corrmj's draws, and the Kensler permutation's per-lane rejection loop,
// which the JAX package ran in the XLA glue around its kernels
// (path_fused.py) wherever its loop kernel could not take the sampler. The
// instantiations without kGen never run that code, but they still store a 0
// into the carry's seventh row (smp2), which moved their schedule: the
// flagship's SASS changed, and path_loop_grad went from 126 to 128
// registers (PERF.md).
//
// path_loop_bvh_kernel is the same walk with its two sweeps a step through
// the ordered BVH walk in global memory (trace.cuh): the big-mesh route that
// the JAX package took through path_fused.py's streamed sweeps, B5 in
// _bounce (:132-135) and B6 in _stream_occ (:161-172). Only the light,
// point and camera rows stay in shared memory, and only where they fit
// (small_shared; past that they are read from global memory); the kernel
// counts its tests and node visits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "launch.cuh"
#include "trace.cuh"

namespace {

// Each kernel is capped at 64 registers, 32 warps an SM, by its largest
// block and the blocks an SM that block needs; it launches at any power of
// two from 32 up to that block (the code reads blockDim). kEnv: under the
// environment light of `env`; kGen: the generic sampler.
template <bool kEnv, bool kGen>
__global__ void __launch_bounds__(512, 2)
    path_loop_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                     const float* __restrict__ bn, const float* __restrict__ material,
                     const int* __restrict__ lanes, const float* __restrict__ f_in,
                     const int* __restrict__ i_in, float* __restrict__ f_out,
                     int* __restrict__ i_out, int n, int n_steps, zdr::EnvTables env) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < tables_n; k += blockDim.x) smem[k] = tables[k];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::Tables tb = zdr::tables_at(smem, bn, material, q);
  zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                            lanes[2L * n + lane], q.seed, q);
  zdr::LaneState s;
  zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
  zdr::run_lane<false, zdr::DenseSweep<>, kEnv, kGen>(s, lc, tb, q, n_steps, nullptr,
                                                      zdr::DenseSweep<>(), nullptr, &env);
  zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
}

template <bool kEnv, bool kGen>
__global__ void __launch_bounds__(256, 4)
    path_loop_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables,
                         int small_shared, const float* __restrict__ bn,
                         const float* __restrict__ material,
                         const int* __restrict__ lanes, const float* __restrict__ f_in,
                         const int* __restrict__ i_in, float* __restrict__ f_out,
                         int* __restrict__ i_out, int n, int n_steps, zdr::Bvh bvh,
                         unsigned long long* counts, zdr::EnvTables env) {
  extern __shared__ float smem[];
  const float* small = zdr::load_small(smem, tables, q, small_shared);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                              lanes[2L * n + lane], q.seed, q);
    zdr::LaneState s;
    zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
    zdr::run_lane<false, zdr::BvhTrace, kEnv, kGen>(s, lc, tb, q, n_steps, nullptr,
                                                    zdr::BvhTrace{bvh}, &count, &env);
    zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
  }
  zdr::warp_add(counts, count.tests);
  zdr::warp_add(counts + 1, count.visits);
}

template <bool kGen>
__global__ void sampler_probe_kernel(zdr::LoopParams q, const float* __restrict__ bn,
                                     const int* __restrict__ lanes, int n, int k,
                                     float* __restrict__ out) {
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::sampler_probe_lane<kGen>(q, bn, lanes[lane], lanes[n + lane], (uint32_t)lanes[2L * n + lane],
                          (uint32_t)lanes[3L * n + lane], k, out, lane, n);
}

// One launch of the dense kernel, with or without the env.
int loop_dense(const int* params, const float* tables, int tables_n, const float* bn,
               const float* material, const int* lanes, const float* f_in, const int* i_in,
               float* f_out, int* i_out, int n, int n_steps, zdr::EnvTables env, bool with_env,
               int block, int* plan, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  // the params' env count must be the instantiation's
  if (tables_n != zdr::tables_size(q) || (q.n_env != 0) != with_env)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&q,     &tables, &tables_n, &bn,  &material, &lanes, &f_in,
                  &i_in,  &f_out,  &i_out,    &n,   &n_steps,  &env};
  const void* fns[2][2] = {
      {(const void*)path_loop_kernel<false, false>, (const void*)path_loop_kernel<false, true>},
      {(const void*)path_loop_kernel<true, false>, (const void*)path_loop_kernel<true, true>}};
  const void* fn = fns[with_env][zdr::gen_sampler(q)];
  return zdr::launch(fn, n, tables_n * (int)sizeof(float), block, plan, args, stream);
}

// One launch of the BVH kernel, with or without the env.
int loop_bvh(const int* params, const float* tables, int tables_n, int small_shared,
             const float* bn, const float* material, const int* lanes, const float* f_in,
             const int* i_in, float* f_out, int* i_out, int n, int n_steps, const float* nodes,
             const float* geom, int n_nodes, int n_rows, unsigned long long* counts,
             zdr::EnvTables env, bool with_env, int block, int* plan, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  // the params' env count must be the instantiation's
  if (tables_n != zdr::tables_size(q) || (q.n_env != 0) != with_env)
    return (int)cudaErrorInvalidValue;
  int smem = small_shared ? zdr::small_size(q) * (int)sizeof(float) : 0;
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  void* args[] = {&q,    &tables, &small_shared, &bn,      &material, &lanes, &f_in,
                  &i_in, &f_out,  &i_out,        &n,       &n_steps,  &bvh,   &counts,
                  &env};
  const void* fns[2][2] = {
      {(const void*)path_loop_bvh_kernel<false, false>,
       (const void*)path_loop_bvh_kernel<false, true>},
      {(const void*)path_loop_bvh_kernel<true, false>,
       (const void*)path_loop_bvh_kernel<true, true>}};
  const void* fn = fns[with_env][zdr::gen_sampler(q)];
  return zdr::launch(fn, n, smem, block, plan, args, stream);
}

}  // namespace

extern "C" {

// params: the 20 ints of zdr::LoopParams (host memory); tables: tables_size floats;
// lanes: (3, n) int32 px, py, stop; carry: (kNumF, n) float32 and
// (kNumI, n) int32, read from *_in and written to *_out; block and plan: as
// launch's (block 0: the plan's pick; plan: 8 ints, written). Returns the
// CUDA error of the launch (0 when it was accepted).
int zdr_path_loop(const int* params, const float* tables, int tables_n, const float* bn,
                  const float* material, const int* lanes, const float* f_in,
                  const int* i_in, float* f_out, int* i_out, int n, int n_steps, int block,
                  int* plan, void* stream) {
  return loop_dense(params, tables, tables_n, bn, material, lanes, f_in, i_in, f_out, i_out, n,
                    n_steps, zdr::EnvTables{}, false, block, plan, stream);
}

// zdr_path_loop through the BVH: nodes (n_nodes, 16) float32, geom (n_rows,
// 12) float32 rows in leaf order, each with its global id in float 9
// (trace.cuh Bvh); counts: two uint64, to which the kernel adds its
// ray-triangle tests and node visits; small_shared 1 copies the small
// tables into shared memory, 0 reads them from `tables`.
int zdr_path_loop_bvh(const int* params, const float* tables, int tables_n, int small_shared,
                      const float* bn,
                      const float* material, const int* lanes, const float* f_in,
                      const int* i_in, float* f_out, int* i_out, int n, int n_steps,
                      const float* nodes, const float* geom, int n_nodes, int n_rows, unsigned long long* counts, int block, int* plan,
                      void* stream) {
  return loop_bvh(params, tables, tables_n, small_shared, bn, material, lanes, f_in, i_in,
                  f_out, i_out, n, n_steps, nodes, geom, n_nodes, n_rows, counts,
                  zdr::EnvTables{}, false, block, plan, stream);
}

// zdr_path_loop under an environment light: the params' n_env is 1, and
// env_tex (env_h, env_w, 4), env_prob, env_alias and env_pdf are the
// envmap's tables (zdr_tpu_torch/envmap.py EnvMap), read through the
// read-only path.
int zdr_path_loop_env(const int* params, const float* tables, int tables_n, const float* bn,
                      const float* material, const int* lanes, const float* f_in,
                      const int* i_in, float* f_out, int* i_out, int n, int n_steps,
                      const float* env_tex, int env_h, int env_w, const float* env_prob,
                      const int* env_alias, const float* env_pdf, int block, int* plan,
                      void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return loop_dense(params, tables, tables_n, bn, material, lanes, f_in, i_in, f_out, i_out, n,
                    n_steps, zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias,
                                             env_pdf),
                    true, block, plan, stream);
}

// zdr_path_loop_bvh under an environment light, as zdr_path_loop_env.
int zdr_path_loop_env_bvh(const int* params, const float* tables, int tables_n,
                          int small_shared, const float* bn, const float* material,
                          const int* lanes, const float* f_in, const int* i_in, float* f_out,
                          int* i_out, int n, int n_steps, const float* nodes,
                          const float* geom, int n_nodes, int n_rows,
                          unsigned long long* counts, const float* env_tex, int env_h,
                          int env_w, const float* env_prob, const int* env_alias,
                          const float* env_pdf, int block, int* plan, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return loop_bvh(params, tables, tables_n, small_shared, bn, material, lanes, f_in, i_in,
                  f_out, i_out, n, n_steps, nodes, geom, n_nodes, n_rows, counts,
                  zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf),
                  true, block, plan, stream);
}

// lanes: (4, n) int32 px, py, seed, sample_idx; out: (3k, n) float32, for
// each j the draws next1, then next2's x and y.
int zdr_sampler_probe(const int* params, const float* bn, const int* lanes, int n, int k,
                      float* out, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  auto fn = zdr::gen_sampler(q) ? sampler_probe_kernel<true> : sampler_probe_kernel<false>;
  fn<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(q, bn, lanes, n, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
