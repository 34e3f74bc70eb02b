// The path-loop gradient kernel: the PRB texture gradient of the path
// integrator, in one launch.
//
// Replaces the tap mode (want_grad) of
// zdr_tpu/integrators/pallas_loop.py::_loop_kernel together with the rest
// of render_path_backward_loop (:1082-1286): the tap store, the post-pass's
// reverse scans and tap algebra, and the scatter (texture.segment_scatter_add4).
// The TPU walk stored 16 planes per bounce iteration for every lane (about
// 4 GB at 512^2), bounded its while_loop with LOOP_TAP_CAP and an `allow`
// plane, and recovered each tap's suffix radiance G' with associative
// scans. Here one thread owns one pixel lane for the whole walk, as in
// path_loop.cu, and runs the forward's step in tap mode
// (path_loop_step.cuh, loop_step<true>): each bounce writes a row of 13
// floats (its radiance, P, bq, u0 and u3, the splat id), and when a sample
// ends with a radiance that is not NaN its rows are walked back with G'
// summed from the last, and each tap's 4 channels go into the (H*W, 4)
// gradient. The sample stream is keyed by the sample index, so the taps are
// the JAX backward's at splat_merge=1, and their sum is its gradient.
//
// What bounds it on an H100: the forward's latency- and divergence-bound
// walk (path_loop.cu), plus the taps: some 262144 * 64 * 3.5 = 59 M at the
// flagship 512^2 / 64 spp, into a 16 MB gradient that stays in the 50 MB
// L2. Every row in global scratch would be 235 MB at the flagship, each
// written and read back from DRAM, a warp's stores scattered over the
// depths its lanes are at; four scalar atomics a tap would be four times
// the atomics. So the kernel
//   - keeps a sample's first k_near rows in the block's shared memory,
//     [row][plane][column] at a column stride of kBlock + 1 (a warp's
//     stores and the replay's reads spread over the banks), sized at launch
//     from what the tables leave without costing a resident block
//     (zdr_path_loop_grad_plan; the deeper rows, few, in global scratch);
//   - replays a finished sample's rows from there, by its lane, after the
//     step (a replay by the whole warp, 32 rows at a time, keeps more lanes
//     busy and costs more: PERF.md, studies/grad_split.py);
//   - adds a tap with one 16-byte vector atomic.
// The atomics sum in an order that changes from run to run, so the
// gradient's last bits do too.
//
// Under an environment map the kernels run their kEnv instantiations
// (path_loop_grad_env, path_loop_grad_env_bvh), as path_loop.cu's do: the
// env's miss radiance enters a row's radiance as an emitter hit's does, so
// the rows keep their layout (kRowPlanes).
//
// The generic sampler (corrmj; pmj02bn at a spp that is no power of two)
// runs the kGen instantiations, as path_loop.cu's.
//
// splat_merge > 1 (the params' merge) runs the kMerge instantiations: a
// row carries a 14th plane, its step's merge draw, and a finished sample's
// rows are merged in step order into the lane's pending tap, one atomic a
// group of `merge` steps (path_loop_step.cuh replay_merge: the JAX loop
// backward's reservoir merge, pallas_loop.py:1232-1261). The others keep
// their code (a template argument, as kEnv and kGen). packed_splat rounds
// the gradient's texels to bf16 after the launch (splat.cu), as the JAX
// loop route's one flush rounds its totals.
//
// path_loop_grad_bvh_kernel is the same walk with its sweeps through the
// ordered BVH walk in global memory (trace.cuh), as path_loop.cu's
// path_loop_bvh_kernel: the big-mesh route of the JAX package's path_fused
// backward (B5 and B6 in place of the sweeps), with the small tables in
// shared memory where they fit (small_shared) and read from global memory
// where they do not; it counts its tests and node visits. Its walk is bound
// by the latency of its node and triangle loads, which L1 serves: shared
// memory taken by tap rows takes L1 away (kernels.GRAD_NEAR_ROWS keeps its
// rows in global scratch), and it is compiled for 4 resident blocks an SM
// (128 registers, no spills), so that its register use cannot grow past
// them (studies/grad_split.py times it uncapped and at 5). Under the env
// (path_loop_grad_env_bvh), whose walk skips the shadow rays that cannot
// count, it is compiled for 8 (64 registers, spilling): twice the resident
// warps hide more of the walk's latency (studies/env_split.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kNearStride = kBlock + 1;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may hold

size_t near_bytes(int k_near, bool merge) {
  int planes = merge ? zdr::row_planes<true>() : zdr::kRowPlanes;
  return (size_t)k_near * planes * kNearStride * sizeof(float);
}

// The lane's tap-mode state: its adjoint (0 past n) and its rows' homes.
__device__ zdr::GradLane grad_lane(const float* le_grad, long lane, int n, float* near,
                                   int k_near, float* far, float* grad) {
  zdr::GradLane gl;
  bool real = lane < n;
  gl.lg[0] = real ? le_grad[lane] : 0.0f;
  gl.lg[1] = real ? le_grad[n + lane] : 0.0f;
  gl.lg[2] = real ? le_grad[2L * n + lane] : 0.0f;
  gl.near = near;
  gl.near_stride = kNearStride;
  gl.k_near = k_near;
  gl.col = threadIdx.x;
  gl.far = far;
  gl.far_stride = n;
  gl.lane = lane;
  gl.grad = grad;
  return gl;
}

// A thread past the last lane has no sample (stop 0): its walk ends at once.
template <bool kEnv, bool kGen, bool kMerge, class Tracer>
__device__ __forceinline__ void walk(const zdr::Tables& tb, const zdr::LoopParams& q,
                                     const int* lanes, const float* f_in, const int* i_in,
                                     float* f_out, int* i_out, long lane, int n, int n_steps,
                                     const zdr::GradLane& gl, const Tracer& tr,
                                     zdr::TraceCount* count, const zdr::EnvTables* env,
                                     int merge) {
  zdr::LaneState s;
  zdr::LaneConst lc;
  if (lane < n) {
    lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane], lanes[2L * n + lane], q.seed, q);
    zdr::load_lane<kGen>(s, f_in, i_in, lane, n);
  } else {
    lc = zdr::lane_const<kGen>(0, 0, 0, q.seed, q);
    s.sample_idx = 0;
    s.in_flight = 0;
  }
  zdr::run_lane<true, Tracer, kEnv, kGen, kMerge>(s, lc, tb, q, n_steps, &gl, tr, count, env,
                                                  merge);
  if (lane < n) zdr::store_lane<kGen>(s, f_out, i_out, lane, n);
}

template <bool kEnv, bool kGen, bool kMerge>
__global__ void __launch_bounds__(kBlock)
    path_loop_grad_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                          const float* __restrict__ bn, const float* __restrict__ material,
                          const int* __restrict__ lanes, const float* __restrict__ le_grad,
                          const float* __restrict__ f_in, const int* __restrict__ i_in,
                          float* __restrict__ f_out, int* __restrict__ i_out,
                          float* __restrict__ far, float* grad, int n, int n_steps,
                          int k_near, zdr::EnvTables env, int merge) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < tables_n; k += blockDim.x) smem[k] = tables[k];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::Tables tb = zdr::tables_at(smem, bn, material, q);
  zdr::GradLane gl = grad_lane(le_grad, lane, n, smem + tables_n, k_near, far, grad);
  walk<kEnv, kGen, kMerge>(tb, q, lanes, f_in, i_in, f_out, i_out, lane, n, n_steps, gl,
                           zdr::DenseSweep<>(), nullptr, &env, merge);
}

template <bool kEnv, bool kGen, bool kMerge>
__global__ void __launch_bounds__(kBlock, kEnv ? 8 : 4)
    path_loop_grad_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables,
                              int small_shared, const float* __restrict__ bn,
                              const float* __restrict__ material,
                              const int* __restrict__ lanes, const float* __restrict__ le_grad,
                              const float* __restrict__ f_in, const int* __restrict__ i_in,
                              float* __restrict__ f_out, int* __restrict__ i_out,
                              float* __restrict__ far, float* grad, int n, int n_steps,
                              int k_near, zdr::Bvh bvh, unsigned long long* counts,
                              zdr::EnvTables env, int merge) {
  extern __shared__ float smem[];
  const float* small = zdr::load_small(smem, tables, q, small_shared);
  int n_small = small_shared ? zdr::small_size(q) : 0;
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
  zdr::GradLane gl = grad_lane(le_grad, lane, n, smem + n_small, k_near, far, grad);
  walk<kEnv, kGen, kMerge>(tb, q, lanes, f_in, i_in, f_out, i_out, lane, n, n_steps, gl,
                           zdr::BvhTrace{bvh}, &count, &env, merge);
  zdr::warp_add(counts, count.tests);
  zdr::warp_add(counts + 1, count.visits);
}

// The dense kernel's instantiation for the params and the splat's merge:
// the env, the generic sampler, the merge.
using DenseKernel = decltype(&path_loop_grad_kernel<false, false, false>);
using BvhKernel = decltype(&path_loop_grad_bvh_kernel<false, false, false>);

DenseKernel dense_fn(const zdr::LoopParams& q, int merge) {
  const DenseKernel fns[8] = {
      path_loop_grad_kernel<false, false, false>, path_loop_grad_kernel<true, false, false>,
      path_loop_grad_kernel<false, true, false>,  path_loop_grad_kernel<true, true, false>,
      path_loop_grad_kernel<false, false, true>,  path_loop_grad_kernel<true, false, true>,
      path_loop_grad_kernel<false, true, true>,   path_loop_grad_kernel<true, true, true>};
  return fns[(q.n_env != 0 ? 1 : 0) | (zdr::gen_sampler(q) ? 2 : 0) | (merge > 1 ? 4 : 0)];
}

// The BVH kernel's, likewise.
BvhKernel bvh_fn(const zdr::LoopParams& q, int merge) {
  const BvhKernel fns[8] = {
      path_loop_grad_bvh_kernel<false, false, false>, path_loop_grad_bvh_kernel<true, false, false>,
      path_loop_grad_bvh_kernel<false, true, false>,  path_loop_grad_bvh_kernel<true, true, false>,
      path_loop_grad_bvh_kernel<false, false, true>,  path_loop_grad_bvh_kernel<true, false, true>,
      path_loop_grad_bvh_kernel<false, true, true>,   path_loop_grad_bvh_kernel<true, true, true>};
  return fns[(q.n_env != 0 ? 1 : 0) | (zdr::gen_sampler(q) ? 2 : 0) | (merge > 1 ? 4 : 0)];
}

// Dynamic shared memory past 48 KB needs the kernel's consent; give it the
// most a block may hold.
int allow_smem(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
}

// One launch of the dense gradient kernel, with or without the env.
int grad_dense(const int* params, const float* tables, int tables_n, const float* bn,
               const float* material, const int* lanes, const float* le_grad,
               const float* f_in, const int* i_in, float* f_out, int* i_out, float* far,
               float* grad, int n, int n_steps, int k_near, zdr::EnvTables env, bool with_env,
               void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  int merge = zdr::splat_knobs(params).merge;
  // the params' env count must be the instantiation's
  if (tables_n != zdr::tables_size(q) || (q.n_env != 0) != with_env)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)tables_n * sizeof(float) + near_bytes(k_near, merge > 1);
  DenseKernel fn = dense_fn(q, merge);
  int err = allow_smem((const void*)fn);
  if (err) return err;
  int grid = (n + kBlock - 1) / kBlock;
  fn<<<grid, kBlock, smem, (cudaStream_t)stream>>>(q, tables, tables_n, bn, material, lanes,
                                                   le_grad, f_in, i_in, f_out, i_out, far, grad,
                                                   n, n_steps, k_near, env, merge);
  return (int)cudaGetLastError();
}

// One launch of the BVH gradient kernel, with or without the env.
int grad_bvh(const int* params, const float* tables, int tables_n, int small_shared,
             const float* bn, const float* material, const int* lanes, const float* le_grad,
             const float* f_in, const int* i_in, float* f_out, int* i_out, float* far,
             float* grad, int n, int n_steps, int k_near, const float* nodes, const float* geom,
             int n_nodes, int n_rows, unsigned long long* counts, zdr::EnvTables env,
             bool with_env, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  int merge = zdr::splat_knobs(params).merge;
  // the params' env count must be the instantiation's
  if (tables_n != zdr::tables_size(q) || (q.n_env != 0) != with_env)
    return (int)cudaErrorInvalidValue;
  size_t smem = (small_shared ? (size_t)zdr::small_size(q) * sizeof(float) : 0) +
                near_bytes(k_near, merge > 1);
  BvhKernel fn = bvh_fn(q, merge);
  int err = allow_smem((const void*)fn);
  if (err) return err;
  int grid = (n + kBlock - 1) / kBlock;
  fn<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, small_shared, bn, material, lanes, le_grad, f_in, i_in, f_out, i_out, far,
      grad, n, n_steps, k_near, zdr::Bvh{nodes, geom, n_nodes, n_rows}, counts, env, merge);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch of the gradient kernel that the params pick (the env where
// their n_env is 1, the generic sampler where zdr::gen_sampler holds, the
// merge where their merge passes 1; the BVH where bvh is 1), as grad_dense
// and grad_bvh pick it, whose tables
// take table_bytes of shared memory: k_near, the most near rows, up to
// k_cap, that keep the resident blocks an SM of k_near = 0 (the rows are
// only as deep as max_depth, so k_cap need not pass it). info: k_near, the
// block size, the registers a thread, the resident blocks an SM, the
// block's shared memory, the local memory a thread (spills). Returns the
// CUDA error (cudaErrorInvalidValue when the tables alone do not fit a
// block).
int zdr_path_loop_grad_plan(const int* params, int bvh, int table_bytes, int k_cap, int* info) {
  if (bvh < 0 || bvh > 1) return (int)cudaErrorInvalidValue;
  zdr::LoopParams q = zdr::params_from(params);
  int knob = zdr::splat_knobs(params).merge;
  const void* kernel = bvh ? (const void*)bvh_fn(q, knob) : (const void*)dense_fn(q, knob);
  bool merge = knob > 1;
  int err = allow_smem(kernel);
  if (err) return err;
  if (table_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int base = 0, occ = 0, k_near = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&base, kernel, kBlock, table_bytes);
  if (err) return err;
  for (int k = 1; k <= k_cap; ++k) {
    size_t bytes = table_bytes + near_bytes(k, merge);
    if (bytes > (size_t)kMaxSmem) break;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBlock, bytes);
    if (err) return err;
    if (occ < base) break;
    k_near = k;
  }
  info[0] = k_near;
  info[1] = kBlock;
  info[2] = attr.numRegs;
  info[3] = base;
  info[4] = (int)(table_bytes + near_bytes(k_near, merge));
  info[5] = (int)attr.localSizeBytes;
  return 0;
}

// As zdr_path_loop (path_loop.cu), plus le_grad: (3, n) float32, each
// lane's per-sample adjoint; k_near from zdr_path_loop_grad_plan; far:
// (max(max_depth - k_near, 0), kRowPlanes, n) float32, the deeper rows
// (kRowPlanes + 1 planes where the params' merge passes 1);
// grad: (tex_h * tex_w, 4) float32, 16-byte aligned, zeroed by the caller,
// to which the kernel adds. The carry in must be the first carry (no
// sample in flight). Returns the CUDA error of the launch (0 when it was
// accepted).
int zdr_path_loop_grad(const int* params, const float* tables, int tables_n,
                       const float* bn, const float* material, const int* lanes,
                       const float* le_grad, const float* f_in, const int* i_in,
                       float* f_out, int* i_out, float* far, float* grad, int n,
                       int n_steps, int k_near, void* stream) {
  return grad_dense(params, tables, tables_n, bn, material, lanes, le_grad, f_in, i_in, f_out,
                    i_out, far, grad, n, n_steps, k_near, zdr::EnvTables{}, false, stream);
}

// zdr_path_loop_grad through the BVH, with the BVH arguments and counts of
// zdr_path_loop_bvh (path_loop.cu); small_shared 1 copies the small tables
// into shared memory, 0 reads them from `tables`.
int zdr_path_loop_grad_bvh(const int* params, const float* tables, int tables_n,
                           int small_shared, const float* bn, const float* material,
                           const int* lanes, const float* le_grad, const float* f_in,
                           const int* i_in, float* f_out, int* i_out, float* far,
                           float* grad, int n, int n_steps, int k_near, const float* nodes,
                           const float* geom, int n_nodes, int n_rows,
                           unsigned long long* counts, void* stream) {
  return grad_bvh(params, tables, tables_n, small_shared, bn, material, lanes, le_grad, f_in,
                  i_in, f_out, i_out, far, grad, n, n_steps, k_near, nodes, geom, n_nodes,
                  n_rows, counts, zdr::EnvTables{}, false, stream);
}

// zdr_path_loop_grad under an environment light: the params' n_env is 1,
// and the env's tables as zdr_path_loop_env's (path_loop.cu); k_near from
// zdr_path_loop_grad_plan of the same params.
int zdr_path_loop_grad_env(const int* params, const float* tables, int tables_n,
                           const float* bn, const float* material, const int* lanes,
                           const float* le_grad, const float* f_in, const int* i_in,
                           float* f_out, int* i_out, float* far, float* grad, int n,
                           int n_steps, int k_near, const float* env_tex, int env_h,
                           int env_w, const float* env_prob, const int* env_alias,
                           const float* env_pdf, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return grad_dense(params, tables, tables_n, bn, material, lanes, le_grad, f_in, i_in, f_out,
                    i_out, far, grad, n, n_steps, k_near,
                    zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf),
                    true, stream);
}

// zdr_path_loop_grad_bvh under an environment light, as
// zdr_path_loop_grad_env; k_near from zdr_path_loop_grad_plan of the same params.
int zdr_path_loop_grad_env_bvh(const int* params, const float* tables, int tables_n,
                               int small_shared, const float* bn, const float* material,
                               const int* lanes, const float* le_grad, const float* f_in,
                               const int* i_in, float* f_out, int* i_out, float* far,
                               float* grad, int n, int n_steps, int k_near,
                               const float* nodes, const float* geom, int n_nodes, int n_rows,
                               unsigned long long* counts, const float* env_tex, int env_h,
                               int env_w, const float* env_prob, const int* env_alias,
                               const float* env_pdf, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return grad_bvh(params, tables, tables_n, small_shared, bn, material, lanes, le_grad, f_in,
                  i_in, f_out, i_out, far, grad, n, n_steps, k_near, nodes, geom, n_nodes,
                  n_rows, counts,
                  zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf),
                  true, stream);
}

}  // extern "C"
