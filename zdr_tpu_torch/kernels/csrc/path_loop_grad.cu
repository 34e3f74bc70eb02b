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
// (path_loop_step.cuh, loop_step<true>): each bounce writes its 14 tap
// values into the lane's scratch row of its depth (max_depth rows per lane,
// about 235 MB at 512^2), and when the sample ends with a radiance that is
// not NaN, the thread walks those rows from last to first, keeps G' in
// registers, and adds each tap's 4 channels into the (H*W, 4) gradient with
// float atomics. The sample stream is keyed by the sample index, so the taps
// are the JAX backward's at splat_merge=1, and their sum is its gradient.
//
// What bounds it on an H100: the forward's latency- and divergence-bound
// walk (path_loop.cu), plus about 4 atomics per tap: some 262144 * 64 * 3.5
// = 59 M taps at the flagship 512^2 / 64 spp, into a 16 MB gradient that
// stays in the 50 MB L2, and 14 scratch stores per bounce. The atomics sum
// in an order that changes from run to run, so the gradient's last bits do
// too. This first kernel is simple and right; occupancy, lane sorting and
// the atomic pattern are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "path_loop_step.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    path_loop_grad_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                          const float* __restrict__ bn, const float* __restrict__ material,
                          const int* __restrict__ lanes, const float* __restrict__ le_grad,
                          const float* __restrict__ f_in, const int* __restrict__ i_in,
                          float* __restrict__ f_out, int* __restrict__ i_out,
                          float* __restrict__ scratch, float* grad, int n, int n_steps) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < tables_n; k += blockDim.x) smem[k] = tables[k];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::Tables tb = zdr::tables_at(smem, bn, material, q);
  zdr::LaneConst lc = zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane],
                                      q.seed, q);
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

}  // namespace

extern "C" {

// As zdr_path_loop (path_loop.cu), plus le_grad: (3, n) float32, each
// lane's per-sample adjoint; scratch: (max(max_depth, 1), kTapPlanes, n)
// float32; grad: (tex_h * tex_w, 4) float32, zeroed by the caller, to which
// the kernel adds. The carry in must be the first carry (no sample in
// flight). Returns the CUDA error of the launch (0 when it was accepted).
int zdr_path_loop_grad(const int* params, const float* tables, int tables_n,
                       const float* bn, const float* material, const int* lanes,
                       const float* le_grad, const float* f_in, const int* i_in,
                       float* f_out, int* i_out, float* scratch, float* grad, int n,
                       int n_steps, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)tables_n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      path_loop_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + kBlock - 1) / kBlock;
  path_loop_grad_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, tables_n, bn, material, lanes, le_grad, f_in, i_in, f_out, i_out, scratch,
      grad, n, n_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
