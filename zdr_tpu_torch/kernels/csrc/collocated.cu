// The collocated integrator's kernels: its forward render and its texture
// gradient.
//
// Replace zdr_tpu/integrators/pallas_bounce.py::_trace_interact_kernel
// (:474, B3) as collocated_fused.py runs it once a sample (:148-210), with
// the XLA glue after it (material fetch, GGX shade at wi = wo, 1/t^2), and,
// on the big-mesh route, pallas_stream.py::_stream_closest_kernel (:392),
// B3's streamed closest hit:
//   collocated        one thread per pixel lane, persistent over the lane's
//                     spp: each sample is the primary ray's closest hit and
//                     its shade (collocated_step.cuh), accumulated in
//                     registers.
//   collocated_grad   the same samples (the caller passes seed + 1) in tap
//                     mode: each sample's four gradient channels go with one
//                     16-byte float4 atomic into the (H*W, 4) gradient at its
//                     stochastic corner (collocated.py:55's
//                     stochastic_splat); the TPU gathered them in a splat
//                     buffer and flushed it.
// The TPU ran a kernel and XLA ops a sample over (rows, 512) planes with the
// planes between them in HBM; here nothing of a sample leaves the thread.
//
// What bounds them on an H100: a sample is one sweep and a few hundred FP32
// operations of shading, so the sweep's tests dominate on the dense route
// and the walk's dependent loads on the BVH route, as in the direct kernels,
// whose dense and BVH layouts these keep (PERF.md gives their times beside
// their bounds). The dense kernel sweeps the compact rows in shared memory
// without the early out (CompactSweep<false>: accel="auto" takes the dense
// route only below DENSE_MAX_TRIS, where the early out costs more than it
// skips), at 64 registers, the block picked at launch (launch.cuh); the BVH
// kernel walks trace.cuh's ordered BVH in global memory at 256 threads and
// 64 registers, the small tables in shared memory where they fit. A simple
// kernel that is right: tuning is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "collocated_step.cuh"
#include "launch.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBlock = 512;

template <bool kGrad>
__global__ void __launch_bounds__(kMaxBlock, 2)
    collocated_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                      const float* __restrict__ bn, const float* __restrict__ material,
                      const int* __restrict__ lanes, const float* __restrict__ le_grad,
                      float* __restrict__ acc_out, float* grad, unsigned long long* counts,
                      int n) {
  extern __shared__ float smem[];
  zdr::load_compact(smem, tables, q, zdr::compact_size(q));
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::compact_tables(smem, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane],
                                        q.seed, q);
    zdr::DirectTaps dt;
    if (kGrad) {
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = grad;
    }
    zdr::V3 acc = zdr::collocated_lane<kGrad>(tb, q, lc, &dt, count);
    acc_out[lane] = acc.x;
    acc_out[n + lane] = acc.y;
    acc_out[2L * n + lane] = acc.z;
  }
  zdr::warp_add(counts, count.tests);
}

template <bool kGrad>
__global__ void __launch_bounds__(kBlock, 4)
    collocated_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables,
                          int small_shared, const float* __restrict__ bn,
                          const float* __restrict__ material, const int* __restrict__ lanes,
                          const float* __restrict__ le_grad, float* __restrict__ acc_out,
                          float* grad, zdr::Bvh bvh, unsigned long long* counts, int n) {
  extern __shared__ float smem[];
  const float* small = zdr::load_small(smem, tables, q, small_shared);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane],
                                        q.seed, q);
    zdr::DirectTaps dt;
    if (kGrad) {
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = grad;
    }
    zdr::BvhTrace tr{bvh};
    zdr::V3 acc = zdr::collocated_lane<kGrad>(tb, q, lc, &dt, count, tr);
    acc_out[lane] = acc.x;
    acc_out[n + lane] = acc.y;
    acc_out[2L * n + lane] = acc.z;
  }
  zdr::warp_add(counts, count.tests);
  zdr::warp_add(counts + 1, count.visits);
}

template <typename K>
int launch_config(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// As zdr_direct (direct.cu), without the early out: the dense kernel,
// forward (le_grad null) or tap mode; block and plan as launch.cuh's.
// Returns the CUDA error of the launch (0 when it was accepted).
int zdr_collocated(const int* params, const float* tables, int tables_n, const float* bn,
                   const float* material, const int* lanes, const float* le_grad, float* acc,
                   float* grad, unsigned long long* counts, int n, int block, int* plan,
                   void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  int smem = zdr::compact_size(q) * (int)sizeof(float);
  void* args[] = {&q,       &tables, &tables_n, &bn,     &material, &lanes,
                  &le_grad, &acc,    &grad,     &counts, &n};
  const void* fn = le_grad ? (const void*)collocated_kernel<true>
                           : (const void*)collocated_kernel<false>;
  return zdr::launch(fn, n, smem, block, plan, args, stream);
}

// As zdr_direct_bvh (direct.cu): the BVH kernel, forward or tap mode.
int zdr_collocated_bvh(const int* params, const float* tables, int tables_n, int small_shared,
                       const float* bn, const float* material, const int* lanes,
                       const float* le_grad, float* acc, float* grad, const float* nodes,
                       const float* geom, int n_nodes, int n_rows, unsigned long long* counts,
                       int n, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = small_shared ? (size_t)zdr::small_size(q) * sizeof(float) : 0;
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  int grid = (n + kBlock - 1) / kBlock;
  auto fn = le_grad ? collocated_bvh_kernel<true> : collocated_bvh_kernel<false>;
  int err = launch_config(fn, smem);
  if (err) return err;
  fn<<<grid, kBlock, smem, (cudaStream_t)stream>>>(q, tables, small_shared, bn, material, lanes,
                                                   le_grad, acc, grad, bvh, counts, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
