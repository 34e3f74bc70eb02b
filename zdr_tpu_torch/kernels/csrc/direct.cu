// The direct integrator's kernels: its forward render, its texture gradient,
// and the closest-hit + interaction of a ray batch.
//
// Replace zdr_tpu/integrators/pallas_bounce.py::_trace_interact_kernel
// (:474) and ::_shade_kernel (:917, split mode, forward and tap) as
// direct_fused.py chains them (:124-268), with the XLA glue between them:
//   direct        one thread per pixel lane, persistent over the lane's spp:
//                 each sample is the primary ray's closest hit, NEE + shadow
//                 + GGX shade + bounce sample, and the bounce ray's closest
//                 hit (direct_step.cuh), accumulated in registers.
//   direct_grad   the same samples (the caller passes seed + 1) in tap mode:
//                 each sample's four gradient channels go with one 16-byte
//                 float4 atomic (sm_90) into the (H*W, 4) gradient at its
//                 stochastic corner, as path_loop_grad's taps do. The
//                 TPU gathered them in a splat buffer and flushed it
//                 (direct_fused.py:300-345); direct has one tap a sample, so
//                 it is added where it is made.
//   trace_interact   B3 alone over a ray batch, full or lite, for checks.
// The TPU ran each kernel once a sample over (rows, 512) planes and kept
// the planes between them in HBM; here nothing of a sample leaves the thread.
//
// What bounds them on an H100: the brute-force sweeps, FP32 arithmetic from
// a scene table in shared memory, 3 sweeps a sample (the shadow sweep stops
// at its first hit, the bounce sweep runs only for a ray that goes on).
// At ~46 FP32 operations a ray-triangle test, a 962-triangle scene at 512^2
// and 256 spp is at most ~9e12 operations a render: ~0.13 s at 67 TFLOP/s.
// Every warp reads the same triangle at once (a shared-memory broadcast).
// Shared memory holds only what the sweeps read, 9 floats a triangle in rows
// of 12 (46 KB for 962 triangles; the full 31-float rows would take 119 KB
// and allow one 8-warp block an SM), plus the light and camera rows; the
// hit triangle's 22 attributes come from the full table in global memory,
// twice a sample. Registers then bound the resident warps: the direct
// kernels are held to 64 registers, 4 blocks (32 warps) an SM. Its time
// against the first version's (full rows in shared memory), on the protocol
// on an H100 80GB HBM3 at 700 W, is in PERF.md (chip_smoke.py, phase 11).
// This first kernel is simple and right; lane sorting and an emissive-first
// bounce lookup are later work.
//
// The BVH instantiations (direct_bvh_kernel<false> / <true>, both behind
// zdr_direct_bvh) run the same samples with every sweep an ordered walk of
// the BVH in global memory (trace.cuh: child-box nodes, near child first,
// a short stack), read through the read-only path: they replace the
// big-mesh chain of direct_fused.py, B5's closest
// sweep on the primary ray (:139-142) and B6's occlusion for the shadow
// (:197-200) and the bounce's emitter lookup. Shared memory keeps only the
// light, point and camera rows; the tree (50,880 triangles: 2.4 MB of rows,
// ~0.5 MB of nodes) lies in HBM and mostly in the 50 MB L2. What bounds them
// is the walk's dependent loads and its divergence, not FP32 work: the
// kernels count their node visits beside their tests. They stay at 64
// registers and 256 threads: 128, 80 and 48 registers, and blocks of 128
// and 512, measured slower, or no faster on the protocol and the big mesh
// at once (studies/walk_split.py; PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "direct_step.cuh"

namespace {

constexpr int kBlock = 256;

// The compact copy of the first n floats of the tables (compact_at).
__device__ void load_compact(float* smem, const float* __restrict__ tables,
                             const zdr::LoopParams& q, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) smem[k] = zdr::compact_at(tables, q, k);
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
    trace_interact_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                          const float* __restrict__ rays, const int* __restrict__ active,
                          float* __restrict__ f_out, int* __restrict__ i_out, int n, int lite) {
  extern __shared__ float smem[];
  load_compact(smem, tables, q, q.n_tris * zdr::kGeomCols);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::Tables tb = zdr::compact_tables(smem, tables, nullptr, nullptr, q);
  zdr::trace_interact_lane(tb, q, rays, active, f_out, i_out, lane, n, lite != 0);
}

template <bool kGrad>
__global__ void __launch_bounds__(kBlock, 4)
    direct_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                  const float* __restrict__ bn, const float* __restrict__ material,
                  const int* __restrict__ lanes, const float* __restrict__ le_grad,
                  float* __restrict__ acc_out, float* grad, unsigned long long* counts,
                  int n) {
  extern __shared__ float smem[];
  load_compact(smem, tables, q, zdr::compact_size(q));
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
    zdr::V3 acc = zdr::direct_lane<kGrad>(tb, q, lc, &dt, count);
    acc_out[lane] = acc.x;
    acc_out[n + lane] = acc.y;
    acc_out[2L * n + lane] = acc.z;
  }
  zdr::warp_add(counts, count.tests);
}

// The same samples with every sweep through the BVH; shared memory holds
// the small tables only, where they fit (small_shared).
template <bool kGrad>
__global__ void __launch_bounds__(kBlock, 4)
    direct_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables, int small_shared,
                      const float* __restrict__ bn, const float* __restrict__ material,
                      const int* __restrict__ lanes, const float* __restrict__ le_grad,
                      float* __restrict__ acc_out, float* grad, zdr::Bvh bvh,
                      unsigned long long* counts, int n) {
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
    zdr::V3 acc = zdr::direct_lane<kGrad>(tb, q, lc, &dt, count, tr);
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

// params: the 17 ints of zdr::LoopParams (only n_tris is read); tables: the
// (n_tris, 31) scene table; rays: (7, n) float32 o3 d3 pdf_prev; active:
// (n,) int32; f_out / i_out: (14, n) / (2, n), or (3, n) / (1, n) when lite.
// Returns the CUDA error of the launch (0 when it was accepted).
int zdr_trace_interact(const int* params, const float* tables, int tables_n,
                       const float* rays, const int* active, float* f_out, int* i_out, int n,
                       int lite, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != q.n_tris * zdr::kSceneCols) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)q.n_tris * zdr::kGeomCols * sizeof(float);
  int err = launch_config(trace_interact_kernel, smem);
  if (err) return err;
  int grid = (n + kBlock - 1) / kBlock;
  trace_interact_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, tables_n, rays, active, f_out, i_out, n, lite);
  return (int)cudaGetLastError();
}

// As zdr_path_loop (path_loop.cu) for the tables; lanes: (3, n) int32 px,
// py, spp; acc: (3, n) float32, each lane's sum of clamped radiances;
// counts: two uint64, to which the kernel adds its ray-triangle tests and
// its BVH node visits (none in the dense sweep).
int zdr_direct(const int* params, const float* tables, int tables_n, const float* bn,
               const float* material, const int* lanes, float* acc,
               unsigned long long* counts, int n, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)zdr::compact_size(q) * sizeof(float);
  int err = launch_config(direct_kernel<false>, smem);
  if (err) return err;
  int grid = (n + kBlock - 1) / kBlock;
  direct_kernel<false><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, tables_n, bn, material, lanes, nullptr, acc, nullptr, counts, n);
  return (int)cudaGetLastError();
}

// As zdr_direct, plus le_grad: (3, n) float32, each lane's per-sample
// adjoint; grad: (tex_h * tex_w, 4) float32, zeroed by the caller, to which
// the kernel adds.
int zdr_direct_grad(const int* params, const float* tables, int tables_n, const float* bn,
                    const float* material, const int* lanes, const float* le_grad,
                    float* acc, float* grad, unsigned long long* counts, int n,
                    void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)zdr::compact_size(q) * sizeof(float);
  int err = launch_config(direct_kernel<true>, smem);
  if (err) return err;
  int grid = (n + kBlock - 1) / kBlock;
  direct_kernel<true><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, tables_n, bn, material, lanes, le_grad, acc, grad, counts, n);
  return (int)cudaGetLastError();
}

// zdr_direct (le_grad and grad null) and zdr_direct_grad through the BVH:
// nodes (n_nodes, 16) float32, geom (n_rows, 12) float32 rows in leaf order,
// each with its global id in float 9 (trace.cuh Bvh); small_shared 1 copies
// the small tables into shared memory, 0 reads them from `tables`.
int zdr_direct_bvh(const int* params, const float* tables, int tables_n, int small_shared,
                   const float* bn,
                   const float* material, const int* lanes, const float* le_grad, float* acc,
                   float* grad, const float* nodes, const float* geom, int n_nodes,
                   int n_rows, unsigned long long* counts, int n,
                   void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = small_shared ? (size_t)zdr::small_size(q) * sizeof(float) : 0;
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  int grid = (n + kBlock - 1) / kBlock;
  int err;
  if (le_grad) {
    err = launch_config(direct_bvh_kernel<true>, smem);
    if (err) return err;
    direct_bvh_kernel<true><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
        q, tables, small_shared, bn, material, lanes, le_grad, acc, grad, bvh, counts, n);
  } else {
    err = launch_config(direct_bvh_kernel<false>, smem);
    if (err) return err;
    direct_bvh_kernel<false><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
        q, tables, small_shared, bn, material, lanes, nullptr, acc, nullptr, bvh, counts, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
