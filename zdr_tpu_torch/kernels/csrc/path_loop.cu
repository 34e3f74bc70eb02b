// The path-loop kernel: the whole forward render of the path integrator.
//
// Replaces zdr_tpu/integrators/pallas_loop.py::_loop_kernel (forward mode)
// together with the XLA bilinear fetch (pallas_bounce.read_quads_planes) and
// the while_loop around them (render_path_loop). The TPU kernel ran once per
// bounce over (rows, 512) planes; here one thread owns one pixel lane and
// stays resident for the whole render, stepping its lane until its samples
// are done (persistent over the window).
//
// What bounds it on an H100: latency and divergence, not bytes or FLOPs.
// Each step is a branchy, integer-heavy walk (the sampler is ~100 uint32 ops
// per draw, 7 draws a step), a brute-force sweep over a tiny scene held in
// shared memory, and four texel loads at random uvs from one 16 MB material
// (1024^2 x float4), served mostly from L2. Lanes of a warp finish their
// paths at different depths and idle until the warp's last lane is done.
// This first kernel is simple and right; occupancy, divergence and lane
// sorting are left to later work.
//
// path_loop_bvh_kernel is the same walk with its two sweeps a step through
// the escape-link BVH in global memory (trace.cuh): the big-mesh route that
// the JAX package took through path_fused.py's streamed sweeps, B5 in
// _bounce (:132-135) and B6 in _stream_occ (:161-172). Only the light,
// point and camera rows stay in shared memory; the kernel counts its tests
// and node visits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    path_loop_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                     const float* __restrict__ bn, const float* __restrict__ material,
                     const int* __restrict__ lanes, const float* __restrict__ f_in,
                     const int* __restrict__ i_in, float* __restrict__ f_out,
                     int* __restrict__ i_out, int n, int n_steps) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < tables_n; k += blockDim.x) smem[k] = tables[k];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::Tables tb = zdr::tables_at(smem, bn, material, q);
  zdr::LaneConst lc = zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane],
                                      q.seed, q);
  zdr::LaneState s;
  zdr::load_lane(s, f_in, i_in, lane, n);
  zdr::run_lane(s, lc, tb, q, n_steps);
  zdr::store_lane(s, f_out, i_out, lane, n);
}

__global__ void __launch_bounds__(kBlock)
    path_loop_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables,
                         const float* __restrict__ bn, const float* __restrict__ material,
                         const int* __restrict__ lanes, const float* __restrict__ f_in,
                         const int* __restrict__ i_in, float* __restrict__ f_out,
                         int* __restrict__ i_out, int n, int n_steps, zdr::Bvh bvh,
                         unsigned long long* counts) {
  extern __shared__ float smem[];
  const float* small = tables + (long)q.n_tris * zdr::kSceneCols;
  for (int k = threadIdx.x; k < zdr::small_size(q); k += blockDim.x) smem[k] = small[k];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::bvh_tables(smem, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const(lanes[lane], lanes[n + lane], lanes[2L * n + lane],
                                        q.seed, q);
    zdr::LaneState s;
    zdr::load_lane(s, f_in, i_in, lane, n);
    zdr::run_lane(s, lc, tb, q, n_steps, nullptr, zdr::BvhTrace{bvh}, &count);
    zdr::store_lane(s, f_out, i_out, lane, n);
  }
  zdr::warp_add(counts, count.tests);
  zdr::warp_add(counts + 1, count.visits);
}

__global__ void sampler_probe_kernel(zdr::LoopParams q, const float* __restrict__ bn,
                                     const int* __restrict__ lanes, int n, int k,
                                     float* __restrict__ out) {
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::sampler_probe_lane(q, bn, lanes[lane], lanes[n + lane], (uint32_t)lanes[2L * n + lane],
                          (uint32_t)lanes[3L * n + lane], k, out, lane, n);
}

}  // namespace

extern "C" {

// params: the 17 ints of zdr::LoopParams (host memory); tables: tables_size floats;
// lanes: (3, n) int32 px, py, stop; carry: (kNumF, n) float32 and
// (kNumI, n) int32, read from *_in and written to *_out. Returns the CUDA
// error of the launch (0 when it was accepted).
int zdr_path_loop(const int* params, const float* tables, int tables_n, const float* bn,
                  const float* material, const int* lanes, const float* f_in,
                  const int* i_in, float* f_out, int* i_out, int n, int n_steps,
                  void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)tables_n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      path_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + kBlock - 1) / kBlock;
  path_loop_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, tables_n, bn, material, lanes, f_in, i_in, f_out, i_out, n, n_steps);
  return (int)cudaGetLastError();
}

// zdr_path_loop through the BVH: box (n_nodes, 6) float32, link (n_nodes, 2)
// int32, geom (slots, 12) float32 rows in leaf order, perm (slots,) int32
// global ids (-1 pads); counts: two uint64, to which the kernel adds its
// ray-triangle tests and node visits.
int zdr_path_loop_bvh(const int* params, const float* tables, int tables_n, const float* bn,
                      const float* material, const int* lanes, const float* f_in,
                      const int* i_in, float* f_out, int* i_out, int n, int n_steps,
                      const float* box, const int* link, const float* geom, const int* perm,
                      int n_nodes, unsigned long long* counts, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)zdr::small_size(q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      path_loop_bvh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + kBlock - 1) / kBlock;
  path_loop_bvh_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      q, tables, bn, material, lanes, f_in, i_in, f_out, i_out, n, n_steps,
      zdr::Bvh{box, link, geom, perm, n_nodes}, counts);
  return (int)cudaGetLastError();
}

// lanes: (4, n) int32 px, py, seed, sample_idx; out: (3k, n) float32, for
// each j the draws next1, then next2's x and y.
int zdr_sampler_probe(const int* params, const float* bn, const int* lanes, int n, int k,
                      float* out, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  int grid = (n + kBlock - 1) / kBlock;
  sampler_probe_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(q, bn, lanes, n, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
