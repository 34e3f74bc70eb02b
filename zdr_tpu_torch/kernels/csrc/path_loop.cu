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
// is left: a wavefront split of the sampler, sweeps and shading into passes
// is the next redesign's.
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

#include "trace.cuh"

namespace {

// Each kernel is capped at 64 registers, 32 warps an SM, by its largest
// block and the blocks an SM that block needs; it launches at any power of
// two from 32 up to that block (the code reads blockDim).
__global__ void __launch_bounds__(512, 2)
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

__global__ void __launch_bounds__(256, 4)
    path_loop_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables,
                         int small_shared, const float* __restrict__ bn,
                         const float* __restrict__ material,
                         const int* __restrict__ lanes, const float* __restrict__ f_in,
                         const int* __restrict__ i_in, float* __restrict__ f_out,
                         int* __restrict__ i_out, int n, int n_steps, zdr::Bvh bvh,
                         unsigned long long* counts) {
  extern __shared__ float smem[];
  const float* small = zdr::load_small(smem, tables, q, small_shared);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
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

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may hold

// Plan and launch fn over n lanes with smem bytes of dynamic shared memory.
// block: threads a block, a power of two from 32 up to fn's largest (its
// __launch_bounds__), or 0 to pick one of them: those of the fewest rounds,
// ceil(blocks / (resident blocks an SM x SMs)); in one round, those of the
// fewest lanes on the busiest SM, ceil(blocks / SMs) x block, so a small
// render spreads over the SMs; and of them the largest block (a block's
// neighbouring pixels share texels in L1). plan (8 ints): the block,
// fn's largest block, registers a thread, local memory a thread (bytes),
// resident blocks an SM, SMs, blocks, rounds. -> the CUDA error
// (cudaErrorInvalidValue for another block, or tables past a block).
int launch(const void* fn, int n, int smem, int block, int* plan, void** args, void* stream) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  plan[0] = 0;
  long best_busiest = 0;
  for (int b = 32; b <= attr.maxThreadsPerBlock; b *= 2) {
    if (block && b != block) continue;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, b, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) continue;
    int blocks = (n + b - 1) / b;
    int rounds = (blocks + occ * sms - 1) / (occ * sms);
    long busiest = rounds == 1 ? (long)((blocks + sms - 1) / sms) * b : 0;
    if (plan[0] && (rounds > plan[7] || (rounds == plan[7] && busiest > best_busiest))) continue;
    best_busiest = busiest;
    const int row[8] = {b, attr.maxThreadsPerBlock, attr.numRegs, (int)attr.localSizeBytes,
                        occ, sms, blocks, rounds};
    for (int j = 0; j < 8; ++j) plan[j] = row[j];
  }
  if (!plan[0]) return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernel(fn, dim3(plan[6]), dim3(plan[0]), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// params: the 17 ints of zdr::LoopParams (host memory); tables: tables_size floats;
// lanes: (3, n) int32 px, py, stop; carry: (kNumF, n) float32 and
// (kNumI, n) int32, read from *_in and written to *_out; block and plan: as
// launch's (block 0: the plan's pick; plan: 8 ints, written). Returns the
// CUDA error of the launch (0 when it was accepted).
int zdr_path_loop(const int* params, const float* tables, int tables_n, const float* bn,
                  const float* material, const int* lanes, const float* f_in,
                  const int* i_in, float* f_out, int* i_out, int n, int n_steps, int block,
                  int* plan, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  void* args[] = {&q,     &tables, &tables_n, &bn,  &material, &lanes, &f_in,
                  &i_in,  &f_out,  &i_out,    &n,   &n_steps};
  return launch((const void*)path_loop_kernel, n, tables_n * (int)sizeof(float), block, plan,
                args, stream);
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
  zdr::LoopParams q = zdr::params_from(params);
  if (tables_n != zdr::tables_size(q)) return (int)cudaErrorInvalidValue;
  int smem = small_shared ? zdr::small_size(q) * (int)sizeof(float) : 0;
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  void* args[] = {&q,    &tables, &small_shared, &bn,      &material, &lanes, &f_in,
                  &i_in, &f_out,  &i_out,        &n,       &n_steps,  &bvh,   &counts};
  return launch((const void*)path_loop_bvh_kernel, n, smem, block, plan, args, stream);
}

// lanes: (4, n) int32 px, py, seed, sample_idx; out: (3k, n) float32, for
// each j the draws next1, then next2's x and y.
int zdr_sampler_probe(const int* params, const float* bn, const int* lanes, int n, int k,
                      float* out, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  sampler_probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(q, bn, lanes, n, k,
                                                                           out);
  return (int)cudaGetLastError();
}

}  // extern "C"
