// The launch of a kernel whose block the launch picks, for the path-loop
// forward kernels (path_loop.cu) and the dense direct kernels (direct.cu):
// host code, compiled with each.
#pragma once

#include <cuda_runtime.h>

namespace zdr {

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
inline int launch(const void* fn, int n, int smem, int block, int* plan, void** args,
                  void* stream) {
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

}  // namespace zdr
