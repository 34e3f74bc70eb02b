// The epilogue of the packed gradient splat: the bf16 rounding of a
// gradient's texels (splat.cuh round_bf16), in place, or of a scratch
// gradient added into the gradient.
//
// Replaces no Pallas kernel: the JAX package rounds the scatter's per-texel
// totals to bf16 in its XLA flush (zdr_tpu/texture.py:186-211
// segment_scatter_add4's packed .set-scatter). Here the taps are summed by
// the gradient kernels' float atomics, so the rounding of the totals is a
// pass of its own over the (H*W, 4) gradient:
//   in place   after path_loop_grad's launch: the loop route's one flush of
//              totals (pallas_loop.py:1254-1258, packed, not prepacked);
//   round-add  after each launch of a direct or collocated gradient kernel
//              over kSplatBatch samples into a scratch gradient: grad +=
//              bf16(scratch), scratch = 0 for the next launch, the flush of
//              each group of 4 samples (direct_fused.py:328-345).
// One thread a texel (float4), neighbouring threads on neighbouring texels:
// bound by the bytes, 16 MB read and 16 MB written in place at a 1024^2
// material, twice that for the round-add.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "splat.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(zdr::round_bf16(v.x), zdr::round_bf16(v.y), zdr::round_bf16(v.z),
                     zdr::round_bf16(v.w));
}

__global__ void __launch_bounds__(kBlock) round_kernel(float4* __restrict__ x, long n4) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) x[i] = round4(x[i]);
}

__global__ void __launch_bounds__(kBlock)
    round_add_kernel(float4* __restrict__ grad, float4* __restrict__ scratch, long n4) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = round4(scratch[i]);
  float4 g = grad[i];
  grad[i] = make_float4(g.x + s.x, g.y + s.y, g.z + s.z, g.w + s.w);
  scratch[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

extern "C" {

// grad: n float32 (n a multiple of 4, 16-byte aligned). scratch null: grad
// = bf16(grad) in place; else grad += bf16(scratch), and scratch (n float32,
// 16-byte aligned) is zeroed. Returns the CUDA error of the launch.
int zdr_splat_round(float* grad, float* scratch, long long n, void* stream) {
  if (n % 4 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  long n4 = (long)(n / 4);
  if (n4 == 0) return 0;
  unsigned grid = (unsigned)((n4 + kBlock - 1) / kBlock);
  if (scratch)
    round_add_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<float4*>(grad), reinterpret_cast<float4*>(scratch), n4);
  else
    round_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(reinterpret_cast<float4*>(grad),
                                                             n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
