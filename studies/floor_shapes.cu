// Shapes of the floor probe's out = a + b (zdr_tpu_torch/kernels/csrc/
// sweep_variants.cu floor_kernel), for studies/floor_shapes.py: each a
// launch of its own, by index in the order of floor_shapes.py's SHAPES.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfloor_shapes.so floor_shapes.cu
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// the scalar tail: the last n % 4 floats, by the threads whose index is
// past the float4s (first) or by the last block's first threads (last)
template <bool kLastBlock>
__device__ __forceinline__ void tail(const float4* a, const float4* b, float4* out, int n,
                                     int i) {
  int n4 = n / 4;
  int t;
  if (kLastBlock) {
    if (blockIdx.x != gridDim.x - 1 || (int)threadIdx.x >= n - 4 * n4) return;
    t = 4 * n4 + threadIdx.x;
  } else {
    t = 4 * n4 + i;
    if (t >= n) return;
  }
  reinterpret_cast<float*>(out)[t] =
      reinterpret_cast<const float*>(a)[t] + reinterpret_cast<const float*>(b)[t];
}

// the parent's kernel: one float a thread
__global__ void scalar_kernel(const float* a, const float* b, float* out, int n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] + b[i];
}

// kItems float4s a thread, or (kStride) one at a time over a grid stride
template <int kItems, bool kStride>
__global__ void items_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                             float4* __restrict__ out, int n) {
  int n4 = n / 4;
  int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (kStride) {
    for (int i = first; i < n4; i += gridDim.x * blockDim.x) out[i] = add4(a[i], b[i]);
  } else {
    int base = first * kItems;
    float4 x[kItems], y[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n4) {
        x[k] = a[base + k];
        y[k] = b[base + k];
      }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n4) out[base + k] = add4(x[k], y[k]);
  }
  tail<false>(a, b, out, n, first);
}

// one float4 a thread: streaming loads (kLoadCs) and a streaming store
// (kStoreCs) or plain ones; the tail by the first threads or the last block
template <bool kLoadCs, bool kStoreCs, bool kLastBlock>
__global__ void one_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                           float4* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n / 4) {
    float4 x = kLoadCs ? __ldcs(a + i) : a[i];
    float4 y = kLoadCs ? __ldcs(b + i) : b[i];
    if (kStoreCs)
      __stcs(out + i, add4(x, y));
    else
      out[i] = add4(x, y);
  }
  tail<kLastBlock>(a, b, out, n, i);
}

int blocks(int items, int per_block) { return items > 0 ? (items + per_block - 1) / per_block : 1; }

}  // namespace

// Launch shape v (floor_shapes.py SHAPES) of out = a + b over n floats
// (16-byte aligned) on `stream`; sms: the card's SMs. -> the CUDA error.
extern "C" int floor_shape(int v, const float* a, const float* b, float* out, int n, int sms,
                           void* stream) {
  auto s = (cudaStream_t)stream;
  auto A = reinterpret_cast<const float4*>(a);
  auto B = reinterpret_cast<const float4*>(b);
  auto O = reinterpret_cast<float4*>(out);
  int n4 = n / 4;
  switch (v) {
    case 0: scalar_kernel<<<blocks(n, 128), 128, 0, s>>>(a, b, out, n); break;
    case 1: {
      int g = blocks(n4, 256);
      items_kernel<1, true><<<g < 4 * sms ? g : 4 * sms, 256, 0, s>>>(A, B, O, n);
      break;
    }
    case 2: items_kernel<1, true><<<sms, 256, 0, s>>>(A, B, O, n); break;
    case 3: items_kernel<1, false><<<blocks(n4, 128), 128, 0, s>>>(A, B, O, n); break;
    case 4: items_kernel<1, false><<<blocks(n4, 256), 256, 0, s>>>(A, B, O, n); break;
    case 5: items_kernel<1, false><<<blocks(n4, 512), 512, 0, s>>>(A, B, O, n); break;
    case 6: items_kernel<2, false><<<blocks(n4, 256), 128, 0, s>>>(A, B, O, n); break;
    case 7: items_kernel<2, false><<<blocks(n4, 512), 256, 0, s>>>(A, B, O, n); break;
    case 8: items_kernel<4, false><<<blocks(n4, 1024), 256, 0, s>>>(A, B, O, n); break;
    case 9: one_kernel<false, true, false><<<blocks(n4, 64), 64, 0, s>>>(A, B, O, n); break;
    case 10: one_kernel<false, true, false><<<blocks(n4, 128), 128, 0, s>>>(A, B, O, n); break;
    case 11: one_kernel<false, true, false><<<blocks(n4, 256), 256, 0, s>>>(A, B, O, n); break;
    case 12: one_kernel<false, true, true><<<blocks(n4, 256), 256, 0, s>>>(A, B, O, n); break;
    case 13: one_kernel<false, false, true><<<blocks(n4, 256), 256, 0, s>>>(A, B, O, n); break;
    case 14: one_kernel<true, true, false><<<blocks(n4, 64), 64, 0, s>>>(A, B, O, n); break;
    case 15: one_kernel<true, true, false><<<blocks(n4, 128), 128, 0, s>>>(A, B, O, n); break;
    case 16: one_kernel<true, true, false><<<blocks(n4, 256), 256, 0, s>>>(A, B, O, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
