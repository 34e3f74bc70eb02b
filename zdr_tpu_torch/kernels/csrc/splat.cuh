// The bf16 rounding of the packed gradient splat, for the kernels and their
// host builds.
//
// The JAX package's packed_splat stores the scatter's totals (and, where it
// buffers its taps, each tap's four channels) as bf16 pairs packed into one
// float32 (zdr_tpu/texture.py:112-125 pack_bf16_pair, :135-228
// segment_scatter_add4(packed=, prepacked=)): a value keeps the bits of
// x.astype(bfloat16).astype(float32). round_bf16 computes those bits with
// integer arithmetic, so that a CUDA build and a g++ build round alike: add
// 0x7FFF and the lowest bit that stays (ties to even), then drop the low 16
// bits. Denormals keep their bits (no flush to zero), finite values past
// bf16's largest round to inf, and a NaN stays a NaN. Its plain version is
// zdr_tpu_torch/texture.py round_bf16.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#include <vector>
#endif

#ifdef __CUDACC__
#define ZDR_SPLAT_HD __host__ __device__ __forceinline__
#else
#define ZDR_SPLAT_HD inline
#endif

namespace zdr {

// the rows of the JAX package's splat buffer (path_persistent.py:30
// SCATTER_BATCH): the direct and collocated backwards flush every 4 samples
constexpr int kSplatBatch = 4;

// The splat knobs, the last 3 of the 23 integer parameters
// (kernels.pack_params): splat_merge, the taps a path lane merges into one
// (the path gradient kernels' kMerge instantiations where it passes 1);
// packed_splat (0 or 1), the bf16 rounding (the direct and collocated
// gradient kernels' kPacked instantiations); first, the first sample of a
// kPacked launch, which runs samples first .. first + kSplatBatch - 1. The
// launches read them and hand the kernels what they use as arguments of
// their own: zdr::LoopParams, which every kernel takes, keeps its layout.
struct SplatKnobs {
  int merge, packed, first;
};

inline SplatKnobs splat_knobs(const int* params) {
  return SplatKnobs{params[20], params[21], params[22]};
}

ZDR_SPLAT_HD float round_bf16(float x) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(x);
#else
  memcpy(&u, &x, sizeof u);
#endif
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return x;  // NaN
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float r;
  memcpy(&r, &u, sizeof r);
  return r;
#endif
}

#ifndef __CUDACC__
// The host builds' packed gradient, as the card's launches make it: for
// each group of kSplatBatch samples from 0 below n_samples, run(first,
// scratch) adds the group's taps into a zeroed scratch of n floats, then
// grad += bf16(scratch) (splat.cu's round-add).
template <class Run>
inline void host_packed_groups(int n_samples, float* grad, long n, Run&& run) {
  std::vector<float> scratch(n);
  for (int first = 0; first < n_samples; first += kSplatBatch) {
    for (long k = 0; k < n; ++k) scratch[k] = 0.0f;
    run(first, scratch.data());
    for (long k = 0; k < n; ++k) grad[k] = grad[k] + round_bf16(scratch[k]);
  }
}
#endif

}  // namespace zdr
