// The standalone trace kernels: closest hit and any hit of a ray batch
// against a triangle set, the counterparts of the JAX accel API's trace
// (zdr_tpu/accel/trace.py::trace_closest / trace_any, :551-614).
//
// Two modes, by the Accel they are given:
//   dense   every ray against every triangle, in global order: replaces
//           zdr_tpu/accel/pallas_trace.py::_closest_kernel (:35) and
//           ::_any_kernel (:103), which kept the whole (T_pad, 16) table in
//           VMEM. Here a block of 256 rays stages tiles of kTile geometry
//           rows (24 KB) through shared memory, block-cooperatively with
//           16-byte loads, so any T fits; every warp then reads the same row
//           at once (a broadcast). The any-hit block stops once all its rays
//           are occluded.
//   bvh     one thread per ray walks the BVH in order (trace.cuh) in
//           global memory through the read-only path: replaces the
//           HBM-streamed sweeps zdr_tpu/integrators/pallas_stream.py::
//           _stream_closest_kernel (:392) and ::_stream_any_kernel (:507),
//           which the accel API reaches with method "stream" (trace.py:571,
//           :607), and the jnp walk of method "bvh".
// What bounds them on an H100: the dense mode is FP32 work, ~46 operations a
// ray-triangle test; the walk is dependent loads (a node, then its leaf's
// rows) and the divergence of rays that visit different nodes. Both count
// their ray-triangle tests and node visits into a two-element uint64 counter.
// Wider nodes and ray sorting are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 512;  // geometry rows a shared-memory tile holds

struct Rays {
  const float* o;  // (n, 3)
  const float* d;  // (n, 3)
  const float* t_min;
  const float* t_max;
  int n;
};

__device__ zdr::V3 ray_vec(const float* v, long i) {
  return zdr::v3(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
}

template <bool kClosest>
__global__ void __launch_bounds__(kBlock)
    dense_kernel(const float* __restrict__ geom, int n_tris, Rays r, float* __restrict__ t_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int* __restrict__ prim_out, int* __restrict__ occ_out,
                 unsigned long long* counts) {
  __shared__ float4 tile[kTile * zdr::kGeomCols / 4];
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < r.n;
  zdr::V3 o = zdr::v3(0.0f, 0.0f, 0.0f), d = o;
  float t_min = 0.0f, best_t = 0.0f, bu = 0.0f, bv = 0.0f;
  int prim = -1;
  bool done = !live;
  unsigned long long tests = 0;
  if (live) {
    o = ray_vec(r.o, i);
    d = ray_vec(r.d, i);
    t_min = r.t_min[i];
    best_t = r.t_max[i];
  }
  const float4* rows = reinterpret_cast<const float4*>(geom);
  for (int base = 0; base < n_tris; base += kTile) {
    // any hit: the block stops once every ray is occluded (a barrier too)
    if (!kClosest && __syncthreads_and(done)) break;
    int count = min(kTile, n_tris - base);
    for (int k = threadIdx.x; k < count * zdr::kGeomCols / 4; k += blockDim.x)
      tile[k] = __ldg(rows + (long)base * zdr::kGeomCols / 4 + k);
    __syncthreads();
    const float* t_rows = reinterpret_cast<const float*>(tile);
    if (kClosest && live) {
      zdr::dense_closest(t_rows, count, base, o, d, t_min, best_t, bu, bv, prim);
      tests += (unsigned long long)count;
    } else if (!kClosest && !done) {
      int k = zdr::dense_any(t_rows, count, o, d, t_min, best_t);
      done = k > 0;
      tests += (unsigned long long)(done ? k : -k);
    }
    __syncthreads();
  }
  if (live) {
    if (kClosest) {
      t_out[i] = best_t;
      u_out[i] = bu;
      v_out[i] = bv;
      prim_out[i] = prim;
    } else {
      occ_out[i] = done ? 1 : 0;
    }
  }
  zdr::warp_add(counts, tests);
}

template <bool kClosest>
__global__ void __launch_bounds__(kBlock)
    bvh_kernel(zdr::Bvh bvh, Rays r, float* __restrict__ t_out, float* __restrict__ u_out,
               float* __restrict__ v_out, int* __restrict__ prim_out,
               int* __restrict__ occ_out, unsigned long long* counts) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (i < r.n) {
    zdr::V3 o = ray_vec(r.o, i), d = ray_vec(r.d, i);
    if (kClosest) {
      float best_t = r.t_max[i], bu = 0.0f, bv = 0.0f;
      prim_out[i] = zdr::bvh_closest(bvh, o, d, r.t_min[i], best_t, bu, bv, &count);
      t_out[i] = best_t;
      u_out[i] = bu;
      v_out[i] = bv;
    } else {
      occ_out[i] = zdr::bvh_any(bvh, o, d, r.t_min[i], r.t_max[i], &count) ? 1 : 0;
    }
  }
  zdr::warp_add(counts, count.tests);
  zdr::warp_add(counts + 1, count.visits);
}

template <bool kClosest>
int launch(int bvh_mode, const float* geom, int n_rows, const float* nodes, int n_nodes,
           Rays r, float* t, float* u, float* v, int* prim, int* occ,
           unsigned long long* counts, void* stream) {
  int grid = (r.n + kBlock - 1) / kBlock;
  if (grid == 0) return 0;
  if (bvh_mode)
    bvh_kernel<kClosest><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        zdr::Bvh{nodes, geom, n_nodes, n_rows}, r, t, u, v, prim, occ, counts);
  else
    dense_kernel<kClosest><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        geom, n_rows, r, t, u, v, prim, occ, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bvh_mode 0: geom (n_rows, 12) float32 rows in global order; 1: the BVH
// (trace.cuh Bvh: nodes (n_nodes, 16), geom rows in leaf order, each with
// its global id in float 9). o, d: (n, 3) float32; t_min, t_max: (n,)
// float32. Out: t (t_max on a miss), u, v (0 on a miss) float32, prim int32
// (-1 on a miss); counts: two uint64, to which the kernel adds its
// ray-triangle tests and node visits. Returns the CUDA error of the launch.
int zdr_trace_closest(int bvh_mode, const float* geom, int n_rows, const float* nodes,
                      int n_nodes, const float* o, const float* d, const float* t_min,
                      const float* t_max, float* t, float* u, float* v, int* prim,
                      unsigned long long* counts, int n, void* stream) {
  return launch<true>(bvh_mode, geom, n_rows, nodes, n_nodes, Rays{o, d, t_min, t_max, n}, t,
                      u, v, prim, nullptr, counts, stream);
}

// As zdr_trace_closest; out: occ (n,) int32, 1 where a triangle is hit at t
// in (t_min, t_max).
int zdr_trace_any(int bvh_mode, const float* geom, int n_rows, const float* nodes,
                  int n_nodes, const float* o, const float* d, const float* t_min,
                  const float* t_max, int* occ, unsigned long long* counts, int n,
                  void* stream) {
  return launch<false>(bvh_mode, geom, n_rows, nodes, n_nodes, Rays{o, d, t_min, t_max, n},
                       nullptr, nullptr, nullptr, nullptr, occ, counts, stream);
}

}  // extern "C"
