// The sweep variants: the H100 counterparts of the TPU measurement kernels
// under tools/ (B9), which took apart the cost of kernel 1, the closest-hit
// sweep of B3/B4, on the reference protocol's 962-triangle scene:
//   tools/profile_wide.py::kernel (:89), tools/profile_chunk.py::chunk_kernel
//   (:96), profile_sweep_variants.py::trace_kernel_v (:156) and
//   profile_mxu_variants.py::fori_kernel (:101) / hybrid_kernel (:158)
//     -> sweep_variant: the dense FP32 Möller–Trumbore sweep with kTile rows a
//        shared-memory tile and R rays a thread (a tile row loaded once for R
//        rays, where the TPU amortised MXU issue over G or C ray rows), in
//        four modes: closest (t, u, v, prim: accel.cu's), any, and the sweep
//        followed by the full or the lite emitter epilogue of
//        trace_interact, the winner's attribute row read from global memory
//        after the sweep (the fori / hybrid / full / lite questions);
//   profile_mxu_variants.py::mxu_kernel (:212) and trace_kernel_v's Woop
//   sweep -> woop_sweep: the same sweep by the Woop test over precomputed
//        rows (accel/woop.py), the winner re-derived by Möller–Trumbore;
//   profile_mxu_variants.py::aabb_kernel (:358) -> aabb_sweep: a box a tile
//        of kTile triangles in scene order, a warp skipping a tile that no
//        ray of it hits (capped by its best t, or t_max for any hit), a block
//        skipping its load when no warp needs it; MT or Woop tests;
//   profile_chunk.py::run_nop (:161) -> floor_probe: out = a + b over the ray
//        arrays, the floor of the timing harness.
// The variants are one templated kernel, sweep_kernel<kTile, R, mode, Woop,
// cull>; only the grid points that chip_smoke.py phase 14 times are
// instantiated (kPoints). They share no code path with the production
// kernels' instantiations, which keep their registers.
//
// What bounds them on an H100: FP32 work, ~46 operations a Möller–Trumbore
// test and 40 a Woop test (comparisons not counted; built without
// contraction), 27 a box test; the rows stream through shared memory as broadcasts. The
// count of ray-triangle tests and box tests goes into two uint64 counters.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "sweep_variants.cuh"

namespace {

constexpr int kBlock = 256;

struct SweepArgs {
  const float* rows;   // (n_tris, 12): MT geometry rows or Woop rows
  const float* geom;   // (n_tris, 12) geometry rows: the Woop re-derive
  const float* table;  // (n_tris, 31) attribute rows: the epilogues
  const float* boxes;  // (ceil(n_tris / kTile), 6): the culls
  int n_tris;
  const float* rays;  // (8, n) o3 d3 pdf_prev t_max
  const int* active;  // (n,)
  float* f_out;
  int* i_out;
  unsigned long long* counts;  // ray-triangle tests, box tests
  int n;
};

template <int kTile, int R, int kMode, bool kWoop, bool kCull>
__global__ void __launch_bounds__(kBlock) sweep_kernel(SweepArgs a) {
  static_assert(!kCull || R == 1, "a cull is decided a warp of rays: one ray a thread");
  constexpr bool kAny = kMode == zdr::kModeAny;
  extern __shared__ float4 tile[];
  long first = (long)blockIdx.x * kBlock * R + threadIdx.x;
  zdr::SweepRay s[R];
#pragma unroll
  for (int k = 0; k < R; ++k) s[k] = zdr::sweep_ray(a.rays, first + (long)k * kBlock, a.n, kMode);
  const float4* src = reinterpret_cast<const float4*>(a.rows);
  for (int base = 0; base < a.n_tris; base += kTile) {
    if (kAny) {
      // any hit: the block stops once none of its rays is open (a barrier)
      bool closed = true;
#pragma unroll
      for (int k = 0; k < R; ++k) closed = closed && !s[k].open();
      if (__syncthreads_and(closed)) break;
    }
    bool need = true;
    if (kCull) {
      need = zdr::tile_need(s[0], a.boxes + 6 * (base / kTile));
      if (!__syncthreads_or(need)) continue;  // no warp of the block needs the tile
      need = __any_sync(0xffffffffu, need);
    }
    int count = min(kTile, a.n_tris - base);
    for (int k = threadIdx.x; k < count * zdr::kGeomCols / 4; k += kBlock)
      tile[k] = __ldg(src + (long)base * zdr::kGeomCols / 4 + k);
    __syncthreads();
    if (need) {
      const float* rows = reinterpret_cast<const float*>(tile);
      for (int j = 0; j < count; ++j) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          zdr::sweep_row<kWoop, kAny>(s[k], rows + j * zdr::kGeomCols, base + j);
      }
    }
    __syncthreads();
  }
  unsigned long long tests = 0, box_tests = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    zdr::sweep_finish<kWoop>(s[k], kMode, a.geom, a.table, a.rays, a.active, a.f_out, a.i_out,
                             first + (long)k * kBlock, a.n);
    tests += s[k].tests;
    box_tests += s[k].box_tests;
  }
  zdr::warp_add(a.counts, tests);
  zdr::warp_add(a.counts + 1, box_tests);
}

template <int kTile, int R, int kMode, bool kWoop, bool kCull>
int launch_point(const SweepArgs& a, cudaStream_t stream) {
  constexpr int kSmem = kTile * zdr::kGeomCols * 4;
  auto* kernel = sweep_kernel<kTile, R, kMode, kWoop, kCull>;
  static bool opted_in = false;  // dynamic shared memory past 48 KB needs it
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int grid = (a.n + kBlock * R - 1) / (kBlock * R);
  if (grid == 0) return 0;
  kernel<<<grid, kBlock, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct Point {
  int mode, tile, r;
  bool woop, cull;
  int (*launch)(const SweepArgs&, cudaStream_t);
};

#define ZDR_POINT(M, T, R, W, C) {M, T, R, W, C, launch_point<T, R, M, W, C>}
#define ZDR_GRID(M)                                                                   \
  ZDR_POINT(M, 128, 1, false, false), ZDR_POINT(M, 128, 2, false, false),             \
      ZDR_POINT(M, 128, 4, false, false), ZDR_POINT(M, 256, 1, false, false),         \
      ZDR_POINT(M, 256, 2, false, false), ZDR_POINT(M, 256, 4, false, false),         \
      ZDR_POINT(M, 512, 1, false, false), ZDR_POINT(M, 512, 2, false, false),         \
      ZDR_POINT(M, 512, 4, false, false), ZDR_POINT(M, 1024, 1, false, false),        \
      ZDR_POINT(M, 1024, 2, false, false), ZDR_POINT(M, 1024, 4, false, false)
#define ZDR_CULLS(M)                                                                  \
  ZDR_POINT(M, 128, 1, false, true), ZDR_POINT(M, 256, 1, false, true),               \
      ZDR_POINT(M, 512, 1, false, true), ZDR_POINT(M, 128, 1, true, true),            \
      ZDR_POINT(M, 256, 1, true, true), ZDR_POINT(M, 512, 1, true, true)

// The grid points phase 14 times (zdr_sweep_points lists them):
// sweep_variant's kTile x R for closest and any hit, and R 1
// and 2 at kTile 512 with the epilogues; woop_sweep at kTile 512 in every
// mode; aabb_sweep at kTile 128, 256, 512, MT and Woop.
const Point kPoints[] = {
    ZDR_GRID(zdr::kModeClosest),
    ZDR_GRID(zdr::kModeAny),
    ZDR_POINT(zdr::kModeInteract, 512, 1, false, false),
    ZDR_POINT(zdr::kModeInteract, 512, 2, false, false),
    ZDR_POINT(zdr::kModeLite, 512, 1, false, false),
    ZDR_POINT(zdr::kModeLite, 512, 2, false, false),
    ZDR_POINT(zdr::kModeClosest, 512, 1, true, false),
    ZDR_POINT(zdr::kModeAny, 512, 1, true, false),
    ZDR_POINT(zdr::kModeInteract, 512, 1, true, false),
    ZDR_POINT(zdr::kModeLite, 512, 1, true, false),
    ZDR_CULLS(zdr::kModeClosest),
    ZDR_CULLS(zdr::kModeAny),
};

__global__ void floor_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             float* __restrict__ out, int n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] + b[i];
}

}  // namespace

extern "C" {

// One sweep variant at grid point (mode 0 closest, 1 any, 2 interact, 3
// lite; kTile; R rays a thread; woop 0/1; cull 0/1). rows (n_tris, 12)
// float32, MT geometry rows or, with woop, Woop rows; geom (n_tris, 12)
// geometry rows (the Woop re-derive); table (n_tris, 31) (the epilogues);
// boxes (ceil(n_tris / kTile), 6) (the culls); rays (8, n) float32 o3 d3
// pdf_prev t_max; active (n,) int32. Out: closest f_out (3, n) t u v and
// i_out (1, n) prim; any i_out (1, n) occluded; interact (14, n) and (2, n),
// lite (3, n) and (1, n) as zdr_trace_interact's. counts: two uint64, to
// which the kernel adds its ray-triangle tests and box tests. Returns the
// CUDA error of the launch, cudaErrorInvalidValue for a point not built.
int zdr_sweep_variant(int mode, int tile, int r, int woop, int cull, const float* rows,
                      const float* geom, const float* table, const float* boxes, int n_tris,
                      const float* rays, const int* active, float* f_out, int* i_out,
                      unsigned long long* counts, int n, void* stream) {
  SweepArgs a{rows, geom, table, boxes, n_tris, rays, active, f_out, i_out, counts, n};
  for (const Point& p : kPoints)
    if (p.mode == mode && p.tile == tile && p.r == r && p.woop == (woop != 0) &&
        p.cull == (cull != 0))
      return p.launch(a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The grid points the library is built for: writes up to `cap` of them into
// out as (mode, kTile, R, woop, cull), five ints each -> their number.
int zdr_sweep_points(int* out, int cap) {
  int n = (int)(sizeof(kPoints) / sizeof(kPoints[0]));
  for (int k = 0; k < n && k < cap; ++k) {
    const Point& p = kPoints[k];
    int row[5] = {p.mode, p.tile, p.r, p.woop ? 1 : 0, p.cull ? 1 : 0};
    for (int j = 0; j < 5; ++j) out[5 * k + j] = row[j];
  }
  return n;
}

// out = a + b over n floats: the floor of the timing harness.
int zdr_floor_probe(const float* a, const float* b, float* out, int n, void* stream) {
  int grid = (n + kBlock - 1) / kBlock;
  if (grid == 0) return 0;
  floor_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
