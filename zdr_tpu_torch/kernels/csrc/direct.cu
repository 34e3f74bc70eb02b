// The direct integrator's kernels: its forward render, its texture gradient,
// and the closest-hit + interaction of a ray batch.
//
// Replace zdr_tpu/integrators/pallas_bounce.py::_trace_interact_kernel
// (:474) and ::_shade_kernel (:917, split mode, forward and tap) as
// direct_fused.py chains them (:124-268), with the XLA glue between them:
//   direct        one thread per pixel lane, persistent over the lane's spp:
//                 each sample is the primary ray's closest hit, NEE + shadow
//                 + GGX shade + bounce sample, and the bounce ray's
//                 emitter, looked up emitter first or by its closest hit
//                 (direct_step.cuh), accumulated in registers.
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
// What bounds them on an H100, measured (studies/direct_split.py, builds
// that each differ in one thing; PERF.md): the issue of their FP32 work.
// Shared memory holds only what the sweeps read, 9 floats a triangle in
// rows of 12 (46 KB for 962 triangles), which the compiler reads with two
// 16-byte LDS and one LDS a test, plus the light and camera rows; the hit
// triangle's 22 attributes come from the full table in global memory (1-2%
// of the time). On the reference's protocol (962 triangles) the three
// sweeps were ~89% of `direct`, one test ~130 issue slots a warp; on the
// cornell box (12) ~35%, beside the sampler's ~12%. Each sweep is
// direct_step.cuh's CompactSweep (4-6% faster on the cornell box than
// DenseSweep<kGeomCols> over the same rows, which spilled more). On a
// scene that accel="auto" sends to the BVH (kernels.direct_early: from
// accel/build.DENSE_MAX_TRIS["direct"] triangles on), which reaches the
// dense kernels only where the caller forces the dense route, a lane
// leaves a test once its bounds show a miss, and a warp skips the rest of
// the test where all its lanes do (the early out: the protocol's kernels
// ~20% faster; at 12-26 triangles its bounds cost up to 7% more than they
// skip). The hits, the tie rule and the test counts are DenseSweep's. The
// kernels are held to 64 registers (80, 128 and 48 measured slower on one
// scene or both); the launch picks the block (launch.cuh): 512 threads at
// 512x512 (7% faster than 256 on the cornell box; 2% slower on the
// protocol, whose blocks take 43-225 ms, so that SMs idle 10-13% of the
// span, but a 256-thread cap halved the resident threads of a table past
// 114 KB). Their atomics cost 0-3%. Lane sorting is later work.
//
// The bounce ray looks up its emitter first where the launch's params say
// emit_first (kernels: at most 32 light triangles), as JAX's merged
// _shade_kernel (pallas_bounce.py:1134-1237) and streamed route
// (direct_fused.py:203-236) do: a closest hit over the light rows, then one
// any-hit of the scene (CompactSweep / BvhTrace bounce_any) capped at it, or
// none where no light is hit and there is no env (direct_step.cuh
// bounce_emit); the light triangles' scene-row ids follow the packed tables.
// Otherwise its closest hit over the scene, the lite B3.
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
// at once (studies/walk_split.py; PERF.md), and so do their env
// instantiations: 80, 96 and 128 registers and blocks of 128 measured
// slower, or no faster on apps/example.py's scene and the big mesh under
// the env at once (studies/env_split.py). Under the env a lane walks its
// NEE shadow ray only where the light sample lies above its hemisphere
// (most of a lone object's env samples do not); in tap mode it reads the
// env sample's pdf and texels after the walk, where NEE counts
// (direct_step.cuh direct_sample).
//
// Each kernel has kGen instantiations for the generic sampler (corrmj;
// pmj02bn at a spp that is no power of two: zdr::gen_sampler), as
// path_loop.cu's; the others compile to the code they had before them.
//
// packed_splat (the params' packed) runs the gradient kernels' kPacked
// instantiations, the JAX package's packed flush (direct_fused.py:319-345):
// each tap's channels are rounded to bf16 before its atomic, and a launch
// runs one group of kSplatBatch samples (from the params' first, the
// kernels' last argument) into a
// zeroed scratch gradient, adding to each lane's radiance sums from the
// launch before; the caller rounds the scratch's texels to bf16 into the
// gradient after each launch (splat.cu). splat_merge is not read, as in JAX.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see zdr_tpu_torch/kernels/__init__.py).
#include <cuda_runtime.h>

#include "direct_step.cuh"
#include "launch.cuh"

namespace {

constexpr int kBlock = 256;
// the dense kernels' largest block: the launch picks theirs (launch), at 64
// registers (__launch_bounds__(kMaxBlock, 2))
constexpr int kMaxBlock = 512;

__global__ void __launch_bounds__(kBlock)
    trace_interact_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                          const float* __restrict__ rays, const int* __restrict__ active,
                          float* __restrict__ f_out, int* __restrict__ i_out, int n, int lite) {
  extern __shared__ float smem[];
  zdr::load_compact(smem, tables, q, q.n_tris * zdr::kGeomCols);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  zdr::Tables tb = zdr::compact_tables(smem, tables, nullptr, nullptr, q);
  zdr::trace_interact_lane(tb, q, rays, active, f_out, i_out, lane, n, lite != 0);
}

template <bool kGrad, bool kEarly, bool kEnv, bool kGen, bool kPacked>
__global__ void __launch_bounds__(kMaxBlock, 2)
    direct_kernel(zdr::LoopParams q, const float* __restrict__ tables, int tables_n,
                  const float* __restrict__ bn, const float* __restrict__ material,
                  const int* __restrict__ lanes, const float* __restrict__ le_grad,
                  float* __restrict__ acc_out, float* grad, unsigned long long* counts,
                  int n, zdr::EnvTables env, int first, const float* __restrict__ light_rows) {
  extern __shared__ float smem[];
  zdr::load_compact(smem, tables, q, zdr::compact_size(q));
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::compact_tables(smem, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                              lanes[2L * n + lane], q.seed, q);
    zdr::DirectTaps dt;
    if (kGrad) {
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = grad;
    }
    zdr::V3 acc0 = {0.0f, 0.0f, 0.0f};
    if (kPacked) acc0 = {acc_out[lane], acc_out[n + lane], acc_out[2L * n + lane]};
    zdr::V3 acc = zdr::direct_lane<kGrad, kEnv, zdr::CompactSweep<kEarly>, kGen, kPacked>(
        tb, q, lc, &dt, count, zdr::CompactSweep<kEarly>(), &env, light_rows, acc0, first);
    acc_out[lane] = acc.x;
    acc_out[n + lane] = acc.y;
    acc_out[2L * n + lane] = acc.z;
  }
  zdr::warp_add(counts, count.tests);
}

// The same samples with every sweep through the BVH; shared memory holds
// the small tables only, where they fit (small_shared).
template <bool kGrad, bool kEnv, bool kGen, bool kPacked>
__global__ void __launch_bounds__(kBlock, 4)
    direct_bvh_kernel(zdr::LoopParams q, const float* __restrict__ tables, int small_shared,
                      const float* __restrict__ bn, const float* __restrict__ material,
                      const int* __restrict__ lanes, const float* __restrict__ le_grad,
                      float* __restrict__ acc_out, float* grad, zdr::Bvh bvh,
                      unsigned long long* counts, int n, zdr::EnvTables env, int first,
                      const float* __restrict__ light_rows) {
  extern __shared__ float smem[];
  const float* small = zdr::load_small(smem, tables, q, small_shared);
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  zdr::TraceCount count = {0, 0};
  if (lane < n) {
    zdr::Tables tb = zdr::bvh_tables(small, tables, bn, material, q);
    zdr::LaneConst lc = zdr::lane_const<kGen>(lanes[lane], lanes[n + lane],
                                              lanes[2L * n + lane], q.seed, q);
    zdr::DirectTaps dt;
    if (kGrad) {
      dt.lg[0] = le_grad[lane];
      dt.lg[1] = le_grad[n + lane];
      dt.lg[2] = le_grad[2L * n + lane];
      dt.grad = grad;
    }
    zdr::BvhTrace tr{bvh};
    zdr::V3 acc0 = {0.0f, 0.0f, 0.0f};
    if (kPacked) acc0 = {acc_out[lane], acc_out[n + lane], acc_out[2L * n + lane]};
    zdr::V3 acc = zdr::direct_lane<kGrad, kEnv, zdr::BvhTrace, kGen, kPacked>(
        tb, q, lc, &dt, count, tr, &env, light_rows, acc0, first);
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

// The dense direct kernel of the generic sampler (kGen) or not.
template <bool kGen>
const void* dense_fn(bool grad, bool early, bool with_env, bool packed) {
  if (grad && packed)
    return with_env ? (early ? (const void*)direct_kernel<true, true, true, kGen, true>
                             : (const void*)direct_kernel<true, false, true, kGen, true>)
                    : (early ? (const void*)direct_kernel<true, true, false, kGen, true>
                             : (const void*)direct_kernel<true, false, false, kGen, true>);
  if (with_env)
    return grad ? (early ? (const void*)direct_kernel<true, true, true, kGen, false>
                         : (const void*)direct_kernel<true, false, true, kGen, false>)
                : (early ? (const void*)direct_kernel<false, true, true, kGen, false>
                         : (const void*)direct_kernel<false, false, true, kGen, false>);
  return grad ? (early ? (const void*)direct_kernel<true, true, false, kGen, false>
                       : (const void*)direct_kernel<true, false, false, kGen, false>)
              : (early ? (const void*)direct_kernel<false, true, false, kGen, false>
                       : (const void*)direct_kernel<false, false, false, kGen, false>);
}

// One launch of the dense direct kernel, forward or tap mode (le_grad
// set), with or without the early out and the env.
int direct_dense(const int* params, const float* tables, int tables_n, const float* bn,
                 const float* material, const int* lanes, const float* le_grad, float* acc,
                 float* grad, unsigned long long* counts, int n, int early, zdr::EnvTables env,
                 bool with_env, int block, int* plan, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  const float* light_rows;
  if (!zdr::light_rows_of(params, q, tables, tables_n, light_rows))
    return (int)cudaErrorInvalidValue;
  int smem = zdr::compact_size(q) * (int)sizeof(float);
  zdr::SplatKnobs knobs = zdr::splat_knobs(params);
  void* args[] = {&q,   &tables, &tables_n, &bn, &material, &lanes,       &le_grad,
                  &acc, &grad,   &counts,   &n,  &env,      &knobs.first, &light_rows};
  bool taps = le_grad != nullptr, packed = knobs.packed != 0;
  const void* fn = zdr::gen_sampler(q) ? dense_fn<true>(taps, early, with_env, packed)
                                        : dense_fn<false>(taps, early, with_env, packed);
  return zdr::launch(fn, n, smem, block, plan, args, stream);
}

// The direct BVH kernel of the generic sampler (kGen) or not.
template <bool kGen>
auto bvh_fn(bool grad, bool with_env, bool packed) {
  if (grad && packed)
    return with_env ? direct_bvh_kernel<true, true, kGen, true>
                    : direct_bvh_kernel<true, false, kGen, true>;
  return grad ? (with_env ? direct_bvh_kernel<true, true, kGen, false>
                          : direct_bvh_kernel<true, false, kGen, false>)
              : (with_env ? direct_bvh_kernel<false, true, kGen, false>
                          : direct_bvh_kernel<false, false, kGen, false>);
}

// One launch of the direct BVH kernel, likewise.
int direct_bvh(const int* params, const float* tables, int tables_n, int small_shared,
               const float* bn, const float* material, const int* lanes, const float* le_grad,
               float* acc, float* grad, const float* nodes, const float* geom, int n_nodes,
               int n_rows, unsigned long long* counts, int n, zdr::EnvTables env,
               bool with_env, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  const float* light_rows;
  if (!zdr::light_rows_of(params, q, tables, tables_n, light_rows))
    return (int)cudaErrorInvalidValue;
  size_t smem = small_shared ? (size_t)zdr::small_size(q) * sizeof(float) : 0;
  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};
  int grid = (n + kBlock - 1) / kBlock;
  zdr::SplatKnobs knobs = zdr::splat_knobs(params);
  bool taps = le_grad != nullptr, packed = knobs.packed != 0;
  auto fn = zdr::gen_sampler(q) ? bvh_fn<true>(taps, with_env, packed)
                                 : bvh_fn<false>(taps, with_env, packed);
  int err = launch_config(fn, smem);
  if (err) return err;
  fn<<<grid, kBlock, smem, (cudaStream_t)stream>>>(q, tables, small_shared, bn, material, lanes,
                                                   le_grad, acc, grad, bvh, counts, n, env,
                                                   knobs.first, light_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// params: the 20 ints of zdr::LoopParams (only n_tris is read); tables: the
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

// As zdr_path_loop (path_loop.cu) for the tables, and where the params' int
// 23 (emit_first) is set, the light triangles' n_light_tris scene-row ids
// (int bits) after them, for the emitter-first bounce lookup (tables_n
// counts them); lanes: (3, n) int32 px,
// py, spp; le_grad: null for the forward, or (3, n) float32, each lane's
// per-sample adjoint, for the tap mode; acc: (3, n) float32, each lane's sum
// of clamped radiances; grad: (tex_h * tex_w, 4) float32, zeroed by the
// caller, to which the tap mode adds (null for the forward); counts: two
// uint64, to which the kernel adds its ray-triangle tests and its BVH node
// visits (none in the dense sweep); early: the sweeps with the early out
// (1) or without (0); block and plan: as launch.cuh's (block 0: the
// plan's pick; plan: 8 ints, written). Returns the CUDA error of the launch (0
// when it was accepted).
int zdr_direct(const int* params, const float* tables, int tables_n, const float* bn,
               const float* material, const int* lanes, const float* le_grad, float* acc,
               float* grad, unsigned long long* counts, int n, int early, int block,
               int* plan, void* stream) {
  return direct_dense(params, tables, tables_n, bn, material, lanes, le_grad, acc, grad, counts,
                      n, early, zdr::EnvTables{}, false, block, plan, stream);
}

// zdr_direct (block and plan aside) through the BVH:
// nodes (n_nodes, 16) float32, geom (n_rows, 12) float32 rows in leaf order,
// each with its global id in float 9 (trace.cuh Bvh); small_shared 1 copies
// the small tables into shared memory, 0 reads them from `tables`.
int zdr_direct_bvh(const int* params, const float* tables, int tables_n, int small_shared,
                   const float* bn,
                   const float* material, const int* lanes, const float* le_grad, float* acc,
                   float* grad, const float* nodes, const float* geom, int n_nodes,
                   int n_rows, unsigned long long* counts, int n,
                   void* stream) {
  return direct_bvh(params, tables, tables_n, small_shared, bn, material, lanes, le_grad, acc,
                    grad, nodes, geom, n_nodes, n_rows, counts, n, zdr::EnvTables{}, false,
                    stream);
}

// zdr_direct under an environment light: the params' n_env is 1, and
// env_tex (env_h, env_w, 4), env_prob, env_alias and env_pdf are the
// envmap's tables (zdr_tpu_torch/envmap.py EnvMap), read through the
// read-only path.
int zdr_direct_env(const int* params, const float* tables, int tables_n, const float* bn,
                   const float* material, const int* lanes, const float* le_grad, float* acc,
                   float* grad, unsigned long long* counts, int n, int early,
                   const float* env_tex, int env_h, int env_w, const float* env_prob,
                   const int* env_alias, const float* env_pdf, int block, int* plan,
                   void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return direct_dense(params, tables, tables_n, bn, material, lanes, le_grad, acc, grad, counts,
                      n, early,
                      zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf),
                      true,
                      block, plan, stream);
}

// zdr_direct_bvh under an environment light, as zdr_direct_env.
int zdr_direct_env_bvh(const int* params, const float* tables, int tables_n, int small_shared,
                       const float* bn, const float* material, const int* lanes,
                       const float* le_grad, float* acc, float* grad, const float* nodes,
                       const float* geom, int n_nodes, int n_rows, unsigned long long* counts,
                       int n, const float* env_tex, int env_h, int env_w, const float* env_prob,
                       const int* env_alias, const float* env_pdf, void* stream) {
  zdr::LoopParams q = zdr::params_from(params);
  if (q.n_env != 1 || !env_tex || env_h < 2 || env_w < 1) return (int)cudaErrorInvalidValue;
  return direct_bvh(params, tables, tables_n, small_shared, bn, material, lanes, le_grad, acc,
                    grad, nodes, geom, n_nodes, n_rows, counts, n,
                    zdr::env_tables(q, env_tex, env_h, env_w, env_prob, env_alias, env_pdf),
                    true,
                    stream);
}

}  // extern "C"
