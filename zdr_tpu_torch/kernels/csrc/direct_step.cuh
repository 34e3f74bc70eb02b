// One sample of the direct integrator for one lane: the per-lane code of the
// direct kernels (direct.cu), and the closest-hit + interaction of one ray.
//
// Replaces the chain that zdr_tpu/integrators/direct_fused.py::_one_sample
// (:124-268) runs for a scene under 256 triangles, in split mode:
//   pallas_bounce.py::_trace_interact_kernel (:474, with _interact_epilogue
//   :434) on the primary ray; the XLA glue's material fetch, NEE light
//   selection and BSDF draws (fused_glue.py:289-295, :469-479, want_rr
//   off); pallas_bounce.py::_shade_kernel (:917) for the NEE shadow test,
//   the MIS weights, the GGX shade and the bounce sample; the lite
//   _trace_interact_kernel on the bounce ray for its MIS-weighted emitter;
//   and, in tap mode, _shade_kernel's gradient taps (:1253-1336) with
//   le_rem = the sample's whole radiance.
// On the TPU those are three kernels a sample with their planes in HBM
// between them; here one thread keeps the whole sample in registers.
//
// The interaction, the light selection, the GGX and ONB helpers, the
// sampler and the roughness derivative are path_loop_step.cuh's own,
// included, not copies: the same formulas in the same operand order as the
// plain PyTorch version (integrators/bounce.py, integrators/direct.py). The
// sweeps are the compact sweep below (CompactSweep: DenseSweep's tests in
// that order, with an exact early out), or trace.cuh's BVH.
// Build it as that header says (no FMA contraction, no fast math).
#pragma once

#include "trace.cuh"

namespace zdr {

// float outputs of trace_interact: p3 uv2 ns3 ng3 add_emit3 (the ints:
// shade, miss); lite: add_emit3 (miss)
constexpr int kTraceF = 14;

// The direct kernels keep a compact copy of the tables in shared memory:
// each triangle's 9 geometry floats (p0, e1, e2) in a row of kGeomCols
// (trace.cuh), 16-byte aligned, then the light, light-instance, point and
// camera rows. A hit triangle's attributes are read from the full (T, 31)
// rows once per sweep, not swept. The BVH route keeps only the small tables
// there (trace.cuh bvh_tables).

ZDR_HD int compact_size(const LoopParams& q) {
  return tables_size(q) - q.n_tris * (kSceneCols - kGeomCols);
}

// Element k of the compact copy of the packed tables.
ZDR_HD float compact_at(const float* tables, const LoopParams& q, int k) {
  int geom = q.n_tris * kGeomCols;
  if (k < geom) {
    int col = k % kGeomCols;
    return col < 9 ? tables[(k / kGeomCols) * kSceneCols + col] : 0.0f;
  }
  return tables[q.n_tris * kSceneCols + (k - geom)];
}

// The tables over a compact copy, the attributes from the full tables.
ZDR_HD Tables compact_tables(const float* compact, const float* tables, const float* bn,
                             const float* material, const LoopParams& q) {
  Tables t;
  t.scene = compact;
  t.attrs = tables;
  t.lights = compact + q.n_tris * kGeomCols;
  t.linst = t.lights + q.n_light_tris * kLightCols;
  t.points = t.linst + q.n_mesh * 2;
  t.cam = t.points + q.n_point * 6;
  t.bn = bn;
  t.material = material;
  return t;
}

#ifdef __CUDACC__
// The compact copy of the first n floats of the tables (compact_at) in the
// block's shared memory.
__device__ inline void load_compact(float* smem, const float* __restrict__ tables,
                                    const LoopParams& q, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) smem[k] = compact_at(tables, q, k);
  __syncthreads();
}
#endif

// ------------------------------------------------------- the compact sweep
//
// The direct kernels' sweeps over the compact rows (tb.scene, kGeomCols
// floats a row, in shared memory on the card): the tests, hits, tie rule
// and counts of DenseSweep<kGeomCols> (path_loop_step.cuh), with or without
// (kEarly) an exact early out. mt_hit's terms up to u's numerator s =
// dot(sv, h) are computed first; a lane whose bounds on them show a miss
// leaves the test there, and after v's and t's numerators the same, before
// the division. Every lane of a warp tests the same triangle at once, so a
// warp whose lanes all leave skips the rest of the test. A miss is shown
// only where the rounding of u = (1/a) s (and of v, u + v, t) cannot turn it
// into a hit (mt_early), so the exact test decides every triangle that the
// early out does not leave, and a triangle left counts as a test. The
// branch is each lane's own: a warp vote (__all_sync over __activemask())
// measured slower. A row is three shared-memory loads (two of 16 bytes), as
// the compiler already read DenseSweep's.

// the early out's bounds on a numerator over |a|: below kUnder u, v or t
// rounds below 0 (-2^-60, exact: |a| > 1e-12 keeps |a| * 2^-60 normal);
// above kOver (1 + 2^-20) u or v rounds above 1, and u + v above 1 where
// the numerators' sum passes kOver2 (1 + 2^-19); t's upper bound is its
// t_max widened by kOver and at least kTFloor (2^-80), so that |a| times it
// stays normal
constexpr float kUnder = -0x1p-60f;
constexpr float kOver = 1.00000095367431640625f;
constexpr float kOver2 = 1.0000019073486328125f;
constexpr float kTFloor = 0x1p-80f;
// t's lower bound for the shadow sweep's t > 1e-4: 1e-4 narrowed by 2^-20
constexpr float kShadowLo = 1e-4f * 0.99999904632568359375f;

// mt_hit of row `tri` at t in (t_min, t_max), with the early out where
// kEarly (without it the compiler drops the bounds): lo and hi bound
// t's numerator over |a| (kUnder for t_min = 0, kShadowLo for 1e-4; hi =
// t_cut(t_max)) -> whether the row is hit there, with t, u, v.
// Each bound's margin covers the roundings of 1/|a| (2^-22 where it is
// subnormal), of the product, of |a| times the bound and of the sum (2^-24
// each): a numerator past its bound puts u, v, u + v or t strictly past the
// bound of mt_hit's test, and NaN passes no bound. A negative a negates u's,
// v's and t's numerators' signs, so they are compared with their signs
// folded into |a|'s.
template <bool kEarly>
ZDR_HD bool mt_early(const float* tri, V3 o, V3 d, float t_min, float t_max, float lo,
                     float hi, float& t, float& u, float& v) {
  V3 p0 = v3(tri[0], tri[1], tri[2]);
  V3 e1 = v3(tri[3], tri[4], tri[5]);
  V3 e2 = v3(tri[6], tri[7], tri[8]);
  V3 h = vcross(d, e2);
  float a = vdot(e1, h);
  V3 sv = vsub(o, p0);
  float s = vdot(sv, h);
  float aa = fabsf(a);
  bool neg = a < 0.0f;
  float under = aa * kUnder, over = aa * kOver;
  float sa = neg ? -s : s;
  bool out = !(aa > 1e-12f) || sa < under || sa > over;
  if (kEarly && out) return false;
  V3 qv = vcross(sv, e1);
  float rq = vdot(d, qv);
  float tq = vdot(e2, qv);
  float ra = neg ? -rq : rq;
  float ta = neg ? -tq : tq;
  out = out || ra < under || ra > over || sa + ra > aa * kOver2 || ta < aa * lo ||
        ta > aa * hi;
  if (kEarly && out) return false;
  // mt_hit's f, u, v, t where |a| > 1e-12; below it the test fails either way
  float f = 1.0f / a;
  u = f * s;
  v = f * rq;
  t = f * tq;
  return aa > 1e-12f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_max;
}

// The early out's upper bound on t's numerator over |a| for t < t_max.
ZDR_HD float t_cut(float t_max) { return fmaxf(t_max * kOver, kTFloor); }

// DenseSweep<kGeomCols>'s sweeps (the same interface) over the compact rows,
// with the early out where kEarly.
template <bool kEarly>
struct CompactSweep {
  static constexpr bool kBvh = false;

  // Any triangle hit at t in (1e-4, dist); the sweep stops at the first.
  ZDR_HD bool any(const Tables& tb, const LoopParams& q, V3 p, V3 wi, float dist,
                  TraceCount* c) const {
    float hi = t_cut(dist);
    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_early<kEarly>(tb.scene + ti * kGeomCols, p, wi, 1e-4f, dist, kShadowLo, hi, t, u,
                           v)) {
        if (c) c->tests += (unsigned long long)(ti + 1);
        return true;
      }
    }
    if (c) c->tests += (unsigned long long)q.n_tris;
    return false;
  }

  // The nearest hit at t in (0, best_t), the first of equal nearest
  // triangles -> its id (-1: none).
  ZDR_HD int closest(const Tables& tb, const LoopParams& q, V3 o, V3 d, float& best_t,
                     float& bu, float& bv, TraceCount* c) const {
    int prim = -1;
    float hi = t_cut(best_t);
    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_early<kEarly>(tb.scene + ti * kGeomCols, o, d, 0.0f, best_t, kUnder, hi, t, u,
                           v)) {
        best_t = t;
        bu = u;
        bv = v;
        prim = ti;
        hi = t_cut(best_t);
      }
    }
    if (c) c->tests += (unsigned long long)q.n_tris;
    return prim;
  }
};

// B3 for ray `lane` of the (7, n) float planes o3 d3 pdf_prev and the (n,)
// active flags, over compact tables: closest hit, interaction and
// emitter-hit MIS (pallas_bounce.py:474-534). Every ray sweeps the whole
// table, as in the TPU kernel: its outputs are defined for inactive rays too.
// The hit comes from `tr` (the sweep variants hand in a hit found before).
template <class Tracer = CompactSweep<true>>
ZDR_HD void trace_interact_lane(const Tables& tb, const LoopParams& q, const float* rays,
                                const int* active, float* f_out, int* i_out, long lane,
                                long n, bool lite, const Tracer& tr = Tracer()) {
#define ZDR_R(k) rays[(long)(k) * n + lane]
  V3 o = v3(ZDR_R(0), ZDR_R(1), ZDR_R(2));
  V3 d = v3(ZDR_R(3), ZDR_R(4), ZDR_R(5));
  float pdf_prev = ZDR_R(6);
#undef ZDR_R
  bool act = active[lane] != 0;
  Hit h = closest_interact(tb, q, o, d, pdf_prev, act, tr);
  int miss = (act && h.miss) ? 1 : 0;
  if (lite) {
    f_out[lane] = h.ae.x;
    f_out[n + lane] = h.ae.y;
    f_out[2 * n + lane] = h.ae.z;
    i_out[lane] = miss;
    return;
  }
  const float vals[kTraceF] = {h.p.x,  h.p.y,  h.p.z,  h.ux,   h.uy,   h.ns.x, h.ns.y,
                               h.ns.z, h.ng.x, h.ng.y, h.ng.z, h.ae.x, h.ae.y, h.ae.z};
  for (int k = 0; k < kTraceF; ++k) f_out[(long)k * n + lane] = vals[k];
  i_out[lane] = h.shade ? 1 : 0;
  i_out[n + lane] = miss;
}

// What tap mode adds to a lane: its per-sample adjoint and the gradient.
struct DirectTaps {
  float lg[3];
  float* grad;  // (tex_h * tex_w, 4)
};

// Sample `sample_idx` of a lane -> its radiance (before the clamp).
// kGrad: also adds the sample's texture gradient, one tap at one texel.
// kEnv: under the environment light `env` (direct_fused.py:151-156,
// :242-251): a miss of the primary ray adds it at MIS against no BSDF pdf,
// NEE may choose it (its shadow ray has no end), and a miss of the bounce
// ray adds it MIS-weighted against the BSDF pdf. The gradient needs no term
// of its own: the taps read the env through nee.ev and rad - rk.
// The sweeps go through `tr` (the compact sweep, or trace.cuh's BVH) and
// add their work to `cnt`.
template <bool kGrad = false, bool kEnv = false, class Tracer = CompactSweep<true>>
ZDR_HD V3 direct_sample(const Tables& tb, const LoopParams& q, const LaneConst& lc,
                        uint32_t sample_idx, const DirectTaps* dt, TraceCount& cnt,
                        const Tracer& tr = Tracer(), const EnvTables* env = nullptr) {
  SamplerCtx sc;
  sc.q = &q;
  sc.lc = &lc;
  sc.bn = tb.bn;
  sc.seed = q.seed;

  // the camera's 2 draws and the primary ray (fused_glue.py:121-170)
  Sampler smp = fresh_sampler(sc, sample_idx);
  float cu0, cu1;
  next2(sc, smp, cu0, cu1);
  V3 o, d;
  camera_ray(tb.cam, q, lc.px, lc.py, cu0, cu1, o, d);

  // B3 on the primary ray: no BSDF pdf, every lane active
  Hit hit = closest_interact(tb, q, o, d, kPdfNone, true, tr, &cnt);
  if constexpr (kEnv) {
    if (hit.miss) hit.ae = vadd(hit.ae, env_miss_add(*env, d, kPdfNone));
  }

  // the glue: material, NEE's 4 draws, the BSDF's 3 (no roulette draw)
  V3 dif;
  float rough;
  read_bilinear(tb.material, q.tex_h, q.tex_w, hit.ux, hit.uy, dif, rough);
  Nee nee = nee_select<kEnv>(tb, q, sc, smp, hit.p, env);
  float u_lobe = next1(sc, smp);
  float ub0, ub1;
  next2(sc, smp, ub0, ub1);

  // B2 at depth 0 with beta = 1: the shadow test, MIS, GGX shade + sample.
  // Roulette is inert (depth 0 < rr_depth 2) and the path goes on when the
  // bounce is valid (depth 1 < max_depth 16), as direct_fused.py:204 sets it.
  bool shade = hit.shade;
  V3 wo = vscale(d, -1.0f);
  V3 tangent, binormal;
  make_onb(hit.ns, tangent, binormal);
  V3 wo_local = to_local(tangent, binormal, hit.ns, wo);
  // only a shading lane reads the shadow test
  bool occ = shade && tr.any(tb, q, hit.p, nee.wi, nee.dist, &cnt);
  V3 wll = to_local(tangent, binormal, hit.ns, nee.wi);
  bool nee_ok = shade && !occ && wll.z >= 1e-4f;
  float pdf_bsdf_at_light = ggx_sample_pdf(wo_local, wll, rough);
  float mis_nee = nee.pdf / jmax(nee.pdf + pdf_bsdf_at_light, 1e-4f);
  float nee_weight = mis_nee / jmax(nee.pdf, 1e-4f);

  V3 wil = ggx_sample(wo_local, rough, u_lobe, ub0, ub1);
  float pdf_bounce = ggx_sample_pdf(wo_local, wil, rough);
  V3 wi = to_world(tangent, binormal, hit.ns, wil);
  bool bounce_ok = shade && vdot(wi, hit.ng) >= 1e-4f && wil.z >= 1e-4f;
  V3 next_o = vadd(hit.p, vscale(hit.ng, 1e-4f));

  V3 b_nee = ggx_brdf(wo_local, wll, dif, rough);
  V3 b_bounce = ggx_brdf(wo_local, wil, dif, rough);
  float inv_pdf = 1.0f / jmax(pdf_bounce, 1e-9f);
  // beta * b * inv_pdf with beta = 1
  V3 beta_next = v3(b_bounce.x * inv_pdf, b_bounce.y * inv_pdf, b_bounce.z * inv_pdf);
  V3 nee_c = v3(b_nee.x * nee_weight * nee.ev.x, b_nee.y * nee_weight * nee.ev.y,
                b_nee.z * nee_weight * nee.ev.z);
  V3 rk = v3(hit.ae.x + (nee_ok ? nee_c.x : 0.0f), hit.ae.y + (nee_ok ? nee_c.y : 0.0f),
             hit.ae.z + (nee_ok ? nee_c.z : 0.0f));

  // the lite B3 on the bounce ray: its MIS-weighted emitter. A ray that
  // does not go on adds nothing, so its sweep is skipped.
  V3 bae = v3(0.0f, 0.0f, 0.0f);
  if (bounce_ok) {
    Hit bh = closest_interact(tb, q, next_o, wi, pdf_bounce, true, tr, &cnt);
    bae = bh.ae;
    if constexpr (kEnv) {
      if (bh.miss) bae = vadd(bae, env_miss_add(*env, wi, pdf_bounce));
    }
  }
  V3 rad = v3(rk.x + beta_next.x * bae.x, rk.y + beta_next.y * bae.y,
              rk.z + beta_next.z * bae.z);

  if constexpr (kGrad) {
    // B2's taps (pallas_bounce.py:1253-1304) at in_grad = 1: le_rem less
    // this vertex's own terms is the bounce term; its cotangent through
    // b_bounce is le_rem / b_bounce per channel. The VJP of ggx_brdf =
    // (spec + dif / pi) * wi_z is written out: wi_z / pi in each diffuse
    // channel, dspec/drough * wi_z summed over the channels in roughness.
    const float lg[3] = {dt->lg[0], dt->lg[1], dt->lg[2]};
    const float lev[3] = {nee.ev.x, nee.ev.y, nee.ev.z};
    const float bb[3] = {b_bounce.x, b_bounce.y, b_bounce.z};
    const float ler[3] = {rad.x - rk.x, rad.y - rk.y, rad.z - rk.z};
    float ctn[3], ctb[3];
    for (int c = 0; c < 3; ++c) {
      ctn[c] = nee_ok ? nee_weight * lev[c] * lg[c] : 0.0f;
      ctb[c] = (bounce_ok && bb[c] > 1e-8f) ? ler[c] / jmax(bb[c], 1e-8f) * lg[c] : 0.0f;
    }
    float wlz = wll.z, wiz = wil.z;
    float g[4];
    for (int c = 0; c < 3; ++c) g[c] = (ctn[c] * wlz) / kPi + (ctb[c] * wiz) / kPi;
    g[3] = (ctn[0] * wlz + ctn[1] * wlz + ctn[2] * wlz) *
               ggx_spec_droughness(wo_local, wll, rough) +
           (ctb[0] * wiz + ctb[1] * wiz + ctb[2] * wiz) *
               ggx_spec_droughness(wo_local, wil, rough);
    // the stochastic single-corner splat (pallas_bounce.py:1305-1336), one
    // vector atomic (path_loop_step.cuh splat_add4: a NaN channel adds 0);
    // the salt follows the sample's 9 draws (direct_fused.py:260)
    if (nee_ok || bounce_ok) {
      int id = splat_id(hit.ux, hit.uy, lcg_to_unit_float(sampler_salt(sc, smp)), q.tex_h,
                        q.tex_w);
      splat_add4(dt->grad, id, g[0], g[1], g[2], g[3]);
    }
  }
  return rad;
}

// A lane's samples 0 .. stop-1, accumulated with the clamp-and-NaN rule of
// direct_fused.py:283-286 -> the sum of its clamped radiances.
template <bool kGrad = false, bool kEnv = false, class Tracer = CompactSweep<true>>
ZDR_HD V3 direct_lane(const Tables& tb, const LoopParams& q, const LaneConst& lc,
                      const DirectTaps* dt, TraceCount& cnt, const Tracer& tr = Tracer(),
                      const EnvTables* env = nullptr) {
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < lc.stop; ++s) {
    V3 rad = direct_sample<kGrad, kEnv>(tb, q, lc, (uint32_t)s, dt, cnt, tr, env);
    if (!(is_nan(rad.x) || is_nan(rad.y) || is_nan(rad.z)))
      acc = v3(acc.x + jclip(rad.x, 0.0f, kRadianceClamp),
               acc.y + jclip(rad.y, 0.0f, kRadianceClamp),
               acc.z + jclip(rad.z, 0.0f, kRadianceClamp));
  }
  return acc;
}

}  // namespace zdr
