// One sample of the collocated integrator for one lane: the per-lane code of
// the collocated kernels (collocated.cu).
//
// Replaces zdr_tpu/integrators/collocated_fused.py::_one_sample (:148-210):
// pallas_bounce.py::_trace_interact_kernel (:474, B3) on the primary ray,
// then the XLA glue's material fetch and GGX shade at wi = wo under a unit
// point light at the camera, and, in tap mode, the shade's VJP and the
// stochastic single-corner splat (collocated.py:55, stochastic_splat=True).
// On the TPU that is a kernel and a chain of XLA ops a sample with their
// planes in HBM between them; here one thread keeps the sample in
// registers.
//
// The hit, the interaction, the sampler, the GGX helpers and the splat are
// path_loop_step.cuh's and direct_step.cuh's own, included: the same
// formulas in the same operand order as the plain PyTorch version
// (integrators/collocated.py). Build it as path_loop_step.cuh says (no FMA
// contraction, no fast math).
#pragma once

#include "direct_step.cuh"

namespace zdr {

// Sample `sample_idx` of a lane -> its radiance (before the clamp).
// kGrad: also adds the sample's texture gradient, one tap at one texel. The
// sweep goes through `tr` (the compact sweep, or trace.cuh's BVH) and adds
// its work to `cnt`. kGen: the generic sampler (path_loop_step.cuh
// lane_const).
template <bool kGrad = false, class Tracer = CompactSweep<false>, bool kGen = false,
          bool kPacked = false>
ZDR_HD V3 collocated_sample(const Tables& tb, const LoopParams& q, const LaneConst& lc,
                            uint32_t sample_idx, const DirectTaps* dt, TraceCount& cnt,
                            const Tracer& tr = Tracer()) {
  SamplerCtx sc;
  sc.q = &q;
  sc.lc = &lc;
  sc.bn = tb.bn;
  sc.seed = q.seed;

  // the camera's 2 draws and the primary ray
  Sampler smp = fresh_sampler<kGen>(sc, sample_idx);
  float cu0, cu1;
  next2<kGen>(sc, smp, cu0, cu1);
  V3 o, d;
  camera_ray(tb.cam, q, lc.px, lc.py, cu0, cu1, o, d);

  // B3: no BSDF pdf, so an emitter's MIS weight is 1 and the front-facing
  // hits split into shade (not emissive) and add_emit > 0 (emissive): their
  // union is the shaded set (collocated_fused.py:178), emission playing no
  // role
  Hit hit = closest_interact(tb, q, o, d, kPdfNone, true, tr, &cnt);
  bool valid = hit.shade || hit.ae.x > 0.0f || hit.ae.y > 0.0f || hit.ae.z > 0.0f;
  // the unit light at the camera: 1 / t^2 by the sweep's own t, as the
  // unfused estimator (collocated.py:43), which tests/golden locks
  float inv_t = 1.0f / jmax(hit.t, 1e-6f);
  float li = inv_t * inv_t;

  V3 dif;
  float rough;
  read_bilinear(tb.material, q.tex_h, q.tex_w, hit.ux, hit.uy, dif, rough);
  V3 wo = vscale(d, -1.0f);
  V3 tangent, binormal;
  make_onb(hit.ns, tangent, binormal);
  V3 wo_local = to_local(tangent, binormal, hit.ns, wo);
  V3 beta = ggx_brdf(wo_local, wo_local, dif, rough);
  V3 rad = valid ? v3(beta.x * li, beta.y * li, beta.z * li) : v3(0.0f, 0.0f, 0.0f);

  if constexpr (kGrad) {
    // the VJP of ggx_brdf(wo, wo) = (spec + dif / pi) * wo_z at the
    // cotangent li * le_grad: wo_z / pi in each diffuse channel,
    // the reverse chain of spec in roughness (ggx_spec_droughness); one vector
    // atomic at the corner drawn from the salt after the camera's draws
    // (splat_add4: a NaN channel adds 0)
    if (valid) {
      const float ct[3] = {li * dt->lg[0], li * dt->lg[1], li * dt->lg[2]};
      float wz = wo_local.z;
      float g3 = ggx_spec_droughness(wo_local, wo_local, rough,
                                     ggx_spec_cotangent(ct[0], ct[1], ct[2], wz));
      int id = splat_id(hit.ux, hit.uy, lcg_to_unit_float(sampler_salt<kGen>(sc, smp)),
                        q.tex_h, q.tex_w);
      float g[4] = {(ct[0] * wz) / kPi, (ct[1] * wz) / kPi, (ct[2] * wz) / kPi, g3};
      if constexpr (kPacked)
        for (int c = 0; c < 4; ++c) g[c] = round_bf16(g[c]);
      splat_add4(dt->grad, id, g[0], g[1], g[2], g[3]);
    }
  }
  return rad;
}

// A lane's samples 0 .. stop-1, accumulated with the clamp-and-NaN rule of
// the render wrapper (wrapper.py:194-196) -> the sum of its clamped
// radiances. kPacked: the launch's group of samples, as direct_lane's, with
// the taps rounded to bf16 (collocated_fused.py:263-284).
template <bool kGrad = false, class Tracer = CompactSweep<false>, bool kGen = false,
          bool kPacked = false>
ZDR_HD V3 collocated_lane(const Tables& tb, const LoopParams& q, const LaneConst& lc,
                          const DirectTaps* dt, TraceCount& cnt, const Tracer& tr = Tracer(),
                          V3 acc = V3{0.0f, 0.0f, 0.0f}, int first = 0) {
  int stop = kPacked ? (lc.stop < first + kSplatBatch ? lc.stop : first + kSplatBatch)
                     : lc.stop;
  for (int s = kPacked ? first : 0; s < stop; ++s) {
    V3 rad = collocated_sample<kGrad, Tracer, kGen, kPacked>(tb, q, lc, (uint32_t)s, dt, cnt,
                                                             tr);
    if (!(is_nan(rad.x) || is_nan(rad.y) || is_nan(rad.z)))
      acc = v3(acc.x + jclip(rad.x, 0.0f, kRadianceClamp),
               acc.y + jclip(rad.y, 0.0f, kRadianceClamp),
               acc.z + jclip(rad.z, 0.0f, kRadianceClamp));
  }
  return acc;
}

}  // namespace zdr
