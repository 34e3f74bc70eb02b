// Per-ray code of the sweep variants (sweep_variants.cu; sweep_variants_host.cpp
// runs it on the CPU): the closest-hit and any-hit sweep of a ray over a
// triangle table, by Möller–Trumbore or by the Woop test, with or without
// per-tile box culls, and the epilogues after it.
//
// They are the H100 counterparts of the TPU measurement kernels under tools/
// (B9), which took the cost of kernel 1, the closest-hit sweep of B3/B4,
// apart: tile width and rays a step (profile_wide.py, profile_chunk.py),
// the epilogue's share (profile_sweep_variants.py full vs lite,
// profile_mxu_variants.py fori/hybrid), the Woop test (mxu_kernel) and tile
// AABB culls (aabb_kernel). What they measured as MXU issue, bf16x3 passes
// and packed keys has no counterpart here; each variant asks its question of
// the FP32 sweep that the port's kernels run.
//
// The same formulas in the same operand order as the plain versions
// (zdr_tpu_torch/accel/variants.py); build without FMA contraction and
// without fast math, and the two agree bit for bit.
#pragma once

#include "direct_step.cuh"

namespace zdr {

enum SweepMode { kModeClosest = 0, kModeAny = 1, kModeInteract = 2, kModeLite = 3 };
constexpr int kWarp = 32;

// The Woop test of one ray against a triangle's Woop row (accel/woop.py:
// [m_u | -m_u.p0 | m_v | -m_v.p0 | m_w | -m_w.p0]), pallas_bounce.py::
// _tile_uv_t (:595-622) in FP32: t = -o'_w / d'_w, u = o'_u + t d'_u,
// v = o'_v + t d'_v; true when the barycentrics are inside. A degenerate
// triangle's zero row gives t = NaN, which no t range admits.
ZDR_HD bool woop_hit(const float* w, V3 o, V3 d, float& t, float& u, float& v) {
  float ow = w[8] * o.x + w[9] * o.y + w[10] * o.z + w[11];
  float dw = w[8] * d.x + w[9] * d.y + w[10] * d.z;
  t = -ow / dw;
  float ou = w[0] * o.x + w[1] * o.y + w[2] * o.z + w[3];
  float du = w[0] * d.x + w[1] * d.y + w[2] * d.z;
  u = ou + t * du;
  float ov = w[4] * o.x + w[5] * o.y + w[6] * o.z + w[7];
  float dv = w[4] * d.x + w[5] * d.y + w[6] * d.z;
  v = ov + t * dv;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

template <bool kWoop>
ZDR_HD bool tri_hit(const float* row, V3 o, V3 d, float& t, float& u, float& v) {
  if constexpr (kWoop) return woop_hit(row, o, d, t, u, v);
  return mt_hit(row, o, d, t, u, v);
}

// A ray's sweep: best_t is t_max for any hit, else the nearest t so far.
struct SweepRay {
  V3 o, d;
  float t_min, best_t, bu, bv;
  int prim;
  bool live, occ;
  unsigned tests, box_tests;
  ZDR_HD bool open() const { return live && !occ; }
};

// Ray i of the (8, n) planes o3 d3 pdf_prev t_max: closest hit at t in
// (0, t_max), any hit in (1e-4, t_max); the epilogue modes take t_max =
// kTMax, as trace_interact does.
ZDR_HD SweepRay sweep_ray(const float* rays, long i, long n, int mode) {
  SweepRay s;
  s.live = i < n;
  s.occ = false;
  s.o = s.d = v3(0.0f, 0.0f, 0.0f);
  s.t_min = mode == kModeAny ? 1e-4f : 0.0f;
  s.best_t = kTMax;
  if (s.live) {
    s.o = v3(rays[i], rays[n + i], rays[2 * n + i]);
    s.d = v3(rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
    if (mode == kModeClosest || mode == kModeAny) s.best_t = rays[7 * n + i];
  }
  s.bu = s.bv = 0.0f;
  s.prim = -1;
  s.tests = s.box_tests = 0;
  return s;
}

// One row (global triangle `id`) of the sweep: closest keeps the nearest t
// in (t_min, best_t), the first of equal t, as accel.cu's dense sweep; any
// hit stops at the first t in (t_min, t_max).
template <bool kWoop, bool kAny>
ZDR_HD void sweep_row(SweepRay& s, const float* row, int id) {
  if (!s.open()) return;
  s.tests += 1;
  float t, u, v;
  if (tri_hit<kWoop>(row, s.o, s.d, t, u, v) && t > s.t_min && t < s.best_t) {
    if (kAny) {
      s.occ = true;
    } else {
      s.best_t = t;
      s.bu = u;
      s.bv = v;
      s.prim = id;
    }
  }
}

// Whether an open ray's slab test (trace.cuh aabb_hit, the BVH walk's) hits
// a tile's box, capped by the best t so far (closest) or t_max (any): the
// cull of pallas_bounce.py::_mxu_sweep_row's tile_need (:678-698). A tile
// whose box no ray of a warp hits holds no hit that ray keeps.
ZDR_HD bool tile_need(SweepRay& s, const float* box) {
  if (!s.open()) return false;
  s.box_tests += 1;
  V3 inv = v3(safe_inv(s.d.x), safe_inv(s.d.y), safe_inv(s.d.z));
  return aabb_hit(s.o, inv, box, s.t_min, s.best_t);
}

// A hit found before the epilogue, handed to closest_interact as its
// tracer.
struct GivenHit {
  static constexpr bool kBvh = false;
  float t, u, v;
  int prim;
  ZDR_HD int closest(const Tables&, const LoopParams&, V3, V3, float& best_t, float& bu,
                     float& bv, TraceCount*) const {
    best_t = t;
    bu = u;
    bv = v;
    return prim;
  }
};

// After the sweep: the Woop sweep's winner gets its t, u, v by Möller–Trumbore
// from its geometry row (pallas_bounce.py::_mt_rederive, :810-828); then the
// mode's outputs of ray i: closest t, u, v (f_out) and prim (i_out); any the
// occlusion (i_out); interact and lite trace_interact's 16 or 4 planes, by
// direct_step.cuh's own epilogue over the (T, 31) attribute rows.
template <bool kWoop>
ZDR_HD void sweep_finish(SweepRay& s, int mode, const float* geom, const float* table,
                         const float* rays, const int* active, float* f_out, int* i_out,
                         long i, long n) {
  if (!s.live) return;
  if (mode == kModeAny) {
    i_out[i] = s.occ ? 1 : 0;
    return;
  }
  if (kWoop && s.prim >= 0) {
    float r[9];
    load_row(geom, s.prim, r);
    mt_hit(r, s.o, s.d, s.best_t, s.bu, s.bv);
  }
  if (mode == kModeClosest) {
    f_out[i] = s.best_t;
    f_out[n + i] = s.bu;
    f_out[2 * n + i] = s.bv;
    i_out[i] = s.prim;
    return;
  }
  Tables tb = {};
  tb.attrs = table;
  LoopParams q = {};
  trace_interact_lane(tb, q, rays, active, f_out, i_out, i, n, mode == kModeLite,
                      GivenHit{s.best_t, s.bu, s.bv, s.prim});
}

}  // namespace zdr
