#!/usr/bin/env python3
"""The path-loop forward kernel against builds of it that each differ in one
thing, on one CUDA card: its blocks' timeline, its warps' efficiency, where
its time goes, its register caps and its blocks.

    python3 studies/loop_split.py [OUT.json]

Each build is a copy of zdr_tpu_torch/kernels/csrc/ under the textual edits
of BUILDS, each of which must match its file exactly once, compiled with the
package's nvcc flags into studies/_build/ (git-ignored), all builds at once;
ptxas's report of each build's path_loop_kernel (registers, stack, spills)
is printed. Every build keeps the package's C entries, so
kernels.loop_launch launches it, at its pick of a block or at a block
named. The input is chip_smoke.py phase 6's: the flagship (cornell box,
pmj02bn, 512x512, 64 spp, 1024^2 material of 0.5, seed 0, the dense route);
the blocks and register caps are also timed on phase 13's big mesh (50,882
triangles, the BVH route), and the blocks on small renders of both (SMALL:
128x128 and 256x256 at 64 spp, 16,384 and 65,536 lanes, under the 132 SMs'
resident threads), where the launch's pick spreads the lanes over the SMs.
The builds:
  production  the package's sources;
  sampler2x   every draw of a step (next1, next2) computed twice, the second
              folded into the result, so that the compiler keeps both;
  sweeps2x    both dense sweeps of a step (the closest hit and the shadow
              test) run twice, likewise;
  texel2x     the material's bilinear fetch twice;
  restart2x   the restart branch (a fresh sampler, its camera draw and the
              camera ray) twice;
so each part's time is the build's time less production's;
  regs128, regs80, regs48
              both kernels under other register caps: __launch_bounds__ of
              CAPS (a largest block and the blocks an SM it needs) in place
              of the package's (512, 2) dense and (256, 4) BVH, timed at
              blocks of 128 and 256;
  timeline    production, with each block's start and end (%globaltimer) and
              SM (%smid), each lane's steps, and the active lanes of its warp
              (__activemask) at the head of each step, launched at its pick
              and at 128 threads;
  timeline128 the timeline at regs128's cap, at 128 threads (the parent
              kernel's launch: 128 threads, 128 registers).
Each build's carry is held bit for bit against production's (a build that
computes a part twice computes the same result). CUDA events, the median of
5 after a warm-up. The timeline's numbers: the waves (blocks over resident
blocks), the SM-time idle (each SM's time without a block, over SMs x the
kernel's span) and the part of it after each SM's last block, the blocks'
times, the mean active lanes a warp at a step's head, the lanes' steps and
the slowest lane of each warp and block against its mean lane. Writes the
numbers to OUT.json as well (by default studies/_build/loop_split.json).
Imports nothing of JAX.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "_build")
STEP, LOOP = "path_loop_step.cuh", "path_loop.cu"
# build -> the __launch_bounds__ of both kernels: 128, 80 and 48 registers
CAPS = {"regs128": (512, 1), "regs80": (256, 3), "regs48": (256, 5)}
CAP_BLOCKS = (128, 256)
# the small renders' resolutions (64 spp)
SMALL = ((128, 128), (256, 256))

# a value the compiler cannot know and that is 0 at run time: a lane stops
# at its spp, far below 2**30
ZERO_U = "(uint32_t)(c.lc->stop >> 30)"
DRAW2 = """template <bool kGen>
ZDR_HD float study_next1(const SamplerCtx& c, Sampler& s) {
  Sampler t = s;
  t.a += ZERO;
  t.b += ZERO;
  float again = next1<kGen>(c, t);
  float u = next1<kGen>(c, s);
  return again == u ? u : again;
}

template <bool kGen>
ZDR_HD void study_next2(const SamplerCtx& c, Sampler& s, float& ux, float& uy) {
  Sampler t = s;
  t.a += ZERO;
  t.b += ZERO;
  float ax, ay;
  next2<kGen>(c, t, ax, ay);
  next2<kGen>(c, s, ux, uy);
  ux = ax == ux ? ux : ax;
  uy = ay == uy ? uy : ay;
}

""".replace("ZERO", ZERO_U)
NEE = "template <bool kEnv = false, bool kGen = false>\nZDR_HD Nee nee_select("
SAMPLER2X = [
    (STEP, NEE, DRAW2 + NEE),
    (STEP, "float u_sel = next1<kGen>(c, s);", "float u_sel = study_next1<kGen>(c, s);"),
    (STEP, "float u_prim = next1<kGen>(c, s);", "float u_prim = study_next1<kGen>(c, s);"),
    (STEP, "next2<kGen>(c, s, u2a, u2b);", "study_next2<kGen>(c, s, u2a, u2b);"),
    (STEP, "s.u_lobe = next1<kGen>(sc, s.smp);", "s.u_lobe = study_next1<kGen>(sc, s.smp);"),
    (STEP, "next2<kGen>(sc, s.smp, s.u_b0, s.u_b1);",
     "study_next2<kGen>(sc, s.smp, s.u_b0, s.u_b1);"),
    (STEP, "s.u_rr = next1<kGen>(sc, s.smp);", "s.u_rr = study_next1<kGen>(sc, s.smp);"),
    (STEP, "next2<kGen>(sc, s.smp, cu0, cu1);", "study_next2<kGen>(sc, s.smp, cu0, cu1);"),
]
ANY = """    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, p, wi, t, u, v) && t > 1e-4f && t < dist) {
        if (c) c->tests += (unsigned long long)(ti + 1);
        return true;
      }
    }
    if (c) c->tests += (unsigned long long)q.n_tris;
    return false;
"""
ANY2 = """    int again = -1;
    for (int ti = q.n_tris >> 20; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, p, wi, t, u, v) && t > 1e-4f && t < dist) {
        again = ti;
        break;
      }
    }
    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, p, wi, t, u, v) && t > 1e-4f && t < dist) {
        if (c) c->tests += (unsigned long long)(ti + 1);
        return again == ti;
      }
    }
    if (c) c->tests += (unsigned long long)q.n_tris;
    return again >= 0;
"""
CLOSEST = """    int prim = -1;
    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, o, d, t, u, v) && t > 0.0f && t < best_t) {
"""
CLOSEST2 = """    int again = -1;
    float again_t = best_t;
    for (int ti = q.n_tris >> 20; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, o, d, t, u, v) && t > 0.0f && t < again_t) {
        again_t = t;
        again = ti;
      }
    }
    int prim = -1;
    for (int ti = 0; ti < q.n_tris; ++ti) {
      float t, u, v;
      if (mt_hit(tb.scene + ti * kRowCols, o, d, t, u, v) && t > 0.0f && t < best_t) {
"""
CLOSEST_END = """    if (c) c->tests += (unsigned long long)q.n_tris;
    return prim;
"""
CLOSEST_END2 = """    if (c) c->tests += (unsigned long long)q.n_tris;
    return again == prim ? prim : again;
"""
FETCH = "  read_bilinear(tb.material, q.tex_h, q.tex_w, s.uv_x, s.uv_y, dif, rough);\n"
FETCH2 = FETCH + """  {
    float zero = (float)(lc.stop >> 30);
    V3 dif2;
    float rough2;
    read_bilinear(tb.material, q.tex_h, q.tex_w, s.uv_x + zero, s.uv_y + zero, dif2, rough2);
    dif.x = dif2.x == dif.x ? dif.x : dif2.x;
    dif.y = dif2.y == dif.y ? dif.y : dif2.y;
    dif.z = dif2.z == dif.z ? dif.z : dif2.z;
    rough = rough2 == rough ? rough : rough2;
  }
"""
RESTART = """    s.smp = fresh_sampler<kGen>(sc, (uint32_t)s.sample_idx);
    float cu0, cu1;
    next2<kGen>(sc, s.smp, cu0, cu1);
    camera_ray(tb.cam, q, lc.px, lc.py, cu0, cu1, o_n, d_n);
"""
RESTART2 = """    Sampler t = fresh_sampler<kGen>(sc, (uint32_t)s.sample_idx + (uint32_t)(lc.stop >> 30));
    float tu0, tu1;
    V3 o2, d2;
    next2<kGen>(sc, t, tu0, tu1);
    camera_ray(tb.cam, q, lc.px, lc.py, tu0, tu1, o2, d2);
""" + RESTART + """    o_n = v3(o2.x == o_n.x ? o_n.x : o2.x, o2.y == o_n.y ? o_n.y : o2.y,
             o2.z == o_n.z ? o_n.z : o2.z);
    d_n = v3(d2.x == d_n.x ? d_n.x : d2.x, d2.y == d_n.y ? d_n.y : d2.y,
             d2.z == d_n.z ? d_n.z : d2.z);
"""
RUN_LANE = """  for (int it = 0; it < n_steps; ++it) {
    if (s.sample_idx >= lc.stop && s.in_flight == 0) break;
    int last = loop_step<kGrad, Tracer, kEnv, kGen>(s, lc, tb, q, gl, tr, c, env);
    if constexpr (kGrad) {
      if (last >= 0) replay_sample(*gl, last, q.tex_h * q.tex_w);
    }
  }
"""
STUDY_BLOCKS, STUDY_LANES = 8192, 262144
RUN_LANE_TIMED = """#ifdef __CUDA_ARCH__
  unsigned long long study_t = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(study_t));
  unsigned study_block = blockIdx.x;
  long study_lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (study_block < kStudyBlocks) {
    atomicMin(&study_t0[study_block], study_t);
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    study_sm[study_block] = smid;
  }
  unsigned study_steps = 0;
  unsigned long long study_active = 0, study_warp_steps = 0;
#endif
  for (int it = 0; it < n_steps; ++it) {
    if (s.sample_idx >= lc.stop && s.in_flight == 0) break;
#ifdef __CUDA_ARCH__
    ++study_steps;
    unsigned mask = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(mask) - 1) {
      study_active += __popc(mask);
      ++study_warp_steps;
    }
#endif
    int last = loop_step<kGrad, Tracer, kEnv, kGen>(s, lc, tb, q, gl, tr, c, env);
    if constexpr (kGrad) {
      if (last >= 0) replay_sample(*gl, last, q.tex_h * q.tex_w);
    }
  }
#ifdef __CUDA_ARCH__
  if (study_lane < kStudyLanes) study_lane_steps[study_lane] = study_steps;
  if (study_warp_steps) {
    atomicAdd(&study_warp[0], study_active);
    atomicAdd(&study_warp[1], study_warp_steps);
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(study_t));
  if (study_block < kStudyBlocks) atomicMax(&study_t1[study_block], study_t);
#endif
"""
RUN_LANE_HEAD = ("template <bool kGrad = false, class Tracer = DenseSweep<>, bool kEnv = false,\n"
                 "          bool kGen = false>\nZDR_HD void run_lane(")
STUDY_GLOBALS = f"""#ifdef __CUDACC__
constexpr unsigned kStudyBlocks = {STUDY_BLOCKS};
constexpr long kStudyLanes = {STUDY_LANES};
__device__ unsigned long long study_t0[kStudyBlocks], study_t1[kStudyBlocks];
__device__ unsigned study_sm[kStudyBlocks], study_lane_steps[kStudyLanes];
__device__ unsigned long long study_warp[2];
#endif

"""
STUDY_READ = """
// The timeline's records: reset (t0 to the largest value, the rest to 0),
// or read into the caller's host buffers.
extern "C" int zdr_study_timeline(int reset, unsigned long long* t0, unsigned long long* t1,
                                  unsigned* sm, unsigned* steps, unsigned long long* warp) {
  void* p = nullptr;
  cudaError_t err = cudaSuccess;
  if (reset) {
    if ((err = cudaGetSymbolAddress(&p, zdr::study_t0))) return (int)err;
    if ((err = cudaMemset(p, 0xff, sizeof(zdr::study_t0)))) return (int)err;
    if ((err = cudaGetSymbolAddress(&p, zdr::study_t1))) return (int)err;
    if ((err = cudaMemset(p, 0, sizeof(zdr::study_t1)))) return (int)err;
    if ((err = cudaGetSymbolAddress(&p, zdr::study_lane_steps))) return (int)err;
    if ((err = cudaMemset(p, 0, sizeof(zdr::study_lane_steps)))) return (int)err;
    if ((err = cudaGetSymbolAddress(&p, zdr::study_warp))) return (int)err;
    return (int)cudaMemset(p, 0, sizeof(zdr::study_warp));
  }
  if ((err = cudaMemcpyFromSymbol(t0, zdr::study_t0, sizeof(zdr::study_t0)))) return (int)err;
  if ((err = cudaMemcpyFromSymbol(t1, zdr::study_t1, sizeof(zdr::study_t1)))) return (int)err;
  if ((err = cudaMemcpyFromSymbol(sm, zdr::study_sm, sizeof(zdr::study_sm)))) return (int)err;
  if ((err = cudaMemcpyFromSymbol(steps, zdr::study_lane_steps,
                                  sizeof(zdr::study_lane_steps))))
    return (int)err;
  return (int)cudaMemcpyFromSymbol(warp, zdr::study_warp, sizeof(zdr::study_warp));
}
"""


def _caps(block, min_blocks):
    """The edits that put both kernels under __launch_bounds__(block,
    min_blocks)."""
    return [(LOOP, "__launch_bounds__(512, 2)\n    path_loop_kernel(",
             f"__launch_bounds__({block}, {min_blocks})\n    path_loop_kernel("),
            (LOOP, "__launch_bounds__(256, 4)\n    path_loop_bvh_kernel(",
             f"__launch_bounds__({block}, {min_blocks})\n    path_loop_bvh_kernel(")]


TIMELINE = [(STEP, RUN_LANE_HEAD, STUDY_GLOBALS + RUN_LANE_HEAD), (STEP, RUN_LANE, RUN_LANE_TIMED),
            (LOOP, '}  // extern "C"\n', '}  // extern "C"\n' + STUDY_READ)]
# name -> [(file, old, new)]
BUILDS = {
    "production": [],
    "sampler2x": SAMPLER2X,
    "sweeps2x": [(STEP, ANY, ANY2), (STEP, CLOSEST, CLOSEST2), (STEP, CLOSEST_END, CLOSEST_END2)],
    "texel2x": [(STEP, FETCH, FETCH2)],
    "restart2x": [(STEP, RESTART, RESTART2)],
    **{name: _caps(*cap) for name, cap in CAPS.items()},
    "timeline": TIMELINE,
    "timeline128": TIMELINE + _caps(*CAPS["regs128"]),
}


def _edit(name, src):
    for fname, old, new in BUILDS[name]:
        path = os.path.join(src, fname)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {fname} matches {text.count(old)} times:\n{old}")
        else:
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)


def ptxas_report(log):
    """ptxas -v's lines -> {kernel entry: (registers, stack bytes, spill
    store bytes, spill load bytes)} for the path-loop kernels."""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and props:
            out.setdefault(props, [0, 0, 0, 0])[1:4] = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, [0, 0, 0, 0])[0] = int(m.group(1))
    named = {}
    for entry, vals in out.items():
        m = re.search(r"path_loop_bvh_kernel|path_loop_kernel", entry)
        if m:
            named["bvh" if "bvh" in m.group(0) else "dense"] = vals
    return named


def build_all():
    """Copy, edit and compile every build, all nvcc processes at once ->
    ({name: library}, {name: ptxas report})."""
    from zdr_tpu_torch import kernels

    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name in BUILDS:
        src = os.path.join(BUILD, name)
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("__pycache__"))
        _edit(name, src)
        out = os.path.join(BUILD, f"lib{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, LOOP)]
        running[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    prod = kernels.load_library()
    for name, (cmd, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        reports[name] = ptxas_report(log)
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        libs[name] = types.SimpleNamespace(**{
            entry: kernels._bind(lib, entry, getattr(prod, entry).argtypes)
            for entry in ("zdr_path_loop", "zdr_path_loop_bvh")})
        if name.startswith("timeline"):
            libs[name].zdr_study_timeline = kernels._bind(
                lib, "zdr_study_timeline", [ctypes.c_int] + [ctypes.c_void_p] * 5)
    return libs, reports


def inputs(cs, route, dev, res=None):
    """chip_smoke.py's forward of the flagship (phase 6) or the big mesh
    (phase 13), at its resolution or at `res` -> (tables, lanes, material,
    first carry)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    res = res or cs.RES
    scene = cs._flagship(dev) if route == "dense" else cs._bigmesh(dev, "path")
    tb = pl.build_loop_tables(scene._render_data("path"), scene.camera,
                              scene._config(res, cs.SPP), 0)
    lanes = pl.pixel_lanes(res, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    return tb, lanes, mat, pl.init_carry(lanes)


def _same(got, want, what):
    if not (torch.equal(got.f, want.f) and torch.equal(got.i, want.i)):
        bad = int(((got.f != want.f) & ~(torch.isnan(got.f) & torch.isnan(want.f))).any(0).sum())
        raise SystemExit(f"{what}: its carry differs from production's in {bad} lanes")


def _pct(a, qs=(0, 10, 50, 90, 100)):
    return [round(float(np.percentile(a, q)), 4) for q in qs]


def timeline(lib, tb, lanes, mat, carry0, block, want):
    """One launch of a timeline build at `block` (0: its pick) -> its
    numbers."""
    from zdr_tpu_torch import kernels

    n = lanes.shape[1]
    t0 = np.zeros(STUDY_BLOCKS, np.uint64)
    t1 = np.zeros(STUDY_BLOCKS, np.uint64)
    sm = np.zeros(STUDY_BLOCKS, np.uint32)
    steps = np.zeros(STUDY_LANES, np.uint32)
    warp = np.zeros(2, np.uint64)
    ptrs = [a.ctypes.data for a in (t0, t1, sm, steps, warp)]
    torch.cuda.synchronize()
    kernels._raise_on(lib.zdr_study_timeline(1, *ptrs), "zdr_study_timeline")
    got, _c, plan = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps, block)
    torch.cuda.synchronize()
    kernels._raise_on(lib.zdr_study_timeline(0, *ptrs), "zdr_study_timeline")
    _same(got, want, f"timeline block {block}")
    nb, block, sms = plan["blocks"], plan["block"], plan["sms"]
    t0, t1, sm = t0[:nb].astype(np.float64), t1[:nb].astype(np.float64), sm[:nb]
    start, end = t0.min(), t1.max()
    span = end - start
    dur = (t1 - t0) / 1e6  # ms
    busy, idle_after = 0.0, 0.0
    for k in range(sms):
        mine = np.flatnonzero(sm == k)
        if mine.size == 0:
            idle_after += span
            continue
        order = mine[np.argsort(t0[mine])]
        lo, hi = t0[order[0]], t1[order[0]]
        for b in order[1:]:
            if t0[b] > hi:
                busy += hi - lo
                lo, hi = t0[b], t1[b]
            else:
                hi = max(hi, t1[b])
        busy += hi - lo
        idle_after += end - t1[mine].max()
    resident = plan["blocks_per_sm"] * sms
    by_start = np.argsort(t0)
    rounds = [dur[by_start[r:r + resident]] for r in range(0, nb, resident)]
    st = steps[:n].astype(np.float64)
    per_warp = st.reshape(-1, 32)
    per_block = np.pad(st, (0, nb * block - n), constant_values=np.nan).reshape(nb, block)
    tail_start = t0.max()
    return {
        "block": block, "registers": plan["registers"], "local_bytes": plan["local_bytes"],
        "blocks_per_sm": plan["blocks_per_sm"], "blocks": nb, "waves": round(plan["waves"], 4),
        "rounds": plan["rounds"], "span_ms": round(span / 1e6, 4),
        "sm_idle_share": round(1.0 - busy / (sms * span), 4),
        "sm_idle_after_last_block_share": round(idle_after / (sms * span), 4),
        "tail_after_last_start_share": round((end - tail_start) / span, 4),
        "slot_fill": round(float(dur.sum()) * 1e6 / (resident * span), 4),
        "block_ms_pct_0_10_50_90_100": _pct(dur),
        "round_median_ms": [round(float(np.median(r)), 4) for r in rounds],
        "round_blocks": [int(r.size) for r in rounds],
        "active_lanes_a_warp": round(float(warp[0]) / max(float(warp[1]), 1.0), 3),
        "lane_steps_mean_sd": [round(float(st.mean()), 2), round(float(st.std()), 2)],
        "lane_steps_pct_0_1_50_99_100": _pct(st, (0, 1, 50, 99, 100)),
        "warp_max_over_mean": round(float((per_warp.max(1) / per_warp.mean(1)).mean()), 4),
        "block_max_over_mean": round(float(
            (np.nanmax(per_block, 1) / np.nanmean(per_block, 1)).mean()), 4),
    }


def _blocks(largest):
    return [1 << k for k in range(5, 11) if 1 << k <= largest]


def _time(lib, tb, lanes, mat, carry0, block, ref, what):
    """`lib`'s kernel at `block`, held against `ref` -> a row of numbers."""
    from zdr_tpu_torch import kernels
    import chip_smoke as cs

    got, _c, p = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps, block)
    torch.cuda.synchronize()
    _same(got, ref, what)
    t, runs = cs._event_ms(lambda: kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps,
                                                       block))
    return {"block": p["block"], "ms": round(t, 4), "runs": [round(x, 4) for x in runs],
            "registers": p["registers"], "local_bytes": p["local_bytes"],
            "blocks_per_sm": p["blocks_per_sm"], "blocks": p["blocks"],
            "waves": round(p["waves"], 4), "rounds": p["rounds"]}


def _row_note(r):
    return (f"{r['block']} threads {r['ms']:.3f} ms ({r['registers']} registers, "
            f"{r['local_bytes']} B local, {r['blocks_per_sm']} blocks an SM, {r['blocks']} "
            f"blocks, {r['waves']:.3f} waves, {r['rounds']} rounds)")


def study(cs, libs, reports, dev, smi, out_path):
    from zdr_tpu_torch import kernels

    out = {"card": smi, "ptxas": reports}
    tb, lanes, mat, carry0 = inputs(cs, "dense", dev)
    prod = kernels.load_library()
    want, _c, plan = kernels.loop_launch(prod, tb, lanes, mat, carry0, tb.n_steps)
    torch.cuda.synchronize()
    ms = {}
    for name in ("production", "sampler2x", "sweeps2x", "texel2x", "restart2x"):
        lib = libs[name]
        got = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps)[0]
        torch.cuda.synchronize()
        _same(got, want, name)
        ms[name] = cs._event_ms(
            lambda lib=lib: kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps))[0]
    out["split_ms"] = {k: round(v, 4) for k, v in ms.items()}
    out["split_share"] = {k: round((ms[k] - ms["production"]) / ms["production"], 4)
                          for k in ms if k != "production"}
    print(f"[loop split] flagship pmj02bn {cs.RES[0]}x{cs.RES[1]} {cs.SPP} spp, path_loop at "
          f"its pick ({plan['block']} threads, {plan['registers']} registers, "
          f"{plan['blocks_per_sm']} blocks an SM, {plan['waves']:.3f} waves, {plan['rounds']} "
          f"rounds), CUDA events, median of 5 (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + "; each part's share of production: "
          + ", ".join(f"{k[:-2]} {v:.1%}" for k, v in out["split_share"].items())
          + f"; ptxas: " + "; ".join(f"{k} {reports[k]}" for k in ms) + f"; card {smi}",
          flush=True)

    out["blocks"], out["small"] = {}, {}
    for route in ("dense", "bvh"):
        tbr, lanes_r, mat_r, carry_r = (tb, lanes, mat, carry0) if route == "dense" else \
            inputs(cs, "bvh", dev)
        ref, _c, pick = kernels.loop_launch(prod, tbr, lanes_r, mat_r, carry_r, tbr.n_steps)
        torch.cuda.synchronize()
        rows = {"pick": pick["block"], "production": [
            _time(prod, tbr, lanes_r, mat_r, carry_r, b, ref, f"{route} block {b}")
            for b in _blocks(pick["max_block"])]}
        for name, (largest, _m) in CAPS.items():
            rows[name] = [_time(libs[name], tbr, lanes_r, mat_r, carry_r, b, ref,
                                f"{name} {route} block {b}")
                          for b in CAP_BLOCKS if b <= largest]
        out["blocks"][route] = rows
        print(f"[loop blocks] {route} ({tbr.scene.shape[0]} tris, {lanes_r.shape[1]} lanes), the "
              f"pick {pick['block']}: " + "; ".join(
                  f"{name} (ptxas {reports[name].get(route)}): "
                  + ", ".join(_row_note(r) for r in rows[name])
                  for name in ("production", *CAPS)) + f"; card {smi}", flush=True)
        for res in SMALL:
            tbs, lanes_s, mat_s, carry_s = inputs(cs, route, dev, res)
            ref, _c, pick = kernels.loop_launch(prod, tbs, lanes_s, mat_s, carry_s, tbs.n_steps)
            torch.cuda.synchronize()
            rows = [_time(prod, tbs, lanes_s, mat_s, carry_s, b, ref, f"{route} {res} block {b}")
                    for b in _blocks(pick["max_block"])]
            out["small"][f"{route} {res[0]}x{res[1]}"] = {"pick": pick["block"], "rows": rows}
            print(f"[loop small] {route} {res[0]}x{res[1]} {cs.SPP} spp ({lanes_s.shape[1]} "
                  f"lanes), the pick {pick['block']}: "
                  + "; ".join(_row_note(r) for r in rows) + f"; card {smi}", flush=True)

    out["timeline"] = []
    for name, block in (("timeline", 0), ("timeline", 128), ("timeline128", 128)):
        row = timeline(libs[name], tb, lanes, mat, carry0, block, want)
        row["build"] = name
        out["timeline"].append(row)
        print(f"[loop timeline] flagship, {name} at {row['block']} threads: "
              + json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(BUILD, "loop_split.json")
    libs, reports = build_all()
    study(cs, libs, reports, dev, smi, out_path)


if __name__ == "__main__":
    main()
