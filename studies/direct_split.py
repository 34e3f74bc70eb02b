#!/usr/bin/env python3
"""The direct integrator's dense kernels (direct, direct_grad) against builds
of them that each differ in one thing, on one CUDA card: their registers,
how their sweeps read the compact rows, where their time goes, their
register caps, blocks and tail wave, and the warps' active lanes at the
sweeps' heads.

    python3 studies/direct_split.py [OUT.json]

Each build is a copy of zdr_tpu_torch/kernels/csrc/ under the textual edits
of its entry in BUILDS (each edit names one or more forms of the text it
replaces, or a Regex, and exactly one form must match its file exactly
once), compiled from direct.cu with the package's nvcc flags into
studies/_build/ (git-ignored), every build at once. Every build keeps the
package's C entries, so the study launches it as the wrappers launch
production's (kernels.direct_launch where the package has it). The inputs
are chip_smoke.py phase 11's dense main paths: the cornell box (12
triangles, pmj02bn, 512x512, 64 spp) and the reference's protocol (962
triangles, 512x512, 256 spp, accel="bruteforce"), 1024^2 material of 0.5,
the render at seed 0, the tap mode at seed 1 with the adjoint 1 / spp.
The builds:
  production  the package's sources;
  primary2x   the primary ray's sweep run twice (the second, on the same ray,
              folded into the ray's origin by a test that never holds, so
              that the compiler keeps both), likewise
  shadow2x    the NEE shadow ray's sweep (any hit), and
  bounce2x    the bounce ray's sweep: each part's time is the build's time
              less production's;
  sampler2x   every draw of a sample (next1, next2) computed twice;
  attrs2x     the hit triangle's attributes read twice;
  texel2x     the material's bilinear fetch twice;
  noatomic    direct_grad's gradient taps computed but not added (the add
              behind a test that never holds): the atomics' share;
  regs128, regs80, regs48
              direct_kernel under other __launch_bounds__ (CAPS), the
              package's being 64 registers;
  timeline    production, with each block's start and end (%globaltimer)
              and SM (%smid), and the active lanes of each warp
              (__activemask) at the head of the primary, shadow and bounce
              sweeps;
on sources whose block is fixed at 256 (before the launch picked it):
  block128, block512
              the kernels at 128 and 512 threads at the same 64 registers;
and on sources with the compact sweep (CompactSweep in direct_step.cuh),
where the launch takes a block and the sweep (with the early out or
without), production at every block up to its largest and with each sweep,
here and on phase 15's dense scenes up to the protocol's (SIZES: 12 to 962
triangles, 512x512, 64 spp); and
  oneout      the early out in one stage, after t's numerator, and
  vote        each stage's branch a warp vote (__all_sync over
              __activemask()) where production's is each lane's own (LEADS).
ptxas's registers, stack frame and spills of each build's direct kernels,
and, from cuobjdump -sass of production, each kernel's loads by opcode
(LDS: shared memory; LD: generic) with the kernels' SASS written beside
OUT.json. Each build's forward is held bit for bit against production's
with the same test count, its gradient (but noatomic's) at chip_smoke.py
phase 7's bars. CUDA events, the median of 5 (the protocol: 3) after a
warm-up. Writes the numbers to OUT.json as well (by default
studies/_build/direct_split.json). Runs from the root of either checkout:
the package's own, or a parent's with this file copied in. Imports nothing
of JAX.
"""

import collections
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
BUILD = os.path.join(HERE, "_build", "direct_split")
STEP, DIRECT, LOOP_STEP = "direct_step.cuh", "direct.cu", "path_loop_step.cuh"
# build -> direct_kernel's __launch_bounds__ (block, blocks an SM)
CAPS = {"regs128": (256, 2), "regs80": (256, 3), "regs48": (256, 5)}


class Regex(str):
    """An edit's target as a regular expression, which must match once."""


# a value the compiler cannot know and that is 0 at run time: a lane stops
# at its spp, far below 2**30
ZERO = "(float)(lc.stop >> 30)"
ZERO_U = "(uint32_t)(c.lc->stop >> 30)"
PRIMARY = "  Hit hit = closest_interact(tb, q, o, d, kPdfNone, true, tr, &cnt);\n"
PRIMARY2 = f"""  {{
    float again_t = kTMax, again_u = 0.0f, again_v = 0.0f;
    int again = tr.closest(tb, q, v3(o.x + {ZERO}, o.y, o.z), d, again_t, again_u, again_v,
                           nullptr);
    o.x += again < -1 ? 1.0f : 0.0f;
  }}
""" + PRIMARY
SHADOW = "  bool occ = shade && tr.any(tb, q, hit.p, nee.wi, nee.dist, &cnt);\n"
SHADOW2 = f"""  bool occ_again =
      shade && tr.any(tb, q, v3(hit.p.x + {ZERO}, hit.p.y, hit.p.z), nee.wi, nee.dist, nullptr);
""" + SHADOW + "  occ = occ_again == occ ? occ : occ_again;\n"
BOUNCE = ("  if (bounce_ok) bae = closest_interact(tb, q, next_o, wi, pdf_bounce, true, tr, "
          "&cnt).ae;\n")
BOUNCE2 = f"""  if (bounce_ok) {{
    float again_t = kTMax, again_u = 0.0f, again_v = 0.0f;
    int again = tr.closest(tb, q, v3(next_o.x + {ZERO}, next_o.y, next_o.z), wi, again_t,
                           again_u, again_v, nullptr);
    next_o.x += again < -1 ? 1.0f : 0.0f;
  }}
""" + BOUNCE
# the draws twice: each of direct_sample's and nee_select's draws through a
# wrapper that also draws from a copy of the state, folded into the result
DRAW2 = """ZDR_HD float study_next1(const SamplerCtx& c, Sampler& s) {
  Sampler t = s;
  t.a += ZERO;
  t.b += ZERO;
  float again = next1(c, t);
  float u = next1(c, s);
  return again == u ? u : again;
}

ZDR_HD void study_next2(const SamplerCtx& c, Sampler& s, float& ux, float& uy) {
  Sampler t = s;
  t.a += ZERO;
  t.b += ZERO;
  float ax, ay;
  next2(c, t, ax, ay);
  next2(c, s, ux, uy);
  ux = ax == ux ? ux : ax;
  uy = ay == uy ? uy : ay;
}

""".replace("ZERO", ZERO_U)
NEE = "template <bool kEnv = false>\nZDR_HD Nee nee_select("
SAMPLER2X = [
    (LOOP_STEP, NEE, DRAW2 + NEE),
    (LOOP_STEP, "float u_sel = next1(c, s);", "float u_sel = study_next1(c, s);"),
    (LOOP_STEP, "float u_prim = next1(c, s);", "float u_prim = study_next1(c, s);"),
    (LOOP_STEP, "next2(c, s, u2a, u2b);", "study_next2(c, s, u2a, u2b);"),
    (STEP, "  next2(sc, smp, cu0, cu1);\n", "  study_next2(sc, smp, cu0, cu1);\n"),
    (STEP, "  float u_lobe = next1(sc, smp);\n", "  float u_lobe = study_next1(sc, smp);\n"),
    (STEP, "  next2(sc, smp, ub0, ub1);\n", "  study_next2(sc, smp, ub0, ub1);\n"),
]
# the attributes twice: a second read of the hit's row at an index the
# compiler cannot know to equal it (best_t is never below -1), folded in
ATTRS = ("  for (int k = 0; k < 22; ++k) av[k] = miss ? 0.0f : tb.attrs[prim * kSceneCols + 9 + "
         "k];\n")
ATTRS2 = ATTRS + """  {
    int again = prim + (best_t < -1.0f ? 1 : 0);
    for (int k = 0; k < 22; ++k) {
      float a2 = miss ? 0.0f : tb.attrs[again * kSceneCols + 9 + k];
      av[k] = a2 == av[k] ? av[k] : a2;
    }
  }
"""
FETCH = "  read_bilinear(tb.material, q.tex_h, q.tex_w, hit.ux, hit.uy, dif, rough);\n"
FETCH2 = FETCH + f"""  {{
    float zero = {ZERO};
    V3 dif2;
    float rough2;
    read_bilinear(tb.material, q.tex_h, q.tex_w, hit.ux + zero, hit.uy + zero, dif2, rough2);
    dif.x = dif2.x == dif.x ? dif.x : dif2.x;
    dif.y = dif2.y == dif.y ? dif.y : dif2.y;
    dif.z = dif2.z == dif.z ? dif.z : dif2.z;
    rough = rough2 == rough ? rough : rough2;
  }}
"""
TAP_VECTOR = "      splat_add4(dt->grad, id, g[0], g[1], g[2], g[3]);\n"
TAP_NONE = "      if (g[0] + g[1] + g[2] + g[3] == 1234.5f) dt->grad[4L * id] = 0.0f;\n"
# direct_kernel's launch bounds, whatever they are
BOUNDS = Regex(r"__launch_bounds__\([^)]*\)\n    direct_kernel\(")
FIXED_BLOCK = "constexpr int kBlock = 256;\n"

# the timeline: each block's start (after its table copy) and end and its SM,
# and at each sweep's head the active lanes of the warp, summed into one of
# 64 slots by block (6 counters a slot: lanes and heads of the primary,
# shadow and bounce sweeps)
STUDY_BLOCKS = 8192
TAP_AT = "// What tap mode adds to a lane: its per-sample adjoint and the gradient.\n"
STUDY_GLOBALS = f"""#ifdef __CUDACC__
constexpr unsigned kStudyBlocks = {STUDY_BLOCKS};
__device__ unsigned long long study_t0[kStudyBlocks], study_t1[kStudyBlocks];
__device__ unsigned study_sm[kStudyBlocks];
__device__ unsigned long long study_heads[64 * 6];
#endif
#ifdef __CUDA_ARCH__
#define ZDR_STUDY_HEAD(k)                                                          \\
  {{                                                                                \\
    unsigned m_ = __activemask();                                                  \\
    if ((int)(threadIdx.x & 31) == __ffs(m_) - 1) {{                                \\
      atomicAdd(&study_heads[(blockIdx.x & 63) * 6 + 2 * (k)],                     \\
                (unsigned long long)__popc(m_));                                   \\
      atomicAdd(&study_heads[(blockIdx.x & 63) * 6 + 2 * (k) + 1], 1ull);          \\
    }}                                                                              \\
  }}
#else
#define ZDR_STUDY_HEAD(k) {{}}
#endif

"""
KERNEL_START = ("  zdr::TraceCount count = {0, 0};\n  if (lane < n) {\n"
                "    zdr::Tables tb = zdr::compact_tables(")
STUDY_START = """  unsigned long long study_t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(study_t));
  if (blockIdx.x < zdr::kStudyBlocks && threadIdx.x == 0) {
    atomicMin(&zdr::study_t0[blockIdx.x], study_t);
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    zdr::study_sm[blockIdx.x] = smid;
  }
"""
KERNEL_END = "  zdr::warp_add(counts, count.tests);\n}\n"
STUDY_END = """  zdr::warp_add(counts, count.tests);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(study_t));
  if (blockIdx.x < zdr::kStudyBlocks) atomicMax(&zdr::study_t1[blockIdx.x], study_t);
}
"""
STUDY_READ = """
// The timeline's records: reset (t0 to the largest value, the rest to 0),
// or read into the caller's host buffers.
extern "C" int zdr_study_timeline(int reset, unsigned long long* t0, unsigned long long* t1,
                                  unsigned* sm, unsigned long long* heads) {
  void* p = nullptr;
  cudaError_t err = cudaSuccess;
  if (reset) {
    if ((err = cudaGetSymbolAddress(&p, zdr::study_t0))) return (int)err;
    if ((err = cudaMemset(p, 0xff, sizeof(zdr::study_t0)))) return (int)err;
    if ((err = cudaGetSymbolAddress(&p, zdr::study_t1))) return (int)err;
    if ((err = cudaMemset(p, 0, sizeof(zdr::study_t1)))) return (int)err;
    if ((err = cudaGetSymbolAddress(&p, zdr::study_heads))) return (int)err;
    return (int)cudaMemset(p, 0, sizeof(zdr::study_heads));
  }
  if ((err = cudaMemcpyFromSymbol(t0, zdr::study_t0, sizeof(zdr::study_t0)))) return (int)err;
  if ((err = cudaMemcpyFromSymbol(t1, zdr::study_t1, sizeof(zdr::study_t1)))) return (int)err;
  if ((err = cudaMemcpyFromSymbol(sm, zdr::study_sm, sizeof(zdr::study_sm)))) return (int)err;
  return (int)cudaMemcpyFromSymbol(heads, zdr::study_heads, sizeof(zdr::study_heads));
}
"""
TIMELINE = [
    (STEP, TAP_AT, STUDY_GLOBALS + TAP_AT),
    (STEP, PRIMARY, "  ZDR_STUDY_HEAD(0)\n" + PRIMARY),
    (STEP, SHADOW, "  if (shade) ZDR_STUDY_HEAD(1)\n" + SHADOW),
    (STEP, BOUNCE, "  if (bounce_ok) ZDR_STUDY_HEAD(2)\n" + BOUNCE),
    (DIRECT, KERNEL_START, STUDY_START + KERNEL_START),
    (DIRECT, KERNEL_END, STUDY_END),
    (DIRECT, '}  // extern "C"\n', '}  // extern "C"\n' + STUDY_READ),
]


def _cap(block, min_blocks):
    return [(DIRECT, BOUNDS, f"__launch_bounds__({block}, {min_blocks})\n    direct_kernel(")]


# name -> [(file, old or (old, ...) or Regex, new)]
BUILDS = {
    "production": [],
    "primary2x": [(STEP, PRIMARY, PRIMARY2)],
    "shadow2x": [(STEP, SHADOW, SHADOW2)],
    "bounce2x": [(STEP, BOUNCE, BOUNCE2)],
    "sampler2x": SAMPLER2X,
    "attrs2x": [(LOOP_STEP, ATTRS, ATTRS2)],
    "texel2x": [(STEP, FETCH, FETCH2)],
    "noatomic": [(STEP, TAP_VECTOR, TAP_NONE)],
    **{name: _cap(*cap) for name, cap in CAPS.items()},
    "timeline": TIMELINE,
}
# sources whose block is fixed (kBlock): other blocks are builds
FIXED = {"block128": [(DIRECT, FIXED_BLOCK, FIXED_BLOCK.replace("256", "128"))] + _cap(128, 8),
         "block512": [(DIRECT, FIXED_BLOCK, FIXED_BLOCK.replace("256", "512"))] + _cap(512, 2)}
# sources with the compact sweep: its early out's first stage taken out, or
# each stage's branch made a warp vote (__all_sync over __activemask())
STAGE1 = ("  bool out = !(aa > 1e-12f) || sa < under || sa > over;\n"
          "  if (kEarly && out) return false;\n")
STAGE2 = "        ta > aa * hi;\n  if (kEarly && out) return false;\n"
VOTE = """ZDR_HD bool study_all(bool miss) {
#ifdef __CUDA_ARCH__
  return __all_sync(__activemask(), miss);
#else
  return miss;
#endif
}

"""
MT_EARLY = "template <bool kEarly>\nZDR_HD bool mt_early("
LEADS = {"oneout": [(STEP, STAGE1, STAGE1.splitlines(keepends=True)[0])],
         "vote": [(STEP, MT_EARLY, VOTE + MT_EARLY),
                  (STEP, STAGE1, STAGE1.replace("kEarly && out", "kEarly && study_all(out)")),
                  (STEP, STAGE2, STAGE2.replace("kEarly && out", "kEarly && study_all(out)"))]}
# phase 15's dense scenes up to the protocol's, by sphere stacks (None: the
# cornell box): 12, 26, 50, 122, 226 and 962 triangles
SIZES = (None, (3, 6), (4, 8), (6, 12), (8, 16), (16, 32))
SPLIT = ("primary2x", "shadow2x", "bounce2x", "sampler2x", "attrs2x", "texel2x")
SCENES = ("cornell box", "protocol")


def compact_sweep(csrc):
    """Whether the sources in `csrc` have the redesigned compact sweep."""
    with open(os.path.join(csrc, STEP)) as fh:
        return "CompactSweep" in fh.read()


def _edit(name, src, edits):
    for fname, olds, new in edits:
        path = os.path.join(src, fname)
        with open(path) as fh:
            text = fh.read()
        if isinstance(olds, Regex):
            text, k = re.subn(olds, new.replace("\\", "\\\\"), text)
            if k != 1:
                raise SystemExit(f"{name}: {olds!r} matches {fname} {k} times")
        else:
            olds = (olds,) if isinstance(olds, str) else olds
            hits = [old for old in olds if text.count(old) == 1]
            if len(hits) != 1 or any(text.count(old) > 1 for old in olds):
                raise SystemExit(f"{name}: the edit of {fname} matches "
                                 f"{[text.count(o) for o in olds]} times:\n{olds[0]}")
            text = text.replace(hits[0], new)
        with open(path, "w") as fh:
            fh.write(text)


def ptxas_report(log):
    """ptxas -v's lines -> {kernel entry: [registers, stack frame bytes,
    spill store bytes, spill load bytes]} for the dense direct kernels and
    trace_interact (every instantiation, by its mangled name)."""
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
    return {k: v for k, v in out.items()
            if ("direct_kernel" in k and "bvh" not in k) or "trace_interact_kernel" in k}


def _cuobjdump():
    for path in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                              "cuobjdump"), shutil.which("cuobjdump") or ""):
        if path and os.path.exists(path):
            return path
    try:
        import triton

        path = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                            "cuobjdump")
        return path if os.path.exists(path) else None
    except ImportError:
        return None


def sass_loads(lib_path, sass_path):
    """cuobjdump -sass of a library -> {kernel: {load opcode: count}} for its
    dense direct kernels and trace_interact; their SASS is written to
    sass_path."""
    tool = _cuobjdump()
    if tool is None:
        return {"error": "no cuobjdump"}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out, keep, name = {}, [], None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            name = name if (("direct_kernel" in name and "bvh" not in name)
                            or "trace_interact_kernel" in name) else None
            if name:
                out[name] = collections.Counter()
        if not name:
            continue
        keep.append(ln)
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m:
            op = m.group(1)
            if op.split(".")[0] in ("LDS", "LD", "LDG", "LDL", "LDC", "ULDC", "STL", "ATOM",
                                    "ATOMG", "RED", "REDG", "MUFU", "VOTE", "BRA", "BSSY"):
                out[name][op] += 1
            out[name]["all"] += 1
    with open(sass_path, "w") as fh:
        fh.write("\n".join(keep) + "\n")
    return {k: dict(sorted(v.items())) for k, v in out.items()}


def build_all(csrc):
    """Copy, edit and compile every build that applies to these sources,
    all nvcc processes at once -> ({name: library entries}, {name: ptxas
    report}, {name: library path})."""
    from zdr_tpu_torch import kernels

    builds = dict(BUILDS, **(LEADS if compact_sweep(csrc) else FIXED))
    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name, edits in builds.items():
        src = os.path.join(BUILD, name)
        shutil.copytree(csrc, src, ignore=shutil.ignore_patterns("__pycache__"))
        _edit(name, src, edits)
        out = os.path.join(BUILD, f"lib{name}_direct.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, DIRECT)]
        running[name] = (cmd, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    prod = kernels.load_library()
    libs, reports, paths = {}, {}, {}
    for name, (cmd, out, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        reports[name] = ptxas_report(log)
        paths[name] = out
        lib = ctypes.CDLL(out)
        ns = types.SimpleNamespace()
        for e in ("zdr_direct", "zdr_direct_grad"):
            if hasattr(prod, e):
                setattr(ns, e, kernels._bind(lib, e, getattr(prod, e).argtypes))
        if name == "timeline":
            ns.zdr_study_timeline = kernels._bind(
                lib, "zdr_study_timeline", [ctypes.c_int] + [ctypes.c_void_p] * 4)
        libs[name] = ns
    return libs, reports, paths


def launch(lib, tb, lanes, mat, le, block=0, early=None):
    """One launch of a build's dense direct kernel, forward (le None) or tap
    mode, at `block` (0: the launch's pick) with the sweep `early` says
    (None: the package's rule) -> (acc, grad or None, counts, the launch's
    plan or None)."""
    from zdr_tpu_torch import kernels

    if hasattr(kernels, "direct_launch"):
        grad, acc, counts, plan = kernels.direct_launch(lib, tb, lanes, mat, le, block, early)
        return acc, grad, counts, plan
    if block or early is not None:
        raise SystemExit("these sources fix the block and the sweep: builds, not launches")
    dev = lanes.device
    n, tables, params, _shared = kernels._loop_inputs(tb, lanes, mat, 0, dev, "direct")
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    counts = kernels._counts(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (params, tables.data_ptr(), tables.numel(), kernels._bn_ptr(tb), mat.data_ptr(),
            lanes.data_ptr())
    if le is None:
        rc = lib.zdr_direct(*head, acc.data_ptr(), counts.data_ptr(), n, stream)
        grad = None
    else:
        grad = torch.zeros_like(mat)
        rc = lib.zdr_direct_grad(*head, le.data_ptr(), acc.data_ptr(), grad.data_ptr(),
                                 counts.data_ptr(), n, stream)
    kernels._raise_on(rc, "zdr_direct")
    return acc, grad, counts, None


def inputs(cs, scene_name, dev, stacks=None):
    """chip_smoke.py phase 11's dense main-path inputs, or phase 15's dense
    scene of sphere `stacks` -> (tables at seed 0, tables at seed 1, lanes,
    material, adjoint, reps)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    if scene_name == "protocol":
        scene, spp, reps = cs._protocol(dev), cs.PROTOCOL_SPP, 3
    elif stacks is not None:
        scene, spp, reps = cs._protocol(dev, "bruteforce", "direct", stacks), cs.SPP, 5
    else:
        scene, spp, reps = cs._flagship(dev, "direct"), cs.SPP, 5
    tb, tb1 = (pl.build_loop_tables(scene._data, scene.camera, scene._config(cs.RES, spp), s)
               for s in (0, 1))
    if tb.bvh is not None:
        raise SystemExit(f"{scene_name}: not the dense route")
    lanes = pl.pixel_lanes(cs.RES, spp, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    return tb, tb1, lanes, mat, le, reps


def time_build(cs, lib, inp, ref=None, check_grad=True, block=0, early=None):
    """A build's dense direct kernels on `inp`, held against `ref`
    (production's outputs) -> ({fwd_ms, grad_ms, ...}, its outputs)."""
    tb, tb1, lanes, mat, le, reps = inp
    acc, _g, counts, plan = launch(lib, tb, lanes, mat, None, block, early)
    _a, grad, gcounts, _p = launch(lib, tb1, lanes, mat, le, block, early)
    torch.cuda.synchronize()
    if ref is not None:
        if not torch.equal(acc, ref[0]):
            raise SystemExit(f"the forward differs from production's in "
                             f"{int((acc != ref[0]).any(0).sum())} lanes")
        if counts.tolist() != ref[2]:
            raise SystemExit(f"the forward's counts {counts.tolist()} are not production's "
                             f"{ref[2]}")
        if check_grad:
            cs._assert_grad_close(grad, ref[1], "the gradient against production's")
    fwd = cs._event_ms(lambda: launch(lib, tb, lanes, mat, None, block, early), reps)
    bwd = cs._event_ms(lambda: launch(lib, tb1, lanes, mat, le, block, early), reps)
    n = lanes.shape[1] * tb.spp
    row = {"fwd_ms": round(fwd[0], 4), "grad_ms": round(bwd[0], 4),
           "fwd_runs": [round(x, 4) for x in fwd[1]], "grad_runs": [round(x, 4) for x in bwd[1]],
           "tests_a_sample": round(counts.tolist()[0] / n, 4)}
    if plan is not None:
        row["plan"] = plan
    return row, (acc, grad, counts.tolist())


def timeline(cs, lib, inp, ref):
    """One forward launch of the timeline build -> its numbers: the blocks'
    waves and times, the SMs' idle share, the warps' active lanes at each
    sweep's head."""
    tb, _tb1, lanes, mat, _le, _reps = inp
    t0 = np.zeros(STUDY_BLOCKS, np.uint64)
    t1 = np.zeros(STUDY_BLOCKS, np.uint64)
    sm = np.zeros(STUDY_BLOCKS, np.uint32)
    heads = np.zeros(64 * 6, np.uint64)
    ptrs = [a.ctypes.data for a in (t0, t1, sm, heads)]
    from zdr_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels._raise_on(lib.zdr_study_timeline(1, *ptrs), "zdr_study_timeline")
    acc, _g, _c, plan = launch(lib, tb, lanes, mat, None)
    torch.cuda.synchronize()
    kernels._raise_on(lib.zdr_study_timeline(0, *ptrs), "zdr_study_timeline")
    if not torch.equal(acc, ref[0]):
        raise SystemExit("the timeline build's forward differs from production's")
    block = plan["block"] if plan else 256
    nb = -(-lanes.shape[1] // block)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0, t1, sm = t0[:nb].astype(np.float64), t1[:nb].astype(np.float64), sm[:nb]
    start, end = t0.min(), t1.max()
    span = end - start
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
    dur = (t1 - t0) / 1e6
    h = heads.reshape(64, 6).sum(0).astype(np.float64)
    return {
        "block": block, "blocks": nb, "span_ms": round(span / 1e6, 4),
        "sm_idle_share": round(1.0 - busy / (sms * span), 4),
        "sm_idle_after_last_block_share": round(idle_after / (sms * span), 4),
        "tail_after_last_start_share": round((end - t0.max()) / span, 4),
        "block_ms_pct_0_10_50_90_100": [round(float(np.percentile(dur, q)), 4)
                                        for q in (0, 10, 50, 90, 100)],
        "active_lanes_at_head": {k: round(h[2 * i] / max(h[2 * i + 1], 1.0), 3)
                                 for i, k in enumerate(("primary", "shadow", "bounce"))},
        "warp_heads": {k: int(h[2 * i + 1]) for i, k in enumerate(("primary", "shadow",
                                                                      "bounce"))},
    }


def _blocks(largest):
    return [1 << k for k in range(5, 11) if 1 << k <= largest]


def study(cs, libs, reports, paths, compact, dev, smi, out_path):
    out = {"card": smi, "compact_sweep": compact, "ptxas": reports}
    sass_path = os.path.splitext(out_path)[0] + "_sass.txt"
    out["sass_loads"] = sass_loads(paths["production"], sass_path)
    print(f"[direct ptxas] {'compact sweep' if compact else 'DenseSweep'} sources; "
          f"[registers, stack frame bytes, spill stores, spill loads] by build: "
          + json.dumps(reports) + f"; production's loads by SASS opcode: "
          + json.dumps(out["sass_loads"]) + f" (SASS in {os.path.relpath(sass_path, ROOT)}); "
          f"card {smi}", flush=True)
    out["scenes"] = {}
    for scene_name in SCENES:
        inp = inputs(cs, scene_name, dev)
        prod, ref = time_build(cs, libs["production"], inp)
        rows = {"production": prod}
        for name in libs:
            if name in ("production", "timeline"):
                continue
            rows[name] = time_build(cs, libs[name], inp, ref, check_grad=name != "noatomic")[0]
        base_f, base_g = prod["fwd_ms"], prod["grad_ms"]
        share = {k: round((rows[k]["fwd_ms"] - base_f) / base_f, 4) for k in SPLIT}
        gshare = {k: round((rows[k]["grad_ms"] - base_g) / base_g, 4) for k in SPLIT}
        atomics = round((base_g - rows["noatomic"]["grad_ms"]) / base_g, 4)
        if compact:
            rows["blocks"] = [time_build(cs, libs["production"], inp, ref, block=b)[0]
                              for b in _blocks(1024)
                              if b <= (prod.get("plan") or {}).get("max_block", 256)]
            for early in (True, False):
                rows["early" if early else "noearly"] = time_build(
                    cs, libs["production"], inp, ref, early=early)[0]
        line = {"rows": rows, "share_fwd": share, "share_grad": gshare,
                "atomic_share": atomics, "timeline": timeline(cs, libs["timeline"], inp, ref)}
        out["scenes"][scene_name] = line
        print(f"[direct split] {scene_name}: production direct {base_f:.3f} ms, direct_grad "
              f"{base_g:.3f} ms, {prod['tests_a_sample']} tests a sample; each part's share "
              f"(a build that runs it twice, less production) of direct: "
              + ", ".join(f"{k[:-2]} {v:.1%}" for k, v in share.items())
              + "; of direct_grad: " + ", ".join(f"{k[:-2]} {v:.1%}" for k, v in gshare.items())
              + f"; direct_grad's atomics {atomics:.1%}; builds (direct / direct_grad ms): "
              + ", ".join(f"{k} {v['fwd_ms']:.3f} / {v['grad_ms']:.3f}" for k, v in rows.items()
                          if isinstance(v, dict))
              + (("; blocks: " + ", ".join(f"{r['plan']['block']} {r['fwd_ms']:.3f} / "
                                           f"{r['grad_ms']:.3f}" for r in rows["blocks"]))
                 if compact else "")
              + f"; timeline {json.dumps(line['timeline'])}; card {smi}", flush=True)
    if compact:
        out["sizes"] = sizes(cs, libs, dev, smi)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)


def sizes(cs, libs, dev, smi):
    """Production's dense kernels without the early out and with it, and
    the vote build's with it, on each scene of SIZES, the forwards bit for
    bit the same -> {triangles: rows}."""
    out = {}
    for stacks in SIZES:
        inp = inputs(cs, "cornell box", dev, stacks)
        row, ref = time_build(cs, libs["production"], inp, early=False)
        rows = {"noearly": row,
                "early": time_build(cs, libs["production"], inp, ref, early=True)[0]}
        if "vote" in libs:
            rows["vote"] = time_build(cs, libs["vote"], inp, ref, early=True)[0]
        out[inp[0].scene.shape[0]] = rows
    print("[direct sizes] phase 15's dense scenes, 512x512 64 spp, direct / direct_grad ms "
          "without the early out, with it, and with it by a warp vote: " + "; ".join(
              f"{n} tris " + " against ".join(f"{r[k]['fwd_ms']:.3f} / {r[k]['grad_ms']:.3f}"
                                              for k in r) for n, r in out.items())
          + f"; card {smi}", flush=True)
    return out


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from zdr_tpu_torch import kernels

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(BUILD, "direct_split.json")
    compact = compact_sweep(kernels.CSRC)
    libs, reports, paths = build_all(kernels.CSRC)
    study(cs, libs, reports, paths, compact, dev, smi, out_path)


if __name__ == "__main__":
    main()
