#!/usr/bin/env python3
"""The direct integrator's BVH kernels (direct_bvh, direct_grad_bvh) against
builds of them that each differ in one thing, on one CUDA card: the
registers and local memory of the four BVH megakernels, where the direct
kernels' time goes, their register caps and blocks, and the walk's designs.

    python3 studies/walk_split.py [OUT.json]

Each build is a copy of zdr_tpu_torch/kernels/csrc/ under the textual edits
of its entry in BUILDS (each edit names one or more forms of the text it
replaces, and exactly one must match its file exactly once), compiled with
the package's nvcc flags into studies/_build/ (git-ignored), every build's
sources at once. The production build compiles path_loop.cu,
path_loop_grad.cu and direct.cu, and ptxas's report of the four BVH
megakernels (registers, stack frame = local bytes, spill stores and loads)
is printed; the other builds compile direct.cu. Every build keeps the
package's C entries, so the study launches it as the wrappers launch
production's.

The inputs are chip_smoke.py's: the reference's protocol (962 triangles,
pmj02bn, 512x512, 256 spp, the route accel="auto" takes, the BVH) and the
big mesh (50,882 triangles, 512x512, 64 spp), 1024^2 material of 0.5, the
render at seed 0, the tap mode at seed 1 with the adjoint 1 / spp; the
direct builds on each scene with the bounce ray's emitter-first lookup
("emit", where the sources have it) and with its closest hit ("closest":
the tables built with scene_tables.MERGED_MAX_LIGHT_TRIS lowered). The
builds:
  production  the package's sources;
  primary2x   the primary ray's walk run twice (the second, on the same ray,
              folded into the ray's origin by a test that never holds, so
              that the compiler keeps both), likewise
  shadow2x    the NEE shadow ray's walk (any hit), and
  bounce2x    the bounce ray's lookup, whichever the launch takes (its
              closest walk, or emitter first its light hit and capped
              any-hit walk): each part's time is the build's time less
              production's, the rest production's less the three;
  noatomic    direct_grad's gradient taps computed but not added (the add
              behind a test that never holds): the atomics' share;
  regs128, regs80, regs48, block128, block512
              the direct BVH kernels under other __launch_bounds__ (CAPS:
              block, blocks an SM) and blocks, production's (256, 4) being
              64 registers at 256 threads.
Builds of the ordered walk alone (skipped, and said so, on sources with
the escape-link walk); all but scalar4 and stack32 replace trace.cuh's
bvh_walk whole with walk()'s text of it, which under production's pieces
is production's function (checked before any build):
  scalar4     direct_grad's tap as four scalar atomics, as before the
              vector atomic;
  stackshared the walk's stack in shared-memory slots (K_SHARED entries a
              thread, strided by the block) in place of local memory (the
              direct kernels alone: the path gradient kernel's launch plan
              refuses the static shared memory);
  noorder     the walk without near-child-first order: child 0 first,
              child 1 pushed, whatever their distances;
  skip        the walk with a skip on pop: each entry pushed with its entry
              distance, and one past the best t by the time it is popped
              skipped (closest hit);
  ifif        the walk as one loop, a node or a leaf an iteration, where
              production runs two, internal nodes until a leaf and then
              the leaf;
  stack32     the walk's stack of 32 entries, where production's has 64
              (a walk touches only the entries below its depth);
  unrolled    the leaf's loop without production's #pragma unroll 1 (the
              compiler's unrolling).
stack32 and unrolled (PATH_BUILDS) also build the path BVH kernels, timed
on the big mesh beside production's.
On the ordered walk, production also walks trees of each leaf width in
LEAF_WIDTHS (accel/variants.leaf_accel), and the path BVH kernels are timed
on the big mesh at each width.

Each build's and each tree's forward is held bit for bit against
production's (the walk's hits do not depend on its order or its tree), and
its gradient (but noatomic's) at chip_smoke.py phase 7's bars. CUDA
events, the median of 5 after a warm-up. Writes the numbers to OUT.json as well (by
default studies/_build/walk_split.json). Runs from the root of either
checkout: the package's own, or a parent's with this file copied in.
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

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "_build")
STEP, DIRECT, TRACE = "direct_step.cuh", "direct.cu", "trace.cuh"
LOOP, GRAD = "path_loop.cu", "path_loop_grad.cu"
LEAF_WIDTHS = (2, 4, 8)
# build -> the direct BVH kernels' __launch_bounds__ (block, blocks an SM)
CAPS = {"regs128": (256, 2), "regs80": (256, 3), "regs48": (256, 5),
        "block128": (128, 8), "block512": (512, 2)}

# a value the compiler cannot know and that is 0 at run time: a lane stops
# at its spp, far below 2**30
ZERO = "(float)(lc.stop >> 30)"
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
# the bounce ray's lookup: its closest hit over the scene (the lite B3), and
# where the sources have it, emitter first (direct_step.cuh bounce_emit);
# bounce2x runs the lookup the launch takes twice
BOUNCE = "    Hit bh = closest_interact(tb, q, next_o, wi, pdf_bounce, true, tr, &cnt);\n"
BOUNCE2 = f"""    {{
      float again_t = kTMax, again_u = 0.0f, again_v = 0.0f;
      int again = tr.closest(tb, q, v3(next_o.x + {ZERO}, next_o.y, next_o.z), wi, again_t,
                             again_u, again_v, nullptr);
      next_o.x += again < -1 ? 1.0f : 0.0f;
    }}
""" + BOUNCE
EMIT = "    bae = bounce_emit<kEnv>(tb, q, light_rows, next_o, wi, pdf_bounce, tr, cnt, env);\n"
EMIT2 = f"""    {{
      TraceCount again_cnt = {{0, 0}};
      V3 again = bounce_emit<kEnv>(tb, q, light_rows, v3(next_o.x + {ZERO}, next_o.y, next_o.z),
                                   wi, pdf_bounce, tr, again_cnt, env);
      next_o.x += again.x < -1.0f ? 1.0f : 0.0f;
    }}
""" + EMIT
# the head of the bounce's lookup, either
BOUNCE_HEAD = "  V3 bae = v3(0.0f, 0.0f, 0.0f);\n"
# the tap's add: four scalar atomics (the escape-link sources) or one vector
# atomic (the ordered walk's)
TAP_SCALAR = "      for (int c = 0; c < 4; ++c) splat_add(dt->grad, id, c, g[c]);\n"
TAP_VECTOR = "      splat_add4(dt->grad, id, g[0], g[1], g[2], g[3]);\n"
TAP_NONE = "      if (g[0] + g[1] + g[2] + g[3] == 1234.5f) dt->grad[4L * id] = 0.0f;\n"
SPLAT_SCALAR = """
ZDR_HD void splat_add(float* grad, int id, int c, float v) {
  if (is_nan(v) || v == 0.0f) return;
#ifdef __CUDA_ARCH__
  atomicAdd(grad + 4L * id + c, v);
#else
  grad[4L * id + c] += v;
#endif
}
"""
TAP_SCALAR_AT = "// What tap mode adds to a lane: its per-sample adjoint and the gradient.\n"
# The ordered walk's builds replace trace.cuh's bvh_walk whole, by its
# name, with walk()'s text of it: WALK_WHILE or WALK_IF under the pieces a
# build changes. walk() with production's pieces must be production's
# function, character for character (checked), so that each build differs
# from it in the one piece it names.
WALK_HEAD = """template <bool kAny>
ZDR_HD int bvh_walk(const Bvh& b, V3 o, V3 d, float t_min, float& best_t, float& bu, float& bv,
                    TraceCount* c) {
  V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int prim = -1;
  if (b.n_rows == 0) return -1;
@STACK@  int sp = 0;
  int ref = b.n_nodes ? 0 : ~(b.n_rows - 1);
  while (true) {
"""
VISIT = """      if (c) c->visits += 1;
      Node nd = load_node(b, ref);
      float n0, n1;
      bool h0 = slab(o, inv, nd.lo0, nd.hi0, t_min, best_t, n0);
      bool h1 = slab(o, inv, nd.lo1, nd.hi1, t_min, best_t, n1);
"""
LEAF = """    int e = ~ref;
    int first = e >> kCountBits, count = (e & ((1 << kCountBits) - 1)) + 1;
@UNROLL@    for (int k = 0; k < count; ++k) {
      if (c) c->tests += 1;
      float r[9], t, u, v;
      int gid = load_row(b.geom, first + k, r);
      if (!mt_hit(r, o, d, t, u, v) || !(t > t_min)) continue;
      if (kAny) {
        if (t < best_t) return 0;
      } else if (t < best_t || (t == best_t && gid < prim)) {
        best_t = t;
        bu = u;
        bv = v;
        prim = gid;
      }
    }
"""
# production's two loops, internal nodes until a leaf and then the leaf
# ("while-while", Aila and Laine)
WALK_WHILE = WALK_HEAD + """    while (ref >= 0) {
""" + VISIT + """      if (h0 && h1) {
        bool swap = @ORDER@;
@PUSH@        ref = swap ? nd.ref1 : nd.ref0;
      } else if (h0 || h1) {
        ref = h0 ? nd.ref0 : nd.ref1;
@NODE_POP@    }
""" + LEAF + """@LEAF_POP@  }
}
"""
# one loop, a node or a leaf an iteration
WALK_IF = WALK_HEAD + """    if (ref >= 0) {
""" + VISIT + """      if (h0 && h1) {
        bool swap = @ORDER@;
@PUSH@        ref = swap ? nd.ref1 : nd.ref0;
        continue;
      }
      if (h0 || h1) {
        ref = h0 ? nd.ref0 : nd.ref1;
        continue;
      }
    } else {
""" + ("  " + LEAF.replace("\n    ", "\n      ").replace("@UNROLL@    ", "@UNROLL@      ")) + """    }
@LEAF_POP@  }
}
"""
# the stack's pieces: its declaration, a push of the far child, the pop at a
# node with no child hit (after its if-else chain) and after a leaf
STACK_LOCAL = {
    "@STACK@": "  int stack[kStackDepth];  // the far children still to visit\n",
    "@PUSH@": "        stack[sp++] = swap ? nd.ref0 : nd.ref1;\n",
    "@NODE_POP@": ("      } else if (sp == 0) {\n        return prim;\n      } else {\n"
                   "        ref = stack[--sp];\n      }\n"),
    "@LEAF_POP@": "    if (sp == 0) return prim;\n    ref = stack[--sp];\n",
}
# the stack in shared-memory slots of the block: kShared entries a thread,
# entry k of thread x at k * blockDim.x + x, for blocks of up to 256 threads
# (the trees measured are at most 19 internal nodes deep at leaf 2 and wider)
K_SHARED = 20
STACK_SHARED = {
    "@STACK@": f"""#ifdef __CUDA_ARCH__
  __shared__ int study_stack[{K_SHARED} * 256];
  int* stack = study_stack + threadIdx.x;
  const int stride = blockDim.x;
#else
  int stack[{K_SHARED}];
  const int stride = 1;
#endif
""",
    "@PUSH@": "        stack[sp++ * stride] = swap ? nd.ref0 : nd.ref1;\n",
    "@NODE_POP@": STACK_LOCAL["@NODE_POP@"].replace("stack[--sp]", "stack[--sp * stride]"),
    "@LEAF_POP@": STACK_LOCAL["@LEAF_POP@"].replace("stack[--sp]", "stack[--sp * stride]"),
}
# the skip on pop: each entry with its entry distance, an entry whose
# distance is past the best t by the time it is popped skipped (closest hit)
SKIP_POP = """do {
  if (sp == 0) return prim;
  --sp;
} while (!kAny && stack_t[sp] > best_t * kSlabSlack);
ref = stack[sp];
"""
STACK_SKIP = {
    "@STACK@": STACK_LOCAL["@STACK@"] + "  float stack_t[kStackDepth];\n",
    "@PUSH@": "        stack_t[sp] = swap ? n0 : n1;\n" + STACK_LOCAL["@PUSH@"],
    "@NODE_POP@": "      } else {\n" + "".join("        " + ln + "\n"
                                               for ln in SKIP_POP.splitlines()) + "      }\n",
    "@LEAF_POP@": "".join("    " + ln + "\n" for ln in SKIP_POP.splitlines()),
}


def walk(loop=WALK_WHILE, stack=STACK_LOCAL, order="n1 < n0", unroll="#pragma unroll 1\n"):
    """The text of bvh_walk under these pieces; the defaults are production's."""
    text = loop.replace("@ORDER@", order).replace("@UNROLL@", unroll)
    for key, piece in stack.items():
        text = text.replace(key, piece)
    return text


class Function(str):
    """An edit's target: the whole definition of the function of this name
    (its template line, if any, to its closing brace at the start of a
    line)."""


def _function_span(text, name):
    spans = [m.span() for m in re.finditer(
        rf"(?:template <[^\n]*>\n)?ZDR_HD [^\n]*\b{name}\(.*?\n}}\n", text, re.S)]
    return spans[0] if len(spans) == 1 else None


BOUNDS = "__launch_bounds__(kBlock, 4)\n    direct_bvh_kernel("
BLOCK = "constexpr int kBlock = 256;\n"


def _caps(block, min_blocks):
    """The edits that put the direct BVH kernels under
    __launch_bounds__(block, min_blocks) at `block` threads."""
    edits = [(DIRECT, BOUNDS, BOUNDS.replace("kBlock, 4", f"kBlock, {min_blocks}"))]
    if block != 256:
        edits.append((DIRECT, BLOCK, BLOCK.replace("256", str(block))))
    return edits


# name -> [(file, old or (old, ...), new)]
BUILDS = {
    "production": [],
    "primary2x": [(STEP, PRIMARY, PRIMARY2)],
    "shadow2x": [(STEP, SHADOW, SHADOW2)],
    "bounce2x": [(STEP, BOUNCE, BOUNCE2)],  # and EMIT's where the sources have it
    "noatomic": [(STEP, (TAP_SCALAR, TAP_VECTOR), TAP_NONE)],
    **{name: _caps(*cap) for name, cap in CAPS.items()},
}
WALK = Function("bvh_walk")
STACK_DEPTH = "constexpr int kStackDepth = 64;\n"
# the ordered walk's builds (skipped on the escape-link sources)
DESIGN = {
    "scalar4": [(STEP, TAP_VECTOR, TAP_SCALAR), (STEP, TAP_SCALAR_AT,
                                                 SPLAT_SCALAR.lstrip() + "\n" + TAP_SCALAR_AT)],
    "stackshared": [(TRACE, WALK, walk(stack=STACK_SHARED))],
    "noorder": [(TRACE, WALK, walk(order="false && n1 < n0"))],
    "skip": [(TRACE, WALK, walk(stack=STACK_SKIP))],
    "ifif": [(TRACE, WALK, walk(loop=WALK_IF))],
    "stack32": [(TRACE, STACK_DEPTH, STACK_DEPTH.replace("64", "32"))],
    "unrolled": [(TRACE, WALK, walk(unroll=""))],
}
# the design builds that also build the path BVH kernels, timed on the big
# mesh beside production's
PATH_BUILDS = ("stack32", "unrolled")
SPLIT = ("primary2x", "shadow2x", "bounce2x")
# the kernels' mangled entry names -> the names ptxas reports are keyed by
ENTRIES = {"direct_bvh_kernelILb0": "direct_bvh", "direct_bvh_kernelILb1": "direct_grad_bvh",
           "path_loop_bvh_kernel": "path_loop_bvh",
           "path_loop_grad_bvh_kernel": "path_loop_grad_bvh",
           "direct_kernelILb0": "direct", "direct_kernelILb1": "direct_grad"}


def ordered_walk(csrc):
    """Whether the sources in `csrc` walk the BVH in order with a stack."""
    with open(os.path.join(csrc, TRACE)) as fh:
        return "kStackDepth" in fh.read()


def _edit(name, src, edits):
    for fname, olds, new in edits:
        path = os.path.join(src, fname)
        with open(path) as fh:
            text = fh.read()
        if isinstance(olds, Function):
            span = _function_span(text, olds)
            if span is None:
                raise SystemExit(f"{name}: {fname} has no one definition of {olds}")
            with open(path, "w") as fh:
                fh.write(text[:span[0]] + new + text[span[1]:])
            continue
        olds = (olds,) if isinstance(olds, str) else olds
        hits = [old for old in olds if text.count(old) == 1]
        if len(hits) != 1 or any(text.count(old) > 1 for old in olds):
            raise SystemExit(f"{name}: the edit of {fname} matches {[text.count(o) for o in olds]}"
                             f" times:\n{olds[0]}")
        with open(path, "w") as fh:
            fh.write(text.replace(hits[0], new))


def ptxas_report(log):
    """ptxas -v's lines -> {kernel: [registers, stack frame bytes, spill
    store bytes, spill load bytes]} for the kernels of ENTRIES."""
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
    for mangled, vals in out.items():
        for key, name in ENTRIES.items():
            if (key in mangled and not ("direct_kernel" in key and "bvh" in mangled)
                    and not _env_instantiation(mangled)):
                named[name] = vals
    return named


def _env_instantiation(mangled):
    """Whether a direct kernel's mangled name is an envmap instantiation
    (its last flag, kEnv, set), which sources from before the envmap lack."""
    m = re.search(r"direct_kernelI((?:Lb[01]E){3})", mangled) or re.search(
        r"direct_bvh_kernelI((?:Lb[01]E){2})", mangled)
    return bool(m) and m.group(1).endswith("Lb1E")


def emit_first(csrc):
    """Whether the sources in `csrc` have the emitter-first bounce lookup."""
    with open(os.path.join(csrc, STEP)) as fh:
        return EMIT in fh.read()


def with_emit(builds, csrc):
    """`builds` with bounce2x's second edit, EMIT's, where the sources have
    the emitter-first lookup."""
    if not emit_first(csrc):
        return builds
    return dict(builds, bounce2x=builds["bounce2x"] + [(STEP, EMIT, EMIT2)])


def lookup_tables(cs, data, camera, cfg, lookup):
    """The tables at seeds 0 and 1 with the bounce's lookup `lookup`:
    "emit" (the package's: emitter first, where the sources have it) or
    "closest" (chip_smoke.py's _closest_tables where it has them; sources
    without the emitter-first lookup have only the closest)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    if lookup == "closest" and hasattr(cs, "_closest_tables"):
        return cs._closest_tables(data, camera, cfg, (0, 1))
    return [pl.build_loop_tables(data, camera, cfg, s) for s in (0, 1)]


def build_all():
    """Copy, edit and compile every build that applies to these sources,
    all nvcc processes at once -> ({name: library entries}, {name: ptxas
    report}, the builds skipped)."""
    from zdr_tpu_torch import kernels

    ordered = ordered_walk(kernels.CSRC)
    if ordered:
        with open(os.path.join(kernels.CSRC, TRACE)) as fh:
            text = fh.read()
        span = _function_span(text, WALK)
        if span is None or text[span[0]:span[1]] != walk():
            raise SystemExit(f"walk() is not {TRACE}'s bvh_walk: bring WALK_WHILE and its "
                             f"pieces up to date with it")
    builds = with_emit(dict(BUILDS, **(DESIGN if ordered else {})), kernels.CSRC)
    skipped = [] if ordered else list(DESIGN)
    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name, edits in builds.items():
        src = os.path.join(BUILD, name)
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("__pycache__"))
        _edit(name, src, edits)
        files = (DIRECT, LOOP, GRAD) if name in ("production", *PATH_BUILDS) else (DIRECT,)
        for f in files:
            out = os.path.join(BUILD, f"lib{name}_{f.split('.')[0]}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, f)]
            running[(name, f)] = (cmd, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    prod = kernels.load_library()
    libs, reports = {}, {}
    for (name, f), (cmd, out, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        reports.setdefault(name, {}).update(ptxas_report(log))
        lib = ctypes.CDLL(out)
        entries = {DIRECT: ("zdr_direct_bvh",),
                   LOOP: ("zdr_path_loop_bvh",),
                   GRAD: ("zdr_path_loop_grad_bvh", "zdr_path_loop_grad_plan")}[f]
        ns = libs.setdefault(name, types.SimpleNamespace())
        for e in entries:
            setattr(ns, e, kernels._bind(lib, e, getattr(prod, e).argtypes))
    return libs, reports, skipped


def _bvh_args(kernels):
    """The kernels' BVH argument check (named _bvh_args before the ordered
    walk)."""
    return getattr(kernels, "bvh_args", None) or kernels._bvh_args


def direct_launch(lib, tb, lanes, mat, le):
    """One launch of a build's zdr_direct_bvh, forward (le None) or tap
    mode, as kernels.direct_bvh launches production's -> (acc, grad or
    None, counts)."""
    from zdr_tpu_torch import kernels

    dev = lanes.device
    n, tables, params, shared = kernels._loop_inputs(tb, lanes, mat, 0, dev, "direct")
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    grad = None if le is None else torch.zeros_like(mat)
    counts = kernels._counts(dev)
    rc = lib.zdr_direct_bvh(
        params, tables.data_ptr(), tables.numel(), int(shared), kernels._bn_ptr(tb),
        mat.data_ptr(), lanes.data_ptr(), None if le is None else le.data_ptr(), acc.data_ptr(),
        None if grad is None else grad.data_ptr(), *_bvh_args(kernels)(tb.bvh, dev),
        counts.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    kernels._raise_on(rc, "zdr_direct_bvh")
    return acc, grad, counts


def inputs(cs, scene_name, integrator, dev, lookup="emit"):
    """chip_smoke.py's main-path inputs of the protocol (by accel="auto")
    or the big mesh, with the bounce's lookup `lookup` (lookup_tables) ->
    (tables at seed 0, tables at seed 1, lanes, material, adjoint)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    if scene_name == "protocol":
        scene, spp = cs._protocol(dev, accel="auto", integrator=integrator), cs.PROTOCOL_SPP
    else:
        scene, spp = cs._bigmesh(dev, integrator), cs.SPP
    data = scene._render_data(integrator)
    tb, tb1 = lookup_tables(cs, data, scene.camera, scene._config(cs.RES, spp), lookup)
    if tb.bvh is None:
        raise SystemExit(f"{scene_name}: not the BVH route")
    lanes = pl.pixel_lanes(cs.RES, spp, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    return tb, tb1, lanes, mat, le


def time_direct(cs, lib, inp, ref=None, check_grad=True):
    """A build's direct BVH kernels on `inp`, held against `ref` (production's
    outputs) -> ({fwd_ms, grad_ms, ...}, its outputs)."""
    tb, tb1, lanes, mat, le = inp
    acc, _g, counts = direct_launch(lib, tb, lanes, mat, None)
    gacc, grad, gcounts = direct_launch(lib, tb1, lanes, mat, le)
    torch.cuda.synchronize()
    if ref is not None:
        if not torch.equal(acc, ref[0]):
            raise SystemExit(f"the forward differs from production's in "
                             f"{int((acc != ref[0]).any(0).sum())} lanes")
        if check_grad:
            cs._assert_grad_close(grad, ref[1], "the gradient against production's")
    fwd = cs._event_ms(lambda: direct_launch(lib, tb, lanes, mat, None))
    bwd = cs._event_ms(lambda: direct_launch(lib, tb1, lanes, mat, le))
    n = lanes.shape[1] * tb.spp
    c = counts.tolist()
    row = {"fwd_ms": round(fwd[0], 4), "grad_ms": round(bwd[0], 4),
           "fwd_runs": [round(x, 4) for x in fwd[1]], "grad_runs": [round(x, 4) for x in bwd[1]],
           "tests_a_sample": round(c[0] / n, 3), "visits_a_sample": round(c[1] / n, 3),
           "counts": c, "grad_counts": gcounts.tolist()}
    return row, (acc, grad)


def time_path(cs, lib, inp, ref=None):
    """A build's path BVH kernels on the big mesh's path inputs, the
    forward's carry held bit for bit against `ref` (production's) -> (ms,
    the carry)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    tb, tb1, lanes, mat, le = inp
    carry0 = pl.init_carry(lanes)
    carry, counts, _p = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps)
    torch.cuda.synchronize()
    if ref is not None and not (torch.equal(carry.f, ref.f) and torch.equal(carry.i, ref.i)):
        raise SystemExit("the path forward's carry differs from production's")
    fwd = cs._event_ms(lambda: kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps))
    bwd = cs._event_ms(lambda: kernels.grad_launch(lib, tb1, lanes, mat, le, tb.n_steps))
    return {"path_loop_bvh_ms": round(fwd[0], 4), "path_loop_grad_bvh_ms": round(bwd[0], 4),
            "path_counts": counts.tolist()}, carry


def _with_tree(inp, tree):
    import dataclasses

    tb, tb1, *rest = inp
    return (dataclasses.replace(tb, bvh=tree), dataclasses.replace(tb1, bvh=tree), *rest)


def study(cs, libs, reports, skipped, dev, smi, out_path):
    from zdr_tpu_torch import kernels

    ordered = ordered_walk(kernels.CSRC)
    out = {"card": smi, "ordered_walk": ordered, "ptxas": reports, "skipped": skipped}
    print(f"[walk ptxas] {'ordered' if ordered else 'escape-link'} walk; the four BVH "
          f"megakernels of production [registers, stack frame (local) bytes, spill stores, "
          f"spill loads]: {json.dumps(reports['production'])}; builds skipped: {skipped}; "
          f"card {smi}", flush=True)
    direct_in = {name: inputs(cs, name, "direct", dev) for name in ("protocol", "big mesh")}
    rows, refs = {}, {}
    scenes = dict(direct_in)
    if emit_first(kernels.CSRC):
        scenes = {f"{k}, emit": v for k, v in direct_in.items()}
        scenes.update({f"{k}, closest": inputs(cs, k, "direct", dev, "closest")
                       for k in direct_in})
    for scene_name, inp in scenes.items():
        prod, ref = time_direct(cs, libs["production"], inp)
        refs[scene_name] = ref
        rows[scene_name] = {"production": prod}
        for name in libs:
            if name == "production":
                continue
            rows[scene_name][name] = time_direct(cs, libs[name], inp, ref,
                                                 check_grad=name != "noatomic")[0]
        r = rows[scene_name]
        base_f, base_g = prod["fwd_ms"], prod["grad_ms"]
        split = {k: round((r[k]["fwd_ms"] - base_f) / base_f, 4) for k in SPLIT}
        split["rest"] = round(1.0 - sum(split.values()), 4)
        atomics = round((base_g - r["noatomic"]["grad_ms"]) / base_g, 4)
        r["split_share"], r["atomic_share"] = split, atomics
        print(f"[walk split] {scene_name}: production direct_bvh {base_f:.3f} ms, "
              f"direct_grad_bvh {base_g:.3f} ms, {prod['tests_a_sample']} tests and "
              f"{prod['visits_a_sample']} visits a sample; direct_bvh's share: "
              + ", ".join(f"{k} {v:.1%}" for k, v in split.items())
              + f"; direct_grad_bvh's atomics {atomics:.1%} (noatomic "
              f"{r['noatomic']['grad_ms']:.3f} ms); builds (fwd / grad ms): "
              + ", ".join(f"{k} {v['fwd_ms']:.3f} / {v['grad_ms']:.3f}" for k, v in r.items()
                          if isinstance(v, dict) and "fwd_ms" in v)
              + f"; card {smi}", flush=True)
    out["direct"] = rows

    if ordered:
        from zdr_tpu_torch.accel import variants as tv

        path_in = inputs(cs, "big mesh", "path", dev)
        out["path"], path_ref = time_path(cs, libs["production"], path_in)
        print(f"[walk path] production's path BVH kernels on the big mesh "
              f"{json.dumps(out['path'])}; card {smi}", flush=True)
        out["path_builds"] = {name: time_path(cs, libs[name], path_in, path_ref)[0]
                              for name in PATH_BUILDS}
        print(f"[walk path] builds' path BVH kernels on the big mesh "
              f"{json.dumps(out['path_builds'])}; card {smi}", flush=True)
        out["leaf"] = {}
        for leaf in LEAF_WIDTHS:
            line = {}
            for scene_name, inp in direct_in.items():
                tree = tv.leaf_accel(_geom_of(cs, scene_name, dev), leaf)
                ref = refs.get(scene_name) or refs[f"{scene_name}, emit"]
                line[scene_name] = time_direct(cs, libs["production"], _with_tree(inp, tree),
                                               ref)[0]
                line[scene_name]["nodes"] = int(tree.nodes.shape[0])
            tree = tv.leaf_accel(_geom_of(cs, "big mesh", dev), leaf)
            line["big mesh path"] = time_path(cs, libs["production"], _with_tree(path_in, tree),
                                              path_ref)[0]
            out["leaf"][leaf] = line
            print(f"[walk leaf] leaf {leaf}: " + json.dumps(line) + f"; card {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)


def _geom_of(cs, scene_name, dev):
    scene = cs._protocol(dev, accel="auto") if scene_name == "protocol" else \
        cs._bigmesh(dev, "direct")
    return scene._data.geom


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(BUILD, "walk_split.json")
    libs, reports, skipped = build_all()
    study(cs, libs, reports, skipped, dev, smi, out_path)


if __name__ == "__main__":
    main()
