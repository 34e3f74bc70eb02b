#!/usr/bin/env python3
"""The direct integrator's env BVH kernels (direct_env_bvh,
direct_grad_env_bvh) against builds of them that each differ in one thing,
on one CUDA card: where their time goes, their register caps and blocks,
ptxas's report of the four direct env kernels, and how many shading lanes
draw an env sample below their hemisphere. With --integrator path, the
path integrator's env kernels likewise (below).

    python3 studies/env_split.py [--integrator direct|path] [OUT.json]

Each build is a copy of zdr_tpu_torch/kernels/csrc/ under the textual edits
of its entry in BUILDS (walk_split.py's manner: each edit names the text it
replaces, which must match its file exactly once), compiled with the
package's nvcc flags into studies/_build/env/ (git-ignored), every build's
direct.cu at once. The builds:
  production  the package's sources;
  primary2x   the primary ray's walk run twice (walk_split.py's edit),
  shadow2x    the NEE shadow ray's walk (to 1e30 where NEE takes the env),
  bounce2x    the bounce ray's any-hit to kTMax where it hits no light
              triangle (the env's escape test),
  envdraw2x   NEE's env draw: both alias draws, the pdf entry and the
              texel fetch (on the redesigned sources, which fetch after the
              shadow walk where NEE counts, the second fetch runs on every
              lane that draws the env), and
  miss2x      env_miss_add (the primary's and the bounce's), each run
              twice (the second folded into nothing by a test that never
              holds, on a value the compiler cannot know): each part's
              time is the build's time less production's;
  noatomic    the gradient's taps computed but not added (walk_split.py's);
  b<B>r<R>    the env BVH instantiations alone at B threads a block and at
              most R registers (__launch_bounds__(B, 65536 / (B R))),
              production's (256, 4) being b256r64; the no-env kernels keep
              theirs.
The scenes, 512x512, 64 spp, a 512^2 material of 0.5, by accel="auto" (the
BVH), the render at seed 0 and the tap mode at seed 1 with the adjoint
1 / spp:
  example     apps/example.py's (chip_smoke._example: the 960-triangle
              sphere under make_test_envmap(256, 512), no light triangle);
  big mesh    tools/bench_bigmesh.py's (chip_smoke._bigmesh: 50,882
              triangles, a 2-triangle quad light) under the same envmap;
  example 1024x2048
              the example under make_test_envmap(1024, 2048), whose
              texture (32 MiB) does not sit in L2 with the tables.
Each build's forward is held bit for bit against production's, its
gradient (but noatomic's) at chip_smoke.py phase 7's bars. CUDA events, the
median of 5 after a warm-up. The share of shading lanes whose light sample
takes the env and lies below the shading hemisphere (wll.z < 1e-4, so that
NEE adds nothing whatever the shadow ray finds) is counted with the plain
direct samples (bounce.shade_plain's own frame) on every 64th lane, the
first 8 samples. Writes the numbers to OUT.json (by default
studies/_build/env_split.json, or env_split_path.json). Runs from the root
of a checkout, the package's own or a parent's with this file copied into
its studies/ (its edits match the path kernels' sources before and after
their redesign); imports nothing of JAX.

--integrator path: the path env kernels, path_loop_env(_bvh) and
path_loop_grad_env(_bvh) (path_loop.cu, path_loop_grad.cu over
path_loop_step.cuh loop_step<.., kEnv = true>), launched by
kernels.loop_launch and grad_launch, against PATH_BUILDS: production;
  closest2x   the next hit's sweep or walk (closest_interact's) run twice,
  shadow2x    the NEE shadow ray's (where the sources walk it),
  envdraw2x   nee_select's env draw, pdf entry and texel fetch,
  miss2x      env_miss_add, and
  rough2x     the tap mode's two roughness taps (ggx_spec_droughness,
              torch.func's reverse chain since C3), each twice as above;
  noatomic    the taps replayed but not added;
  noreplay    no finished sample's rows replayed (nor added): the replay's
              share is noatomic's time less noreplay's;
  grad_b64, grad_b256, dense_min5, bvh_min3, bvh_min4, bvh_min5,
  bvh_uncapped
              the gradient kernels (every instantiation) at other blocks
              and __launch_bounds__ (production: 128 threads, the dense
              kernel uncapped, the BVH one at 4 blocks an SM, its env
              instantiation at 8 since the redesign);
  fwd_dense_b256r64, fwd_bvh_b128r64, fwd_bvh_b128r80
              the env forwards alone at B threads a block and R registers
              (production: 512 x 2 dense, 256 x 4 BVH, 64 registers).
A build whose edits are the gradient's alone compiles path_loop_grad.cu
only; its forward is production's. A build whose edits are the forward's
alone compiles path_loop.cu only; its gradient is production's and is not
timed. PATH_SCENES at 512x512, 64 spp, a
1024^2 material of 0.5, the render at seed 0 and the tap mode at seed 1
with the adjoint 1 / spp: the flagship (chip_smoke._flagship: the cornell
box and its light, the dense route) under make_test_envmap(256, 512),
tools/bench_round3.py's env_scene (chip_smoke._env_scene, the BVH), the big
mesh (chip_smoke._bigmesh, 50,882 triangles, the BVH) under
make_test_envmap(256, 512), and the flagship under make_test_envmap(1024,
2048). Each build's forward is held bit for bit against production's and
its gradient at phase 7's bars (not the split's that change it). The share
of shading steps whose light sample lies below the hemisphere (wll.z <
1e-4: NEE adds nothing, whatever the shadow ray finds), split into env and
mesh (or point) samples, is counted by the plain walk (path_loop.loop_step's
own frame) on every 64th lane, the first 4 samples; the same share without
an env on the flagship (path) and the direct protocol
(tools/bench_reference.py by accel="auto", chip_smoke._protocol).
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import walk_split as ws  # noqa: E402

BUILD = os.path.join(HERE, "_build", "env")
STEP, DIRECT, LOOPSTEP = "direct_step.cuh", "direct.cu", "path_loop_step.cuh"
# a value the compiler cannot know and that is 0 at run time (no scene has
# 2**30 triangles or texture rows)
ZERO_Q = "(float)(q.n_tris >> 30)"
ZERO_E = "(float)(e.h >> 30)"
# the bounce's escape test under the env (direct_step.cuh bounce_emit)
ESCAPE = ("    if (!tr.bounce_any(tb, q, o, d, kTMax, &cnt)) return vadd(zero, "
          "env_miss_add(*env, d, pdf_prev));\n")
ESCAPE2 = f"""    {{
      bool again = tr.bounce_any(tb, q, v3(o.x + {ZERO_Q}, o.y, o.z), d, kTMax, nullptr);
      o.y *= again ? 1.0f + {ZERO_Q} : 1.0f;
    }}
""" + ESCAPE
# NEE's env draw, its pdf entry and its texels (path_loop_step.cuh
# nee_select<true>)
ENVDRAW = "    if (idx < n_env) {\n"
ENVDRAW2 = ENVDRAW + f"""      {{
        float again_yu, again_xu;
        int again_y = env_alias_draw(*env, kEnvMapH, u2b + {ZERO_Q}, 0, again_yu);
        int again_x = env_alias_draw(*env, kEnvMapW, u2a, kEnvMapH + again_y * kEnvMapW, again_xu);
        float again_u = ((float)again_x + again_xu) / (float)kEnvMapW;
        float again_v = ((float)again_y + again_yu) / (float)kEnvMapH;
        float again_pdf = ro_load(env->pdf + again_y * kEnvMapW + again_x) * env_inv_sin(again_v);
        V3 again_ev = env_fetch(*env, again_u, again_v);
        u2a *= again_pdf + again_ev.x < -1.0f ? 2.0f : 1.0f;
      }}
"""
# env_miss_add run twice: the definition renamed, and a twin that calls it
# on a direction the compiler cannot know is d, then on d
MISS = "ZDR_HD V3 env_miss_add(const EnvTables& e, V3 d, float pdf_prev) {\n"
MISS_ONCE = MISS.replace("env_miss_add(", "env_miss_add_once(")
MISS_AT = "// The env tables of a launch: the texture (h, w, 4), the alias\n"
MISS_TWICE = f"""ZDR_HD V3 env_miss_add(const EnvTables& e, V3 d, float pdf_prev) {{
  V3 again = env_miss_add_once(e, v3(d.x + {ZERO_E}, d.y, d.z), pdf_prev);
  V3 once = env_miss_add_once(e, d, pdf_prev);
  return again.x < -1e30f ? again : once;
}}

"""
# the redesigned sources: the shadow walk only where NEE can count
SKIP_SHADOW = ("    occ = shade && wll.z >= 1e-4f && tr.any(tb, q, hit.p, nee.wi, nee.dist, "
               "&cnt);\n")
SKIP_SHADOW2 = f"""    bool occ_again = shade && wll.z >= 1e-4f &&
                     tr.any(tb, q, v3(hit.p.x + {ws.ZERO}, hit.p.y, hit.p.z), nee.wi, nee.dist,
                            nullptr);
""" + SKIP_SHADOW + "    occ = occ_again == occ ? occ : occ_again;\n"
BOUNDS = "__launch_bounds__(kBlock, 4)\n    direct_bvh_kernel("
GRID = "  zdr::Bvh bvh{nodes, geom, n_nodes, n_rows};\n  int grid = (n + kBlock - 1) / kBlock;\n"
LAUNCH = "  fn<<<grid, kBlock, smem, (cudaStream_t)stream>>>"
# (block, registers) of the env BVH instantiations; production's (256, 64)
CAPS = ((256, 80), (256, 128), (128, 64), (128, 80), (128, 96), (128, 128))


def _caps(block, regs):
    """The edits that put the env BVH instantiations alone under `block`
    threads a block and at most `regs` registers."""
    blocks = 65536 // (block * regs)
    return [(DIRECT, BOUNDS, BOUNDS.replace("kBlock, 4", f"kEnv ? {block} : kBlock, "
                                                         f"kEnv ? {blocks} : 4")),
            (DIRECT, GRID, GRID.replace("int grid = (n + kBlock - 1) / kBlock;",
                                        f"int blk = with_env ? {block} : kBlock;\n"
                                        f"  int grid = (n + blk - 1) / blk;")),
            (DIRECT, LAUNCH, LAUNCH.replace("kBlock", "blk"))]


BUILDS = {
    "production": [],
    "primary2x": [(STEP, ws.PRIMARY, ws.PRIMARY2)],
    "shadow2x": [[(STEP, ws.SHADOW, ws.SHADOW2), (STEP, SKIP_SHADOW, SKIP_SHADOW2)]],
    "bounce2x": [(STEP, ESCAPE, ESCAPE2)],
    "envdraw2x": [(LOOPSTEP, ENVDRAW, ENVDRAW2)],
    "miss2x": [(LOOPSTEP, MISS, MISS_ONCE), (LOOPSTEP, MISS_AT, MISS_TWICE + MISS_AT)],
    "noatomic": [(STEP, ws.TAP_VECTOR, ws.TAP_NONE)],
    **{f"b{b}r{r}": _caps(b, r) for b, r in CAPS},
}
SPLIT = ("primary2x", "shadow2x", "bounce2x", "envdraw2x", "miss2x")
# the four direct env kernels (chip_smoke.PTXAS_ENTRIES' names)
ENV_KERNELS = ("direct_env", "direct_env_early", "direct_grad_env", "direct_grad_env_early",
               "direct_env_bvh", "direct_grad_env_bvh")
SCENES = (("example", 256), ("big mesh", 256), ("example 1024x2048", 1024))


def _edit(name, src, edits):
    """walk_split._edit of each edit; a list of edits is one edit in either
    form of the sources, of which exactly one must match."""
    for edit in edits:
        if isinstance(edit, list):
            hits = []
            for fname, old, new in edit:
                with open(os.path.join(src, fname)) as fh:
                    if fh.read().count(old) == 1:
                        hits.append((fname, old, new))
            if len(hits) != 1:
                raise SystemExit(f"{name}: {len(hits)} of the edit's forms match")
            edit = hits[0]
        ws._edit(name, src, [edit])


def build_all():
    """Copy, edit and compile every build's direct.cu, all nvcc processes at
    once -> ({name: library entries}, {name: ptxas of the env kernels})."""
    import chip_smoke as cs
    from zdr_tpu_torch import kernels

    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name, edits in BUILDS.items():
        src = os.path.join(BUILD, name)
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("__pycache__"))
        _edit(name, src, edits)
        out = os.path.join(BUILD, f"lib{name}_direct.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, DIRECT)]
        running[name] = (cmd, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    prod = kernels.load_library()
    libs, reports = {}, {}
    for name, (cmd, out, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        report = cs.ptxas_bvh(log)
        reports[name] = {k: [report[k][f] for f in ("registers", "local_bytes", "spill_stores",
                                                     "spill_loads")] for k in ENV_KERNELS}
        lib = ctypes.CDLL(out)
        libs[name] = types.SimpleNamespace(zdr_direct_env_bvh=kernels._bind(
            lib, "zdr_direct_env_bvh", prod.zdr_direct_env_bvh.argtypes))
    return libs, reports


def env_launch(lib, tb, lanes, mat, le):
    """One launch of a build's zdr_direct_env_bvh, forward (le None) or tap
    mode, as kernels.direct_env_bvh launches production's -> (acc, grad or
    None, counts)."""
    from zdr_tpu_torch import kernels

    dev = lanes.device
    n, tables, params, shared = kernels._loop_inputs(tb, lanes, mat, 0, dev, "direct")
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    grad = None if le is None else torch.zeros_like(mat)
    counts = kernels._counts(dev)
    rc = lib.zdr_direct_env_bvh(
        params, tables.data_ptr(), tables.numel(), int(shared), kernels._bn_ptr(tb),
        mat.data_ptr(), lanes.data_ptr(), None if le is None else le.data_ptr(), acc.data_ptr(),
        None if grad is None else grad.data_ptr(), *kernels.bvh_args(tb.bvh, dev),
        counts.data_ptr(), n, *kernels.env_args(tb.env, dev),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels._raise_on(rc, "zdr_direct_env_bvh")
    return acc, grad, counts


def scene_of(cs, name, env_h, dev):
    """The study's scene `name` under make_test_envmap(env_h, 2 env_h)."""
    from zdr_tpu_torch.envmap import make_test_envmap

    if name.startswith("example"):
        scene = cs._example(dev)
        if env_h != 256:
            scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
        return scene
    scene = cs._bigmesh(dev, "direct")
    scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
    return scene


def inputs(cs, scene, dev):
    """The scene's main-path inputs -> (tables at seed 0, tables at seed 1,
    lanes, material, adjoint)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    data = scene._render_data("direct")
    cfg = scene._config(cs.RES, cs.SPP)
    tb, tb1 = (pl.build_loop_tables(data, scene.camera, cfg, s) for s in (0, 1))
    if tb.bvh is None or tb.env is None:
        raise SystemExit("not the env BVH route")
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((512, 512, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    return tb, tb1, lanes, mat, le


def time_build(cs, lib, inp, ref=None, check_grad=True):
    """A build's env BVH kernels on `inp`, held against `ref` (production's
    outputs) -> ({fwd_ms, grad_ms, ...}, its outputs)."""
    tb, tb1, lanes, mat, le = inp
    acc, _g, counts = env_launch(lib, tb, lanes, mat, None)
    _a, grad, gcounts = env_launch(lib, tb1, lanes, mat, le)
    torch.cuda.synchronize()
    if ref is not None:
        if not torch.equal(acc, ref[0]):
            raise SystemExit(f"the forward differs from production's in "
                             f"{int((acc != ref[0]).any(0).sum())} lanes")
        if check_grad:
            cs._assert_grad_close(grad, ref[1], "the gradient against production's")
    fwd = cs._event_ms(lambda: env_launch(lib, tb, lanes, mat, None))
    bwd = cs._event_ms(lambda: env_launch(lib, tb1, lanes, mat, le))
    n = lanes.shape[1] * tb.spp
    c = counts.tolist()
    row = {"fwd_ms": fwd[0], "grad_ms": bwd[0], "fwd_runs": fwd[1], "grad_runs": bwd[1],
           "tests_a_sample": c[0] / n, "visits_a_sample": c[1] / n, "counts": c,
           "grad_counts": gcounts.tolist()}
    return row, (acc, grad)


def below_share(tb, lanes, mat, stride=64, samples=8):
    """The plain direct samples of every `stride`-th lane, the first
    `samples` of each -> {shading lanes, those whose light sample takes the
    env, and of these the ones below the shading hemisphere (wll.z < 1e-4:
    the kernel's nee_ok test), and of all shading lanes those below}."""
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.microfacet import make_onb, to_local

    sub = pl.pixel_lanes(tb.res, samples, lanes.device)[:, ::stride].contiguous()
    tally = dict(shading=0, env=0, env_below=0, below=0)
    shade = dr.shade_plain

    def counted(scene, ray, nee, *args, **kw):
        on = ray[12] != 0
        t, b = make_onb(ray[3:6])
        below = on & (to_local(t, b, ray[3:6], nee[0:3])[2] < 1e-4)
        env = on & (nee[3] == 1e30)
        tally["shading"] += int(on.sum())
        tally["env"] += int(env.sum())
        tally["env_below"] += int((env & below).sum())
        tally["below"] += int(below.sum())
        return shade(scene, ray, nee, *args, **kw)

    dr.shade_plain = counted
    try:
        dr.render_direct_plain(tb, sub, mat)
    finally:
        dr.shade_plain = shade
    tally["env_below_share"] = tally["env_below"] / max(tally["env"], 1)
    tally["below_share"] = tally["below"] / max(tally["shading"], 1)
    return tally


# ------------------------------------------------------------- the path kernels

GRAD = "path_loop_grad.cu"
# a value the compiler cannot know and that is 0 at run time (loop_step's)
ZERO_L = ws.ZERO
CLOSEST = "  Hit hit = closest_interact(tb, q, o_n, d_n, pdf_prev, in_flight_n, tr, c);\n"
CLOSEST2 = f"""  {{
    float again_t = kTMax, again_u = 0.0f, again_v = 0.0f;
    int again = tr.closest(tb, q, v3(o_n.x + {ZERO_L}, o_n.y, o_n.z), d_n, again_t, again_u,
                           again_v, nullptr);
    o_n.x += again < -1 ? 1.0f : 0.0f;
  }}
""" + CLOSEST
# the shadow walk: on every shading lane (before the redesign), or under the
# env only where the light sample lies above the hemisphere
P_SHADOW = "  bool occ = shade && tr.any(tb, q, s.p, s.wl, s.l_dist, c);\n"
P_SHADOW2 = f"""  bool occ_again =
      shade && tr.any(tb, q, v3(s.p.x + {ZERO_L}, s.p.y, s.p.z), s.wl, s.l_dist, nullptr);
""" + P_SHADOW + "  occ = occ_again == occ ? occ : occ_again;\n"
P_SKIP = ("    occ = shade && wi_light_local.z >= 1e-4f && tr.any(tb, q, s.p, s.wl, s.l_dist, "
          "c);\n")
P_SKIP2 = f"""    bool occ_again = shade && wi_light_local.z >= 1e-4f &&
                     tr.any(tb, q, v3(s.p.x + {ZERO_L}, s.p.y, s.p.z), s.wl, s.l_dist, nullptr);
""" + P_SKIP + "    occ = occ_again == occ ? occ : occ_again;\n"
ROUGH = """      float p3 = ggx_spec_droughness(wo_local, wi_light_local, rough,
                                     ggx_spec_cotangent(ct.x, ct.y, ct.z, wlz));
      float u0 = wi_local.z / kPi;
      // the plain version's unit cotangent on all three channels, a third
      // of it for one channel's S
      float u3 = ggx_spec_droughness(wo_local, wi_local, rough,
                                     ggx_spec_cotangent(1.0f, 1.0f, 1.0f, wi_local.z)) *
                 (1.0f / 3.0f);
"""
ROUGH2 = f"""      float again_p3 = ggx_spec_droughness(wo_local, wi_light_local, rough + {ZERO_L},
                                           ggx_spec_cotangent(ct.x, ct.y, ct.z, wlz));
      float again_u3 = ggx_spec_droughness(wo_local, wi_local, rough + {ZERO_L},
                                           ggx_spec_cotangent(1.0f, 1.0f, 1.0f, wi_local.z));
""" + ROUGH + "      u3 = again_p3 + again_u3 == 1234.5f ? again_u3 : u3;\n"
ATOMIC = "  atomicAdd(reinterpret_cast<float4*>(grad) + id, make_float4(a, b, c, d));\n"
REPLAY = "      if (last >= 0) replay_sample(*gl, last, q.tex_h * q.tex_w);\n"
DENSE_BOUNDS = "__launch_bounds__(kBlock)\n    path_loop_grad_kernel("
# the forward kernels' bounds (path_loop.cu); a cap build applies to the
# env instantiations alone, by kEnv in the bound, as the BVH gradient's does
FWD_DENSE_BOUNDS = "__launch_bounds__(512, 2)\n    path_loop_kernel("
FWD_BVH_BOUNDS = "__launch_bounds__(256, 4)\n    path_loop_bvh_kernel("
# the BVH kernel's bounds before the redesign and after it (the env
# instantiation at 8 blocks an SM)
BVH_BOUNDS = ("__launch_bounds__(kBlock, 4)\n    path_loop_grad_bvh_kernel(",
              "__launch_bounds__(kBlock, kEnv ? 8 : 4)\n    path_loop_grad_bvh_kernel(")
BLOCK = "constexpr int kBlock = 128;\n"
# name -> [(file, old or (old, ...), new)]
PATH_BUILDS = {
    "production": [],
    "closest2x": [(LOOPSTEP, CLOSEST, CLOSEST2)],
    "shadow2x": [[(LOOPSTEP, P_SHADOW, P_SHADOW2), (LOOPSTEP, P_SKIP, P_SKIP2)]],
    "envdraw2x": [(LOOPSTEP, ENVDRAW, ENVDRAW2)],
    "miss2x": [(LOOPSTEP, MISS, MISS_ONCE), (LOOPSTEP, MISS_AT, MISS_TWICE + MISS_AT)],
    "rough2x": [(LOOPSTEP, ROUGH, ROUGH2)],
    "noatomic": [(LOOPSTEP, ATOMIC, "  if (a + b + c + d == 1e-38f) grad[0] = a;\n")],
    "noreplay": [(LOOPSTEP, REPLAY, "")],
    "grad_b64": [(GRAD, BLOCK, BLOCK.replace("128", "64"))],
    "grad_b256": [(GRAD, BLOCK, BLOCK.replace("128", "256"))],
    "dense_min5": [(GRAD, DENSE_BOUNDS, DENSE_BOUNDS.replace("(kBlock)", "(kBlock, 5)"))],
    **{f"bvh_{k}": [(GRAD, BVH_BOUNDS,
                     f"__launch_bounds__(kBlock{v})\n    path_loop_grad_bvh_kernel(")]
       for k, v in (("min3", ", 3"), ("min4", ", 4"), ("min5", ", 5"), ("uncapped", ""))},
    # the env forwards at B threads a block and R registers (65536 / (B x
    # blocks an SM)): production's are 512 x 2 dense and 256 x 4 on the BVH
    "fwd_dense_b256r64": [("path_loop.cu", FWD_DENSE_BOUNDS,
                           "__launch_bounds__(kEnv ? 256 : 512, kEnv ? 4 : 2)\n"
                           "    path_loop_kernel(")],
    **{f"fwd_bvh_b128r{r}": [("path_loop.cu", FWD_BVH_BOUNDS,
                              f"__launch_bounds__(kEnv ? 128 : 256, kEnv ? {m} : 4)\n"
                              "    path_loop_bvh_kernel(")]
       for r, m in ((64, 8), (80, 6))},
}
# the builds whose edits change the gradient alone (their forward is
# production's), and those that change what the gradient computes
GRAD_ONLY = ("rough2x", "noatomic", "noreplay", "grad_b64", "grad_b256", "dense_min5",
             "bvh_min3", "bvh_min4", "bvh_min5", "bvh_uncapped")
# the builds whose edits change the forward alone (their gradient is
# production's, and is not timed again)
FWD_ONLY = ("fwd_dense_b256r64", "fwd_bvh_b128r64", "fwd_bvh_b128r80")
NOT_GRAD = ("noatomic", "noreplay")
PATH_SPLIT = ("closest2x", "shadow2x", "envdraw2x", "miss2x")
GRAD_SPLIT = PATH_SPLIT + ("rough2x",)
PATH_KERNELS = ("path_loop", "path_loop_grad", "path_loop_env", "path_loop_grad_env",
                "path_loop_bvh", "path_loop_grad_bvh", "path_loop_env_bvh",
                "path_loop_grad_env_bvh")
PATH_SCENES = (("flagship", 256), ("env_scene", 128), ("big mesh", 256),
               ("flagship 1024x2048", 1024))
LOOP_ENTRIES = ("zdr_path_loop_env", "zdr_path_loop_env_bvh")
GRAD_ENTRIES = ("zdr_path_loop_grad_plan", "zdr_path_loop_grad_env",
                "zdr_path_loop_grad_env_bvh")


def build_path():
    """Copy, edit and compile every path build, all nvcc processes at once
    -> ({name: (forward entries, gradient entries)}, {name: ptxas of the
    path kernels})."""
    import chip_smoke as cs
    from zdr_tpu_torch import kernels

    root = os.path.join(BUILD, "path")
    shutil.rmtree(root, ignore_errors=True)
    running = []
    for name, edits in PATH_BUILDS.items():
        src = os.path.join(root, name)
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("__pycache__"))
        _edit(name, src, edits)
        sources = ([GRAD] if name in GRAD_ONLY else
                   ["path_loop.cu"] if name in FWD_ONLY else ["path_loop.cu", GRAD])
        for source in sources:
            out = os.path.join(root, f"lib{name}_{source[:-3]}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, source)]
            running.append((name, source, cmd, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    prod = kernels.load_library()
    libs, logs = {}, {}
    for name, source, cmd, out, proc in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        logs[name] = logs.get(name, "") + log
        lib = ctypes.CDLL(out)
        entries = LOOP_ENTRIES if source == "path_loop.cu" else GRAD_ENTRIES
        libs.setdefault(name, {}).update({e: kernels._bind(lib, e, getattr(prod, e).argtypes)
                                          for e in entries})
    reports = {}
    for name, entries in libs.items():
        if name in GRAD_ONLY:
            entries.update({e: libs["production"][e] for e in LOOP_ENTRIES})
        if name in FWD_ONLY:
            entries.update({e: libs["production"][e] for e in GRAD_ENTRIES})
        report = cs.ptxas_bvh(logs[name])
        reports[name] = {k: [report[k][f] for f in ("registers", "local_bytes", "spill_stores",
                                                     "spill_loads")]
                         for k in PATH_KERNELS if k in report}
    return {k: types.SimpleNamespace(**v) for k, v in libs.items()}, reports


def path_scene(cs, name, env_h, dev):
    """The study's path scene `name` (PATH_SCENES)."""
    from zdr_tpu_torch.envmap import make_test_envmap

    if name == "env_scene":
        return cs._env_scene(dev)
    scene = cs._bigmesh(dev, "path") if name == "big mesh" else cs._flagship(dev)
    scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
    return scene


def path_inputs(cs, scene, dev):
    """The scene's main-path inputs -> (tables at seed 0, tables at seed 1,
    lanes, material, adjoint)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    data = scene._render_data("path")
    cfg = scene._config(cs.RES, cs.SPP)
    tb, tb1 = (pl.build_loop_tables(data, scene.camera, cfg, s) for s in (0, 1))
    if tb.env is None:
        raise SystemExit("not an env scene")
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    return tb, tb1, lanes, mat, le


def time_path_build(cs, lib, inp, ref=None, check_grad=True, time_grad=True):
    """A build's path env kernels on `inp`, held against `ref` (production's
    outputs) -> ({fwd_ms, grad_ms, ...}, its outputs); grad_ms None where
    time_grad is false."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    tb, tb1, lanes, mat, le = inp

    def fwd():
        return kernels.loop_launch(lib, tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)

    def bwd():
        return kernels.grad_launch(lib, tb1, lanes, mat, le, tb1.n_steps)

    carry, counts, plan = fwd()
    grad, _carry, gcounts, gplan = bwd()
    torch.cuda.synchronize()
    acc = carry.f[0:3]
    if ref is not None:
        if not torch.equal(acc, ref[0]):
            raise SystemExit(f"the forward differs from production's in "
                             f"{int((acc != ref[0]).any(0).sum())} lanes")
        if check_grad:
            cs._assert_grad_close(grad, ref[1], "the gradient against production's")
    f_ms = cs._event_ms(fwd)
    g_ms = cs._event_ms(bwd) if time_grad else (None, None)
    n = lanes.shape[1] * tb.spp
    row = {"fwd_ms": f_ms[0], "grad_ms": g_ms[0], "fwd_runs": f_ms[1], "grad_runs": g_ms[1],
           "fwd_plan": plan, "grad_plan": gplan}
    if counts is not None:
        c, g = counts.tolist(), gcounts.tolist()
        row.update(tests_a_sample=c[0] / n, visits_a_sample=c[1] / n,
                   grad_tests_a_sample=g[0] / n, grad_visits_a_sample=g[1] / n)
    return row, (acc, grad)


def path_below_share(tb, lanes, mat, stride=64, samples=4):
    """The plain path walk of every `stride`-th lane, the first `samples`
    samples of each -> {shading steps, their light samples that take the env
    and those that do not, and of each those below the shading hemisphere
    (wll.z < 1e-4, loop_step's frame), with the shares}."""
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.microfacet import make_onb, to_local

    sub = pl.pixel_lanes(tb.res, samples, lanes.device)[:, ::stride].contiguous()
    fi, ii = pl.F_IDX, pl.I_IDX
    tally = dict(shading=0, env=0, env_below=0, mesh=0, mesh_below=0)
    carry = pl.init_carry(sub)
    for _ in range(tb.n_steps):
        if not bool((carry.i[ii["sample_idx"]] < sub[2]).any()):
            break
        shade = (carry.i[ii["in_flight"]] != 0) & (carry.i[ii["shade"]] != 0)
        ns = tuple(carry.f[fi[k]] for k in ("ns_x", "ns_y", "ns_z"))
        wl = tuple(carry.f[fi[k]] for k in ("wl_x", "wl_y", "wl_z"))
        t_, b_ = make_onb(ns)
        below = shade & (to_local(t_, b_, ns, wl)[2] < 1e-4)
        env = shade & (carry.f[fi["l_dist"]] == 1e30)
        tally["shading"] += int(shade.sum())
        tally["env"] += int(env.sum())
        tally["env_below"] += int((env & below).sum())
        tally["mesh"] += int((shade & ~env).sum())
        tally["mesh_below"] += int((shade & ~env & below).sum())
        carry = pl.loop_step(carry, tb, sub, mat)
    for k in ("env", "mesh"):
        tally[f"{k}_below_share"] = tally[f"{k}_below"] / max(tally[k], 1)
    tally["below_share"] = (tally["env_below"] + tally["mesh_below"]) / max(tally["shading"], 1)
    return tally


def _share_note(share):
    return (f"shading steps {share['shading']}: env samples {share['env']}, "
            f"{share['env_below_share']:.1%} below the hemisphere; mesh or point samples "
            f"{share['mesh']}, {share['mesh_below_share']:.1%} below; all "
            f"{share['below_share']:.1%}")


def main_path(cs, dev, smi, out_path):
    """The path env kernels' split (--integrator path)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    libs, reports = build_path()
    out = {"card": smi, "ptxas": reports, "scenes": {}, "no_env": {}}
    print(f"[path ptxas] the path kernels of production [registers, stack frame (local) bytes, "
          f"spill stores, spill loads]: {json.dumps(reports['production'])}; the env "
          f"kernels of every build: "
          + json.dumps({k: {e: v.get(e) for e in PATH_KERNELS if "_env" in e}
                        for k, v in reports.items()}) + f"; card {smi}", flush=True)
    for scene_name, env_h in PATH_SCENES:
        inp = path_inputs(cs, path_scene(cs, scene_name, env_h, dev), dev)
        prod, ref = time_path_build(cs, libs["production"], inp)
        rows = {"production": prod}
        for name in libs:
            if name != "production":
                rows[name] = time_path_build(cs, libs[name], inp, ref,
                                             check_grad=name not in NOT_GRAD,
                                             time_grad=name not in FWD_ONLY)[0]
        base_f, base_g = prod["fwd_ms"], prod["grad_ms"]
        split = {k: (rows[k]["fwd_ms"] - base_f) / base_f for k in PATH_SPLIT}
        gsplit = {k: (rows[k]["grad_ms"] - base_g) / base_g for k in GRAD_SPLIT}
        split["rest"], gsplit["rest"] = 1.0 - sum(split.values()), 1.0 - sum(gsplit.values())
        gsplit["atomics"] = (base_g - rows["noatomic"]["grad_ms"]) / base_g
        gsplit["replay"] = (rows["noatomic"]["grad_ms"] - rows["noreplay"]["grad_ms"]) / base_g
        share = path_below_share(inp[0], inp[2], inp[3])
        out["scenes"][scene_name] = dict(builds=rows, split=split, grad_split=gsplit,
                                         below=share)
        print(f"[path split] {scene_name} ({'BVH' if inp[0].bvh is not None else 'dense'}): "
              f"production forward {base_f:.4f} ms, gradient {base_g:.4f} ms"
              + (f", {prod['tests_a_sample']:.3f} tests and {prod['visits_a_sample']:.3f} "
                 f"visits a sample" if "tests_a_sample" in prod else "")
              + "; the forward's shares: " + ", ".join(f"{k} {v:.1%}" for k, v in split.items())
              + "; the gradient's: " + ", ".join(f"{k} {v:.1%}" for k, v in gsplit.items())
              + f"; {_share_note(share)}; builds (fwd / grad ms): "
              + ", ".join(f"{k} {v['fwd_ms']:.4f} / "
                          + ("-" if v["grad_ms"] is None else f"{v['grad_ms']:.4f}")
                          for k, v in rows.items())
              + f"; card {smi}", flush=True)
    # the no-env kernels' light samples below the hemisphere: the flagship
    # (path) and the direct protocol by accel="auto"
    flag = cs._flagship(dev)
    cfg = flag._config(cs.RES, cs.SPP)
    tb = pl.build_loop_tables(flag._render_data("path"), flag.camera, cfg, 0)
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    out["no_env"]["flagship"] = path_below_share(tb, lanes, mat)
    proto = cs._protocol(dev, "auto")
    tbp = pl.build_loop_tables(proto._render_data("direct"), proto.camera,
                               proto._config(cs.RES, cs.PROTOCOL_SPP), 0)
    lanes_p = pl.pixel_lanes(cs.RES, cs.PROTOCOL_SPP, dev)
    out["no_env"]["protocol"] = below_share(tbp, lanes_p, mat)
    print(f"[path split] without an env: the flagship (path) "
          f"{_share_note(out['no_env']['flagship'])}; the protocol (direct, auto) "
          f"{json.dumps(out['no_env']['protocol'])}; card {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", help="the JSON written")
    ap.add_argument("--integrator", choices=("direct", "path"), default="direct")
    args = ap.parse_args()
    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = "env_split_path.json" if args.integrator == "path" else "env_split.json"
    out_path = args.out or os.path.join(HERE, "_build", name)
    if args.integrator == "path":
        return main_path(cs, dev, smi, out_path)
    libs, reports = build_all()
    out = {"card": smi, "ptxas": reports, "scenes": {}}
    print(f"[env ptxas] the direct env kernels of production [registers, stack frame (local) "
          f"bytes, spill stores, spill loads]: {json.dumps(reports['production'])}; the env "
          f"BVH kernels of every build: "
          + json.dumps({k: {e: v[e] for e in ENV_KERNELS[4:]} for k, v in reports.items()})
          + f"; card {smi}", flush=True)
    for scene_name, env_h in SCENES:
        inp = inputs(cs, scene_of(cs, scene_name, env_h, dev), dev)
        prod, ref = time_build(cs, libs["production"], inp)
        rows = {"production": prod}
        for name in libs:
            if name != "production":
                rows[name] = time_build(cs, libs[name], inp, ref,
                                        check_grad=name != "noatomic")[0]
        base_f, base_g = prod["fwd_ms"], prod["grad_ms"]
        split = {k: (rows[k]["fwd_ms"] - base_f) / base_f for k in SPLIT}
        gsplit = {k: (rows[k]["grad_ms"] - base_g) / base_g for k in SPLIT}
        split["rest"], gsplit["rest"] = 1.0 - sum(split.values()), 1.0 - sum(gsplit.values())
        atomics = (base_g - rows["noatomic"]["grad_ms"]) / base_g
        share = below_share(*inp[:1], inp[2], inp[3])
        out["scenes"][scene_name] = dict(builds=rows, split=split, grad_split=gsplit,
                                         atomic_share=atomics, below=share)
        print(f"[env split] {scene_name}: production direct_env_bvh {base_f:.4f} ms, "
              f"direct_grad_env_bvh {base_g:.4f} ms, {prod['tests_a_sample']:.3f} tests and "
              f"{prod['visits_a_sample']:.3f} visits a sample; direct_env_bvh's share: "
              + ", ".join(f"{k} {v:.1%}" for k, v in split.items())
              + "; direct_grad_env_bvh's: " + ", ".join(f"{k} {v:.1%}" for k, v in gsplit.items())
              + f"; atomics {atomics:.1%}; shading lanes {share['shading']}, their env samples "
              f"{share['env']}, below the hemisphere {share['env_below']} "
              f"({share['env_below_share']:.1%} of the env samples; all light samples below "
              f"{share['below_share']:.1%} of shading lanes); builds (fwd / grad ms): "
              + ", ".join(f"{k} {v['fwd_ms']:.4f} / {v['grad_ms']:.4f}" for k, v in rows.items())
              + f"; card {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
