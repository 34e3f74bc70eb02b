#!/usr/bin/env python3
"""The direct integrator's env BVH kernels (direct_env_bvh,
direct_grad_env_bvh) against builds of them that each differ in one thing,
on one CUDA card: where their time goes, their register caps and blocks,
ptxas's report of the four direct env kernels, and how many shading lanes
draw an env sample below their hemisphere.

    python3 studies/env_split.py [OUT.json]

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
studies/_build/env_split.json). Runs from the root of a checkout; imports
nothing of JAX.
"""

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


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "_build",
                                                                   "env_split.json")
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
