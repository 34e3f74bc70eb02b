#!/usr/bin/env python3
"""The path-loop gradient kernel against builds of it that each differ in
one thing, on one CUDA card: where its time goes and what its design chose.

    python3 studies/grad_split.py

Each build is a copy of zdr_tpu_torch/kernels/csrc/ (with replay_warp.cuh
beside it) under the textual edits of BUILDS, each of which must match its
file exactly once, compiled with the package's nvcc flags into
studies/_build/ (git-ignored), all builds at once. Every build keeps the
package's C entries, so kernels.grad_launch launches it. The inputs are
chip_smoke.py's: the flagship (phase 8: cornell box, pmj02bn, 512x512, 64
spp, 1024^2 material of 0.5, the dense route) and the big mesh (phase 13:
50,882 triangles, the BVH route), the backward at seed 1 with the adjoint
1 / spp. The builds:
  no_atomics    every tap computed, none added;
  no_replay     the rows stored, none replayed;
  no_rows       no row stored, none replayed; so the kernel's time splits
                into the atomics (production - no_atomics), the replay
                (no_atomics - no_replay), the rows and their math
                (no_replay - no_rows) and the walk (no_rows);
  warp          the warp replays its finished samples together
                (replay_warp.cuh) instead of each lane its own;
  count         warp, counting the replay's work: its active lanes a warp
                each way, and the samples by their rows;
  block64, block256   other blocks;
  bvh_uncapped  the BVH kernel without its 4-blocks-an-SM register cap;
  min5          both kernels compiled for 5 blocks an SM;
and the production build at 0 to 8 tap rows a sample in shared memory.
Each build's gradient is held against the production kernel's at
chip_smoke.py's bars (but the split's, which compute another function).
CUDA events, the median of 5 after a warm-up. One line a route. Imports
nothing of JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "_build")
STEP, GRAD = "path_loop_step.cuh", "path_loop_grad.cu"

ATOMIC = "  atomicAdd(reinterpret_cast<float4*>(grad) + id, make_float4(a, b, c, d));\n"
REPLAY = "      if (last >= 0) replay_sample(*gl, last, q.tex_h * q.tex_w);\n"
STORE = "      for (int k = 0; k < kRowPlanes; ++k) dst[(long)k * st] = row[k];\n"
STEP_MARK = "// --------------------------------------------------------------- the step\n"
LOOP_TOP = "    if (s.sample_idx >= lc.stop && s.in_flight == 0) break;\n"
WARP_LOOP = """#ifdef __CUDA_ARCH__
    if constexpr (kGrad) {
      bool live = !(s.sample_idx >= lc.stop && s.in_flight == 0);
      if (!__any_sync(0xffffffffu, live)) break;
      int done = live ? loop_step<true>(s, lc, tb, q, gl, tr, c) : -1;
      replay_warp(*gl, done, q.tex_h * q.tex_w);
      continue;
    }
#endif
"""
WARP = [(STEP, STEP_MARK, '#include "replay_warp.cuh"\n\n' + STEP_MARK),
        (STEP, LOOP_TOP, WARP_LOOP + LOOP_TOP)]
# name -> ([(file, old, new)], extra nvcc flags)
BUILDS = {
    # keeps the tap's sum live without adding it
    "no_atomics": ([(STEP, ATOMIC, "  if (a + b + c + d == 1e-38f) grad[0] = a;\n")], ()),
    "no_replay": ([(STEP, REPLAY, "")], ()),
    "no_rows": ([(STEP, REPLAY, ""), (STEP, STORE, "")], ()),
    "warp": (WARP, ()),
    "count": (WARP, ("-DSTUDY_COUNT",)),
    "block64": ([(GRAD, "constexpr int kBlock = 128;", "constexpr int kBlock = 64;")], ()),
    "block256": ([(GRAD, "constexpr int kBlock = 128;", "constexpr int kBlock = 256;")], ()),
    "bvh_uncapped": ([(GRAD, "__launch_bounds__(kBlock, 4)", "__launch_bounds__(kBlock)")], ()),
    "min5": ([(GRAD, "__launch_bounds__(kBlock, 4)", "__launch_bounds__(kBlock, 5)"),
              (GRAD, "__launch_bounds__(kBlock)\n", "__launch_bounds__(kBlock, 5)\n")], ()),
}
COUNTS = 36  # replay_warp.cuh kStudyCounts
NEAR_ROWS = (0, 2, 4, 6, 8)


def build_all():
    """Copy, edit and compile every build, all nvcc processes at once ->
    {name: library}."""
    from zdr_tpu_torch import kernels

    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name, (edits, flags) in BUILDS.items():
        src = os.path.join(BUILD, name)
        shutil.copytree(kernels.CSRC, src)
        shutil.copy(os.path.join(HERE, "replay_warp.cuh"), src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit of {fname} matches {text.count(old)} times:"
                                 f"\n{old}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        out = os.path.join(BUILD, f"lib{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o", out,
               os.path.join(src, GRAD)]
        running[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cmd, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{log}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        libs[name] = types.SimpleNamespace(**{
            entry: kernels._bind(lib, entry, getattr(kernels.load_library(), entry).argtypes)
            for entry in ("zdr_path_loop_grad", "zdr_path_loop_grad_bvh",
                          "zdr_path_loop_grad_plan")})
        if name == "count":
            libs[name].zdr_study_counts = kernels._bind(lib, "zdr_study_counts",
                                                        [ctypes.c_void_p, ctypes.c_int])
    return libs


def inputs(cs, route, dev):
    """chip_smoke.py's backward of the flagship or the big mesh (path) ->
    (tables, lanes, material, adjoint)."""
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = cs._flagship(dev) if route == "dense" else cs._bigmesh(dev, "path")
    tb = pl.build_loop_tables(scene._render_data("path"), scene.camera,
                              scene._config(cs.RES, cs.SPP), 1)
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    return tb, lanes, mat, le


def study(cs, route, libs, dev, smi):
    from zdr_tpu_torch import kernels

    tb, lanes, mat, le = inputs(cs, route, dev)
    prod = kernels.load_library()
    runs = {"production": (prod, None), **{f"k{k}": (prod, k) for k in NEAR_ROWS},
            **{name: (lib, None) for name, lib in libs.items()},
            **{f"{name} k{k}": (libs[name], k) for name in ("bvh_uncapped", "min5")
               for k in (0, 2)}}
    want = kernels.grad_launch(prod, tb, lanes, mat, le, tb.n_steps)[0]
    ms, notes = {}, []
    for name, (lib, k_cap) in runs.items():
        def call(lib=lib, k_cap=k_cap):
            return kernels.grad_launch(lib, tb, lanes, mat, le, tb.n_steps, k_cap)
        grad, _carry, _c, plan = call()
        torch.cuda.synchronize()
        err = ""
        if not name.startswith("no_"):
            err = f"; worst texel rel err {cs._assert_grad_close(grad, want, name)[1]:.2e}"
        ms[name] = cs._event_ms(call)[0]
        notes.append(f"{name} {ms[name]:.2f} ms ({plan['k_near']} near rows, block "
                     f"{plan['block']}, {plan['registers']} registers, {plan['blocks_per_sm']} "
                     f"blocks an SM, {plan['local_bytes']} bytes of local memory{err})")
    count = libs["count"]
    counts = (ctypes.c_ulonglong * COUNTS)()
    kernels._raise_on(count.zdr_study_counts(None, 1), "zdr_study_counts")
    kernels.grad_launch(count, tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    kernels._raise_on(count.zdr_study_counts(counts, 0), "zdr_study_counts")
    steps, rows, most, chunks, *hist = list(counts)
    k = kernels.GRAD_NEAR_ROWS[route]
    far = sum((r - k) * h for r, h in enumerate(hist) if r > k)
    print(f"[grad split] {route}: {tb.scene.shape[0]} tris, pmj02bn {cs.RES[0]}x{cs.RES[1]} "
          f"{cs.SPP} spp, CUDA events, median of 5: " + "; ".join(notes)
          + f"; split (ms): atomics {ms['production'] - ms['no_atomics']:.2f}, replay "
          f"{ms['no_atomics'] - ms['no_replay']:.2f}, tap rows and math "
          f"{ms['no_replay'] - ms['no_rows']:.2f}, the walk {ms['no_rows']:.2f}; the replay's "
          f"active lanes a warp: {rows / max(most, 1):.2f} when each finishing lane replays "
          f"its own rows, {rows / max(chunks, 1):.2f} of 32 when the warp deals them out "
          f"({steps} replay steps of a warp, {rows} rows); samples by their rows (1 ..): "
          f"{hist[1:17]}; rows past the route's {k} near ones: {far / max(rows, 1):.3%}; card "
          f"{smi}", flush=True)


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = build_all()
    for route in ("dense", "bvh"):
        study(cs, route, libs, dev, smi)


if __name__ == "__main__":
    main()
