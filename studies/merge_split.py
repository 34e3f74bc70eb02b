#!/usr/bin/env python3
"""Where the merged path gradient kernel's time goes: the kMerge
instantiation of path_loop_grad (splat_merge 4) against builds of it that
each differ in one thing, on one CUDA card.

    python3 studies/merge_split.py

Each build is a copy of zdr_tpu_torch/kernels/csrc/ under the textual
edits of BUILDS (each must match its file exactly once), compiled from
path_loop_grad.cu with the package's nvcc flags into studies/_build/
(git-ignored), all builds at once; kernels.grad_launch launches each. The
inputs are chip_smoke.py's phase 8 (the flagship: cornell box, pmj02bn,
512x512, 64 spp, 1024^2 material of 0.5, the dense route, the backward at
seed 1 with the adjoint 1 / spp), at splat_merge 4 and at 1 (the
production kernel without the merge). The builds:
  noinline      replay_merge kept out of line (__noinline__);
  no_merge      each real tap added on its own (no reservoir math; the
                gradient is then splat_merge 1's);
  no_forward    replay_merge's second pass skipped (no merge, no atomic);
  no_replay     no finished sample replayed (the rows stored, not read);
  shift         the group of a step by a shift (merge 4) where the kernel
                divides by the runtime merge;
  no_div        the merge's scale tot / w taken as 1 (no division);
  fast_div      the scale by __fdividef (approximate) in place of div_rn;
  ieee_div      the scale by the compiler's correctly rounded division,
                tot / w (its range check and out-of-line slow path);
  double_div    the scale divided in double precision and rounded to float
                (the correctly rounded float quotient: 53 >= 2 * 24 + 2
                bits make the double rounding innocuous);
  div_check     the production kernels and an entry that counts where
                div_rn differs from the compiler's division on DIV_PAIRS
                random pairs of positive normal floats (the merge's
                operands: a dividend up to 2^12 times the divisor).
CUDA events, the median of 5 after a warm-up; ptxas's registers and
spills of each build. Imports nothing of JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "studies", "_build", "merge")
STEP, GRAD = "path_loop_step.cuh", "path_loop_grad.cu"

MERGE_CALL = "      merge_taps(pend, id, t, row[13 * st], n_bins);\n"
REPLAY_CALL = ("      if (last >= 0) replay_merge(*gl, last, it - last, merge, q.tex_h * q.tex_w, "
               "pend);\n")
DIV_PAIRS = 1 << 24
DIV_CHECK = """
__global__ void div_check_kernel(const float* a, const float* b, int n, unsigned* bad) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n && __float_as_uint(zdr::div_rn(a[k], b[k])) != __float_as_uint(a[k] / b[k]))
    atomicAdd(bad, 1u);
}

int zdr_div_check(const float* a, const float* b, int n, unsigned* bad) {
  div_check_kernel<<<(n + 255) / 256, 256>>>(a, b, n, bad);
  return (int)cudaGetLastError();
}

"""
SCALE = "  float scale = div_rn(tot, jmax(take_p ? wp : wn, 1e-30f));\n"
BUILDS = {
    "noinline": [(STEP, "ZDR_HD void replay_merge(",
                  "__host__ __device__ __noinline__ void replay_merge(")],
    "no_merge": [(STEP, MERGE_CALL, "      splat_add4(gl.grad, id, t[0], t[1], t[2], t[3]);\n")],
    "no_forward": [(STEP, "  for (int r = 0; r <= last; ++r) {\n    long st;\n    const float* row",
                    "  for (int r = 0; r < 0; ++r) {\n    long st;\n    const float* row")],
    "no_replay": [(STEP, REPLAY_CALL, "")],
    "shift": [(STEP, "    int group = (it0 + r) / merge;\n", "    int group = (it0 + r) >> 2;\n")],
    "no_div": [(STEP, SCALE, "  float scale = 1.0f;\n")],
    "fast_div": [(STEP, SCALE, "#ifdef __CUDA_ARCH__\n"
                  "  float scale = __fdividef(tot, jmax(take_p ? wp : wn, 1e-30f));\n"
                  "#else\n" + SCALE + "#endif\n")],
    "ieee_div": [(STEP, SCALE, "  float scale = tot / jmax(take_p ? wp : wn, 1e-30f);\n")],
    "div_check": [(GRAD, '}  // extern "C"\n', DIV_CHECK + '}  // extern "C"\n')],
    "double_div": [(STEP, SCALE, "  float scale = (float)((double)tot / "
                    "(double)jmax(take_p ? wp : wn, 1e-30f));\n")],
}


def build_all():
    """Copy, edit and compile every build, all nvcc processes at once ->
    ({name: library entries}, {name: ptxas log})."""
    from zdr_tpu_torch import kernels

    shutil.rmtree(BUILD, ignore_errors=True)
    running = {}
    for name, edits in BUILDS.items():
        src = os.path.join(BUILD, name)
        shutil.copytree(kernels.CSRC, src)
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
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(src, GRAD)]
        running[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (cmd, proc) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed ({' '.join(cmd)}):\n{logs[name]}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        libs[name] = types.SimpleNamespace(**{
            entry: kernels._bind(lib, entry, getattr(kernels.load_library(), entry).argtypes)
            for entry in ("zdr_path_loop_grad", "zdr_path_loop_grad_bvh",
                          "zdr_path_loop_grad_plan")})
        if name == "div_check":
            libs[name].zdr_div_check = kernels._bind(lib, "zdr_div_check", [ctypes.c_void_p] * 2
                                                     + [ctypes.c_int, ctypes.c_void_p])
    return libs, logs


def _merged_ptxas(log):
    """ptxas's line for the dense kMerge instantiation (no env, no kGen)."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "path_loop_grad_kernelILb0ELb0ELb1E" in ln and "Compiling entry" in ln:
            return " | ".join(x.split("ptxas info    :")[-1].strip() for x in lines[k + 1:k + 3])
    return "?"


def main():
    sys.path.insert(0, ROOT)
    import dataclasses

    import chip_smoke as cs
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs, logs = build_all()
    scene = cs._flagship(dev)
    tb1 = pl.build_loop_tables(scene._render_data("path"), scene.camera,
                               scene._config(cs.RES, cs.SPP), 1)
    tb4 = dataclasses.replace(tb1, splat_merge=4)
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    prod = kernels.load_library()
    runs = {"production merge 1": (prod, tb1), "production merge 4": (prod, tb4),
            **{name: (lib, tb4) for name, lib in libs.items()}}
    notes = []
    for name, (lib, tb) in runs.items():
        def call(lib=lib, tb=tb):
            return kernels.grad_launch(lib, tb, lanes, mat, le, tb.n_steps)
        plan = call()[3]
        ms, times = cs._event_ms(call)
        extra = f", ptxas {_merged_ptxas(logs[name])}" if name in logs else ""
        notes.append(f"{name} {ms:.2f} ms of {[round(t, 2) for t in times]} ({plan['k_near']} "
                     f"near rows, {plan['registers']} registers, {plan['blocks_per_sm']} blocks "
                     f"an SM, {plan['local_bytes']} bytes of local memory{extra})")
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.exp2(torch.empty(DIV_PAIRS, device=dev).uniform_(-99.0, 99.0, generator=gen))
    a = b * torch.exp2(torch.empty(DIV_PAIRS, device=dev).uniform_(0.0, 12.0, generator=gen))
    bad = torch.zeros((1,), dtype=torch.int32, device=dev)
    kernels._raise_on(libs["div_check"].zdr_div_check(a.data_ptr(), b.data_ptr(), DIV_PAIRS,
                                                      bad.data_ptr()), "div_check")
    print(f"[merge split] flagship pmj02bn {cs.RES[0]}x{cs.RES[1]} {cs.SPP} spp, CUDA events, "
          f"median of 5: " + "; ".join(notes) + f"; div_rn against the division on "
          f"{DIV_PAIRS} pairs: {int(bad)} differ; card {smi}", flush=True)


if __name__ == "__main__":
    main()
