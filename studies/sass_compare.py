#!/usr/bin/env python3
"""Compare the card's code of two checkouts' kernels, kernel by kernel.

    python3 studies/sass_compare.py OTHER_ROOT [OUT_JSON]

Builds each of SOURCES of this checkout and of OTHER_ROOT (e.g. a `git
archive` of the parent commit) to an sm_90a cubin with the package's nvcc
flags, disassembles both with `cuobjdump -sass`, and pairs their kernels by
name: the demangled name without its parameters, the anonymous namespace
and a lone <false> template argument, so that `path_loop_kernel<false>` (a
kernel given a kEnv argument) pairs with a `path_loop_kernel` of before it;
in a checkout whose kernels take the generic sampler's kGen as their last
template argument, that argument too where it is false, so that
`path_loop_kernel<true, false>` pairs with a `path_loop_kernel<true>` of
before it, and the kGen instantiations are new.
For each pair it prints whether the SASS is equal instruction for
instruction with the immediates aside (every hex literal and `.L_x_` label
replaced), the instruction counts, the first differing instruction, and
ptxas's registers, stack frame and spill bytes of both builds. Kernels
without a partner are listed as new or gone. Needs nvcc and cuobjdump (the
card's machine); writes OUT_JSON when given (e.g. studies/_build/sass.json).
"""

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "studies", "_build", "sass")
SOURCES = ("path_loop.cu", "path_loop_grad.cu", "direct.cu", "collocated.cu", "accel.cu",
           "sweep_variants.cu", "splat.cu")
CSRC = os.path.join("zdr_tpu_torch", "kernels", "csrc")


def _tool(name):
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else (shutil.which(name) or name)


def _flags():
    sys.path.insert(0, ROOT)
    from zdr_tpu_torch import kernels

    drop = {"-shared", "-fPIC"}
    flags = [f for f in kernels.NVCC_FLAGS if f not in drop]
    # -Xcompiler took -fPIC as its argument
    while "-Xcompiler" in flags:
        flags.remove("-Xcompiler")
    return flags


def _build(root, tag):
    """Each source of `root` -> (cubin paths, ptxas log), all nvcc at once."""
    out = os.path.join(BUILD, tag)
    os.makedirs(out, exist_ok=True)
    running = []
    for src in SOURCES:
        cubin = os.path.join(out, src.replace(".cu", ".cubin"))
        cmd = [_tool("nvcc"), *_flags(), "-cubin", "-o", cubin, os.path.join(root, CSRC, src)]
        running.append((cubin, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    cubins, log = [], ""
    for cubin, cmd, proc in running:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{tag}: build failed ({' '.join(cmd)}):\n{text}")
        cubins.append(cubin)
        log += text
    return cubins, log


def _demangle(names):
    if not names:
        return {}
    proc = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                          text=True, check=True)
    return dict(zip(names, proc.stdout.splitlines()))


def _key(demangled, gen=False):
    """A kernel's name without its return type, parameters, anonymous
    namespace and its trailing false template arguments (every one: a
    template argument added at the end, false in the instantiations that
    were there before it, as kGen and the splat knobs kMerge and kPacked,
    keeps their key; `gen` is kept for callers and no longer matters)."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", demangled)
    name = re.sub(r"\(bool\)0", "false", re.sub(r"\(bool\)1", "true", name))
    name = re.sub(r"^void ", "", name)
    name = name[:name.index("(")] if "(" in name else name
    while True:
        short = re.sub(r"<false>$", "", re.sub(r", false>$", ">", name))
        if short == name:
            return name
        name = short


def _sass(cubins):
    """-> {mangled kernel name: [normalised instructions]}"""
    funcs, cur = {}, None
    for cubin in cubins:
        text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
        for ln in text.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                cur = funcs.setdefault(m.group(1), [])
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
            if m and cur is not None:
                ins = re.sub(r"0x[0-9a-fA-F]+", "#", m.group(1))
                cur.append(re.sub(r"\.L_x_\d+", ".L", ins))
    return funcs


def _ptxas(log):
    """ptxas -v's report -> {mangled entry: [registers, stack bytes, spill
    stores, spill loads]}"""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and props:
            out.setdefault(props, [0, 0, 0, 0])[1:4] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, [0, 0, 0, 0])[0] = int(m.group(1))
    return out


def _side(root, tag):
    cubins, log = _build(root, tag)
    funcs, ptxas = _sass(cubins), _ptxas(log)
    names = _demangle(sorted(funcs))
    with open(os.path.join(root, CSRC, "path_loop_step.cuh")) as fh:
        gen = "kGen" in fh.read()
    return {_key(names[m], gen): (funcs[m], ptxas.get(m)) for m in funcs}


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    other, mine = _side(sys.argv[1], "other"), _side(ROOT, "this")
    report = {"pairs": {}, "new": sorted(set(mine) - set(other)),
              "gone": sorted(set(other) - set(mine))}
    for key in sorted(set(mine) & set(other)):
        a, b = other[key][0], mine[key][0]
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if diff is None and len(a) != len(b):
            diff = min(len(a), len(b))
        report["pairs"][key] = {
            "equal": diff is None, "instructions": [len(a), len(b)],
            "first_diff": None if diff is None else [diff, a[diff:diff + 1], b[diff:diff + 1]],
            "ptxas": [other[key][1], mine[key][1]]}
        print(f"[sass] {key}: {'equal' if diff is None else 'DIFFERENT'}, "
              f"{len(a)} vs {len(b)} instructions, ptxas [registers, stack, spill stores, "
              f"spill loads] {other[key][1]} vs {mine[key][1]}"
              + ("" if diff is None else f"; first difference at {diff}: "
                 f"{a[diff:diff + 1]} vs {b[diff:diff + 1]}"), flush=True)
    equal = sorted(k for k, v in report["pairs"].items() if v["equal"])
    print(f"[sass] {len(equal)} of {len(report['pairs'])} kernels equal; different: "
          f"{sorted(set(report['pairs']) - set(equal))}", flush=True)
    print(f"[sass] new here: {report['new']}; gone: {report['gone']}", flush=True)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as fh:
            json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
