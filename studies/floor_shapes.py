#!/usr/bin/env python3
"""The floor probe's out = a + b in several launch shapes against
torch.add, by the device's clock, on one CUDA card.

    python3 studies/floor_shapes.py

Builds floor_shapes.cu into studies/_build/ (git-ignored), checks every
shape equal to a + b at 262,144 floats (chip_smoke.py phase 14's size) and
at a length that is not a multiple of 4, then times each, the package's
floor_probe and torch.add by chip_smoke.py's _graph_ms (GRAPH_CALLS calls
captured in a CUDA graph, the graph replayed between one event pair, the
median of 5 replays, divided by the calls), in ROUNDS rounds in turns,
torch.add before and after the shapes of each round. Prints each one's
median over the rounds with its rounds in microseconds. Imports nothing of
JAX.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "_build")
N = 262144
ROUNDS = 9
# floor_shapes.cu floor_shape's cases, in order
SHAPES = (
    "scalar_b128 (the parent kernel: one float a thread, blocks of 128)",
    "stride_b256_4sm (float4, 256 threads, a grid stride over at most 4 blocks an SM)",
    "stride_b256_1sm (float4, 256 threads, a grid stride over one block an SM)",
    "f4_b128 (one float4 a thread, blocks of 128)",
    "f4_b256",
    "f4_b512",
    "f4x2_b128 (two float4s a thread)",
    "f4x2_b256",
    "f4x4_b256 (four float4s a thread)",
    "stcs_b64 (one float4 a thread, streaming store)",
    "stcs_b128 (the kernel's shape: one float4 a thread, streaming store, blocks of 128)",
    "stcs_b256",
    "stcs_b256_lasttail (the tail by the last block)",
    "plain_b256_lasttail (plain store, the tail by the last block)",
    "ldcs_stcs_b64 (streaming loads and store)",
    "ldcs_stcs_b128",
    "ldcs_stcs_b256",
)


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from zdr_tpu_torch import kernels

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, "libfloor_shapes.so")
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(HERE, "floor_shapes.cu")], check=True)
    lib = ctypes.CDLL(so)
    launch = kernels._bind(lib, "floor_shape", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def shape(v, a, b):
        def call():
            out = torch.empty_like(a)
            kernels._raise_on(launch(v, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     a.shape[0], sms, torch.cuda.current_stream().cuda_stream),
                              SHAPES[v])
            return out
        return call

    g = torch.Generator().manual_seed(0)
    for n in (N, N + 3):
        a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
        for v in range(len(SHAPES)):
            if not torch.equal(shape(v, a, b)(), a + b):
                raise AssertionError(f"{SHAPES[v]} differs from a + b at n = {n}")
    a, b = (torch.rand(N, generator=g).to(dev) for _ in range(2))
    calls = {"torch.add": lambda: torch.add(a, b),
             "floor_probe (the package's wrapper)": lambda: kernels.floor_probe(a, b),
             **{SHAPES[v]: shape(v, a, b) for v in range(len(SHAPES))}}
    times = {k: [] for k in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            times[name].append(cs._graph_ms(fn) * 1e3)
        times["torch.add"].append(cs._graph_ms(calls["torch.add"]) * 1e3)
    lines = [f"{name} {statistics.median(t):.3f} us {[round(x, 3) for x in t]}"
             for name, t in times.items()]
    print(f"[floor shapes] out = a + b over {N} floats, the device's time a call ("
          f"{cs.GRAPH_CALLS} calls a CUDA graph, median of 5 replays), {ROUNDS} rounds in "
          f"turns; median over the rounds, then the rounds: " + "; ".join(lines)
          + f"; card {smi}", flush=True)


if __name__ == "__main__":
    main()
