#!/usr/bin/env python3
"""The path flagship's iteration and its two kernels in two checkouts, in
turns A B B A on one card, with the card's busy time inside the iteration.

    python3 studies/iteration_ab.py DIR_A DIR_B [--reps 11]

Each turn is a process started in that checkout's directory, on that
checkout's zdr_tpu_torch: it builds the kernels and drives bench.py's
cornell box + light (pmj02bn, 512², 64 spp, a 1024² material of 0.5, the
dense route) through Scene.render + loss.backward(). It prints one JSON
line: the iteration (host clock, synchronised), path_loop and
path_loop_grad alone on the iteration's own inputs (CUDA events), each the
median of --reps runs after a warm-up, and torch.profiler's device time of
one iteration by kernel beside that iteration's host time. Needs one CUDA
card; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, ".")
import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import path_loop as pl

reps = int(sys.argv[1])
dev = torch.device("cuda", 0)
kernels.load_library()
scene = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                 integrator="path", accel="bruteforce", device=dev)
scene.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
res, spp = (512, 512), 64
mat = torch.full((1024, 1024, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()


def iteration():
    mat.grad = None
    scene.render(mat, res=res, spp=spp, seed=0)[..., :3].sum().backward()


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def event_ms(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 0)
tb1 = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 1)
lanes = pl.pixel_lanes(res, spp, dev)
le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
m = mat.detach()
runs = {"iteration": lambda: host_ms(iteration),
        "path_loop": lambda: event_ms(lambda: kernels.path_loop(tb, lanes, m, pl.init_carry(lanes),
                                                                tb.n_steps)),
        "path_loop_grad": lambda: event_ms(lambda: kernels.path_loop_grad(tb1, lanes, m, le,
                                                                          tb1.n_steps))}
out = {}
for k, fn in runs.items():
    fn()
    times = [fn() for _ in range(reps)]
    out[k] = {"median": statistics.median(times), "runs": [round(t, 3) for t in times]}

from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) * 1e3
by_kernel = {}
for ev in prof.key_averages():
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    if us:
        by_kernel[ev.key[:60]] = round(us / 1e3, 3)
out["profiled_iteration"] = {"host_ms": round(it_ms, 3),
                             "device_ms": round(sum(by_kernel.values()), 3),
                             "by_kernel": dict(sorted(by_kernel.items(), key=lambda x: -x[1])[:8])}
print("AB " + json.dumps(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    for label, root in zip("ABBA", (args.dirs[0], args.dirs[1], args.dirs[1], args.dirs[0])):
        print(f"=== turn {label}: {os.path.abspath(root)}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TURN, str(args.reps)], cwd=root)
        if proc.returncode != 0:
            raise SystemExit(f"turn {label} ({root}) failed with code {proc.returncode}")


if __name__ == "__main__":
    main()
