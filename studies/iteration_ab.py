#!/usr/bin/env python3
"""Two or more checkouts on one card, in mirrored turns: the first
checkout first and last, the others between, in order and then reversed
(two checkouts: A B B A), so that each has two turns placed alike around
the first's.

    python3 studies/iteration_ab.py [LABEL=]DIR [LABEL=]DIR ...
                                    [--scene flagship|env|path-env]
                                    [--reps N] [--out OUT_DIR] [--images]

Every checkout's kernels are built first, all at once, into its own
zdr_tpu_torch/kernels/_build/ (load_library). Each turn is a process
started in that checkout's directory, on that checkout's zdr_tpu_torch,
that prints one JSON line. A directory named twice is built once and has
the turns of both labels, which gives the spread of one build.

--scene flagship (the default; --reps 11): bench.py's cornell box + light
(pmj02bn, 512², 64 spp, a 1024² material of 0.5, the dense route) through
Scene.render + loss.backward(): the iteration (host clock, synchronised),
path_loop and path_loop_grad alone on the iteration's own inputs (CUDA
events), each the median of --reps runs after a warm-up, and
torch.profiler's device time of one iteration by kernel beside that
iteration's host time.

--scene env (--reps 7; --out needed): the direct integrator's env BVH
kernels, kernels.direct_env_bvh and direct_grad_env_bvh, on three scenes
at 512x512, 64 spp, a 512^2 material of 0.5, by accel="auto" (the BVH),
the render at seed 0 and the tap mode at seed 1 with the adjoint 1 / spp:
apps/example.py's (chip_smoke._example: make_test_envmap(256, 512)), the
big mesh (chip_smoke._bigmesh) under the same envmap, and the example under
make_test_envmap(1024, 2048); each kernel's CUDA event time (the median of
--reps after a warm-up), its tests and node visits, and ptxas's report of
the checkout's direct env kernels. The first turn of each label saves its
images and gradients under OUT_DIR; after the turns every label's images
are held bit for bit against the first label's, and its gradients at
chip_smoke.py phase 7's bars. With --images the first turns also save
Scene.render's images of IMAGES' scenes (512x512, 64 spp: the dense and
BVH direct env kernels and the path env kernels), held bit for bit the
same way.

--scene path-env (--reps 7; --out needed): the path integrator's env
kernels, kernels.path_loop (path_loop_env, path_loop_env_bvh) and
path_loop_grad (path_loop_grad_env, path_loop_grad_env_bvh), as --scene env
times the direct ones, on PATH_SCENES at 512x512, 64 spp, a 1024^2 material
of 0.5, by the route accel="auto" takes: bench.py's flagship under
make_test_envmap(256, 512) (chip_smoke._flagship, dense),
tools/bench_round3.py's env_scene (chip_smoke._env_scene, the BVH), the big
mesh (chip_smoke._bigmesh, 50,882 triangles, the BVH) under
make_test_envmap(256, 512), and the flagship under make_test_envmap(1024,
2048); with the BVH kernels' tests and node visits a sample, and ptxas's
report of the path kernels with and without the env. --images saves
Scene.render's image of each scene (but the 1024 x 2048 map's). Its turn
uses only what chip_smoke.py and the package have had since the path env
kernels came, so an older checkout takes its turns too.

Needs one CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FLAGSHIP_TURN = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, ".")
import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import path_loop as pl

reps = int(sys.argv[1])
dev = torch.device("cuda", 0)
kernels.load_library()
if reps == 0:
    raise SystemExit(0)
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


SCENES = (("example", 256), ("big mesh", 256), ("example 1024x2048", 1024))
ENV_KERNELS = ("direct_env", "direct_env_early", "direct_grad_env", "direct_grad_env_early",
               "direct_env_bvh", "direct_grad_env_bvh")

ENV_TURN = r"""
import json, os, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from zdr_tpu_torch import kernels
from zdr_tpu_torch.envmap import make_test_envmap
from zdr_tpu_torch.integrators import path_loop as pl

reps, out_dir, save = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "save"
images = json.loads(sys.argv[6])
kernels.load_library()
if reps == 0:
    raise SystemExit(0)
report = cs.ptxas_bvh(kernels.build_info["log"])
dev = torch.device("cuda", 0)


def counts(kernel):
    return [int(c) for c in kernel.counts.tolist()]


out = {"ptxas": {k: report.get(k) for k in json.loads(sys.argv[4])}, "scenes": {}}
for name, env_h in json.loads(sys.argv[5]):
    if name.startswith("example"):
        scene = cs._example(dev)
        if env_h != 256:
            scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
    else:
        scene = cs._bigmesh(dev, "direct")
        scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
    data = scene._render_data("direct")
    cfg = scene._config(cs.RES, cs.SPP)
    tb, tb1 = (pl.build_loop_tables(data, scene.camera, cfg, s) for s in (0, 1))
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((512, 512, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    acc = kernels.direct_env_bvh(tb, lanes, mat)
    fcounts = counts(kernels.direct_env_bvh)
    grad, _acc = kernels.direct_grad_env_bvh(tb1, lanes, mat, le)
    gcounts = counts(kernels.direct_grad_env_bvh)
    torch.cuda.synchronize()
    if save:
        torch.save({"acc": acc.cpu(), "grad": grad.cpu()},
                   os.path.join(out_dir, name.replace(" ", "_") + ".pt"))
    fwd = cs._event_ms(lambda: kernels.direct_env_bvh(tb, lanes, mat), reps)
    bwd = cs._event_ms(lambda: kernels.direct_grad_env_bvh(tb1, lanes, mat, le), reps)
    n = lanes.shape[1] * cs.SPP
    out["scenes"][name] = {"fwd_ms": fwd[0], "grad_ms": bwd[0], "fwd_runs": fwd[1],
                           "grad_runs": bwd[1], "tests_a_sample": fcounts[0] / n,
                           "visits_a_sample": fcounts[1] / n, "grad_counts": gcounts}
if save and images:
    def env_of(scene):
        scene.add_envmap(make_test_envmap(256, 512))
        return scene

    def example_dense():
        scene = cs._example(dev)
        scene.accel = "bruteforce"
        return scene

    scenes = {"example dense": example_dense,
              "big mesh": lambda: env_of(cs._bigmesh(dev, "direct")),
              "cornell box direct": lambda: env_of(cs._flagship(dev, "direct")),
              "cornell box path": lambda: env_of(cs._flagship(dev, "path")),
              "env_scene path": lambda: cs._env_scene(dev)}
    mat = torch.full((512, 512, 4), 0.5, dtype=torch.float32, device=dev)
    for name in images:
        img = scenes[name]().render(mat, res=cs.RES, spp=cs.SPP, seed=0)
        torch.save(img.cpu(), os.path.join(out_dir, "image_" + name.replace(" ", "_") + ".pt"))
print("AB " + json.dumps(out), flush=True)
"""
# Scene.render's images compared across the checkouts with --images: the
# dense direct env kernel (the example by "bruteforce", with the early out;
# the cornell box, without it), direct_env_bvh (the big mesh), path_loop_env
# (the cornell box) and path_loop_env_bvh (tools/bench_round3.py's env_scene)
IMAGES = ("example dense", "big mesh", "cornell box direct", "cornell box path",
          "env_scene path")


PATH_SCENES = (("flagship", 256), ("env_scene", 128), ("big mesh", 256),
               ("flagship 1024x2048", 1024))
PATH_KERNELS = ("path_loop", "path_loop_grad", "path_loop_env", "path_loop_grad_env",
                "path_loop_bvh", "path_loop_grad_bvh", "path_loop_env_bvh",
                "path_loop_grad_env_bvh")

PATH_ENV_TURN = r"""
import json, os, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from zdr_tpu_torch import kernels
from zdr_tpu_torch.envmap import make_test_envmap
from zdr_tpu_torch.integrators import path_loop as pl

reps, out_dir, save = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "save"
images = sys.argv[6] == "images"
kernels.load_library()
if reps == 0:
    raise SystemExit(0)
report = cs.ptxas_bvh(kernels.build_info["log"])
dev = torch.device("cuda", 0)


def scene_of(name, env_h):
    if name == "env_scene":
        return cs._env_scene(dev)
    scene = cs._bigmesh(dev, "path") if name == "big mesh" else cs._flagship(dev)
    scene.add_envmap(make_test_envmap(env_h, 2 * env_h))
    return scene


out = {"ptxas": {k: report.get(k) for k in json.loads(sys.argv[4])}, "scenes": {}}
for name, env_h in json.loads(sys.argv[5]):
    scene = scene_of(name, env_h)
    data = scene._render_data("path")
    cfg = scene._config(cs.RES, cs.SPP)
    tb, tb1 = (pl.build_loop_tables(data, scene.camera, cfg, s) for s in (0, 1))
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / cs.SPP, device=dev)
    bvh = tb.bvh is not None
    fname, gname = (("path_loop_env_bvh", "path_loop_grad_env_bvh") if bvh
                    else ("path_loop_env", "path_loop_grad_env"))

    def fwd():
        return kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)

    def bwd():
        return kernels.path_loop_grad(tb1, lanes, mat, le, tb1.n_steps)

    carry = fwd()
    fcounts = getattr(kernels, fname).counts if bvh else None
    fcounts = None if fcounts is None else [int(c) for c in fcounts.tolist()]
    grad, _carry = bwd()
    gcounts = getattr(kernels, gname).counts if bvh else None
    gcounts = None if gcounts is None else [int(c) for c in gcounts.tolist()]
    torch.cuda.synchronize()
    if save:
        torch.save({"acc": carry.f[0:3].cpu(), "grad": grad.cpu()},
                   os.path.join(out_dir, name.replace(" ", "_") + ".pt"))
        if images and env_h != 1024:
            img = scene.render(mat, res=cs.RES, spp=cs.SPP, seed=0)
            torch.save(img.cpu(), os.path.join(out_dir, "image_" + name.replace(" ", "_") + ".pt"))
    f_ms = cs._event_ms(fwd, reps)
    g_ms = cs._event_ms(bwd, reps)
    n = lanes.shape[1] * cs.SPP
    rec = {"route": "bvh" if bvh else "dense", "fwd": fname, "grad": gname,
           "fwd_ms": f_ms[0], "grad_ms": g_ms[0], "fwd_runs": f_ms[1], "grad_runs": g_ms[1],
           "plan": getattr(kernels, gname).plan}
    if fcounts is not None:
        rec.update(tests_a_sample=fcounts[0] / n, visits_a_sample=fcounts[1] / n,
                   grad_tests_a_sample=gcounts[0] / n, grad_visits_a_sample=gcounts[1] / n)
    out["scenes"][name] = rec
print("AB " + json.dumps(out), flush=True)
"""


def _turn_cmd(args, reps, out_dir="", save=False):
    if args.scene == "flagship":
        return [sys.executable, "-c", FLAGSHIP_TURN, str(reps)]
    if args.scene == "path-env":
        return [sys.executable, "-c", PATH_ENV_TURN, str(reps), out_dir,
                "save" if save else "run", json.dumps(PATH_KERNELS), json.dumps(PATH_SCENES),
                "images" if args.images else "none"]
    return [sys.executable, "-c", ENV_TURN, str(reps), out_dir, "save" if save else "run",
            json.dumps(ENV_KERNELS), json.dumps(SCENES),
            json.dumps(IMAGES if args.images else [])]


def _turn(args, root, out_dir, save):
    proc = subprocess.run(_turn_cmd(args, args.reps, out_dir, save), cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{root} failed with code {proc.returncode}:\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")][-1]
    return json.loads(line[3:])


def _env_compare(args, labels):
    """Each label's images against the first label's, bit for bit, and its
    gradients at chip_smoke.py phase 7's bars -> the failures (none: all
    held)."""
    import torch

    import chip_smoke as cs

    path = args.scene == "path-env"
    scenes = [n for n, _h in (PATH_SCENES if path else SCENES)]
    images = ([n for n, h in PATH_SCENES if h != 1024] if path else IMAGES) if args.images else []
    failed = []
    base = labels[0]
    for label in labels[1:]:
        for name in scenes:
            f = name.replace(" ", "_") + ".pt"
            want = torch.load(os.path.join(args.out, base, f))
            got = torch.load(os.path.join(args.out, label, f))
            if not torch.equal(got["acc"], want["acc"]):
                failed.append(f"{label} {name}: the image differs from {base}'s in "
                              f"{int((got['acc'] != want['acc']).any(0).sum())} lanes")
                continue
            try:
                _err, worst = cs._assert_grad_close(got["grad"], want["grad"],
                                                    f"{label} {name} gradient against {base}'s")
            except AssertionError as e:
                failed.append(str(e))
                continue
            print(f"[ab] {label} {name}: the image equals {base}'s bit for bit, the "
                  f"gradient worst texel rel err {worst:.3e} (rtol 1e-4)", flush=True)
        for name in images:
            f = "image_" + name.replace(" ", "_") + ".pt"
            want = torch.load(os.path.join(args.out, base, f))
            got = torch.load(os.path.join(args.out, label, f))
            if not torch.equal(got, want):
                failed.append(f"{label} {name}: Scene.render's image differs from {base}'s "
                              f"in {int((got != want).any(-1).sum())} pixels")
                continue
            print(f"[ab] {label} {name}: Scene.render's image equals {base}'s bit for bit",
                  flush=True)
    return failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", help="[LABEL=]DIR, two or more, the first first and last")
    ap.add_argument("--scene", choices=("flagship", "env", "path-env"), default="flagship")
    ap.add_argument("--reps", type=int, default=None, help="11 (flagship), 7 (env, path-env)")
    ap.add_argument("--out", help="the env scenes' images and JSON (needed with --scene env "
                                  "or path-env)")
    ap.add_argument("--images", action="store_true",
                    help="env, path-env: also compare Scene.render's images")
    args = ap.parse_args()
    if len(args.dirs) < 2 or (args.scene != "flagship" and not args.out):
        ap.error("two or more checkouts; --scene env and path-env need --out")
    if args.reps is None:
        args.reps = 11 if args.scene == "flagship" else 7
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    _name, smi = cs.phase_device()
    trees = {}
    for i, d in enumerate(args.dirs):
        label, root = d.split("=", 1) if "=" in d else ("ABCDEFGH"[i], d)
        trees[label] = os.path.abspath(root)
    labels = list(trees)
    builds = [subprocess.Popen(_turn_cmd(args, 0), cwd=root) for root in set(trees.values())]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a build failed")
    order = [labels[0], *labels[1:], *labels[1:][::-1], labels[0]]
    runs = {k: [] for k in labels}
    for i, label in enumerate(order):
        out = os.path.join(os.path.abspath(args.out), label) if args.out else ""
        if out:
            os.makedirs(out, exist_ok=True)
        rec = _turn(args, trees[label], out, save=not runs[label])
        runs[label].append(rec)
        print(f"[ab] turn {i + 1} {label} ({trees[label]}): {json.dumps(rec)}; card {smi}",
              flush=True)
    summary = {}
    for k, v in runs.items():
        if args.scene == "flagship":
            summary[k] = {name: [r[name]["median"] for r in v]
                          for name in ("iteration", "path_loop", "path_loop_grad")}
        elif args.scene == "path-env":
            summary[k] = {name: {f: [r["scenes"][name][f] for r in v]
                                 for f in ("fwd_ms", "grad_ms")}
                          for name, _h in PATH_SCENES}
            for name, _h in PATH_SCENES:
                first = v[0]["scenes"][name]
                summary[k][name].update({f: first[f] for f in (
                    "tests_a_sample", "visits_a_sample", "grad_tests_a_sample",
                    "grad_visits_a_sample") if f in first})
        else:
            summary[k] = {name: {"fwd_ms": [r["scenes"][name]["fwd_ms"] for r in v],
                                 "grad_ms": [r["scenes"][name]["grad_ms"] for r in v],
                                 "visits_a_sample": v[0]["scenes"][name]["visits_a_sample"],
                                 "tests_a_sample": v[0]["scenes"][name]["tests_a_sample"]}
                          for name, _h in SCENES}
    print("[ab] summary " + json.dumps({"card": smi, "turns": order, "runs": summary}),
          flush=True)
    if args.out:
        with open(os.path.join(args.out, "ab.json"), "w") as fh:
            json.dump({"card": smi, "turns": order, "runs": runs}, fh, indent=1)
    if args.scene != "flagship":
        failed = _env_compare(args, labels)
        if failed:
            raise SystemExit("[ab] " + "; ".join(failed))


if __name__ == "__main__":
    main()
