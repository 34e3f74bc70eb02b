"""Light-stage material capture workload (port of apps/lightstage.py).

An object surrounded by many individually switchable area lights (quads
placed on a Fibonacci sphere by rotation matrices), rendered under
different light patterns through `Scene.update_lights`; a procedural uv
sphere stands in for the reference's bunny. The recovery renders a
ground truth under each pattern, then fits the texture to all of them,
one pattern a step, with Adam. With --batched every pattern renders each
step through parallel.render_batch, split over the ranks of the process
group where one is initialised (torchrun), and the loss is their mean; a
rank past the largest divisor of the patterns that fits the world sits
out and takes the others' result.

Run:  python -m zdr_tpu_torch.apps.lightstage [--small] [--batched]
          [--device cuda|cpu] [--iters N] [--tex N] [--log steps.jsonl]
"""

from __future__ import annotations

import argparse
import time
from math import acos, cos, pi, sin

import numpy as np
import torch

from ..dtypes import Camera, float3
from ..geometry.procedural import make_quad, make_uv_sphere
from ..profiling import RunLogger
from ..scene import Scene
from ._common import app_device

# (lights, image res, spp, iterations, texture side, patterns)
SMALL = (10, (48, 48), 16, 20, 32, 4)
FULL = (30, (512, 512), 256, 200, 256, 8)
EMISSION = 50.0
LR = 2e-2
CLAMP = (1e-3, 1.0)


def rotate_mat(theta: float, phi: float, offset) -> np.ndarray:
    """Pitch-then-yaw-then-translate 4x4."""
    pitch = np.array(
        [
            [cos(theta), -sin(theta), 0, 0],
            [sin(theta), cos(theta), 0, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ]
    )
    yaw = np.array(
        [
            [cos(phi), 0, -sin(phi), 0],
            [0, 1, 0, 0],
            [sin(phi), 0, cos(phi), 0],
            [0, 0, 0, 1],
        ]
    )
    translate = np.eye(4)
    translate[:3, 3] = offset
    return yaw @ pitch @ translate


def build_lightstage(n_lights: int = 30, emission: float = EMISSION, device="cuda") -> Scene:
    """Object + n quads distributed on a golden-angle sphere shell."""
    return Scene(lightstage_models(n_lights, emission), integrator="direct", device=device)


def lightstage_models(n_lights: int = 30, emission: float = EMISSION) -> list:
    """build_lightstage's models: the object, then the n quads."""
    models = [(make_uv_sphere(0.35), rotate_mat(0, -0.4, (0, 0, 0)), None)]
    # quad at y=-2 with its +y normal: after the pitch/yaw rotation it sits
    # on a radius-2 shell facing the object at the origin
    quad = make_quad(0.18, y=-2.0)
    for i in range(n_lights):
        theta = acos((i + 0.5) / n_lights * 2 - 1)
        phi = pi * 2 * 0.618 * (i + 1)
        models.append((quad, rotate_mat(theta, phi, (0.0, 0.0, 0.0)), emission))
    return models


def make_camera() -> Camera:
    return Camera(
        fov=50 / 180 * 3.1415926,
        origin=float3(0, 0.5, 2),
        target=float3(0, 0, 0),
        up=float3(0.0, 1.0, 0.0),
    )


# an off light's emission in --batched: render_batch keeps the scene's light
# structure for every view, so an off light stays in it at about zero
OFF_BATCHED = 1e-6


def make_patterns(n_lights: int, n_pat: int, off=None) -> list:
    """The light patterns, from np.random.RandomState(0): a quarter of the
    lights on at EMISSION each, the others `off` (None: update_lights
    removes them from the light structure, and NEE samples the on-lights
    alone; OFF_BATCHED for --batched); the object first, never a light."""
    rng = np.random.RandomState(0)
    patterns = []
    for _ in range(n_pat):
        on = rng.choice(n_lights, max(n_lights // 4, 1), replace=False)
        patterns.append([None] + [EMISSION if i in on else off for i in range(n_lights)])
    return patterns


def batch_mesh(n_pat: int, device: torch.device):
    """The mesh --batched splits the patterns over: the largest divisor of
    n_pat that fits the process group's world, or None (one rank) without a
    group."""
    import torch.distributed as dist

    from ..parallel import make_mesh

    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    fit = max(d for d in range(1, min(world, n_pat) + 1) if n_pat % d == 0)
    return make_mesh(fit, device_type=device.type)


def _batched(scene, material_gt, patterns, res, spp, iters, tex, dev, log) -> dict:
    """--batched (JAX apps/lightstage.py:118-219) over batch_mesh's ranks.
    Where the world is larger than the mesh, the ranks outside it render
    nothing (as the devices outside JAX's mesh) and every rank returns the
    mesh's result, broadcast from rank 0."""
    import torch.distributed as dist

    n_pat = len(patterns)
    mesh = batch_mesh(n_pat, dev)
    n_mesh = 1 if mesh is None else mesh.size()
    print(f"batched mode: {n_pat} patterns over {n_mesh} rank(s)")
    if mesh is not None and mesh.get_coordinate() is None:
        print(f"rank {dist.get_rank()} sits out: the mesh holds {n_mesh} of "
              f"{dist.get_world_size()} ranks")
        if log is not None:
            log.close()
        result = None
    else:
        result = _fit_batched(scene, material_gt, patterns, res, spp, iters, tex, dev, log,
                              mesh)
    if mesh is not None and n_mesh < dist.get_world_size():
        box = [result]
        dist.broadcast_object_list(box, src=0)
        result = box[0]
    return result


def _fit_batched(scene, material_gt, patterns, res, spp, iters, tex, dev, log, mesh) -> dict:
    """Every pattern each step through render_batch over the mesh, the loss
    and the floor averaged over them; view p of a call at seed s renders at
    s + 7919 p."""
    from ..parallel import render_batch

    n_pat = len(patterns)

    def render_all(m, seed):
        return render_batch(scene, m, scene.camera, patterns, res=res, spp=spp, seed=seed,
                            mesh=mesh)

    with torch.no_grad():
        targets = render_all(material_gt, 0)
    for p in range(n_pat):
        m = float(targets[p, ..., :3].mean())
        print(f"pattern {p}: mean {m:.4f}")
        if not m > 1e-4:
            raise RuntimeError(f"light pattern {p} renders black: lights misconfigured")

    material = torch.full((tex, tex, 4), 0.5, dtype=torch.float32, device=dev)
    material.requires_grad_()
    opt = torch.optim.Adam([material], lr=LR)
    losses = []
    try:
        for it in range(iters):
            t_step = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            imgs = render_all(material, 100 + it * 104729)
            loss = ((imgs - targets) ** 2).sum() / n_pat
            loss.backward()
            opt.step()
            with torch.no_grad():
                material.clamp_(*CLAMP)
            losses.append(float(loss.detach()))  # waits for the step
            if log is not None:
                log.log(it, pattern="all", loss=losses[-1],
                        step_ms=(time.perf_counter() - t_step) * 1e3)
            if it % max(iters // 10, 1) == 0:
                print(f"iter {it:3d} pattern all loss {losses[-1]:.6f}")
    finally:
        if log is not None:
            log.close()
    with torch.no_grad():
        imgs = render_all(material_gt, 5000 * 104729)
        floor = float(((imgs - targets) ** 2).sum()) / n_pat
    return _summary(material.detach(), material_gt, losses, n_pat, floor)


def _summary(m, material_gt, losses, n_pat, floor) -> dict:
    err = float((m - material_gt).abs().mean())
    first = float(np.mean(losses[:n_pat]))
    last = float(np.mean(losses[-n_pat:]))
    print(
        f"loss {first:.4f} -> {last:.4f} (noise floor {floor:.4f})  "
        f"mean |tex err| {err:.4f}"
    )
    return {
        "loss_first": first,
        "loss_last": last,
        "noise_floor": floor,
        "tex_err": err,
        "tex_err_diffuse": float((m - material_gt)[..., :3].abs().mean()),
        "tex_err0_diffuse": float((0.5 - material_gt)[..., :3].abs().mean()),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batched", action="store_true",
                    help="every pattern each step through parallel.render_batch, split over "
                         "the process group's ranks where one is initialised")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--tex", type=int, default=None,
                    help="texture side override (coarser = more gradient signal per texel)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--log", default=None,
                    help="jsonl of every step (profiling.RunLogger): pattern, loss, step_ms")
    args = ap.parse_args(argv)
    dev = app_device(args.device)
    n_lights, res, spp, iters, tex, n_pat = SMALL if args.small else FULL
    iters = args.iters or iters
    tex = args.tex or tex

    scene = build_lightstage(n_lights, device=dev)
    scene.camera = make_camera()
    rng = np.random.RandomState(5)
    material_gt = torch.as_tensor(
        rng.uniform(0.2, 0.8, (tex, tex, 4)).astype(np.float32), device=dev)
    patterns = make_patterns(n_lights, n_pat, OFF_BATCHED if args.batched else None)
    log = RunLogger(args.log) if args.log else None
    if args.batched:
        return _batched(scene, material_gt, patterns, res, spp, iters, tex, dev, log)

    # GT views: one render per light pattern (update_lights switching)
    targets = []
    with torch.no_grad():
        for p, em in enumerate(patterns):
            scene.update_lights(em)
            tgt = scene.render(material_gt, res=res, spp=spp, seed=p)
            targets.append(tgt)
            m = float(tgt[..., :3].mean())
            print(f"pattern {p}: mean {m:.4f}")
            if not m > 1e-4:
                raise RuntimeError(f"light pattern {p} renders black: lights misconfigured")

    # joint recovery across patterns, one pattern a step
    material = torch.full((tex, tex, 4), 0.5, dtype=torch.float32, device=dev)
    material.requires_grad_()
    opt = torch.optim.Adam([material], lr=LR)
    losses = []
    try:
        for it in range(iters):
            t_step = time.perf_counter()
            p = it % n_pat
            scene.update_lights(patterns[p])
            opt.zero_grad(set_to_none=True)
            img = scene.render(material, res=res, spp=spp, seed=100 + it)
            loss = ((img - targets[p]) ** 2).sum()
            loss.backward()
            opt.step()
            with torch.no_grad():
                material.clamp_(*CLAMP)
            losses.append(float(loss.detach()))  # waits for the step
            if log is not None:
                log.log(it, pattern=p, loss=losses[-1],
                        step_ms=(time.perf_counter() - t_step) * 1e3)
            if it % max(iters // 10, 1) == 0:
                print(f"iter {it:3d} pattern {p} loss {losses[-1]:.6f}")
    finally:
        if log is not None:
            log.close()

    with torch.no_grad():
        # MC noise floor of the loss: the TRUE material against the (noisy,
        # other-seed) targets; convergence is judged on the excess above it
        floors = []
        for p, em in enumerate(patterns):
            scene.update_lights(em)
            img = scene.render(material_gt, res=res, spp=spp, seed=5000 + p)
            floors.append(float(((img - targets[p]) ** 2).sum()))
    return _summary(material.detach(), material_gt, losses, n_pat, float(np.mean(floors)))


if __name__ == "__main__":
    main()
