"""End-to-end texture optimization demo (port of apps/example.py).

Renders a ground-truth image of a textured sphere under an environment
light, then recovers the material texture (diffuse RGB + roughness) from
a constant 0.5 with Adam. Procedural stand-ins replace the reference's
assets (a test sky, wood textures), or --material (a PNG/EXR diffuse
texture and optional roughness map, sRGB -> linear by **2.2) and --envmap
(an equirect EXR) supply them. Outputs are written as EXR (HDR images,
diffuse / roughness, the duv/dxy footprint) plus PNG previews, by the
port's own codec (zdr_tpu_torch.imageio_exr: numpy and zlib).

Run:  python -m zdr_tpu_torch.apps.example [--small] [--device cuda|cpu]
          [--material d.png[,r.png]] [--envmap e.exr] [--log steps.jsonl]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..dtypes import Camera, float3
from ..envmap import make_test_envmap
from ..geometry.procedural import make_uv_sphere
from ..imageio_exr import load_image, save_image
from ..profiling import RunLogger
from ..scene import Scene
from ._common import app_device, sync

# (image res, texture side, GT spp, spp a step, iterations)
SMALL = ((64, 64), 32, 64, 16, 40)
FULL = ((512, 512), 512, 512, 64, 500)
LR = 1e-2  # Adam's step; its other defaults are optax.adam's (0.9, 0.999, 1e-8)
CLAMP = (1e-3, 1.0)
OUTPUTS = ("gt", "recon", "diffuse", "roughness", "duvdxy_det")


def procedural_wood(res: int, device="cpu") -> torch.Tensor:
    """Procedural wood-like material (diffuse rings + varying roughness),
    standing in for the reference's wood textures -> (res, res, 4)."""
    y, x = np.mgrid[0:res, 0:res].astype(np.float64) / res
    r = np.sqrt((x - 0.4) ** 2 + (y - 0.55) ** 2)
    rings = 0.5 + 0.5 * np.sin(r * 60.0 + 2.0 * np.sin(x * 9.0))
    base = np.stack(
        [0.45 + 0.25 * rings, 0.28 + 0.15 * rings, 0.12 + 0.06 * rings], -1
    )
    rough = 0.3 + 0.5 * (1.0 - rings)
    mat = np.concatenate([base, rough[..., None]], -1).astype(np.float32)
    return torch.as_tensor(np.clip(mat, 1e-3, 1.0), device=device)


def load_material_files(spec: str, tex_res: int, device="cpu") -> torch.Tensor:
    """A ground-truth material from image files: 'diffuse.png[,roughness.png]'
    -> (R, R, 4), sRGB -> linear (**2.2) for an LDR diffuse; no roughness
    map -> a constant 0.5."""
    parts = spec.split(",")
    d = load_image(parts[0])[..., :3]
    if not parts[0].lower().endswith(".exr"):
        d = d**2.2
    if len(parts) > 1:
        r = load_image(parts[1])
        r = r[..., 0] if r.ndim == 3 else r
    else:
        r = np.full(d.shape[:2], 0.5, np.float32)
    mat = np.concatenate([d, r[..., None]], axis=-1).astype(np.float32)
    if mat.shape[0] != tex_res:
        # nearest resize to the optimization resolution
        yi = (np.arange(tex_res) * mat.shape[0] / tex_res).astype(int)
        xi = (np.arange(tex_res) * mat.shape[1] / tex_res).astype(int)
        mat = mat[yi][:, xi]
    return torch.as_tensor(np.clip(mat, 1e-3, 1.0), device=device)


def build_scene(envmap=None, device="cuda") -> Scene:
    """The sphere (960 triangles) under `envmap` (an array or an EXR/PNG
    path; default make_test_envmap(256, 512)), the direct integrator, the
    app's camera."""
    scene = Scene([(make_uv_sphere(0.5), None, None)], integrator="direct", device=device)
    if envmap is None:
        envmap = make_test_envmap(256, 512)
    elif isinstance(envmap, str):
        envmap = load_image(envmap)[..., :3]
    scene.add_envmap(envmap)
    scene.camera = Camera(
        fov=50 / 180 * 3.1415926,
        origin=float3(1.0, 0.0, 0.0),
        target=float3(0.0, 0.0, 0.0),
        up=float3(0.0, 1.0, 0.0),
    )
    return scene


def train_step(scene: Scene, material: torch.Tensor, opt: torch.optim.Optimizer,
               target: torch.Tensor, res, spp: int, seed: int) -> torch.Tensor:
    """One recovery step: loss = sum((render - target)^2), its backward (the
    texture gradient at seed + 1), an optimizer step, the clamp -> the
    loss (a 0-d tensor on the device, not waited for)."""
    opt.zero_grad(set_to_none=True)
    img = scene.render(material, res=res, spp=spp, seed=seed)
    loss = ((img - target) ** 2).sum()
    loss.backward()
    opt.step()
    with torch.no_grad():
        material.clamp_(*CLAMP)
    return loss.detach()


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="CI-sized run")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--out", default="results")
    ap.add_argument("--material", default=None,
                    help="GT material images: diffuse.png[,roughness.png]")
    ap.add_argument("--envmap", default=None, help="equirect EXR/PNG envmap")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--log", default=None,
                    help="jsonl of every step (profiling.RunLogger): loss, step_ms; each "
                         "step then waits for the device")
    args = ap.parse_args(argv)
    dev = app_device(args.device)

    img_res, tex_res, spp_gt, spp_opt, iters = SMALL if args.small else FULL
    if args.iters:
        iters = args.iters

    scene = build_scene(args.envmap, dev)
    if args.material:
        material_gt = load_material_files(args.material, tex_res, dev)
    else:
        material_gt = procedural_wood(tex_res, dev)
    print("Image resolution:", img_res, " Texture resolution:", tex_res, " device:", dev)

    t0 = time.perf_counter()
    with torch.no_grad():
        I_gt = scene.render(material_gt, res=img_res, spp=spp_gt)
    sync(dev)
    print(f"GT render ({spp_gt} spp): {time.perf_counter() - t0:.1f}s")

    # footprint AOV
    duvdxy = scene.render_duvdxy(material_gt, res=img_res, spp=max(spp_opt // 4, 1))
    print("duv/dxy AOV mean |du/dx|:", float(duvdxy[..., 0].abs().mean()))

    material = torch.full((tex_res, tex_res, 4), 0.5, dtype=torch.float32, device=dev)
    material.requires_grad_()
    opt = torch.optim.Adam([material], lr=LR)
    log = RunLogger(args.log) if args.log else None
    t0 = time.perf_counter()
    try:
        for it in range(iters):
            t_step = time.perf_counter()
            loss = train_step(scene, material, opt, I_gt, img_res, spp_opt, it + 1)
            if log is not None:
                loss_v = float(loss)  # waits for the step
                log.log(it, loss=loss_v, step_ms=(time.perf_counter() - t_step) * 1e3)
            if it % max(iters // 10, 1) == 0:
                print(f"iter {it:4d}  loss {float(loss):.4f}")
    finally:
        if log is not None:
            log.close()
    sync(dev)
    print(f"optimized {iters} iters in {time.perf_counter() - t0:.1f}s")

    with torch.no_grad():
        I = scene.render(material.detach(), res=img_res, spp=spp_gt)
        mse = float(((I - I_gt) ** 2).mean())
        tex_err = float((material - material_gt).abs().mean())
    print("final image MSE:", mse, " mean |tex err|:", tex_err)

    # EXR outputs + PNG previews + the duvdxy footprint AOV
    os.makedirs(args.out, exist_ok=True)
    footprint = (duvdxy[..., 0] * duvdxy[..., 3] - duvdxy[..., 1] * duvdxy[..., 2]).abs()
    m = material.detach()
    arrays = (I_gt[..., :3], I[..., :3], m[..., :3], m[..., 3:].repeat(1, 1, 3),
              footprint[..., None].repeat(1, 1, 3))
    for name, arr in zip(OUTPUTS, arrays):
        arr = arr.cpu().numpy()
        save_image(os.path.join(args.out, f"{name}.exr"), arr)
        save_image(os.path.join(args.out, f"{name}.png"), np.clip(arr, 0, 1) ** (1 / 2.2))
    print("wrote EXR + PNG results to", args.out)
    return mse


if __name__ == "__main__":
    main()
