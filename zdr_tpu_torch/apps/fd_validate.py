"""Finite-difference vs autograd gradient validator (port of
apps/fd_validate.py).

The reference's protocol: pick an (image pixel, texel) pair by importance
(the brightest non-light pixel, the largest-|grad| texel, the roughness
channel forced with p = 0.5), then print the FD and AD estimates of
dI[imgidx]/dmaterial[texidx] for spp = 1 .. 2^max_exp across 5 fixed seeds.
AD is torch.autograd through Scene.render, whose backward re-estimates the
gradient at seed + 1. "Good if values in the last rows of AD and FD are
similar." The starting material is uniform in [0.25, 0.75] from
np.random.RandomState(0).

Run:  python -m zdr_tpu_torch.apps.fd_validate [--integrator path]
          [--max-exp 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from ..dtypes import Camera, float3
from ..geometry.procedural import make_cornell_box, make_cornell_light
from ..scene import Scene
from ._common import app_device

SEEDS = [0, 12345, 853402567, 19260817, 948377263]
FD_EPS = 0.01
PROBE_SPP = 64


def make_scene(integrator: str, device="cuda") -> Scene:
    s = Scene(
        [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator=integrator,
        device=device,
    )
    s.camera = Camera(
        fov=50 / 180 * 3.1415926,
        origin=float3(-0.2, 2.6, -0.5),
        target=float3(-0.2, 2.6, -5.0),
    )
    return s


def start_material(tex: int, device="cpu") -> torch.Tensor:
    return torch.as_tensor(
        np.random.RandomState(0).uniform(0.25, 0.75, (tex, tex, 4)).astype(np.float32),
        device=device)


def pixel_grad(scene: Scene, material: torch.Tensor, imgidx, res, spp: int,
               seed: int) -> torch.Tensor:
    """d image[imgidx] / d material by torch.autograd of Scene.render."""
    m = material.detach().clone().requires_grad_()
    scene.render(m, res=res, spp=spp, seed=seed)[imgidx].backward()
    return m.grad


def pick(scene: Scene, material: torch.Tensor, res):
    """The importance pick -> (imgidx, texidx): the brightest pixel-channel
    that a black, fully rough material changes (so not a light), and the
    texel of the largest |d I[imgidx] / d texel| at PROBE_SPP, in the
    roughness channel when random.Random(0)'s coin says so."""
    with torch.no_grad():
        img = scene.render(material, res=res, spp=PROBE_SPP, seed=0).cpu().numpy()
        black = torch.zeros_like(material)
        black[..., 3] = 1.0
        img_black = scene.render(black, res=res, spp=PROBE_SPP, seed=0).cpu().numpy()
    weight = img[..., :3].copy()
    weight[np.all(img == img_black, axis=-1)] = 0.0
    imgidx = tuple(int(i) for i in np.unravel_index(int(np.argmax(weight)), weight.shape))
    print("Image index:", imgidx, " brightness:", float(img[imgidx]))

    g = pixel_grad(scene, material, imgidx, res, PROBE_SPP, 0).cpu().numpy()
    try_roughness = random.Random(0).random() < 0.5
    if try_roughness:
        gc = np.abs(g[..., 3])
        texidx = np.unravel_index(int(np.argmax(gc)), gc.shape) + (3,)
    else:
        texidx = np.unravel_index(int(np.argmax(np.abs(g))), g.shape)
    texidx = tuple(int(i) for i in texidx)
    print("Texture index:", texidx, " grad:", float(g[texidx]))
    return imgidx, texidx


def fd_value(scene: Scene, material: torch.Tensor, imgidx, texidx, res, spp: int,
             seed: int) -> float:
    """Two-sided FD of image[imgidx] in material[texidx], both renders at
    one seed (correlated noise)."""
    with torch.no_grad():
        m0, m1 = material.clone(), material.clone()
        m0[texidx] -= FD_EPS
        m1[texidx] += FD_EPS
        i0 = float(scene.render(m0, res=res, spp=spp, seed=seed)[imgidx])
        i1 = float(scene.render(m1, res=res, spp=spp, seed=seed)[imgidx])
    return (i1 - i0) / (2 * FD_EPS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--integrator", default="path")
    ap.add_argument("--max-exp", type=int, default=8)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--tex", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = app_device(args.device)
    res = (args.res, args.res)

    scene = make_scene(args.integrator, dev)
    material = start_material(args.tex, dev)
    imgidx, texidx = pick(scene, material, res)
    if not FD_EPS <= float(material[texidx]) <= 1 - FD_EPS:
        raise RuntimeError("material too close to boundary, can not FD")

    spps = [2**e for e in range(args.max_exp + 1)]
    print("\nIncreasing spp, 5 seeds each")
    print("FD:")
    fd_rows = []
    for spp in spps:
        fd_rows.append([fd_value(scene, material, imgidx, texidx, res, spp, s) for s in SEEDS])
        print(" ".join(f"{v:0.6f}" for v in fd_rows[-1]))
    print("AD:")
    ad_rows = []
    for spp in spps:
        ad_rows.append([float(pixel_grad(scene, material, imgidx, res, spp, s)[texidx])
                        for s in SEEDS])
        print(" ".join(f"{v:0.6f}" for v in ad_rows[-1]))
    print("good if values in the last rows of AD and FD are similar")
    return {"imgidx": imgidx, "texidx": texidx, "spp": spps, "fd": fd_rows, "ad": ad_rows}


if __name__ == "__main__":
    main()
