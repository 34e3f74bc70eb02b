"""Camera constants and the primary ray with the tent filter.

Port of zdr_tpu/integrators/pallas_loop.py:207-265 (`camera_const`,
`_camera_ray`). The CUDA step computes the same ray from the same (16,) row.
"""

from __future__ import annotations

import torch

from .dtypes import Camera


def camera_const(camera: Camera) -> torch.Tensor:
    """(16,) float32 camera row on the CPU:
    [origin3, right3, up3, forward3, tan(fov / 2), 0, 0, 0]."""
    def norm3(x, y, z):
        inv = 1.0 / torch.clamp_min(torch.sqrt(x * x + y * y + z * z), 1e-20)
        return x * inv, y * inv, z * inv

    o, t, up = camera.origin, camera.target, camera.up
    fx, fy, fz = norm3(t[0] - o[0], t[1] - o[1], t[2] - o[2])
    ux_, uy_, uz_ = up[0], up[1], up[2]
    rx, ry, rz = norm3(fy * uz_ - fz * uy_, fz * ux_ - fx * uz_, fx * uy_ - fy * ux_)
    upx = ry * fz - rz * fy
    upy = rz * fx - rx * fz
    upz = rx * fy - ry * fx
    scale = torch.tan(0.5 * camera.fov)
    zero = torch.zeros((), dtype=torch.float32)
    vals = [o[0], o[1], o[2], rx, ry, rz, upx, upy, upz, fx, fy, fz, scale,
            zero, zero, zero]
    return torch.stack([v.to(torch.float32).reshape(()) for v in vals])


def tent_warp(u: torch.Tensor) -> torch.Tensor:
    lo = torch.sqrt(2.0 * u) - 1.0
    hi = 1.0 - torch.sqrt(torch.clamp_min(2.0 - 2.0 * u, 0.0))
    return torch.where(u < 0.5, lo, hi)


def camera_ray(cam: torch.Tensor, px, py, u0, u1, res, use_tent: bool):
    """Primary ray through pixel (px, py) jittered by (u0, u1) -> (o, d)
    component tuples. cam is camera_const on the lanes' device."""
    w, h = res
    if use_tent:
        ox = tent_warp(u0) + 0.5
        oy = tent_warp(u1) + 0.5
    else:
        ox, oy = u0, u1
    px_ndc = 2.0 / w * (px.to(torch.float32) + ox) - 1.0
    py_ndc = (2.0 / h * (py.to(torch.float32) + oy) - 1.0) * (h / w)
    return ndc_ray(cam, px_ndc, py_ndc)


def ndc_ray(cam: torch.Tensor, px_ndc, py_ndc):
    """The perspective ray through NDC (px_ndc, py_ndc), y already
    aspect-corrected -> (o, d) component tuples."""
    sx = px_ndc * cam[12]
    sy = py_ndc * cam[12]
    dx = sx * cam[3] - sy * cam[6] + cam[9]
    dy = sx * cam[4] - sy * cam[7] + cam[10]
    dz = sx * cam[5] - sy * cam[8] + cam[11]
    inv = 1.0 / torch.clamp_min(torch.sqrt(dx * dx + dy * dy + dz * dz), 1e-20)
    zero = torch.zeros_like(dx)
    return (zero + cam[0], zero + cam[1], zero + cam[2]), (dx * inv, dy * inv, dz * inv)


def generate_ray(camera: Camera, p: torch.Tensor):
    """Perspective ray through (N, 2) points p in NDC, y already
    aspect-corrected (JAX camera.py:18) -> (o, d) component tuples."""
    return ndc_ray(camera_const(camera).to(p.device), p[:, 0], p[:, 1])
