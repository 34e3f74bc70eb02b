"""Componentized vec3 math on tuples of tensors.

Every expression keeps the JAX package's operand order
(zdr_tpu/integrators/pallas_bounce.py:95-129), and the CUDA step
(kernels/csrc/path_loop_step.cuh) keeps the same order, so the three agree
to the rounding of the transcendental functions.

`div` divides by a constant through a tensor: on a CUDA tensor, torch turns
`x / python_float` into `x * (1 / python_float)`, which rounds differently
from the true division that the JAX package and the kernel compute.
"""

from __future__ import annotations

import torch


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vnormalize(a):
    inv = 1.0 / torch.clamp_min(torch.sqrt(vdot(a, a)), 1e-20)
    return vscale(a, inv)


def vwhere(m, a, b):
    return tuple(torch.where(m, a[k], b[k]) for k in range(3))


def luminance(rgb):
    """CIE Y of a linear rgb tuple (JAX vecmath.py:42)."""
    return 0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]


def offset_ray_origin(p, ng, dist: float = 1e-4):
    """A ray origin nudged along the geometric normal (JAX vecmath.py:48)."""
    return vadd(p, vscale(ng, dist))
