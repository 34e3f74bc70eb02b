"""Render settings, the forward render, the texture gradient and the
autograd bridge between them (port of zdr_tpu/integrators/wrapper.py).

Two routes, picked as the JAX package picks them (:152-164, :236-253): a
bilinear fetch of a material of at least 2x2, with `fused` not False (and
MIS for the direct integrator), takes the kernel routes: the path loop, the
direct and the collocated kernels. Everything else takes the unfused
estimators, plain torch around the trace kernels: the persistent path walk
(path_persistent.py; `persistent=False`, the per-sample loop over
path.path_estimator and path_backward), and for the direct and collocated
integrators the per-sample loop over their estimators. On the kernel
route the direct integrator's bounce ray looks up its emitter first at up
to scene_tables.MERGED_MAX_LIGHT_TRIS light triangles, by either accel
(JAX's merged and streamed modes, direct_fused.py:166-236); JAX's own
split also depends on its TPU thresholds MXU_MIN_TRIS and FUSED_MAX_TRIS,
which the port does not copy (README's port "Differences").
`render_forward_rays` and `render_grad_rays` send any batch of pixels
down either route, the unit that parallel.py shards over ranks;
`render_forward` and `render_grad` are their calls on the full grid.

The port renders all spp in one call: the sampler is keyed by the absolute
sample index, so the JAX package's spp windows give the same image.
`RenderFunction` makes the render differentiable in the material: its
backward re-estimates the gradient at seed + 1 with the per-sample adjoint
d_image / spp (on the card the path_loop_grad, direct_grad or
collocated_grad kernel).
What the port does not render raises NotImplementedError naming the
ROADMAP item that would port it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..samplers import SAMPLERS
from ..vec import div
from .scene_tables import table_floats

RADIANCE_CLAMP = 1e5  # the per-sample clamp (JAX wrapper.py:31)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the fields of the JAX RenderConfig that the
    port's routes read)."""

    res: Tuple[int, int]  # (width, height)
    spp: int
    integrator: str = "direct"
    sampler: str = "pmj02bn"
    use_tent_filter: bool = True
    use_mis: bool = True  # direct: NEE and the BSDF bounce, MIS-weighted
    max_depth: int = 16
    rr_depth: int = 2
    bilinear: bool = True
    # the gradient splat's knobs (JAX defaults 4 and True; the port's 1 and
    # False, the JAX package's exact estimator): splat_merge, the taps of a
    # path lane merged into one (the direct and collocated integrators never
    # merge, direct_fused.py:320); packed_splat, the splat's totals rounded
    # to bf16. Under render_sharded each rank rounds its own partial
    # gradient before the all_reduce.
    splat_merge: int = 1
    packed_splat: bool = False
    # the unfused path walk: persistent lanes (a finished path restarts its
    # lane on the pixel's next sample) or the per-sample loop
    persistent: bool = True
    # the unfused backwards: each tap into one bilinear corner picked with
    # probability its weight (unbiased), or into the four by their weights
    stochastic_splat: bool = True
    # "auto", True and "force": the kernel routes where they apply (the card
    # runs them everywhere: JAX's "auto" is on only off the CPU); False: the
    # unfused estimators
    fused: object = "auto"


def kernel_route(cfg: RenderConfig, material: torch.Tensor) -> bool:
    """Whether a render takes the kernel routes, as the JAX package's
    fused-route gates decide (wrapper.py:152-164, path_fused.py:64,
    direct_fused.py:81, collocated_fused.py:60): a bilinear fetch of a
    material of at least 2x2 and fused not False; for the path integrator
    the persistent walk and the stochastic splat, for the collocated one
    the stochastic splat, for the direct one MIS. Else the unfused
    estimators."""
    if not (cfg.bilinear and min(material.shape[0], material.shape[1]) >= 2
            and cfg.fused is not False):
        return False
    if cfg.integrator == "path":
        return cfg.persistent and cfg.stochastic_splat
    if cfg.integrator == "collocated":
        return cfg.stochastic_splat
    return cfg.use_mis


def check_scope(cfg: RenderConfig, material: torch.Tensor, data) -> None:
    """Raise for what the port does not render: NotImplementedError names the
    ROADMAP item that would port it."""
    if cfg.integrator not in ("path", "direct", "collocated"):
        raise ValueError(f"unknown integrator: {cfg.integrator!r}")
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler kind: {cfg.sampler!r}")
    if cfg.spp <= 0:
        raise ValueError(f"spp must be >= 1, got {cfg.spp}")
    if cfg.fused not in ("auto", "force", True, False):
        raise ValueError(f"fused must be 'auto', 'force', True or False, got {cfg.fused!r}")
    if not kernel_route(cfg, material):
        return
    from ..kernels import check_table_fits

    # the dense route holds its tables in shared memory; the BVH route reads
    # past it what does not fit there
    if data.accel is None or not data.accel.is_bvh:
        check_table_fits(data.meta.num_tris, table_floats(data.meta), cfg.integrator)


def pixel_grid(res, device) -> torch.Tensor:
    """(W*H, 2) int32 pixel coordinates, x fastest (JAX _pixel_grid)."""
    w, h = res
    k = torch.arange(w * h, dtype=torch.int32, device=device)
    return torch.stack([k % w, k // w], dim=1)


def primary_rays(coords, cam, sampler, res, use_tent: bool):
    """The camera's 2 draws and the jittered primary ray of each pixel (JAX
    _primary_rays) -> (o, d, sampler); cam is camera_const on the device."""
    from ..camera import camera_ray

    (u0, u1), sampler = sampler.next2_xy()
    o, d = camera_ray(cam, coords[:, 0], coords[:, 1], u0, u1, res, use_tent)
    return o, d, sampler


def _samplers(cfg, coords, seed):
    """The fresh sampler of each of the spp samples (JAX's scan over them)."""
    from ..samplers import make_sampler
    from ..samplers.pmj02bn import bluenoise

    bn = bluenoise(coords.device) if cfg.sampler == "pmj02bn" else None
    for it in range(cfg.spp):
        yield make_sampler(cfg.sampler, coords, seed, cfg.spp, it, bn)


def _kernel_render(integrator: str, backward: bool):
    """The kernel route's render, or its backward, of an integrator."""
    if integrator == "path":
        from .path_loop import render_path_backward_loop, render_path_loop

        return render_path_backward_loop if backward else render_path_loop
    if integrator == "collocated":
        from .collocated import render_collocated, render_collocated_backward

        return render_collocated_backward if backward else render_collocated
    from .direct import render_direct, render_direct_backward

    return render_direct_backward if backward else render_direct


def render_forward_rays(data, material, camera, seed: int, cfg: RenderConfig, estimator,
                        coords) -> torch.Tensor:
    """spp-averaged radiance of the pixels coords (N, 2) -> (N, 3) (JAX
    wrapper.py:134), the shardable unit: where kernel_route holds, the
    kernel route on the lanes of coords alone (a lane's math does not depend
    on the lanes beside it); else the unfused estimators: the persistent
    path walk, or the per-sample loop over `estimator` with the NaN guard
    and the clamp."""
    from ..camera import camera_const

    if kernel_route(cfg, material):
        from .path_loop import coord_lanes

        render = _kernel_render(cfg.integrator, backward=False)
        return render(data, material, camera, seed, cfg, coord_lanes(coords, cfg.spp))
    data = with_accel(data)
    if cfg.integrator == "path" and cfg.persistent:
        from .path_persistent import render_path_persistent

        return render_path_persistent(data, material, camera, seed, cfg, coords)
    cam = camera_const(camera).to(coords.device)
    acc = None
    for smp in _samplers(cfg, coords, seed):
        o, d, smp = primary_rays(coords, cam, smp, cfg.res, cfg.use_tent_filter)
        rad = torch.stack(estimator(data, material, o, d, smp, cfg), dim=1)
        good = ~torch.isnan(rad).any(dim=1, keepdim=True)
        rad = torch.where(good, torch.clamp(rad, 0.0, RADIANCE_CLAMP), 0.0)
        acc = rad if acc is None else acc + rad
    return div(acc, float(cfg.spp))


def render_grad_rays(data, material, camera, seed: int, le_grad, cfg: RenderConfig, estimator,
                     backward, coords) -> torch.Tensor:
    """d_material of the pixels coords (N, 2) given their (N, 3)
    per-sample adjoints (JAX wrapper.py:223): where kernel_route holds, the
    kernel route's backward on the lanes of coords alone; else the unfused
    estimators: the persistent PRB walk, or the per-sample loop over
    `backward`, or torch.autograd of `estimator` where backward is None."""
    from ..camera import camera_const

    if kernel_route(cfg, material):
        from .path_loop import coord_lanes

        render = _kernel_render(cfg.integrator, backward=True)
        return render(data, material, camera, seed, cfg, le_grad.T.contiguous(),
                      coord_lanes(coords, cfg.spp))
    data = with_accel(data)
    if cfg.integrator == "path" and cfg.persistent:
        from .path_persistent import render_path_backward_persistent

        return render_path_backward_persistent(data, material, camera, seed, cfg, coords,
                                               le_grad)
    cam = camera_const(camera).to(coords.device)
    d_mat = torch.zeros_like(material)
    for smp in _samplers(cfg, coords, seed):
        o, d, smp = primary_rays(coords, cam, smp, cfg.res, cfg.use_tent_filter)
        if backward is not None:
            d_mat = d_mat + backward(data, material, o, d, smp, le_grad, cfg)
            continue
        with torch.enable_grad():
            m = material.detach().requires_grad_()
            rad = torch.stack(estimator(data, m, o, d, smp, cfg), dim=1)
            rad = torch.where(torch.isnan(rad), 0.0, rad)
            (g,) = torch.autograd.grad((rad * le_grad).sum(), m, allow_unused=True)
        if g is not None:
            d_mat = d_mat + g
    return d_mat


def with_accel(data):
    """The data with an accel for the trace kernels: the dense rows of the
    dense route (a SceneData without an accel), built at each render, or
    its BVH."""
    if data.accel is not None:
        return data
    from ..accel.build import build_accel

    return dataclasses.replace(data, accel=build_accel(data.geom, "bruteforce"))


def pixel_adjoint(d_image: torch.Tensor, spp: int) -> torch.Tensor:
    """Every sample's adjoint of each pixel, x fastest: d_image[..., :3] /
    spp as (H*W, 3), NaN -> 0 (wrapper.py:299-323)."""
    le_grad = div(d_image[..., :3].reshape(-1, 3), float(spp))
    return torch.where(torch.isnan(le_grad), 0.0, le_grad)


def render_forward(data, material: torch.Tensor, camera, seed: int, cfg: RenderConfig) -> torch.Tensor:
    """Forward render -> (H, W, 4) image (mean radiance, alpha = 1): the
    full grid of render_forward_rays."""
    from . import get_integrator

    check_scope(cfg, material, data)
    w, h = cfg.res
    rgb = render_forward_rays(data, material, camera, seed, cfg, get_integrator(cfg.integrator)[0],
                              pixel_grid(cfg.res, data.device))
    rgb = rgb.reshape(h, w, 3)
    alpha = torch.ones((h, w, 1), dtype=torch.float32, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def render_grad(data, material: torch.Tensor, camera, seed: int, d_image: torch.Tensor,
                cfg: RenderConfig) -> torch.Tensor:
    """Gradient estimator (wrapper.py:299-323): replay the samples at this
    seed with d_image[..., :3] / spp as every sample's adjoint (NaN -> 0)
    -> d_material (H_tex, W_tex, 4): the full grid of render_grad_rays."""
    from . import get_integrator

    check_scope(cfg, material, data)
    estimator, backward = get_integrator(cfg.integrator)
    return render_grad_rays(data, material, camera, seed, pixel_adjoint(d_image, cfg.spp), cfg,
                            estimator, backward, pixel_grid(cfg.res, data.device))


class RenderFunction(torch.autograd.Function):
    """render_forward, differentiable in the material (wrapper.py:341-385,
    and the original zdr's RenderOperator): the backward re-estimates the
    gradient at seed + 1, decorrelated from the image it differentiates."""

    @staticmethod
    def forward(ctx, material, data, camera, seed: int, cfg: RenderConfig):
        ctx.save_for_backward(material)
        ctx.scene = (data, camera, seed, cfg)
        return render_forward(data, material, camera, seed, cfg)

    @staticmethod
    def backward(ctx, d_image):
        (material,) = ctx.saved_tensors
        data, camera, seed, cfg = ctx.scene
        # uint32 wrap: the bits of JAX's int32 seed + 1
        d_mat = render_grad(data, material, camera, (seed + 1) & 0xFFFFFFFF, d_image, cfg)
        return d_mat, None, None, None, None
