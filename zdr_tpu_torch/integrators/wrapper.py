"""Render settings, the forward render, the texture gradient and the
autograd bridge between them (port of zdr_tpu/integrators/wrapper.py:34-116,
134-220, 299-385: the path loop's route and the direct and collocated
integrators' fused routes).

The port renders all spp in one call: the sampler is keyed by the absolute
sample index, so the JAX package's spp windows give the same image.
`RenderFunction` makes the render differentiable in the material: its
backward re-estimates the gradient at seed + 1 with the per-sample adjoint
d_image / spp (on the card the path_loop_grad, direct_grad or
collocated_grad kernel).
Everything outside the port's scope raises NotImplementedError naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..samplers import SAMPLERS
from ..vec import div
from .scene_tables import table_floats


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the fields of the JAX RenderConfig that the
    path loop and the direct integrator read)."""

    res: Tuple[int, int]  # (width, height)
    spp: int
    integrator: str = "direct"
    sampler: str = "pmj02bn"
    use_tent_filter: bool = True
    use_mis: bool = True  # direct: NEE and the BSDF bounce, MIS-weighted
    max_depth: int = 16
    rr_depth: int = 2
    bilinear: bool = True
    # the PRB backward's TPU scatter knobs (JAX defaults 4 and True); the
    # port splats every tap unmerged, in float32: the JAX package's exact
    # estimator. The direct integrator never merges (direct_fused.py:320).
    splat_merge: int = 1
    packed_splat: bool = False


def check_scope(cfg: RenderConfig, material: torch.Tensor, data) -> None:
    """Raise NotImplementedError for what the port does not render yet."""
    if cfg.integrator not in ("path", "direct", "collocated"):
        raise ValueError(f"unknown integrator: {cfg.integrator!r}")
    if cfg.integrator == "direct" and not cfg.use_mis:
        raise NotImplementedError(
            "direct integrator with use_mis=False (the JAX package's unfused "
            "direct.py): ROADMAP A10"
        )
    if data.meta.n_env and cfg.integrator == "path":
        raise NotImplementedError(
            "envmap with the path integrator (the env in the path kernels, "
            "path_loop and path_loop_grad): ROADMAP A11"
        )
    if not cfg.bilinear or min(material.shape[0], material.shape[1]) < 2:
        raise NotImplementedError(
            "render without the bilinear fetch (nearest filtering, or a "
            "material under 2x2): ROADMAP A6"
        )
    if cfg.sampler == "corrmj":
        raise NotImplementedError("corrmj sampler: ROADMAP A4")
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler kind: {cfg.sampler!r}")
    if cfg.sampler == "pmj02bn" and (cfg.spp <= 0 or cfg.spp & (cfg.spp - 1)):
        raise NotImplementedError(
            "pmj02bn at non-power-of-two spp (generic permutation): ROADMAP A4"
        )
    if (cfg.integrator == "path" and cfg.splat_merge != 1) or cfg.packed_splat:
        raise NotImplementedError(
            "splat_merge != 1 or packed_splat=True (merged or bf16-packed "
            "gradient splats): ROADMAP A17"
        )
    from ..kernels import check_table_fits

    # the dense route holds its tables in shared memory; the BVH route reads
    # past it what does not fit there
    if data.accel is None or not data.accel.is_bvh:
        check_table_fits(data.meta.num_tris, table_floats(data.meta), cfg.integrator)


def render_forward(data, material: torch.Tensor, camera, seed: int, cfg: RenderConfig) -> torch.Tensor:
    """Forward render -> (H, W, 4) image (mean radiance, alpha = 1)."""
    from .collocated import render_collocated
    from .direct import render_direct
    from .path_loop import render_path_loop

    check_scope(cfg, material, data)
    w, h = cfg.res
    render = {"direct": render_direct, "collocated": render_collocated,
              "path": render_path_loop}[cfg.integrator]
    rgb = render(data, material, camera, seed, cfg).reshape(h, w, 3)
    alpha = torch.ones((h, w, 1), dtype=torch.float32, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def render_grad(data, material: torch.Tensor, camera, seed: int, d_image: torch.Tensor,
                cfg: RenderConfig) -> torch.Tensor:
    """Gradient estimator (wrapper.py:299-323): replay the samples at this
    seed with d_image[..., :3] / spp as every sample's adjoint (NaN -> 0)
    -> d_material (H_tex, W_tex, 4)."""
    from .collocated import render_collocated_backward
    from .direct import render_direct_backward
    from .path_loop import render_path_backward_loop

    check_scope(cfg, material, data)
    w, h = cfg.res
    le_grad = div(d_image[..., :3].reshape(h * w, 3), float(cfg.spp))
    le_grad = torch.where(torch.isnan(le_grad), 0.0, le_grad)
    backward = {"direct": render_direct_backward, "collocated": render_collocated_backward,
                "path": render_path_backward_loop}[cfg.integrator]
    return backward(data, material, camera, seed, cfg, le_grad.T.contiguous())


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
