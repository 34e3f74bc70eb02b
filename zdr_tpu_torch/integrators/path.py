"""The unfused path tracer and its Path Replay Backpropagation (port of
zdr_tpu/integrators/path.py).

Forward (`path_estimator`): max_depth bounces of every lane, masked, with
NEE + MIS at each; an emitter hit is weighted against the BSDF pdf its ray
carries (1e30 for a camera ray: full weight); Russian roulette from
rr_depth on the throughput's luminance, q >= 0.05.

Backward (`path_backward`), PRB: replay the forward on the same stream for
the path's radiance Le, then walk it again, taking from Le at each bounce
what the bounce itself added, so that Le holds the radiance of the rest of
the path, and inject two adjoints through the local BRDF only:
    nee:    d b_nee    <- beta * mis * light.eval / pdf * le_grad
    bounce: d b_bounce <- Le / b_bounce * le_grad
The Le / b_bounce form is the JAX package's fix of the reference's
beta / pdf * Le (README "Differences"): Le is absolute, and every later
beta is proportional to this bounce's BSDF value.

Under nearest filtering the backward splats each tap into the texel the
forward read, as read_bsdf's VJP and the collocated backward do; the JAX
package's path backward splats to the bilinear corners there, which is
not the derivative of its own forward (README "Differences").

The traces go through accel.trace_closest / trace_any: on the card the
trace_closest and trace_any kernels (kernels/csrc/accel.cu), dense or BVH
by the scene's route. Vectors are component tuples of (N,) tensors. Every
lane draws the same dimensions a bounce, so that a replay is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.trace import trace_any, trace_closest
from ..envmap import env_radiance, env_sampled_light_pdf
from ..interaction import gather_rows, surface_interact
from ..lights import light_selection_pdf, sample_light, sample_light_pdf
from ..microfacet import (ggx_brdf, ggx_sample, ggx_sample_pdf, ggx_shade_vjp, make_onb,
                          to_local, to_world)
from ..samplers.hashes import lcg_to_unit_float
from ..texture import read_bsdf, write_bsdf_grad, write_bsdf_grad_stochastic
from ..vec import luminance, offset_ray_origin, vdot, vscale

MAX_DEPTH = 16  # RenderConfig.max_depth's default
RR_DEPTH = 2  # RenderConfig.rr_depth's default


def depths(cfg):
    """(max_depth, rr_depth) of a config (the defaults for None)."""
    if cfg is None:
        return MAX_DEPTH, RR_DEPTH
    return cfg.max_depth, cfg.rr_depth


def bilinear_of(cfg) -> bool:
    return True if cfg is None else bool(cfg.bilinear)


def balanced_heuristic(pdf_a, pdf_b):
    return pdf_a / torch.clamp_min(pdf_a + pdf_b, 1e-4)


def stack3(v) -> torch.Tensor:
    """A component tuple -> an (N, 3) tensor without gradient, for a trace."""
    return torch.stack(v, dim=1).detach()


class Vertex(NamedTuple):
    """What one bounce computes, the same in the forward and the backward."""

    active: torch.Tensor  # the lane walks on after this vertex
    add_emit: tuple  # emitter or env radiance added at this vertex
    nee_ok: torch.Tensor
    nee_weight: torch.Tensor  # mis / max(light.pdf, 1e-4)
    nee_light_eval: tuple
    bsdf_nee: tuple  # brdf * cos toward the light
    bsdf_bounce: tuple  # brdf * cos along the continuation
    pdf_bounce: torch.Tensor
    uv: torch.Tensor  # (N, 2) texture coordinates of the hit
    mat: torch.Tensor  # (N, 4) material fetched at the hit
    wo_local: tuple
    wi_nee_local: tuple
    wi_bounce_local: tuple
    next_o: tuple
    next_d: tuple
    u_rr: torch.Tensor  # the roulette's uniform; the caller decides survival


def walk_one_bounce(data, material, o, d, pdf_prev, active, sampler, cfg=None):
    """One bounce of every lane (path.py:93) -> (Vertex, sampler)."""
    hit = trace_closest(data.accel, stack3(o), stack3(d))
    it = surface_interact(hit, data.geom)
    wo = vscale(d, -1.0)
    miss = hit.miss

    zero = torch.zeros_like(pdf_prev)
    if data.env is not None:
        pdf_env = env_sampled_light_pdf(data.env, d) * light_selection_pdf(data)
        mis_env = balanced_heuristic(pdf_prev, pdf_env)
        env_add = tuple(mis_env * x for x in env_radiance(data.env, d))
    else:
        env_add = (zero, zero, zero)

    frontfacing = (vdot(wo, it.ng) >= 1e-4) & (vdot(wo, it.ns) >= 1e-4)
    emission = gather_rows(data.emission, torch.clamp_min(hit.inst, 0).long())
    emissive = (emission[0] > 0.0) | (emission[1] > 0.0) | (emission[2] > 0.0)
    pdf_light_hit = sample_light_pdf(data, o, hit.inst, hit.prim, it.p)
    mis_hit = balanced_heuristic(pdf_prev, pdf_light_hit)
    on_env = active & miss
    on_emit = active & ~miss & frontfacing & emissive
    add_emit = tuple(torch.where(on_env, ea, torch.where(on_emit, mis_hit * e, 0.0))
                     for ea, e in zip(env_add, emission))
    # an emissive instance is a light, every other one is shaded (JAX's
    # deviation from the reference's instance-0 rule)
    shade = active & ~miss & frontfacing & ~emissive

    uv = torch.stack(it.uv, dim=1)
    mat = read_bsdf(uv, material, bilinear_of(cfg))
    dif = (mat[:, 0], mat[:, 1], mat[:, 2])
    rough = mat[:, 3]
    tangent, binormal = make_onb(it.ns)
    wo_local = to_local(tangent, binormal, it.ns, wo)

    # NEE: the same draws for every lane
    light, sampler = sample_light(data, it.p, sampler)
    occluded = trace_any(data.accel, stack3(it.p), stack3(light.wi), t_min=1e-4,
                         t_max=light.dist.detach())
    wi_light_local = to_local(tangent, binormal, it.ns, light.wi)
    nee_ok = shade & ~occluded & (wi_light_local[2] >= 1e-4)
    bsdf_nee = ggx_brdf(wo_local, wi_light_local, dif, rough)
    pdf_bsdf_at_light = ggx_sample_pdf(wo_local, wi_light_local, rough)
    mis_nee = balanced_heuristic(light.pdf, pdf_bsdf_at_light)
    nee_weight = mis_nee / torch.clamp_min(light.pdf, 1e-4)

    # the BSDF sample
    u_lobe, sampler = sampler.next1()
    (u0, u1), sampler = sampler.next2_xy()
    wi_local = ggx_sample(wo_local, rough, u_lobe, u0, u1)
    pdf_bounce = ggx_sample_pdf(wo_local, wi_local, rough)
    wi = to_world(tangent, binormal, it.ns, wi_local)
    bounce_ok = shade & (vdot(wi, it.ng) >= 1e-4) & (wi_local[2] >= 1e-4)
    bsdf_bounce = ggx_brdf(wo_local, wi_local, dif, rough)

    # the roulette's draw, by every lane
    u_rr, sampler = sampler.next1()
    return Vertex(
        active=bounce_ok, add_emit=add_emit, nee_ok=nee_ok, nee_weight=nee_weight,
        nee_light_eval=light.eval, bsdf_nee=bsdf_nee, bsdf_bounce=bsdf_bounce,
        pdf_bounce=pdf_bounce, uv=uv, mat=mat, wo_local=wo_local,
        wi_nee_local=wi_light_local, wi_bounce_local=wi_local,
        next_o=offset_ray_origin(it.p, it.ng), next_d=wi, u_rr=u_rr,
    ), sampler


def apply_rr(depth, beta, active, u_rr, rr_depth: int):
    """Russian roulette on the luminance of beta (path.py:186) -> (active',
    the scale of beta: 1/q on survival)."""
    lum = luminance(beta)
    q = torch.clamp_min(lum, 0.05)
    do_rr = torch.as_tensor(depth, device=u_rr.device) >= rr_depth
    dead = do_rr & ((lum == 0.0) | (u_rr >= q))
    scale = torch.where(do_rr & ~dead & active, 1.0 / q, 1.0)
    return active & ~dead, scale


def next_beta(beta, v: Vertex, depth, rr_depth: int):
    """The forward's beta * b_bounce / pdf (a division, where the backward
    multiplies by 1 / pdf, as JAX's) and the roulette -> (active', beta'
    where the lane walks on, beta elsewhere)."""
    pdf = torch.clamp_min(v.pdf_bounce, 1e-9)
    b = tuple(beta[c] * v.bsdf_bounce[c] / pdf for c in range(3))
    active2, rr = apply_rr(depth, b, v.active, v.u_rr, rr_depth)
    return active2, tuple(torch.where(active2, b[c] * rr, beta[c]) for c in range(3))


def nee_term(v: Vertex):
    """b_nee * mis / pdf * light.eval, per channel."""
    return tuple(v.bsdf_nee[c] * v.nee_weight * v.nee_light_eval[c] for c in range(3))


def _start(ray_o):
    n, dev = ray_o[0].shape[0], ray_o[0].device
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    return (one, one, one), torch.full((n,), 1e30, dtype=torch.float32, device=dev)


def path_estimator(data, material, ray_o, ray_d, sampler, cfg=None):
    """Forward path trace -> the radiance, 3 (N,) tensors (path.py:197).
    Differentiable in the material by torch.autograd (read_bsdf's VJP)."""
    md, rr_d = depths(cfg)
    beta, pdf_prev = _start(ray_o)
    zero = torch.zeros_like(pdf_prev)
    radiance = (zero, zero, zero)
    active = torch.ones_like(pdf_prev, dtype=torch.bool)
    o, d, smp = ray_o, ray_d, sampler
    for depth in range(md):
        v, smp = walk_one_bounce(data, material, o, d, pdf_prev, active, smp, cfg)
        nee = nee_term(v)
        radiance = tuple(radiance[c] + beta[c] * v.add_emit[c] for c in range(3))
        radiance = tuple(radiance[c] + torch.where(v.nee_ok, beta[c] * nee[c], 0.0)
                         for c in range(3))
        active, beta = next_beta(beta, v, depth, rr_d)
        pdf_prev = torch.where(active, v.pdf_bounce, pdf_prev)
        o, d = v.next_o, v.next_d
    return radiance


def splat(d_mat, uv: torch.Tensor, grads, on: torch.Tensor, salt, stochastic: bool,
          bilinear: bool) -> torch.Tensor:
    """d_mat (H, W, 4) plus the 4 (N,) gradient planes of the lanes `on`
    (NaN -> 0; the others add 0): into the corner the salt's uniform picks
    (stochastic, bilinear filtering), the bilinear corners by their
    weights, or under nearest filtering the texel the forward read."""
    g = torch.stack([torch.where(on & ~torch.isnan(x), x, 0.0) for x in grads], dim=1)
    if stochastic and bilinear:
        return write_bsdf_grad_stochastic(uv, g, d_mat, lcg_to_unit_float(salt))
    return write_bsdf_grad(uv, g, d_mat, bilinear)


def stochastic_of(cfg) -> bool:
    return cfg is not None and bool(getattr(cfg, "stochastic_splat", False))


def path_backward(data, material, ray_o, ray_d, sampler, le_grad, cfg=None):
    """PRB texture gradient of one sample per lane, given its (N, 3) adjoint
    -> d_material (H, W, 4) (path.py:237)."""
    md, rr_d = depths(cfg)
    material = material.detach()
    le = path_estimator(data, material, ray_o, ray_d, sampler, cfg)
    le_ok = ~(torch.isnan(le[0]) | torch.isnan(le[1]) | torch.isnan(le[2]))
    le_c = tuple(torch.where(le_ok, x, 0.0) for x in le)
    lg = tuple(torch.where(le_ok, le_grad[:, c], 0.0) for c in range(3))
    stochastic, bilinear = stochastic_of(cfg), bilinear_of(cfg)
    d_mat = torch.zeros_like(material)
    beta, pdf_prev = _start(ray_o)
    active = torch.ones_like(pdf_prev, dtype=torch.bool)
    o, d, smp = ray_o, ray_d, sampler
    for depth in range(md):
        v, smp = walk_one_bounce(data, material, o, d, pdf_prev, active, smp, cfg)
        le_c = tuple(le_c[c] - beta[c] * v.add_emit[c] for c in range(3))
        dif = (v.mat[:, 0], v.mat[:, 1], v.mat[:, 2])
        b_nee, b_bounce, vjp = ggx_shade_vjp(v.wo_local, v.wi_nee_local, v.wi_bounce_local,
                                             dif, v.mat[:, 3])
        nee_full = tuple(beta[c] * b_nee[c] * v.nee_weight * v.nee_light_eval[c]
                         for c in range(3))
        ct_nee = tuple(torch.where(v.nee_ok, beta[c] * v.nee_weight * v.nee_light_eval[c]
                                   * lg[c], 0.0) for c in range(3))
        le_c = tuple(le_c[c] - torch.where(v.nee_ok, nee_full[c], 0.0) for c in range(3))
        # the continuation adjoint: le_c, absolute, over this bounce's BSDF
        ct_bounce = tuple(torch.where(v.active & (b_bounce[c] > 1e-8),
                                      le_c[c] / torch.clamp_min(b_bounce[c], 1e-8) * lg[c], 0.0)
                          for c in range(3))
        grads = vjp((ct_nee, ct_bounce))
        d_mat = splat(d_mat, v.uv, grads, v.nee_ok | v.active, smp.salt(), stochastic, bilinear)
        inv_pdf = 1.0 / torch.clamp_min(v.pdf_bounce, 1e-9)
        b = tuple(beta[c] * b_bounce[c] * inv_pdf for c in range(3))
        active, rr = apply_rr(depth, b, v.active, v.u_rr, rr_d)
        beta = tuple(torch.where(active, b[c] * rr, beta[c]) for c in range(3))
        pdf_prev = torch.where(active, v.pdf_bounce, pdf_prev)
        o, d = v.next_o, v.next_d
    return d_mat


def path_stats(data, material, ray_o, ray_d, sampler, cfg=None):
    """Closest-hit and shadow traces a camera sample, averaged over the lanes
    (path.py:335): every live lane traces one closest hit a bounce, every
    shading lane one shadow ray -> (closest, shadow) float."""
    md, rr_d = depths(cfg)
    n = ray_o[0].shape[0]
    beta, pdf_prev = _start(ray_o)
    active = torch.ones_like(pdf_prev, dtype=torch.bool)
    o, d, smp = ray_o, ray_d, sampler
    n_closest = n_shadow = 0
    for depth in range(md):
        n_closest += int(active.sum())
        v, smp = walk_one_bounce(data, material, o, d, pdf_prev, active, smp, cfg)
        n_shadow += int((v.nee_ok | v.active).sum())
        active, beta = next_beta(beta, v, depth, rr_d)
        pdf_prev = torch.where(active, v.pdf_bounce, pdf_prev)
        o, d = v.next_o, v.next_d
    return n_closest / n, n_shadow / n
