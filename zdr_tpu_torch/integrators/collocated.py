"""The collocated integrator (a unit point light at the camera, one closest
hit a sample, no shadow ray, no scene light): its forward render and its
texture gradient.

Port of zdr_tpu/integrators/collocated.py (`SPECULAR`, `_shade_parts`,
`collocated_estimator`, `collocated_backward` with the default
stochastic_splat=True) and of the JAX package's fused route for it,
collocated_fused.py (`_one_sample` :148-210, `render_collocated_fused`,
`render_collocated_backward_fused`). One sample of a lane
(`collocated_sample_plain`) runs, in order:

  1. a fresh sampler and the camera's 2 draws -> the primary ray;
  2. the closest hit and its interaction (trace_interact's B3, no BSDF
     pdf);
  3. the material at the hit's uv and the GGX shade at wi = wo (F0 0.04)
     times li = 1 / max(t, 1e-6)^2, on the shaded set: a front-facing hit,
     emissive or not, which B3 splits into shade and add_emit > 0
     (collocated_fused.py:178; `valid_front` is the unfused estimator's
     form, collocated.py:36-40: the same set);
  4. with an adjoint, the shade's VJP at the cotangent li * le_grad, into
     one texel: the bilinear corner drawn from the salt after the camera's
     draws.

t is the sweep's own hit distance, as the unfused estimator, which
tests/golden locks, takes it (collocated.py:43); the fused route derives t
again from the hit point (collocated_fused.py:184-185).

`render_collocated_plain`, `render_collocated_backward_plain` and
`collocated_sample_plain` are the plain versions of the CUDA kernels
(kernels/csrc/collocated.cu): the kernels' wrappers run them for CPU
tensors, and on the card they run only where a check compares them with
the kernels. With a BVH in the tables the sweep walks it, as the kernels'
BVH instantiations do.
"""

from __future__ import annotations

import torch

from ..camera import camera_ray
from ..microfacet import ggx_brdf, ggx_shade_vjp, make_onb, to_local
from ..samplers.hashes import lcg_to_unit_float
from ..texture import read_bilinear, scatter_add4, splat_ids
from ..vec import div, vdot, vscale
from .bounce import closest_hit_plain, interact_planes
from .direct import _accumulate, _n_samples
from .path_loop import (PDF_NONE, LoopTables, _fresh_state, _sampler, build_loop_tables,
                        pixel_lanes)


def _hit(tb: LoopTables, lanes, sample_idx: int):
    """The camera ray of sample `sample_idx` of every lane and its closest
    hit -> (d, best_t, trace_interact's 16 outputs, the sampler after the
    camera's draws)."""
    n = lanes.shape[1]
    dev = lanes.device
    idx = torch.full((n,), sample_idx, dtype=torch.int32, device=dev)
    smp = _sampler(tb, lanes, *_fresh_state(tb, lanes, idx))
    (cu0, cu1), smp = smp.next2_xy()
    o, d = camera_ray(tb.cam, lanes[0], lanes[1], cu0, cu1, tb.res, tb.use_tent)
    rays = (*o, *d, torch.full((n,), PDF_NONE, dtype=torch.float32, device=dev),
            torch.ones((n,), dtype=torch.int32, device=dev))
    hit = closest_hit_plain(tb.scene, o, d, tb.bvh)
    return d, hit[0], interact_planes(tb.scene, rays, hit), smp


def valid_front(tb: LoopTables, lanes, sample_idx: int) -> torch.Tensor:
    """The shaded set of sample `sample_idx` by the unfused estimator's
    tests: a hit whose geometric and shading normals both face the ray
    (collocated.py:36-40)."""
    d, _t, k1, _smp = _hit(tb, lanes, sample_idx)
    wo = vscale(d, -1.0)
    hit = k1[15] == 0
    return hit & (vdot(wo, k1[8:11]) >= 1e-4) & (vdot(wo, k1[5:8]) >= 1e-4)


def collocated_sample_plain(tb: LoopTables, lanes, material, sample_idx: int, le_grad=None):
    """Sample `sample_idx` of every lane -> its radiance, 3 (N,) tensors.
    With le_grad, the (3, N) per-sample adjoint: -> (radiance, taps), taps
    the 4 gradient channels and the splat id of each lane's one tap (h * w
    where it splats nowhere)."""
    collocated_sample_plain.calls += 1
    d, t, k1, smp = _hit(tb, lanes, sample_idx)
    uv, ns, shade, ae = k1[3:5], k1[5:8], k1[11] != 0, k1[12:15]
    valid = shade | (ae[0] > 0) | (ae[1] > 0) | (ae[2] > 0)
    inv_t = 1.0 / torch.clamp_min(t, 1e-6)
    li = inv_t * inv_t
    dif0, dif1, dif2, rough = read_bilinear(material, uv[0], uv[1])
    dif = (dif0, dif1, dif2)
    tangent, binormal = make_onb(ns)
    wo_local = to_local(tangent, binormal, ns, vscale(d, -1.0))
    if le_grad is None:
        beta = ggx_brdf(wo_local, wo_local, dif, rough)
    else:
        beta, _b, vjp = ggx_shade_vjp(wo_local, wo_local, wo_local, dif, rough)
    rad = tuple(torch.where(valid, beta[c] * li, 0.0) for c in range(3))
    if le_grad is None:
        return rad
    zero = torch.zeros_like(li)
    ct = tuple(torch.where(valid, li * le_grad[c], 0.0) for c in range(3))
    g = vjp((ct, (zero, zero, zero)))
    g = [torch.where(valid & ~torch.isnan(x), x, 0.0) for x in g]
    h, w = material.shape[0], material.shape[1]
    ids = splat_ids(uv[0], uv[1], lcg_to_unit_float(smp.salt()), h, w)
    ids = torch.where(valid, ids, h * w).to(torch.int32)
    return rad, (*g, ids)


collocated_sample_plain.calls = 0


def render_collocated_plain(tb: LoopTables, lanes, material) -> torch.Tensor:
    """Each lane's samples 0 .. stop-1 -> the (3, N) sums of their clamped
    radiances (the plain version of the collocated kernel)."""
    render_collocated_plain.calls += 1
    zero = torch.zeros((lanes.shape[1],), dtype=torch.float32, device=lanes.device)
    acc = (zero, zero, zero)
    for it in range(_n_samples(lanes)):
        more = _accumulate(acc, collocated_sample_plain(tb, lanes, material, it))
        acc = tuple(torch.where(it < lanes[2], m, a) for m, a in zip(more, acc))
    return torch.stack(acc)


render_collocated_plain.calls = 0


def render_collocated_backward_plain(tb: LoopTables, lanes, material, le_grad):
    """Texture gradient of every lane's samples, given the (3, N) per-sample
    adjoint -> (d_material (H, W, 4), the (3, N) radiance sums of the same
    samples): the plain version of the collocated_grad kernel."""
    render_collocated_backward_plain.calls += 1
    h, w = material.shape[0], material.shape[1]
    lg = tuple(le_grad[c] for c in range(3))
    zero = torch.zeros_like(lg[0])
    acc = (zero, zero, zero)
    grad = torch.zeros((h * w, 4), dtype=torch.float32, device=material.device)
    for it in range(_n_samples(lanes)):
        rad, (g0, g1, g2, g3, ids) = collocated_sample_plain(tb, lanes, material, it, lg)
        live = it < lanes[2]
        more = _accumulate(acc, rad)
        acc = tuple(torch.where(live, m, a) for m, a in zip(more, acc))
        ids = torch.where(live, ids, h * w)
        grad += scatter_add4(ids.to(torch.int64), torch.stack([g0, g1, g2, g3], 1), h * w)
    return grad.reshape(h, w, 4), torch.stack(acc)


render_collocated_backward_plain.calls = 0


def render_collocated(data, material, camera, seed: int, cfg) -> torch.Tensor:
    """spp-averaged radiance of every pixel -> (W*H, 3). On a CUDA device
    one launch of the collocated kernel; on the CPU the plain version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    lanes = pixel_lanes(cfg.res, cfg.spp, data.device)
    return div(kernels.collocated(tb, lanes, material).T, float(cfg.spp))


def render_collocated_backward(data, material, camera, seed: int, cfg, le_grad) -> torch.Tensor:
    """Texture gradient -> d_material (H, W, 4), given the (3, W*H)
    per-sample adjoint of each pixel lane. On a CUDA device one launch of
    the collocated_grad kernel; on the CPU the plain version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    lanes = pixel_lanes(cfg.res, cfg.spp, data.device)
    grad, _acc = kernels.collocated_grad(tb, lanes, material, le_grad)
    return grad
