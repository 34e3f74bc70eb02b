"""The direct integrator (next-event estimation + one MIS-weighted BSDF
bounce): its forward render and its texture gradient.

Port of zdr_tpu/integrators/direct_fused.py, the route the JAX package
takes for a direct render on an accelerator, in its split mode. One sample
of a lane (`direct_sample_plain`, `_one_sample` :124-268) runs, in order:

  1. a fresh sampler and the camera's 2 draws -> the primary ray;
  2. trace_interact on it (no BSDF pdf: an emitter seen directly counts
     in full);
  3. the material at the hit's uv, NEE's 4 draws and light selection, the
     BSDF's 3 draws (no roulette draw);
  4. shade at depth 0, beta = 1: the shadow test, MIS, GGX shade, the
     bounce sample (roulette is inert, rr_depth 2);
  5. the lite trace_interact on the bounce ray: its MIS-weighted emitter;
     radiance = shade's radiance + beta_next * that emitter.

The backward replays each sample at seed + 1 and feeds shade's gradient
taps with le_rem = the sample's whole radiance (:259-268), one tap a
sample, added without a splat merge (:320-325).

`render_direct_plain`, `render_direct_backward_plain` and
`direct_sample_plain` are the plain versions of the CUDA kernels
(kernels/csrc/direct.cu): the kernels' wrappers run them for CPU tensors,
and on the card they run only where a check compares them with the kernels.
With a BVH in the tables (the big-mesh route) every sweep walks it, as the
kernels' BVH instantiations do.
"""

from __future__ import annotations

import torch

from ..camera import camera_ray
from ..samplers.hashes import lcg_to_unit_float
from ..texture import read_bilinear, scatter_add4
from ..vec import div
from .bounce import shade_plain, trace_interact_plain
from .path_loop import (
    PDF_NONE,
    RADIANCE_CLAMP,
    LoopTables,
    _fresh_state,
    _sampler,
    build_loop_tables,
    nee_select,
    pixel_lanes,
)

# direct_fused.py:204: rr_depth 2 and max_depth 16 at depth 0 -> no
# roulette, and the bounce goes on whenever it is valid
RR_DEPTH, MAX_DEPTH = 2, 16


def direct_sample_plain(tb: LoopTables, lanes, material, sample_idx: int, le_grad=None):
    """Sample `sample_idx` of every lane -> its radiance, 3 (N,) tensors.
    With le_grad, the (3, N) per-sample adjoint: -> (radiance, taps), taps
    the 4 gradient channels and the splat id of each lane's one tap."""
    direct_sample_plain.calls += 1
    n = lanes.shape[1]
    dev = lanes.device
    idx = torch.full((n,), sample_idx, dtype=torch.int32, device=dev)
    smp = _sampler(tb, lanes, *_fresh_state(tb, lanes, idx))
    (cu0, cu1), smp = smp.next2_xy()
    o, d = camera_ray(tb.cam, lanes[0], lanes[1], cu0, cu1, tb.res, tb.use_tent)
    big = torch.full((n,), PDF_NONE, dtype=torch.float32, device=dev)
    ones_i = torch.ones((n,), dtype=torch.int32, device=dev)
    k1 = trace_interact_plain(tb.scene, (*o, *d, big, ones_i), bvh=tb.bvh)
    p, uv, ns, ng, shade, ae = k1[0:3], k1[3:5], k1[5:8], k1[8:11], k1[11], k1[12:15]
    mat = read_bilinear(material, uv[0], uv[1])
    (wl, l_dist, l_pdf, lev), smp = nee_select(tb, p, smp)
    u_lobe, smp = smp.next1()
    (u0, u1), smp = smp.next2_xy()

    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    ray = (*p, *ns, *ng, *d, shade, *mat, ones, ones, ones, torch.zeros_like(ones_i), *ae)
    nee = (*wl, l_dist, l_pdf, *lev)
    draws = (u_lobe, u0, u1, torch.zeros_like(u_lobe))
    h, w = material.shape[0], material.shape[1]
    k2 = shade_plain(tb.scene, ray, nee, draws, RR_DEPTH, MAX_DEPTH, h, w,
                     want_occ=le_grad is not None, bvh=tb.bvh)
    bae = trace_interact_plain(tb.scene, (*k2[7:13], k2[6], k2[13]), lite=True, bvh=tb.bvh)
    rad = tuple(k2[c] + k2[3 + c] * bae[c] for c in range(3))
    if le_grad is None:
        return rad
    u_splat = lcg_to_unit_float(smp.salt())
    g = shade_plain(tb.scene, ray, nee, draws, RR_DEPTH, MAX_DEPTH, h, w,
                    grad=(ones_i, *rad, *le_grad, *uv, u_splat), occ_in=k2[14])
    return rad, g[17:22]


direct_sample_plain.calls = 0


def _accumulate(acc, rad):
    """The clamp-and-NaN rule of direct_fused.py:283-286."""
    good = ~(torch.isnan(rad[0]) | torch.isnan(rad[1]) | torch.isnan(rad[2]))
    return tuple(
        acc[c] + torch.where(good, torch.clamp(rad[c], 0.0, RADIANCE_CLAMP), 0.0)
        for c in range(3))


def _n_samples(lanes) -> int:
    """The most samples a lane takes: its stop row, spp on a render."""
    return int(lanes[2].max()) if lanes.shape[1] else 0


def render_direct_plain(tb: LoopTables, lanes, material) -> torch.Tensor:
    """Each lane's samples 0 .. stop-1 -> the (3, N) sums of their clamped
    radiances (the plain version of the direct kernel)."""
    render_direct_plain.calls += 1
    zero = torch.zeros((lanes.shape[1],), dtype=torch.float32, device=lanes.device)
    acc = (zero, zero, zero)
    for it in range(_n_samples(lanes)):
        more = _accumulate(acc, direct_sample_plain(tb, lanes, material, it))
        acc = tuple(torch.where(it < lanes[2], m, a) for m, a in zip(more, acc))
    return torch.stack(acc)


render_direct_plain.calls = 0


def render_direct_backward_plain(tb: LoopTables, lanes, material, le_grad):
    """Texture gradient of every lane's samples, given the (3, N) per-sample
    adjoint -> (d_material (H, W, 4), the (3, N) radiance sums of the same
    samples): the plain version of the direct_grad kernel."""
    render_direct_backward_plain.calls += 1
    h, w = material.shape[0], material.shape[1]
    lg = tuple(le_grad[c] for c in range(3))
    zero = torch.zeros_like(lg[0])
    acc = (zero, zero, zero)
    grad = torch.zeros((h * w, 4), dtype=torch.float32, device=material.device)
    for it in range(_n_samples(lanes)):
        rad, (g0, g1, g2, g3, ids) = direct_sample_plain(tb, lanes, material, it, lg)
        live = it < lanes[2]
        more = _accumulate(acc, rad)
        acc = tuple(torch.where(live, m, a) for m, a in zip(more, acc))
        # a lane past its stop splats nowhere (the sentinel id h * w)
        ids = torch.where(live, ids, h * w)
        grad += scatter_add4(ids.to(torch.int64), torch.stack([g0, g1, g2, g3], 1), h * w)
    return grad.reshape(h, w, 4), torch.stack(acc)


render_direct_backward_plain.calls = 0


def render_direct(data, material, camera, seed: int, cfg) -> torch.Tensor:
    """spp-averaged radiance of every pixel -> (W*H, 3). On a CUDA device
    one launch of the direct kernel; on the CPU the plain version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    lanes = pixel_lanes(cfg.res, cfg.spp, data.device)
    return div(kernels.direct(tb, lanes, material).T, float(cfg.spp))


def render_direct_backward(data, material, camera, seed: int, cfg, le_grad) -> torch.Tensor:
    """Texture gradient -> d_material (H, W, 4), given the (3, W*H)
    per-sample adjoint of each pixel lane. On a CUDA device one launch of
    the direct_grad kernel; on the CPU the plain version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    lanes = pixel_lanes(cfg.res, cfg.spp, data.device)
    grad, _acc = kernels.direct_grad(tb, lanes, material, le_grad)
    return grad
