"""The trace-interact and shade steps of one bounce, on flat ray batches.

Port of zdr_tpu/integrators/pallas_bounce.py's two kernels as the direct
integrator calls them (direct_fused.py:124-268):

  trace_interact_plain   _trace_interact_kernel (:474) with
                         _interact_epilogue (:434): closest hit, winner
                         attributes, interaction and emitter-hit MIS;
  shade_plain            _shade_kernel (:917) in split mode: the NEE shadow
                         sweep (or a given occlusion), MIS weights, GGX shade
                         and sample, the next ray, roulette, and with grad
                         inputs the gradient taps and their splat id;
  light_hit_plain        the bounce ray's emitter-first lookup, its closest
  bounce_any_plain       hit over the light triangles alone
                         (fused_glue.light_hit_planes :384, the merged
                         _shade_kernel :1143-1200) and the any-hit of the
                         scene capped at it (:1201-1230, direct_fused.py
                         :217-227).

They take and return tuples of (N,) tensors in the order of the TPU
kernels' planes, without the (rows, 512) tiling. They are the plain
versions of the per-lane code in kernels/csrc/direct_step.cuh (which runs
the same steps inside the direct kernels) and of the trace_interact kernel.
The sweeps are brute force, O(T) per ray, or, given a BVH (the big-mesh
route, where the JAX package streamed B5/B6), the ordered walk of
accel/trace.py.
"""

from __future__ import annotations

import torch

from ..microfacet import (
    ggx_brdf,
    ggx_sample,
    ggx_sample_pdf,
    ggx_shade_vjp,
    make_onb,
    to_local,
    to_world,
)
from ..accel.trace import bvh_any, chunks
from ..texture import splat_ids
from ..vec import vadd, vdot, vnormalize, vscale
from .path_loop import T_MAX, _mt_all, closest_hit, interact_epilogue, occluded

# trace_interact's 16 outputs (pallas_bounce.py:1360); lite returns the
# last 4
TRACE_NAMES = (
    "p_x", "p_y", "p_z", "uv_x", "uv_y", "ns_x", "ns_y", "ns_z",
    "ng_x", "ng_y", "ng_z", "shade", "ae_r", "ae_g", "ae_b", "miss",
)
def trace_interact_plain(scene: torch.Tensor, rays, lite: bool = False, bvh=None):
    """Closest hit + interaction of every ray (the plain version of the
    trace_interact kernel). scene: the (T, 31) table; rays: 8 (N,) tensors
    o3, d3, pdf_prev float32 and active int32 -> the 16 TRACE_NAMES tensors
    (shade and miss int32), or with lite their last 4. Given `bvh`, the hit
    is the BVH walk's."""
    trace_interact_plain.calls += 1
    return interact_planes(scene, rays, closest_hit_plain(scene, rays[0:3], rays[3:6], bvh),
                           lite)


trace_interact_plain.calls = 0


def closest_hit_plain(scene: torch.Tensor, o, d, bvh=None):
    """path_loop.closest_hit of every ray, in chunks of rays over the
    scene rows, or through `bvh` -> (best_t, u, v, prim)."""
    if bvh is not None:
        return closest_hit(scene, o, d, bvh)
    parts = []
    for sl in chunks(o[0].shape[0], scene.shape[0]):
        parts.append(closest_hit(scene, [x[sl] for x in o], [x[sl] for x in d]))
    return tuple(torch.cat(x) for x in zip(*parts))


def interact_planes(scene: torch.Tensor, rays, hit, lite: bool = False):
    """trace_interact's outputs from a given closest hit (best_t, u, v,
    prim; t 1e30, u = v = 0 and prim -1 on a miss): the winner's attributes
    from `scene`, the interaction and the emitter-hit MIS -> the 16
    TRACE_NAMES tensors, or with lite their last 4."""
    o, d, pdf_prev, active = rays[0:3], rays[3:6], rays[6], rays[7] != 0
    best_t, bu, bv, prim = hit
    miss = prim < 0
    rows = torch.where(miss[:, None], 0.0, scene[torch.clamp_min(prim, 0), 9:31])
    p, uv, ns, ng, shade, ae = interact_epilogue(
        o, d, pdf_prev, active, best_t, bu, bv, miss, tuple(rows.unbind(1)))
    miss_i = (active & miss).to(torch.int32)
    if lite:
        return (*ae, miss_i)
    return (*p, *uv, *ns, *ng, shade.to(torch.int32), *ae, miss_i)


def occluded_plain(scene, p, wi, dist, bvh=None):
    """Any triangle hit at t in (1e-4, dist), per ray, in chunks of rays, or
    through `bvh`."""
    if bvh is not None:
        return occluded(scene, p, wi, dist, bvh)
    out = []
    for sl in chunks(p[0].shape[0], scene.shape[0]):
        ok, _u, _v, t = _mt_all(scene, [x[sl] for x in p], [x[sl] for x in wi])
        out.append((ok & (t > 1e-4) & (t < dist[sl][:, None])).any(dim=1))
    return torch.cat(out)


def light_hit_plain(scene, lights, light_rows, o, d, pdf_prev, active):
    """The closest hit of every ray over the L light triangles alone, at t
    in (0, 1e30), the first of equal nearest, with the emitter-hit MIS
    (fused_glue.light_hit_planes; pallas_bounce.py:1143-1200). lights: the
    (L, 16) light rows; light_rows: their scene-row ids, whose n0 dn1 dn2
    in `scene` give the shading normal of the front test -> (t_e (1e30:
    none), the radiance (3 tensors) as if the path to the light were clear,
    has: an active ray's light hit, on: has, front-facing and emissive)."""
    n, dev = o[0].shape[0], o[0].device
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    if lights.shape[0] == 0:
        none = torch.zeros((n,), dtype=torch.bool, device=dev)
        return zero + T_MAX, (zero, zero, zero), none, none
    best_t, bu, bv, prim = closest_hit_plain(lights, o, d)
    has = active & (prim >= 0)
    j = torch.clamp_min(prim, 0)
    lt = lights[j]
    nr = scene[light_rows.long()[j], 15:24]
    ns = vnormalize(tuple(nr[:, k] + bu * nr[:, 3 + k] + bv * nr[:, 6 + k] for k in range(3)))
    cos_light = -vdot((lt[:, 12], lt[:, 13], lt[:, 14]), d)
    front = (cos_light >= 1e-4) & (-vdot(ns, d) >= 1e-4)
    emissive = (lt[:, 9] > 0.0) | (lt[:, 10] > 0.0) | (lt[:, 11] > 0.0)
    pdf_hit = best_t * best_t / torch.clamp_min(lt[:, 15] * cos_light, 1e-12)
    mis = pdf_prev / torch.clamp_min(pdf_prev + pdf_hit, 1e-4)
    on = has & front & emissive
    return best_t, tuple(torch.where(on, mis * lt[:, 9 + c], 0.0) for c in range(3)), has, on


def bounce_any_plain(scene, o, d, t_max, active, bvh=None):
    """Any triangle hit at t in (0, t_max) by an active ray, the bounce's
    any-hit from its offset origin (direct_fused.py:219-227, t_lo 0), over
    the scene rows in chunks of rays, or through `bvh` -> (N,) bool, False
    where inactive."""
    occ = torch.zeros_like(active)
    if not bool(active.any()):
        return occ
    o, d, t_max = tuple(x[active] for x in o), tuple(x[active] for x in d), t_max[active]
    if bvh is not None:
        occ[active] = bvh_any(bvh, o, d, torch.zeros_like(t_max), t_max)[0]
        return occ
    out = []
    for sl in chunks(o[0].shape[0], scene.shape[0]):
        ok, _u, _v, t = _mt_all(scene, [x[sl] for x in o], [x[sl] for x in d])
        out.append((ok & (t > 0.0) & (t < t_max[sl][:, None])).any(dim=1))
    occ[active] = torch.cat(out)
    return occ


def shade_plain(scene, ray, nee, draws, rr_depth: int, max_depth: int, tex_h: int,
                tex_w: int, grad=None, occ_in=None, want_occ: bool = False, bvh=None):
    """One GGX bounce of every ray (the plain version of B2's split mode).

    ray: 24 (N,) tensors p3, ns3, ng3, d3, shade (int32), material4,
    beta3, depth (int32), add_emit3; nee: 8, wi_l3, dist, pdf, eval3 (the
    selected light sample); draws: 4, u_lobe, u0, u1, u_rr; grad: 10 more,
    in_grad (int32), le_rem3, le_grad3, uv2, u_splat; occ_in: an int32
    occlusion of the same shadow rays, which skips the sweep.
    -> 14 tensors: radiance_add3, beta_next3, pdf_bounce, next_o3,
    next_d3, alive (int32); with grad 8 more: le_rem_next3, g0..g3, splat
    id (int32; tex_h * tex_w where the tap splats nowhere); with want_occ
    the occlusion (int32) last (pallas_bounce.py:1429-1443). Given `bvh`,
    the shadow test walks it."""
    shade_plain.calls += 1
    p, ns, ng, d = ray[0:3], ray[3:6], ray[6:9], ray[9:12]
    shade = ray[12] != 0
    dif, rough = ray[13:16], ray[16]
    beta, depth, add_emit = ray[17:20], ray[20], ray[21:24]
    wi_l, l_dist, l_pdf, l_eval = nee[0:3], nee[3], nee[4], nee[5:8]
    u_lobe, ub0, ub1, u_rr = draws

    wo = vscale(d, -1.0)
    tangent, binormal = make_onb(ns)
    wo_local = to_local(tangent, binormal, ns, wo)
    occ = occ_in != 0 if occ_in is not None else occluded_plain(scene, p, wi_l, l_dist, bvh)
    wi_light_local = to_local(tangent, binormal, ns, wi_l)
    nee_ok = shade & ~occ & (wi_light_local[2] >= 1e-4)
    pdf_bsdf_at_light = ggx_sample_pdf(wo_local, wi_light_local, rough)
    mis_nee = l_pdf / torch.clamp_min(l_pdf + pdf_bsdf_at_light, 1e-4)
    nee_weight = mis_nee / torch.clamp_min(l_pdf, 1e-4)

    wi_local = ggx_sample(wo_local, rough, u_lobe, ub0, ub1)
    pdf_bounce = ggx_sample_pdf(wo_local, wi_local, rough)
    wi = to_world(tangent, binormal, ns, wi_local)
    bounce_ok = shade & (vdot(wi, ng) >= 1e-4) & (wi_local[2] >= 1e-4)
    next_o = vadd(p, vscale(ng, 1e-4))

    if grad is None:
        b_nee = ggx_brdf(wo_local, wi_light_local, dif, rough)
        b_bounce = ggx_brdf(wo_local, wi_local, dif, rough)
    else:
        b_nee, b_bounce, vjp = ggx_shade_vjp(wo_local, wi_light_local, wi_local, dif, rough)

    inv_pdf = 1.0 / torch.clamp_min(pdf_bounce, 1e-9)
    beta_next = tuple(beta[c] * b_bounce[c] * inv_pdf for c in range(3))
    lum = 0.212671 * beta_next[0] + 0.715160 * beta_next[1] + 0.072169 * beta_next[2]
    q = torch.clamp_min(lum, 0.05)
    do_rr = depth >= rr_depth
    dead = do_rr & ((lum == 0.0) | (u_rr >= q))
    rr_scale = torch.where(do_rr & ~dead & bounce_ok, 1.0 / q, 1.0)
    path_alive = bounce_ok & ~dead & (depth + 1 < max_depth)
    beta_next = vscale(beta_next, rr_scale)

    nee_c = tuple(b_nee[c] * nee_weight * l_eval[c] for c in range(3))
    rad = tuple(beta[c] * (add_emit[c] + torch.where(nee_ok, nee_c[c], 0.0)) for c in range(3))
    outs = [*rad, *beta_next, pdf_bounce, *next_o, *wi, path_alive.to(torch.int32)]

    if grad is not None:
        in_grad = grad[0] != 0
        le_rem, lg, uv, u_splat = grad[1:4], grad[4:7], grad[7:9], grad[9]
        # le_rem less this vertex's own terms: the rest of the path
        ler = tuple(le_rem[c] - torch.where(in_grad, rad[c], 0.0) for c in range(3))
        ct_nee = tuple(
            torch.where(in_grad & nee_ok, beta[c] * nee_weight * l_eval[c] * lg[c], 0.0)
            for c in range(3))
        # the continuation adjoint: le_rem / b_bounce per channel
        ct_bounce = tuple(
            torch.where(in_grad & bounce_ok & (b_bounce[c] > 1e-8),
                        ler[c] / torch.clamp_min(b_bounce[c], 1e-8) * lg[c], 0.0)
            for c in range(3))
        g = vjp((ct_nee, ct_bounce))
        grad_on = in_grad & (nee_ok | bounce_ok)
        g = [torch.where(grad_on & ~torch.isnan(x), x, 0.0) for x in g]
        ids = splat_ids(uv[0], uv[1], u_splat, tex_h, tex_w)
        ids = torch.where(grad_on, ids, tex_h * tex_w).to(torch.int32)
        outs += [*ler, *g, ids]
    if want_occ:
        outs.append(occ.to(torch.int32))
    return tuple(outs)


shade_plain.calls = 0
