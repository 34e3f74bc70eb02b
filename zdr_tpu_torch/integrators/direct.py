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
  5. the bounce ray's MIS-weighted emitter; radiance = shade's radiance +
     beta_next * that emitter. Where the tables carry the light triangles'
     scene rows (LoopTables.light_rows: L <= MERGED_MAX_LIGHT_TRIS, the JAX
     package's merged _shade_kernel, pallas_bounce.py:1134-1237, and its
     streamed route, direct_fused.py:203-236) it is looked up emitter
     first (`bounce_emit_plain`): the closest hit over the light triangles
     alone, then one any-hit of the scene on (0, 0.9999 t) of that hit; a
     ray that reaches no light walks nothing, or under an env walks to 1e30
     and adds the env where nothing is hit. Past the cap, the lite
     trace_interact: the closest hit over the scene (:244-257).

Under an environment light (LoopTables.env, direct_fused.py:151-156,
:242-251) a miss of the primary ray adds the env at MIS against no BSDF pdf,
the light selection may choose it (its shadow ray then runs to 1e30), and a
miss of the bounce ray adds it MIS-weighted against the BSDF pdf.

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
from ..envmap import env_miss_add
from ..samplers.hashes import lcg_to_unit_float
from ..texture import add_taps, read_bilinear
from ..vec import div
from .bounce import bounce_any_plain, light_hit_plain, shade_plain, trace_interact_plain
from .path_loop import (
    PDF_NONE,
    RADIANCE_CLAMP,
    T_MAX,
    LoopTables,
    _fresh_state,
    _sampler,
    build_loop_tables,
    nee_select,
)

# direct_fused.py:204: rr_depth 2 and max_depth 16 at depth 0 -> no
# roulette, and the bounce goes on whenever it is valid
RR_DEPTH, MAX_DEPTH = 2, 16
# the bounce's any-hit ends at this share of its light hit's t (the NEE
# shadow ray's epsilon, pallas_bounce.py:1201, direct_fused.py:222)
BOUNCE_CAP = 0.9999


def bounce_emit_plain(tb: LoopTables, o, d, pdf_bounce, alive):
    """The bounce rays' MIS-weighted emitter, looked up emitter first: each
    alive ray's closest light hit (light_hit_plain), kept where nothing of
    the scene lies on (0, BOUNCE_CAP t) of it (bounce_any_plain, walked
    only where the light adds something); without a light hit, under the
    env, the any-hit to 1e30 and the env where it is clear
    (direct_fused.py:217-236) -> 3 (N,) tensors."""
    bounce_emit_plain.calls += 1
    t_e, add, has, on = light_hit_plain(tb.scene, tb.lights, tb.light_rows, o, d, pdf_bounce,
                                        alive)
    walk = on | (alive & ~has) if tb.env is not None else on
    t_hi = torch.where(has, BOUNCE_CAP * t_e, T_MAX)
    clear = ~bounce_any_plain(tb.scene, o, d, t_hi, walk, bvh=tb.bvh)
    bae = tuple(torch.where(clear, a, 0.0) for a in add)
    if tb.env is None:
        return bae
    em = env_miss_add(tb.env, d, pdf_bounce, alive & ~has & clear, tb.inv_n_lights)
    return tuple(bae[c] + em[c] for c in range(3))


bounce_emit_plain.calls = 0


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
    if tb.env is not None:
        em = env_miss_add(tb.env, d, big, k1[15] != 0, tb.inv_n_lights)
        ae = tuple(ae[c] + em[c] for c in range(3))
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
    if tb.light_rows is not None:
        bae = bounce_emit_plain(tb, k2[7:10], k2[10:13], k2[6], k2[13] != 0)
    else:
        bae = trace_interact_plain(tb.scene, (*k2[7:13], k2[6], k2[13]), lite=True, bvh=tb.bvh)
        if tb.env is not None:
            em = env_miss_add(tb.env, k2[10:13], k2[6], bae[3] != 0, tb.inv_n_lights)
            bae = tuple(bae[c] + em[c] for c in range(3))
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
    samples): the plain version of the direct_grad kernel; with
    tb.packed_splat the taps are flushed every SPLAT_BATCH samples in bf16
    (texture.add_taps)."""
    render_direct_backward_plain.calls += 1
    h, w = material.shape[0], material.shape[1]
    lg = tuple(le_grad[c] for c in range(3))
    zero = torch.zeros_like(lg[0])
    acc = (zero, zero, zero)
    grad = torch.zeros((h * w, 4), dtype=torch.float32, device=material.device)
    scratch = torch.zeros_like(grad) if tb.packed_splat else None
    n_samples = _n_samples(lanes)
    for it in range(n_samples):
        rad, (g0, g1, g2, g3, ids) = direct_sample_plain(tb, lanes, material, it, lg)
        live = it < lanes[2]
        more = _accumulate(acc, rad)
        acc = tuple(torch.where(live, m, a) for m, a in zip(more, acc))
        # a lane past its stop splats nowhere (the sentinel id h * w)
        ids = torch.where(live, ids, h * w)
        add_taps(grad, scratch, it, n_samples, ids.to(torch.int64),
                 torch.stack([g0, g1, g2, g3], 1), h * w, tb.packed_splat)
    return grad.reshape(h, w, 4), torch.stack(acc)


render_direct_backward_plain.calls = 0


def render_direct(data, material, camera, seed: int, cfg, lanes) -> torch.Tensor:
    """spp-averaged radiance of every lane -> (N, 3); lanes: (3, N) int32
    rows px, py, spp (path_loop.coord_lanes; pixel_lanes for every pixel). On a
    CUDA device one launch of the direct kernel; on the CPU the plain
    version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    return div(kernels.direct(tb, lanes, material).T, float(cfg.spp))


def render_direct_backward(data, material, camera, seed: int, cfg, le_grad,
                           lanes) -> torch.Tensor:
    """Texture gradient -> d_material (H, W, 4), given the (3, N)
    per-sample adjoint of each lane; lanes as render_direct's. On a CUDA
    device one launch of the direct_grad kernel; on the CPU the plain version."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    grad, _acc = kernels.direct_grad(tb, lanes, material, le_grad)
    return grad


# ------------------------------------------------------ the unfused estimator


def direct_estimator(data, material, ray_o, ray_d, sampler, cfg=None):
    """NEE, and with MIS one BSDF bounce looking for emitters, of one sample
    per lane -> the radiance, 3 (N,) tensors (JAX direct.py:52): the JAX
    package's unfused estimator, which its fused route refuses without MIS
    (direct_fused.py:81). Sampling pdfs, MIS weights and the lights'
    radiance are detached, as JAX's stop_gradient places them: only the GGX
    factors carry the material's gradient."""
    from ..accel.trace import trace_any, trace_closest
    from ..envmap import env_radiance, env_sampled_light_pdf
    from ..interaction import gather_rows, surface_interact
    from ..lights import light_selection_pdf, sample_light, sample_light_pdf
    from ..microfacet import ggx_brdf, ggx_sample, ggx_sample_pdf, make_onb, to_local, to_world
    from ..texture import read_bsdf
    from ..vec import offset_ray_origin, vdot, vscale
    from .path import balanced_heuristic, bilinear_of, stack3

    mis_on = True if cfg is None else bool(cfg.use_mis)
    hit = trace_closest(data.accel, stack3(ray_o), stack3(ray_d))
    it = surface_interact(hit, data.geom)
    wo = vscale(ray_d, -1.0)
    zero = torch.zeros_like(hit.t)
    miss_radiance = (env_radiance(data.env, ray_d) if data.env is not None
                     else (zero, zero, zero))
    frontfacing = (vdot(wo, it.ng) >= 1e-4) & (vdot(wo, it.ns) >= 1e-4)
    emission = gather_rows(data.emission, torch.clamp_min(hit.inst, 0).long())
    hit_light = (emission[0] > 0.0) | (emission[1] > 0.0) | (emission[2] > 0.0)
    shade = ~hit.miss & frontfacing & ~hit_light

    mat = read_bsdf(torch.stack(it.uv, dim=1), material, bilinear_of(cfg))
    dif, rough = (mat[:, 0], mat[:, 1], mat[:, 2]), mat[:, 3]
    tangent, binormal = make_onb(it.ns)
    wo_local = to_local(tangent, binormal, it.ns, wo)

    # NEE: a light sample and its shadow ray
    light, sampler = sample_light(data, it.p, sampler)
    occluded = trace_any(data.accel, stack3(it.p), stack3(light.wi), t_min=1e-4,
                         t_max=light.dist.detach())
    wll = to_local(tangent, binormal, it.ns, light.wi)
    nee_ok = shade & ~occluded & (wll[2] > 0.0)
    bsdf_nee = ggx_brdf(wo_local, wll, dif, rough)
    l_pdf = light.pdf.detach()
    if mis_on:
        mis_nee = balanced_heuristic(l_pdf, ggx_sample_pdf(wo_local, wll, rough).detach())
    else:
        mis_nee = torch.ones_like(l_pdf)
    w_nee = mis_nee / torch.clamp_min(l_pdf, 1e-4)
    radiance = tuple(torch.where(nee_ok, bsdf_nee[c] * w_nee * light.eval[c].detach(), 0.0)
                     for c in range(3))

    if mis_on:
        # the BSDF sample: one more bounce looking for emitters
        u_lobe, sampler = sampler.next1()
        (u0, u1), sampler = sampler.next2_xy()
        wi_local = tuple(x.detach() for x in ggx_sample(wo_local, rough, u_lobe, u0, u1))
        wi = to_world(tangent, binormal, it.ns, wi_local)
        bounce_ok = shade & (vdot(wi, it.ng) >= 1e-4) & (wi_local[2] >= 1e-4)
        hit2 = trace_closest(data.accel, stack3(offset_ray_origin(it.p, it.ng)), stack3(wi))
        it2 = surface_interact(hit2, data.geom)
        nwi = vscale(wi, -1.0)
        front2 = (vdot(nwi, it2.ng) >= 1e-4) & (vdot(nwi, it2.ns) >= 1e-4)
        if data.env is not None:
            em_miss = env_radiance(data.env, wi)
            pdf_miss = env_sampled_light_pdf(data.env, wi) * light_selection_pdf(data)
        else:
            em_miss, pdf_miss = (zero, zero, zero), zero
        em_hit = gather_rows(data.emission, torch.clamp_min(hit2.inst, 0).long())
        pdf_hit = sample_light_pdf(data, tuple(x.detach() for x in it.p), hit2.inst,
                                   hit2.prim, it2.p)
        em2 = tuple(torch.where(hit2.miss, a, b) for a, b in zip(em_miss, em_hit))
        pdf_l2 = torch.where(hit2.miss, pdf_miss, pdf_hit)
        usable2 = (bounce_ok & (hit2.miss | front2)
                   & ((em2[0] > 0.0) | (em2[1] > 0.0) | (em2[2] > 0.0)))
        pdf_b2 = ggx_sample_pdf(wo_local, wi_local, rough).detach()
        mis2 = balanced_heuristic(pdf_b2, pdf_l2.detach())
        b2 = ggx_brdf(wo_local, wi_local, dif, rough)
        pdf_b2c = torch.clamp_min(pdf_b2, 1e-9)
        radiance = tuple(
            radiance[c] + torch.where(usable2, b2[c] / pdf_b2c * mis2 * em2[c].detach(), 0.0)
            for c in range(3))

    out = tuple(torch.where(shade, x, 0.0) for x in radiance)
    out = tuple(torch.where(hit_light & ~hit.miss & frontfacing, e.detach(), x)
                for e, x in zip(emission, out))
    return tuple(torch.where(hit.miss, m.detach(), x) for m, x in zip(miss_radiance, out))


def direct_backward(data, material, ray_o, ray_d, sampler, le_grad, cfg=None):
    """The direct estimator's hand-written gradient (JAX direct.py:145): the
    same sample again, the adjoint through the GGX factors only, one tap a
    sample -> d_material (H, W, 4). The tap splats into the corner the
    sampler's salt picks (stochastic_splat), the bilinear corners, or under
    nearest filtering the texel the forward read (path.splat)."""
    from ..accel.trace import trace_any, trace_closest
    from ..envmap import env_radiance, env_sampled_light_pdf
    from ..interaction import gather_rows, surface_interact
    from ..lights import light_selection_pdf, sample_light, sample_light_pdf
    from ..microfacet import ggx_sample, ggx_sample_pdf, ggx_shade_vjp, make_onb, to_local, to_world
    from ..texture import read_bsdf
    from ..vec import offset_ray_origin, vdot, vscale
    from .path import balanced_heuristic, bilinear_of, splat, stack3, stochastic_of

    mis_on = True if cfg is None else bool(cfg.use_mis)
    material = material.detach()
    hit = trace_closest(data.accel, stack3(ray_o), stack3(ray_d))
    it = surface_interact(hit, data.geom)
    wo = vscale(ray_d, -1.0)
    frontfacing = (vdot(wo, it.ng) >= 1e-4) & (vdot(wo, it.ns) >= 1e-4)
    emission = gather_rows(data.emission, torch.clamp_min(hit.inst, 0).long())
    hit_light = (emission[0] > 0.0) | (emission[1] > 0.0) | (emission[2] > 0.0)
    shade = ~hit.miss & frontfacing & ~hit_light
    uv = torch.stack(it.uv, dim=1)
    mat = read_bsdf(uv, material, bilinear_of(cfg))
    dif, rough = (mat[:, 0], mat[:, 1], mat[:, 2]), mat[:, 3]
    tangent, binormal = make_onb(it.ns)
    wo_local = to_local(tangent, binormal, it.ns, wo)

    light, sampler = sample_light(data, it.p, sampler)
    occluded = trace_any(data.accel, stack3(it.p), stack3(light.wi), t_min=1e-4,
                         t_max=light.dist)
    wll = to_local(tangent, binormal, it.ns, light.wi)
    nee_ok = shade & ~occluded & (wll[2] > 0.0)
    if mis_on:
        mis_nee = balanced_heuristic(light.pdf, ggx_sample_pdf(wo_local, wll, rough))
    else:
        mis_nee = torch.ones_like(light.pdf)
    w_nee = mis_nee / torch.clamp_min(light.pdf, 1e-4)
    zero = torch.zeros_like(w_nee)
    ct_bounce, wil, usable2 = (zero, zero, zero), wll, torch.zeros_like(nee_ok)
    if mis_on:
        u_lobe, sampler = sampler.next1()
        (u0, u1), sampler = sampler.next2_xy()
        wil = ggx_sample(wo_local, rough, u_lobe, u0, u1)
        wi = to_world(tangent, binormal, it.ns, wil)
        bounce_ok = shade & (vdot(wi, it.ng) >= 1e-4) & (wil[2] >= 1e-4)
        hit2 = trace_closest(data.accel, stack3(offset_ray_origin(it.p, it.ng)), stack3(wi))
        it2 = surface_interact(hit2, data.geom)
        nwi = vscale(wi, -1.0)
        front2 = (vdot(nwi, it2.ng) >= 1e-4) & (vdot(nwi, it2.ns) >= 1e-4)
        if data.env is not None:
            em_miss = env_radiance(data.env, wi)
            pdf_miss = env_sampled_light_pdf(data.env, wi) * light_selection_pdf(data)
        else:
            em_miss, pdf_miss = (zero, zero, zero), zero
        em_hit = gather_rows(data.emission, torch.clamp_min(hit2.inst, 0).long())
        em2 = tuple(torch.where(hit2.miss, a, b) for a, b in zip(em_miss, em_hit))
        pdf_l2 = torch.where(hit2.miss, pdf_miss,
                             sample_light_pdf(data, it.p, hit2.inst, hit2.prim, it2.p))
        usable2 = (bounce_ok & (hit2.miss | front2)
                   & ((em2[0] > 0.0) | (em2[1] > 0.0) | (em2[2] > 0.0)))
        pdf_b2 = ggx_sample_pdf(wo_local, wil, rough)
        mis2 = balanced_heuristic(pdf_b2, pdf_l2)
        w_b = mis2 / torch.clamp_min(pdf_b2, 1e-9)
        ct_bounce = tuple(torch.where(usable2, w_b * em2[c] * le_grad[:, c], 0.0)
                          for c in range(3))
    ct_nee = tuple(torch.where(nee_ok, w_nee * light.eval[c] * le_grad[:, c], 0.0)
                   for c in range(3))
    _b_nee, _b_bounce, vjp = ggx_shade_vjp(wo_local, wll, wil, dif, rough)
    return splat(torch.zeros_like(material), uv, vjp((ct_nee, ct_bounce)), nee_ok | usable2,
                 sampler.salt(), stochastic_of(cfg), bilinear_of(cfg))
