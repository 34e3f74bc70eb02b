"""Persistent path loop: one path bounce per step for every lane, and the
PRB texture gradient on the same walk.

Port of zdr_tpu/integrators/pallas_loop.py::_loop_kernel (:388-684) in both
modes, of `render_path_loop` (:1017-1069) and of the one-walk backward
`render_path_backward_loop` (:1082-1286). One step of a lane runs, in order:

  1. the bilinear material fetch at the carried uv;
  2. the NEE shadow test, GGX shade + sample, Russian roulette;
  3. termination bookkeeping, and the restart of a lane that has samples
     left: a fresh sampler at the next sample index and a camera ray;
  4. the next closest hit, its interaction and the emitter-hit MIS, and
     under an environment map the env's MIS-weighted radiance on a miss;
  5. the NEE light selection (the env, the point and the mesh lights) and
     the next bounce's draws.

The draws follow pallas_loop.py:592-640 exactly, so the sample stream is the
JAX package's. In tap mode a step also returns its gradient taps
(TAP_NAMES). `loop_step`, `render_path_loop_plain` and
`render_path_backward_loop_plain` are the plain versions of the CUDA
kernels (kernels/csrc/path_loop.cu, path_loop_grad.cu): the kernels'
wrappers run them for CPU tensors, and on the card they run only where a
check compares them with the kernels.

The closest-hit and occlusion sweeps are brute force, O(T) per ray, over the
triangle table, or, when the tables carry a BVH (LoopTables.bvh, the big-mesh
route), the ordered walk of accel/trace.py that the BVH kernels run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..accel.trace import bvh_any, bvh_closest, mt
from ..accel.types import Accel
from ..camera import camera_const, camera_ray
from ..envmap import EnvMap, env_miss_add, sample_envmap
from ..microfacet import (
    ggx_brdf,
    ggx_sample,
    ggx_shade_vjp,
    ggx_sample_pdf,
    make_onb,
    to_local,
    to_world,
)
from ..samplers.corrmj import corrmj_fresh_state, corrmj_sampler
from ..samplers.hashes import lcg_step, lcg_to_unit_float, to_i32, u32
from ..samplers.lcg import LCGSampler, lcg_fresh_state
from ..samplers.pmj02bn import bluenoise, bn_base, pmj02bn_class
from ..texture import read_bilinear, reservoir_merge_taps, scatter_add4, splat_ids
from ..vec import div, luminance, offset_ray_origin, vadd, vdot, vnormalize, vscale, vsub
from . import scene_tables
from .wrapper import pixel_grid

RADIANCE_CLAMP = 1e5
T_MAX = 1e30  # the closest-hit distance of a miss
PDF_NONE = 1e30  # the "no BSDF pdf" emitter-MIS context of a camera ray

# the carry, one (N,) row per name: F_NAMES float32 then I_NAMES int32
F_NAMES = (
    "acc_r", "acc_g", "acc_b", "cur_r", "cur_g", "cur_b",
    "beta_r", "beta_g", "beta_b",
    "d_x", "d_y", "d_z", "p_x", "p_y", "p_z",
    "ns_x", "ns_y", "ns_z", "ng_x", "ng_y", "ng_z",
    "ae_r", "ae_g", "ae_b", "uv_x", "uv_y",
    "wl_x", "wl_y", "wl_z", "l_dist", "l_pdf",
    "lev_r", "lev_g", "lev_b",
    "u_lobe", "u_b0", "u_b1", "u_rr",
)
# smp0..smp2: corrmj (sample_index, dimension, state), as the JAX kernel
# carries them (pallas_loop.py:177-184); pmj02bn (sample_index, dimension,
# 0); lcg (state, 0, 0)
I_NAMES = ("sample_idx", "shade", "depth", "in_flight", "smp0", "smp1", "smp2")
F_IDX = {n: k for k, n in enumerate(F_NAMES)}
I_IDX = {n: k for k, n in enumerate(I_NAMES)}
# one step's gradient taps in tap mode (pallas_loop.py:666-687): radiance,
# P (the NEE part), Q and S (the bounce part, times G'), the merge draw
# u_m, the splat texel id (H*W: none) and flags (terminated | good << 1 |
# in_flight << 2)
TAP_NAMES = (
    "rad_r", "rad_g", "rad_b", "p0", "p1", "p2", "p3", "q0", "q1", "q2",
    "s0", "s1", "s2", "u_m", "ids", "flags",
)
N_TAP_PLANES = len(TAP_NAMES)


@dataclasses.dataclass
class Carry:
    """The state of every lane between steps. The lanes themselves are a
    (3, N) int32 tensor of rows px, py and the sample index to stop at."""

    f: torch.Tensor  # (len(F_NAMES), N) float32
    i: torch.Tensor  # (len(I_NAMES), N) int32


def init_carry(lanes: torch.Tensor) -> Carry:
    """No lane is in flight and every lane starts at sample 0: the first
    step's restart path draws every first camera ray (pallas_loop.py:998)."""
    n = lanes.shape[1]
    f = torch.zeros((len(F_NAMES), n), dtype=torch.float32, device=lanes.device)
    f[F_IDX["l_pdf"]] = 1.0
    i = torch.zeros((len(I_NAMES), n), dtype=torch.int32, device=lanes.device)
    return Carry(f, i)


@dataclasses.dataclass
class LoopTables:
    """Everything a step reads besides the carry, the lanes and the material."""

    kind: str  # "lcg" | "pmj02bn" | "corrmj"
    spp: int
    res: Tuple[int, int]  # (width, height)
    use_tent: bool
    rr_depth: int
    max_depth: int
    seed: int  # uint32
    n_point: int
    n_mesh: int
    scene: torch.Tensor  # (T, 31)
    lights: torch.Tensor  # (L, 16)
    light_inst: torch.Tensor  # (n_mesh, 2)
    points: torch.Tensor  # (n_point, 6)
    cam: torch.Tensor  # (16,)
    bn: torch.Tensor  # (res*res*n_tex,) blue noise; empty for lcg
    bn_res: int
    bn_ntex: int
    # the scene's BVH: the sweeps walk it, and the kernels' wrappers launch
    # their BVH instantiations; None: the dense sweeps over `scene`
    bvh: Optional[Accel] = None
    # the environment light, the first of the light selection's choices
    # (n_env 1), and the kernels' wrappers launch their env instantiations;
    # None: no env
    env: Optional[EnvMap] = None
    # the gradient splat's knobs (RenderConfig): the path gradient merges
    # each group of splat_merge steps of a lane into one tap; packed_splat
    # rounds the gradient to bf16 (the direct and collocated gradients every
    # 4 samples, their taps too)
    splat_merge: int = 1
    packed_splat: bool = False
    # the direct integrator's bounce ray looks up its emitter first: each
    # light triangle's scene-row id (scene_tables.light_row_table), which
    # the direct kernels read after the packed tables
    # (kernels.direct_tables); None: the closest hit over the scene. The
    # other integrators do not read it.
    light_rows: Optional[torch.Tensor] = None

    @property
    def n_env(self) -> int:
        return 0 if self.env is None else 1

    @property
    def inv_n_lights(self) -> float:
        """1 / the light selection's choices (at least 1): the factor of
        an env sample's and an env miss's pdf."""
        return 1.0 / max(self.n_env + self.n_point + self.n_mesh, 1)

    @property
    def n_steps(self) -> int:
        """The step bound of pallas_loop.py:1040."""
        return (self.spp + 1) * self.max_depth + self.max_depth


def build_loop_tables(data, camera, cfg, seed: int) -> LoopTables:
    dev = data.device
    if cfg.sampler == "pmj02bn":
        bn, res, n_tex = bluenoise(dev)
    else:
        bn, res, n_tex = torch.zeros((0,), dtype=torch.float32, device=dev), 0, 0
    return LoopTables(
        kind=cfg.sampler,
        spp=int(cfg.spp),
        res=tuple(cfg.res),
        use_tent=bool(cfg.use_tent_filter),
        rr_depth=int(cfg.rr_depth),
        max_depth=int(cfg.max_depth),
        seed=int(seed) & 0xFFFFFFFF,
        n_point=data.meta.n_point,
        n_mesh=data.meta.n_lights,
        scene=data.table if data.table is not None else scene_tables.scene_table(data),
        lights=scene_tables.light_table(data),
        light_inst=scene_tables.light_inst_table(data),
        points=scene_tables.point_table(data),
        cam=camera_const(camera).to(dev),
        bn=bn,
        bn_res=res,
        bn_ntex=n_tex,
        bvh=data.accel if data.accel is not None and data.accel.is_bvh else None,
        env=data.env,
        splat_merge=max(int(cfg.splat_merge), 1),
        packed_splat=bool(cfg.packed_splat),
        light_rows=scene_tables.light_row_table(data),
    )


# ------------------------------------------------------------- the sampler

def _sampler(tb: LoopTables, lanes, s0, s1, s2):
    """Sampler from carried state (pallas_loop.py:140), of the class the
    JAX package's factory picks at this spp."""
    if tb.kind == "lcg":
        return LCGSampler(state=u32(s0))
    px = lanes[0].to(torch.int64)
    py = lanes[1].to(torch.int64)
    if tb.kind == "corrmj":
        return corrmj_sampler(px, py, tb.seed, tb.spp, u32(s0), u32(s1), u32(s2))
    return pmj02bn_class(tb.spp)(
        px=px, py=py, sample_index=u32(s0), dimension=u32(s1),
        seed=tb.seed, spp=tb.spp, bn_rows=tb.bn,
        bn_base=bn_base(px, py, tb.seed, tb.bn_res, tb.bn_ntex), n_tex=tb.bn_ntex,
    )


def _state(tb: LoopTables, smp, s1, s2):
    """Sampler -> (smp0, smp1, smp2) int32 rows; a row the kind does not
    use stays as it was."""
    if tb.kind == "lcg":
        return to_i32(smp.state), s1, s2
    if tb.kind == "corrmj":
        return to_i32(smp.sample_index), to_i32(smp.dimension), to_i32(smp.state)
    return to_i32(smp.sample_index), to_i32(smp.dimension), s2


def _fresh_state(tb: LoopTables, lanes, sample_idx):
    """(smp0, smp1, smp2) of a fresh sampler at the lane's next sample
    (pallas_loop.py:187-205)."""
    zero = torch.zeros_like(sample_idx)
    if tb.kind == "lcg":
        st = lcg_fresh_state(lanes[0], lanes[1], tb.seed, sample_idx)
        return to_i32(st), zero, zero
    if tb.kind == "corrmj":
        st = corrmj_fresh_state(lanes[0], lanes[1], tb.seed, sample_idx)
        return sample_idx, zero, to_i32(st)
    return sample_idx, zero, zero


# ------------------------------------------------------------ the sweeps

def _mt_all(scene, o, d):
    """Möller–Trumbore of every ray against every triangle -> (N, T) planes
    (ok without the t range, u, v, t)."""
    cols = [scene[:, k][None, :] for k in range(9)]
    p0, e1, e2 = tuple(cols[0:3]), tuple(cols[3:6]), tuple(cols[6:9])
    return mt(p0, e1, e2, tuple(x[:, None] for x in o), tuple(x[:, None] for x in d))


def occluded(scene, p, wi, dist, bvh=None):
    """Any triangle hit at t in (1e-4, dist) (pallas_loop.py:690), over the
    scene rows or through `bvh`."""
    if bvh is not None:
        return bvh_any(bvh, p, wi, torch.full_like(dist, 1e-4), dist)[0]
    ok, _u, _v, t = _mt_all(scene, p, wi)
    ok = ok & (t > 1e-4) & (t < dist[:, None])
    return ok.any(dim=1)


def closest_hit(scene, o, d, bvh=None):
    """-> (best_t, u, v, prim): the sequential sweep's strict `t < best_t`
    keeps the first of equal nearest triangles, and so does argmin; through
    `bvh`, the smallest id among equal nearest t, the same triangle."""
    if bvh is not None:
        zero = torch.zeros_like(o[0])
        (best_t, prim, bu, bv), _work = bvh_closest(bvh, o, d, zero, zero + T_MAX)
        return best_t, bu, bv, prim.to(torch.int64)
    ok, u, v, t = _mt_all(scene, o, d)
    ok = ok & (t > 0.0) & (t < T_MAX)
    tt = torch.where(ok, t, torch.inf)
    prim = torch.argmin(tt, dim=1, keepdim=True)
    hit = torch.gather(ok, 1, prim)[:, 0]
    best_t = torch.where(hit, torch.gather(t, 1, prim)[:, 0], T_MAX)
    bu = torch.where(hit, torch.gather(u, 1, prim)[:, 0], 0.0)
    bv = torch.where(hit, torch.gather(v, 1, prim)[:, 0], 0.0)
    prim = torch.where(hit, prim[:, 0], -1)
    return best_t, bu, bv, prim


def interact_epilogue(o, d, pdf_prev, active, best_t, bu, bv, miss, av):
    """Hit -> interaction and emitter MIS (pallas_bounce.py:434). av are the
    22 attribute columns 9..30 of the hit triangle (zeros on a miss).
    Returns p3, uv2, ns3, ng3, shade, add_emit3."""
    (uv0x, uv0y, du1x, du1y, du2x, du2y,
     n0x, n0y, n0z, dn1x, dn1y, dn1z, dn2x, dn2y, dn2z,
     ngx, ngy, ngz, emr, emg, emb, inv_pdfc) = av
    t_eff = torch.where(miss, 1.0, best_t)
    p = vadd(o, vscale(d, t_eff))
    ux = uv0x + bu * du1x + bv * du2x
    uy = uv0y + bu * du1y + bv * du2y
    ns = vnormalize((n0x + bu * dn1x + bv * dn2x,
                     n0y + bu * dn1y + bv * dn2y,
                     n0z + bu * dn1z + bv * dn2z))
    ng = (ngx, ngy, ngz)
    wo = vscale(d, -1.0)
    frontfacing = (vdot(wo, ng) >= 1e-4) & (vdot(wo, ns) >= 1e-4)
    emissive = (emr > 0.0) | (emg > 0.0) | (emb > 0.0)
    cos_light = -vdot(ng, d)
    sqr_dist = best_t * best_t
    pdf_hit = sqr_dist / torch.clamp_min(inv_pdfc * cos_light, 1e-12)
    mis_hit = pdf_prev / torch.clamp_min(pdf_prev + pdf_hit, 1e-4)
    emit_on = active & ~miss & frontfacing & emissive
    ae = tuple(torch.where(emit_on, mis_hit * e, 0.0) for e in (emr, emg, emb))
    shade = active & ~miss & frontfacing & ~emissive
    return p, (ux, uy), ns, ng, shade, ae


def closest_interact_miss(scene, o, d, pdf_prev, active, bvh=None):
    """closest_interact's six outputs and the miss flag (no triangle hit)."""
    best_t, bu, bv, prim = closest_hit(scene, o, d, bvh)
    miss = prim < 0
    rows = scene[torch.clamp_min(prim, 0), 9:31]
    rows = torch.where(miss[:, None], 0.0, rows)
    av = tuple(rows.unbind(1))
    return (*interact_epilogue(o, d, pdf_prev, active, best_t, bu, bv, miss, av), miss)


def closest_interact(scene, o, d, pdf_prev, active, bvh=None):
    return closest_interact_miss(scene, o, d, pdf_prev, active, bvh)[:6]


# ------------------------------------------------------------ NEE select

def nee_select(tb: LoopTables, p, smp):
    """Light choice, uniform over the env (first), the point lights and
    the mesh lights, and a sample of the chosen one (pallas_loop.py:270;
    with the env, fused_glue.sample_light_planes :289-381) -> ((wi3, dist,
    pdf, ev3), smp)."""
    u_sel, smp = smp.next1()
    u_prim, smp = smp.next1()
    (u2a, u2b), smp = smp.next2_xy()

    n_env, n_point, n_mesh = tb.n_env, tb.n_point, tb.n_mesh
    n_i = n_env + n_point + n_mesh
    n = float(max(n_i, 1))
    idx = torch.clamp((u_sel * n).to(torch.int32), 0, max(n_i - 1, 0))
    # the choice among the point and mesh lights
    pidx = idx - n_env

    zero = torch.zeros_like(u_sel)
    wi = (zero, zero, zero + 1.0)
    dist = zero
    pdf = zero + 1.0
    ev = (zero, zero, zero)

    if n_mesh > 0:
        mesh_idx = torch.clamp(pidx - n_point, 0, max(n_mesh - 1, 0)).to(torch.int64)
        off = tb.light_inst[mesh_idx, 0]
        tc = tb.light_inst[mesh_idx, 1]
        prim_local = torch.minimum(
            torch.clamp_min(u_prim * tc, 0.0), torch.clamp_min(tc - 1.0, 0.0)
        )
        l_sel = (off + torch.floor(prim_local)).to(torch.int64)
        n_rows = tb.lights.shape[0]
        in_range = (l_sel >= 0) & (l_sel < n_rows)
        lt = tb.lights[torch.clamp(l_sel, 0, n_rows - 1)]
        lt = torch.where(in_range[:, None], lt, 0.0).unbind(1)
        lv0, le1, le2 = lt[0:3], lt[3:6], lt[6:9]
        lem, l_ng, l_inv_pdf = lt[9:12], lt[12:15], lt[15]
        a_bc = torch.where(u2a < u2b, 0.5 * u2a, u2a - 0.5 * u2b)
        b_bc = torch.where(u2a < u2b, u2b - 0.5 * u2a, 0.5 * u2b)
        c_bc = 1.0 - a_bc - b_bc
        pl = tuple(lv0[k] + b_bc * le1[k] + c_bc * le2[k] for k in range(3))
        dv = vsub(pl, p)
        sqr = vdot(dv, dv)
        inv_len = 1.0 / torch.clamp_min(torch.sqrt(sqr), 1e-20)
        m_wi = vscale(dv, inv_len)
        cos_l = -vdot(l_ng, m_wi)
        m_pdf = sqr / torch.clamp_min(l_inv_pdf * cos_l, 1e-12)
        ok = cos_l > 1e-4
        m_ev = tuple(torch.where(ok, lem[k], 0.0) for k in range(3))
        m_dist = 0.9999 * torch.sqrt(sqr)
        wi, dist, pdf, ev = m_wi, m_dist, m_pdf, m_ev

    if n_point > 0:
        pt = tb.points[torch.clamp(pidx, 0, n_point - 1).to(torch.int64)].unbind(1)
        dv = vsub(pt[0:3], p)
        sqr = vdot(dv, dv)
        inv_len = 1.0 / torch.clamp_min(torch.sqrt(sqr), 1e-20)
        p_wi = vscale(dv, inv_len)
        p_pdf = div(sqr, n)
        p_dist = 0.9999 * torch.sqrt(sqr)
        is_point = (pidx >= 0) & (pidx < n_point)
        wi = tuple(torch.where(is_point, p_wi[k], wi[k]) for k in range(3))
        dist = torch.where(is_point, p_dist, dist)
        pdf = torch.where(is_point, p_pdf, pdf)
        ev = tuple(torch.where(is_point, pt[3 + k], ev[k]) for k in range(3))

    if n_env > 0:
        # u2b picks the sample map's row, u2a its column; the shadow ray has
        # no end
        e_wi, e_dist, e_pdf, e_ev = sample_envmap(tb.env, u2a, u2b, tb.inv_n_lights)
        is_env = idx < n_env
        wi = tuple(torch.where(is_env, e_wi[k], wi[k]) for k in range(3))
        dist = torch.where(is_env, e_dist, dist)
        pdf = torch.where(is_env, e_pdf, pdf)
        ev = tuple(torch.where(is_env, e_ev[k], ev[k]) for k in range(3))

    return (wi, dist, pdf, ev), smp


# --------------------------------------------------------------- the step

def loop_step(carry: Carry, tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
              le_grad=None):
    """One bounce for every lane (the plain version of the CUDA kernel's
    step; a finished lane idles, as in the JAX kernel) -> the next Carry.

    Tap mode, with le_grad the (3, N) per-sample adjoint: -> (Carry, taps),
    taps the N_TAP_PLANES (N,) planes of this step, in TAP_NAMES order
    (pallas_loop.py:666-684)."""
    loop_step.calls += 1
    s = {n: carry.f[k] for k, n in enumerate(F_NAMES)}
    si = {n: carry.i[k] for k, n in enumerate(I_NAMES)}

    def v3(a, b, c):
        return (s[a], s[b], s[c])

    dif0, dif1, dif2, rough = read_bilinear(material, s["uv_x"], s["uv_y"])
    dif = (dif0, dif1, dif2)
    in_flight = si["in_flight"] != 0
    shade = (si["shade"] != 0) & in_flight
    beta = v3("beta_r", "beta_g", "beta_b")
    d = v3("d_x", "d_y", "d_z")
    p = v3("p_x", "p_y", "p_z")
    ns = v3("ns_x", "ns_y", "ns_z")
    ng = v3("ng_x", "ng_y", "ng_z")
    add_emit = v3("ae_r", "ae_g", "ae_b")
    wi_l = v3("wl_x", "wl_y", "wl_z")
    l_dist, l_pdf = s["l_dist"], s["l_pdf"]
    l_eval = v3("lev_r", "lev_g", "lev_b")
    depth = si["depth"]

    # NEE shadow test + GGX shade/sample + Russian roulette
    wo = vscale(d, -1.0)
    tangent, binormal = make_onb(ns)
    wo_local = to_local(tangent, binormal, ns, wo)
    occ = occluded(tb.scene, p, wi_l, l_dist, tb.bvh)
    wi_light_local = to_local(tangent, binormal, ns, wi_l)
    nee_ok = shade & ~occ & (wi_light_local[2] >= 1e-4)
    pdf_bsdf_at_light = ggx_sample_pdf(wo_local, wi_light_local, rough)
    mis_nee = l_pdf / torch.clamp_min(l_pdf + pdf_bsdf_at_light, 1e-4)
    nee_weight = mis_nee / torch.clamp_min(l_pdf, 1e-4)

    wi_local = ggx_sample(wo_local, rough, s["u_lobe"], s["u_b0"], s["u_b1"])
    pdf_bounce = ggx_sample_pdf(wo_local, wi_local, rough)
    wi = to_world(tangent, binormal, ns, wi_local)
    bounce_ok = shade & (vdot(wi, ng) >= 1e-4) & (wi_local[2] >= 1e-4)
    next_o = offset_ray_origin(p, ng)

    if le_grad is None:
        b_nee = ggx_brdf(wo_local, wi_light_local, dif, rough)
        b_bounce = ggx_brdf(wo_local, wi_local, dif, rough)
    else:
        b_nee, b_bounce, vjp = ggx_shade_vjp(wo_local, wi_light_local, wi_local, dif, rough)
    inv_pdf = 1.0 / torch.clamp_min(pdf_bounce, 1e-9)
    beta_next = tuple(beta[c] * b_bounce[c] * inv_pdf for c in range(3))
    lum = luminance(beta_next)
    q = torch.clamp_min(lum, 0.05)
    do_rr = depth >= tb.rr_depth
    dead = do_rr & ((lum == 0.0) | (s["u_rr"] >= q))
    rr_scale = torch.where(do_rr & ~dead & bounce_ok, 1.0 / q, 1.0)
    path_alive = bounce_ok & ~dead & (depth + 1 < tb.max_depth)
    beta_next = vscale(beta_next, rr_scale)

    nee_c = tuple(b_nee[c] * nee_weight * l_eval[c] for c in range(3))
    rad = tuple(
        beta[c] * (add_emit[c] + torch.where(nee_ok, nee_c[c], 0.0))
        for c in range(3)
    )
    cur = (s["cur_r"] + rad[0], s["cur_g"] + rad[1], s["cur_b"] + rad[2])

    # termination / restart
    terminated = in_flight & ~path_alive
    good = ~(torch.isnan(cur[0]) | torch.isnan(cur[1]) | torch.isnan(cur[2]))
    acc = tuple(
        s[f"acc_{ch}"] + torch.where(
            terminated & good, torch.clamp(cur[k], 0.0, RADIANCE_CLAMP), 0.0
        )
        for k, ch in enumerate("rgb")
    )
    sample_idx = si["sample_idx"] + terminated.to(torch.int32)
    avail = ~in_flight | terminated
    restart = avail & (sample_idx < lanes[2])

    f0, f1, f2 = _fresh_state(tb, lanes, sample_idx)
    (cu0, cu1), smp_new = _sampler(tb, lanes, f0, f1, f2).next2_xy()
    cam_o, cam_d = camera_ray(tb.cam, lanes[0], lanes[1], cu0, cu1, tb.res, tb.use_tent)

    def sel(a, b, c):
        return torch.where(restart, a, torch.where(path_alive, b, c))

    o_n = tuple(sel(cam_o[k], next_o[k], p[k]) for k in range(3))
    d_n = tuple(sel(cam_d[k], wi[k], d[k]) for k in range(3))
    new0, new1, new2 = _state(tb, smp_new, f1, f2)
    st0 = torch.where(restart, new0, si["smp0"])
    st1 = torch.where(restart, new1, si["smp1"])
    st2 = torch.where(restart, new2, si["smp2"])
    smp = _sampler(tb, lanes, st0, st1, st2)
    reset = restart | terminated
    cur_n = tuple(torch.where(reset, 0.0, cur[k]) for k in range(3))
    beta_n = tuple(
        torch.where(reset, 1.0, torch.where(path_alive, beta_next[k], beta[k]))
        for k in range(3)
    )
    pdf_prev = torch.where(
        terminated, PDF_NONE, torch.where(path_alive, pdf_bounce, PDF_NONE)
    )
    depth_n = torch.where(reset, 0, depth + 1)
    in_flight_n = restart | path_alive

    # next closest hit + interaction; under an env, a live lane's miss adds
    # the env, MIS-weighted against the BSDF pdf of its ray (path_fused.py:143)
    np_, nuv, nns, nng, nshade, nae, nmiss = closest_interact_miss(
        tb.scene, o_n, d_n, pdf_prev, in_flight_n, tb.bvh
    )
    if tb.env is not None:
        em = env_miss_add(tb.env, d_n, pdf_prev, in_flight_n & nmiss, tb.inv_n_lights)
        nae = tuple(nae[c] + em[c] for c in range(3))

    # NEE + bounce draws for the next bounce
    (nwl, nld, nlp, nlev), smp = nee_select(tb, np_, smp)
    nu_lobe, smp = smp.next1()
    (nub0, nub1), smp = smp.next2_xy()
    nu_rr, smp = smp.next1()
    fin0, fin1, fin2 = _state(tb, smp, st1, st2)

    f_out = (
        *acc, *cur_n, *beta_n, *d_n, *np_, *nns, *nng, *nae, *nuv,
        *nwl, nld, nlp, *nlev, nu_lobe, nub0, nub1, nu_rr,
    )
    i_out = (sample_idx, nshade.to(torch.int32), depth_n,
             in_flight_n.to(torch.int32), fin0, fin1, fin2)
    out = Carry(torch.stack(f_out), torch.stack(i_out))
    if le_grad is None:
        return out

    # gradient taps (pallas_loop.py:512-572): everything of this bounce's
    # texture gradient but the suffix radiance G' of the rest of the path
    lg = tuple(le_grad[c] for c in range(3))
    zero = torch.zeros_like(lg[0])
    ct_nee = tuple(
        torch.where(nee_ok, beta[c] * nee_weight * l_eval[c] * lg[c], 0.0) for c in range(3)
    )
    p_taps = vjp((ct_nee, (zero, zero, zero)))
    # unit bounce cotangent: d b_bounce_c / d dif_c = wi_z / pi, and
    # d/d rough summed over the 3 channels = 3 * dspec/drough * wi_z
    u0, _u1, _u2, u3 = vjp(((zero, zero, zero), (zero + 1.0, zero + 1.0, zero + 1.0)))
    b = tuple(
        torch.where(bounce_ok & (b_bounce[c] > 1e-8),
                    lg[c] / torch.clamp_min(b_bounce[c], 1e-8), 0.0)
        for c in range(3)
    )
    q_taps = tuple(b[c] * u0 for c in range(3))
    s_taps = tuple(b[c] * (u3 * (1.0 / 3.0)) for c in range(3))
    # the splat corner, drawn from the carried sampler's salt: the state
    # before this step's restart and draws
    salt = _sampler(tb, lanes, si["smp0"], si["smp1"], si["smp2"]).salt()
    u_m = lcg_to_unit_float(lcg_step(salt))
    h, w = material.shape[0], material.shape[1]
    ids = splat_ids(s["uv_x"], s["uv_y"], lcg_to_unit_float(salt), h, w)
    ids = torch.where(nee_ok | bounce_ok, ids, h * w)
    flags = (terminated.to(torch.int32) | (good.to(torch.int32) << 1)
             | (in_flight.to(torch.int32) << 2))
    return out, (*rad, *p_taps, *q_taps, *s_taps, u_m, ids, flags)


loop_step.calls = 0


def render_path_loop_plain(tb: LoopTables, lanes, material, carry: Carry, n_steps: int) -> Carry:
    """Steps every lane while any has samples left, at most n_steps times
    (the plain version of one kernel launch)."""
    render_path_loop_plain.calls += 1
    stop = lanes[2]
    for _ in range(n_steps):
        if not bool((carry.i[I_IDX["sample_idx"]] < stop).any()):
            break
        carry = loop_step(carry, tb, lanes, material)
    return carry


render_path_loop_plain.calls = 0


def render_path_backward_loop_plain(tb: LoopTables, lanes, material, le_grad, n_steps: int):
    """PRB texture gradient of every lane's samples, given the (3, N)
    per-sample adjoint le_grad -> (d_material (H, W, 4), the final Carry):
    the plain version of the path_loop_grad kernel, and the JAX package's
    one-walk algorithm (pallas_loop.py:1082-1286) in one window.

    Walks the forward from the first carry, keeping every step's taps; then,
    for all lanes at once, a sequential reverse pass over the steps recovers
    G'[it] = term ? 0 : G[it+1], with G[it] = rad[it] + G'[it], and the
    sample's ok flag (good at its terminating step), as post_pass defines
    them; forms g_j = P_j + G'_j Q_j and g_rough = P_3 + sum_c G'_c S_c,
    zeroes NaN taps and the taps of a NaN sample, and scatters. With
    tb.splat_merge > 1 the taps of each group of that many steps are
    merged first, JAX's static fold (pallas_loop.py:1232-1254): the group's
    first step as it is, each later one merged in with its own u_m; with
    tb.packed_splat every texel's total is rounded to bf16."""
    render_path_backward_loop_plain.calls += 1
    carry = init_carry(lanes)
    steps = []
    for _ in range(n_steps):
        if not bool((carry.i[I_IDX["sample_idx"]] < lanes[2]).any()):
            break
        carry, taps = loop_step(carry, tb, lanes, material, le_grad)
        steps.append(taps)
    zero = torch.zeros_like(le_grad[0])
    g_next = (zero, zero, zero)  # G[it + 1]
    ok_next = torch.ones_like(zero, dtype=torch.bool)  # no later term: keep
    ids, vals, u_m = [], [], []
    for taps in reversed(steps):
        rad, p, q, s = taps[0:3], taps[3:7], taps[7:10], taps[10:13]
        flags = taps[15]
        term = (flags & 1) != 0
        ok = torch.where(term, (flags & 2) != 0, ok_next)
        gp = tuple(torch.where(term, 0.0, g_next[c]) for c in range(3))
        g = (p[0] + gp[0] * q[0], p[1] + gp[1] * q[1], p[2] + gp[2] * q[2],
             p[3] + gp[0] * s[0] + gp[1] * s[1] + gp[2] * s[2])
        vals.append(torch.stack([torch.where(ok & ~torch.isnan(x), x, 0.0) for x in g], 1))
        ids.append(taps[14])
        u_m.append(taps[13])
        g_next = tuple(rad[c] + gp[c] for c in range(3))
        ok_next = ok
    h, w = material.shape[0], material.shape[1]
    ids, vals, u_m = ids[::-1], vals[::-1], u_m[::-1]
    if tb.splat_merge > 1:
        ids, vals = merge_steps(ids, vals, u_m, tb.splat_merge, h * w)
    grad = scatter_add4(torch.cat(ids), torch.cat(vals), h * w, packed=tb.packed_splat)
    return grad.reshape(h, w, 4), carry


render_path_backward_loop_plain.calls = 0


def merge_steps(ids, vals, u_m, merge: int, n_bins: int):
    """The walk's taps, a list of (N,) ids and (N, 4) values a step in
    step order, merged within each group of `merge` steps, the steps past
    the walk's last padding the last group as sentinels (JAX's tap store of
    s_cap steps, pallas_loop.py:1232-1254) -> one (ids, values) a group."""
    pad = -len(ids) % merge
    sentinel = torch.full_like(ids[0], n_bins)
    ids = list(ids) + [sentinel] * pad
    vals = list(vals) + [torch.zeros_like(vals[0])] * pad
    u_m = list(u_m) + [torch.zeros_like(u_m[0])] * pad
    out_ids, out_vals = [], []
    for k in range(0, len(ids), merge):
        cur = (ids[k], *vals[k].unbind(1))
        for j in range(k + 1, k + merge):
            cur = reservoir_merge_taps(cur, (ids[j], *vals[j].unbind(1)), u_m[j], n_bins)
        out_ids.append(cur[0])
        out_vals.append(torch.stack(cur[1:], 1))
    return out_ids, out_vals


def coord_lanes(coords: torch.Tensor, spp: int) -> torch.Tensor:
    """(3, N) int32 lane rows of the pixels coords (N, 2): px, py and the
    sample to stop at, spp."""
    c = coords.to(torch.int32)
    return torch.stack([c[:, 0], c[:, 1], torch.full_like(c[:, 0], spp)])


def pixel_lanes(res, spp: int, device) -> torch.Tensor:
    """(3, W*H) int32 lane rows of the raster pixel grid, x fastest."""
    return coord_lanes(pixel_grid(res, device), spp)


def render_path_loop(data, material, camera, seed: int, cfg, lanes) -> torch.Tensor:
    """spp-averaged radiance of every lane -> (N, 3); lanes: (3, N) int32
    rows px, py, spp (coord_lanes; pixel_lanes for every pixel). On a CUDA
    device the whole render is one launch of the kernel; on the CPU the
    plain loop."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    carry = kernels.path_loop(tb, lanes, material, init_carry(lanes), tb.n_steps)
    return div(carry.f[0:3].T, float(cfg.spp))


def render_path_backward_loop(data, material, camera, seed: int, cfg, le_grad,
                              lanes) -> torch.Tensor:
    """PRB texture gradient -> d_material (H, W, 4), given the (3, N)
    per-sample adjoint of each lane; lanes as render_path_loop's. On a CUDA
    device one launch of the path_loop_grad kernel; on the CPU the plain
    walk."""
    from .. import kernels

    tb = build_loop_tables(data, camera, cfg, seed)
    grad, _carry = kernels.path_loop_grad(tb, lanes, material, le_grad, tb.n_steps)
    return grad
