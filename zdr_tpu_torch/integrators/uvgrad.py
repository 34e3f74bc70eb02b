"""Screen-space -> texture-space Jacobian AOV (duv/dxy): port of
zdr_tpu/integrators/uvgrad.py (`_trace_duvdxy`, `render_uvgrad`).

Per sample: a central ray plus two offset rays one pixel apart, sharing the
central jitter (the lcg sampler, whatever the scene's); the central ray's
closest hit through accel/trace.trace_closest (on the card the
trace_closest kernel, the BVH or the dense rows); dp/duv from the hit
triangle's world-space vertices and uvs; the offset rays met on the hit's
plane give dp/dx and dp/dy, and a least-squares solve gives (du/dx, dv/dx,
du/dy, dv/dy). Every expression keeps the JAX package's operand order; the
samples are summed in order, as its scan sums them. Not differentiable
(a footprint for display).
"""

from __future__ import annotations

import torch

from ..accel.trace import trace_closest
from ..camera import camera_const, ndc_ray, tent_warp
from ..samplers import make_sampler
from ..vec import div, vcross, vdot, vnormalize, vscale, vsub
from .wrapper import RenderConfig, pixel_grid


def _cols(x: torch.Tensor):
    return tuple(x.unbind(-1))


def _interp(hit, a0, a1, a2):
    """Barycentric interpolation of component tuples (JAX Hit.interpolate)."""
    w0 = 1.0 - hit.bary_u - hit.bary_v
    return tuple(w0 * a0[k] + hit.bary_u * a1[k] + hit.bary_v * a2[k] for k in range(len(a0)))


def trace_duvdxy(data, o, d, o_dx, d_dx, o_dy, d_dy, t_min=0.0, t_max=1e30) -> torch.Tensor:
    """(N, 3) central rays o, d and their offset rays -> (N, 4) duv/dxy;
    0 on a miss. data must carry an accel (wrapper.with_accel)."""
    hit = trace_closest(data.accel, o, d, t_min, t_max)
    prim = torch.clamp(hit.prim, min=0).long()
    g = data.geom
    tri = g.triangles[prim]
    p0, p1, p2 = (_cols(g.positions[tri[:, k]]) for k in range(3))
    t0, t1, t2 = (_cols(g.uvs[tri[:, k]]) for k in range(3))
    p = _interp(hit, p0, p1, p2)

    # dp/duv: dpde (3x2 cols e1, e2) times the inverse of duvde (2x2), v flipped
    e1, e2 = vsub(p1, p0), vsub(p2, p0)
    du1, dv1 = t1[0] - t0[0], t1[1] - t0[1]
    du2, dv2 = t2[0] - t0[0], t2[1] - t0[1]
    det = du1 * dv2 - dv1 * du2
    inv_det = torch.where(torch.abs(det) > 1e-12,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)
    dpdu = vscale(vsub(vscale(e1, dv2), vscale(e2, dv1)), inv_det)
    dpdv = vscale(vsub(vscale(e2, du1), vscale(e1, du2)), inv_det)
    dpdv = tuple(-c for c in dpdv)  # inverted v

    ng = vnormalize(vcross(e1, e2))

    def plane_hit(oo, dd):
        dn = vdot(dd, ng)
        t = vdot(vsub(p, oo), ng) / torch.where(torch.abs(dn) > 1e-12, dn, 1.0)
        return tuple(oo[k] + t * dd[k] for k in range(3))

    dpdx = vsub(plane_hit(_cols(o_dx), _cols(d_dx)), p)
    dpdy = vsub(plane_hit(_cols(o_dy), _cols(d_dy)), p)

    # least squares: [duvdx] = (A^T A)^-1 A^T dpdx with A = [dpdu dpdv]
    a00 = vdot(dpdu, dpdu)
    a01 = vdot(dpdu, dpdv)
    a11 = vdot(dpdv, dpdv)
    det_a = a00 * a11 - a01 * a01
    inv_a = torch.where(torch.abs(det_a) > 1e-20,
                        1.0 / torch.where(det_a == 0, 1.0, det_a), 0.0)

    def solve(dp):
        b0 = vdot(dpdu, dp)
        b1 = vdot(dpdv, dp)
        return (a11 * b0 - a01 * b1) * inv_a, (a00 * b1 - a01 * b0) * inv_a

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    out = torch.stack([dudx, dvdx, dudy, dvdy], dim=-1)
    return torch.where(hit.miss[:, None], 0.0, out)


def ray_consts(res, device):
    """A render's constants on the device, made once (each copy from the
    host waits for the device): 2 / (w, h), the aspect (1, h / w), the
    one-pixel shifts in x and y, and the trace's t range."""
    w, h = res
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(2.0, **f32) / torch.tensor([w, h], **f32),
            torch.tensor([1.0, h / w], **f32),
            torch.tensor([[1.0, 0.0], [0.0, 1.0]], **f32),
            (torch.tensor(0.0, **f32), torch.tensor(1e30, **f32)))


def sample_rays(cam, consts, coords, seed: int, cfg: RenderConfig, it):
    """Sample `it`'s central ray and its two offset rays, one pixel apart in
    x and y and sharing its jitter -> ((o, d), (o_dx, d_dx), (o_dy, d_dy)),
    each (N, 3). cam is camera_const and consts ray_consts on the coords'
    device; `it` an int or a 0-d tensor there."""
    scale, aspect, shifts, _t_range = consts
    smp = make_sampler("lcg", coords, seed, cfg.spp, it)
    (ux, uy), _smp = smp.next2_xy()
    u2 = torch.stack([ux, uy], dim=-1)
    offset = tent_warp(u2) + 0.5 if cfg.use_tent_filter else u2
    base = coords.to(torch.float32) + offset
    rays = []
    for b in (base, base + shifts[0], base + shifts[1]):
        pix = (scale * b - 1.0) * aspect
        o, d = ndc_ray(cam, pix[:, 0], pix[:, 1])
        rays.append((torch.stack(o, dim=-1), torch.stack(d, dim=-1)))
    return tuple(rays)


def render_uvgrad(data, camera, seed: int, cfg: RenderConfig) -> torch.Tensor:
    """The (du/dx, dv/dx, du/dy, dv/dy) AOV -> (H, W, 4) on the data's
    device: one closest-hit trace a sample (data must carry an accel)."""
    w, h = cfg.res
    dev = data.device
    coords = pixel_grid(cfg.res, dev)
    cam = camera_const(camera).to(dev)
    consts = ray_consts(cfg.res, dev)
    its = torch.arange(cfg.spp, device=dev)
    acc = torch.zeros((h * w, 4), dtype=torch.float32, device=dev)
    for it in range(cfg.spp):
        rays = sample_rays(cam, consts, coords, seed, cfg, its[it])
        g = trace_duvdxy(data, *rays[0], *rays[1], *rays[2], *consts[3])
        g = torch.where(torch.isnan(g).any(dim=-1, keepdim=True), 0.0, g)
        acc = acc + g
    return div(acc, float(cfg.spp)).reshape(h, w, 4)
