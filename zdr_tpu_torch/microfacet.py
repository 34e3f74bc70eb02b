"""GGX microfacet BRDF, its 50/50 cosine + VNDF sampling mixture, and the
orthonormal basis, on componentized local-frame directions (z = normal).

Port of zdr_tpu/integrators/pallas_bounce.py:137-240 with the same
formulas in the same operand order.
"""

from __future__ import annotations

import math

import torch

from .vec import div, vadd, vcross, vdot, vnormalize, vscale, vsub, vwhere

SPECULAR = 0.04
_PI = math.pi


def _ggx_distribution(hz, alpha):
    a2 = alpha * alpha
    nh = torch.clamp_min(hz, 1e-5)
    denom = nh * nh * (a2 - 1.0) + 1.0
    return a2 / (_PI * denom * denom)


def _smith_geometry(vz, alpha):
    a2 = alpha * alpha
    nv = torch.clamp_min(vz, 1e-5)
    nv2 = nv * nv
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))


def ggx_brdf(wo, wi, dif, roughness):
    """brdf * cos(wi) -> rgb tuple."""
    alpha = roughness * roughness
    h = vnormalize(vadd(wi, wo))
    d = _ggx_distribution(h[2], alpha)
    cos_wh = torch.clamp(vdot(wo, h), 1e-5, 1.0)
    one_m = 1.0 - cos_wh
    f = SPECULAR + (1.0 - SPECULAR) * (one_m * one_m * one_m * one_m * one_m)
    g = _smith_geometry(wi[2], alpha) * _smith_geometry(wo[2], alpha)
    wiz = torch.clamp_min(wi[2], 1e-5)
    woz = torch.clamp_min(wo[2], 1e-5)
    spec = (d * f * g) / (4.0 * wiz * woz)
    return tuple((spec + div(dif[c], _PI)) * wi[2] for c in range(3))


def ggx_shade_vjp(wo, wi_nee, wi_bounce, dif, roughness):
    """ggx_brdf toward the light and along the bounce, and their VJP in
    (dif_r, dif_g, dif_b, roughness) -> (b_nee, b_bounce, vjp), where
    vjp((ct_nee3, ct_bounce3)) -> 4 tensors (pallas_loop.py:481-490).

    torch.func differentiates ggx_brdf as written, so this stays an
    independent check on the CUDA kernel's hand-written derivative."""

    def shade(d0, d1, d2, rg):
        df = (d0, d1, d2)
        return ggx_brdf(wo, wi_nee, df, rg), ggx_brdf(wo, wi_bounce, df, rg)

    (b_nee, b_bounce), vjp = torch.func.vjp(shade, *dif, roughness)
    return b_nee, b_bounce, vjp


def _sample_wm(w, alpha, u0, u1):
    """pbrt-v4 visible-normal sample."""
    wh = vnormalize((alpha * w[0], alpha * w[1], w[2]))
    wh = vwhere(wh[2] < 0.0, vscale(wh, -1.0), wh)
    zero = torch.zeros_like(wh[0])
    t1g = vnormalize((-wh[1], wh[0], zero))
    t1 = vwhere(wh[2] < 0.99999, t1g, (zero + 1.0, zero, zero))
    t2 = vcross(wh, t1)
    r = torch.sqrt(u0)
    theta = 2.0 * _PI * u1
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    h = torch.sqrt(torch.clamp_min(1.0 - px * px, 0.0))
    py = h + (py - h) * ((1.0 + wh[2]) / 2.0)
    pz = torch.sqrt(torch.clamp_min(1.0 - px * px - py * py, 0.0))
    nh = vadd(vadd(vscale(t1, px), vscale(t2, py)), vscale(wh, pz))
    return vnormalize((alpha * nh[0], alpha * nh[1], torch.clamp_min(nh[2], 1e-6)))


def _pdf_wm(w, wm, alpha):
    return (
        _smith_geometry(w[2], alpha)
        / torch.clamp_min(torch.abs(w[2]), 1e-9)
        * _ggx_distribution(wm[2], alpha)
        * torch.abs(vdot(w, wm))
    )


def ggx_sample(wo, roughness, u_lobe, u0, u1):
    """50/50 cosine + VNDF mixture -> local wi."""
    r = torch.sqrt(u0)
    phi = 2.0 * _PI * u1
    dif_wi = (r * torch.cos(phi), r * torch.sin(phi),
              torch.sqrt(torch.clamp_min(1.0 - u0, 0.0)))
    alpha = roughness * roughness
    wm = _sample_wm(wo, alpha, u0, u1)
    neg_wo = vscale(wo, -1.0)
    glossy_wi = vsub(neg_wo, vscale(wm, 2.0 * vdot(neg_wo, wm)))
    return vwhere(u_lobe < 0.5, dif_wi, glossy_wi)


def ggx_sample_pdf(wo, wi, roughness):
    alpha = roughness * roughness
    wm = vnormalize(vadd(wi, wo))
    diffuse_pdf = div(wi[2], _PI)
    glossy_pdf = _pdf_wm(wo, wm, alpha) / (
        4.0 * torch.clamp_min(torch.abs(vdot(wo, wm)), 1e-9)
    )
    return 0.5 * diffuse_pdf + 0.5 * glossy_pdf


def make_onb(n):
    """(tangent, binormal) of the frame around unit normal n."""
    cond = torch.abs(n[0]) > torch.abs(n[2])
    zero = torch.zeros_like(n[0])
    b = vwhere(cond, (-n[1], n[0], zero), (zero, -n[2], n[1]))
    b = vnormalize(b)
    t = vnormalize(vcross(b, n))
    return t, b


def to_local(t, b, n, v):
    return (vdot(v, t), vdot(v, b), vdot(v, n))


def to_world(t, b, n, v):
    return (
        v[0] * t[0] + v[1] * b[0] + v[2] * n[0],
        v[0] * t[1] + v[1] * b[1] + v[2] * n[1],
        v[0] * t[2] + v[1] * b[2] + v[2] * n[2],
    )
