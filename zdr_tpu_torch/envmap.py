"""Environment map lighting: the host build of the sampling tables, and the
device lookups of a light sample, a miss and its MIS pdf.

Port of zdr_tpu/envmap.py. The host half (`create_alias_table`,
`_bilinear_wrap`, `build_envmap`, `make_test_envmap`) is the same numpy
code, float64 sums included, so the tables equal the JAX package's bit for
bit. The device half follows the componentised forms of the JAX package's
fused route (zdr_tpu/integrators/fused_glue.py: `_env_direction_to_uv`
:178, `_env_uv_to_direction` :188, `env_fetch_planes` :196,
`env_pdf_planes` :224, `env_miss_add_planes` :236, `_sample_alias_planes`
:247 and the env branch of `sample_light_planes` :363-381), which compute
envmap.py's `direction_to_uv`, `uv_to_direction`, `texture_sample`,
`env_sampled_light_pdf`, `env_radiance`, `_sample_alias` and
`sample_envmap` on (N,) tensors. Two TPU layouts are not carried over: the
texture is read texel by texel, and the alias indices stay int32 (no
float-encoded index). The JAX package's quad-packed texture
(`fused_glue.pack_env_quads`: a 64-byte row of the four texels at each
anchor, so that a fetch is one row gather on the TPU) was measured on the
H100 with 16-byte alias records and the marginal in shared memory, and
made the CUDA kernels no faster (studies/iteration_ab.py --scene env;
PERF.md).

These are the plain versions of the env code of the CUDA kernels
(kernels/csrc/path_loop_step.cuh, the envmap section): the same formulas in
the same operand order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .vec import div

_PI = math.pi

SAMPLE_MAP_W = 512
SAMPLE_MAP_H = 256
# the clip of an alias draw's remapped u (envmap.py:245): 1 - 1e-7 in float32
U_TOP = 1.0 - 1e-7


@dataclasses.dataclass
class EnvMap:
    """An environment map's tensors on one device."""

    texture: torch.Tensor  # (H, W, 4) float32 equirect radiance
    alias_prob: torch.Tensor  # (HM + HM*WM,) float32: [marginal | rows]
    alias_idx: torch.Tensor  # (HM + HM*WM,) int32
    pdf: torch.Tensor  # (HM * WM,) float32 discrete pdf * pixel count


# --------------------------------------------------------------- host build


def create_alias_table(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Alias table for one discrete distribution -> (prob, alias, pdf) of
    len(values); an all-zero row is uniform (envmap.py:60-88)."""
    values = np.abs(np.asarray(values, dtype=np.float64))
    n = len(values)
    total = values.sum()
    if total == 0.0:
        pdf = np.full(n, 1.0 / n)
        return np.ones(n, np.float32), np.arange(n, dtype=np.int32), pdf.astype(np.float32)
    pdf = values / total
    prob = (values * (n / total)).astype(np.float64)
    alias = np.arange(n, dtype=np.int32)
    over = [i for i in range(n) if prob[i] > 1.0]
    under = [i for i in range(n) if prob[i] < 1.0]
    while over and under:
        o = over.pop()
        u = under.pop()
        prob[o] -= 1.0 - prob[u]
        alias[u] = o
        if prob[o] > 1.0:
            over.append(o)
        elif prob[o] < 1.0:
            under.append(o)
    for i in over + under:
        prob[i] = 1.0
        alias[i] = i
    return prob.astype(np.float32), alias, pdf.astype(np.float32)


def _bilinear_wrap(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample of img (H, W, C) at texel-space uv in [0, 1); wrap-x,
    clamp-y (envmap.py:91-106)."""
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xa = x0 % w
    xb = (x0 + 1) % w
    ya = np.clip(y0, 0, h - 1)
    yb = np.clip(y0 + 1, 0, h - 1)
    top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
    bot = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def _filter_taps(img: np.ndarray, pu: np.ndarray, pv: np.ndarray, dx: float, dy: float):
    """_bilinear_wrap(img, pu + dx, clip(pv + dy)) on the grid of columns pu
    and rows pv, element for element the same arithmetic, with the rows and
    columns gathered apart (u varies by column only, v by row only)."""
    h, w = img.shape[:2]
    x = (pu + dx) * w - 0.5
    y = np.clip(pv + dy, 0.0, 1.0 - 1e-7) * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    xa, xb = x0 % w, (x0 + 1) % w
    ra, rb = img[np.clip(y0, 0, h - 1)], img[np.clip(y0 + 1, 0, h - 1)]
    top = ra[:, xa] * (1 - fx) + ra[:, xb] * fx
    bot = rb[:, xa] * (1 - fx) + rb[:, xb] * fx
    return top * (1 - fy) + bot * fy


def build_envmap(img: np.ndarray, compensate_mis: bool = True, device="cpu") -> EnvMap:
    """The envmap of an RGBA image (H, W, 4), 1:2 or 1:1: a 512 x 256
    gaussian-filtered, sin(theta)-weighted luminance sample map (with
    compensate_mis, less its sin-weighted mean, clamped at 0), its
    per-row alias tables after the marginal one, and the density on the
    unit square (envmap.py:109-165), bit for bit: the filter's taps are
    _bilinear_wrap's, gathered by rows and columns (_filter_taps)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"envmap must be (H, W, 4), got {img.shape}")
    if img.shape[0] != img.shape[1] and img.shape[1] != img.shape[0] * 2:
        raise RuntimeError("envmap must be strictly 1:2 or 1:1")

    wm, hm = SAMPLE_MAP_W, SAMPLE_MAP_H
    px = (np.arange(wm) + 0.5) / wm
    py = (np.arange(hm) + 0.5) / hm
    lum_w = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)
    filter_radius, filter_step = 1.0, 0.125
    n = int(math.ceil(filter_radius / filter_step))
    sum_w = 0.0
    sum_scale = np.zeros((hm, wm), dtype=np.float64)
    offs = np.arange(-n, n + 1) * filter_step
    for dy in offs:
        for dx in offs:
            rgb = _filter_taps(img[..., :3], px, py, dx / wm, dy / hm)
            scale = rgb @ lum_w
            # the row's sin(theta), the same for every column
            sin_theta = np.sin((py + dy / hm)[:, None] * _PI)
            weight = math.exp(-4.0 * (dx * dx + dy * dy))
            sum_w += weight
            sum_scale += weight * np.minimum(scale * sin_theta, 1e8)
    scale_map = (sum_scale / sum_w).astype(np.float64)

    if compensate_mis:
        row_w = np.sin((np.arange(hm) + 0.5) / hm * _PI)
        avg = scale_map.mean()
        scale_map = scale_map - avg * (row_w / row_w.mean())[:, None]
        scale_map = np.maximum(scale_map, 0.0)

    probs = np.empty((hm, wm), np.float32)
    aliases = np.empty((hm, wm), np.int32)
    pdfs = np.empty((hm, wm), np.float32)
    row_avg = scale_map.mean(axis=1)
    for y in range(hm):
        probs[y], aliases[y], pdfs[y] = create_alias_table(scale_map[y])
    mp, ma, mpdf = create_alias_table(row_avg)
    pdf_full = pdfs * mpdf[:, None] * (wm * hm)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return EnvMap(
        texture=t(img),
        alias_prob=t(np.concatenate([mp, probs.reshape(-1)])),
        alias_idx=t(np.concatenate([ma, aliases.reshape(-1)])),
        pdf=t(pdf_full.reshape(-1)),
    )


def make_test_envmap(h: int = 64, w: int = 128) -> np.ndarray:
    """Procedural HDR sky: a gradient and a bright sun at (u, v) = (0.3,
    0.3) (envmap.py:168-185)."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    u = (u + 0.5) / w
    v = (v + 0.5) / h
    sky_t = np.cos(v * _PI) * 0.5 + 0.5
    r = 0.25 + 0.75 * sky_t
    g = 0.35 + 0.55 * sky_t
    b = 0.5 + 0.5 * sky_t
    d2 = ((u - 0.3) * 2 * _PI) ** 2 + ((v - 0.3) * _PI) ** 2
    sun = 50.0 * np.exp(-d2 / 0.01)
    img = np.stack([r + sun, g + sun * 0.9, b + sun * 0.7, np.ones_like(r)], -1)
    return img.astype(np.float32)


# --------------------------------------------------------------- device side


def direction_to_uv(d):
    """A direction's equirect (u, v); u wrapped into [0, 1)."""
    theta = torch.acos(torch.clamp(d[1], -1.0, 1.0))
    phi = torch.atan2(d[0], d[2])
    u = 1.0 - div(phi, 2.0 * _PI)
    u = u - torch.floor(u)
    return u, div(theta, _PI)


def uv_to_direction(u, v):
    """(u, v) -> the direction, y up, phi = 2 pi (1 - u)."""
    phi = 2.0 * _PI * (1.0 - u)
    theta = _PI * v
    y = torch.cos(theta)
    st = torch.sin(theta)
    return (torch.sin(phi) * st, y, torch.cos(phi) * st)


def texture_sample(tex: torch.Tensor, u, v):
    """Bilinear equirect radiance at (u, v), wrap-x, clamp-y -> (r, g, b):
    env_fetch_planes' anchor, weights and summation order, its four texels
    read from the (H, W, 4) texture."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)  # in [-1, w-1]
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    fx = x - x0
    fy = torch.clamp(y - y0, 0.0, 1.0)
    xi = torch.clamp(torch.nan_to_num(x0, nan=0.0), -1, w - 1).to(torch.int64)
    yi = torch.clamp(torch.nan_to_num(y0, nan=0.0), 0, h - 2).to(torch.int64)
    xa = torch.where(xi < 0, xi + w, xi)
    xb = torch.where(xi + 1 >= w, xi + 1 - w, xi + 1)
    flat = tex.reshape(h * w, 4)
    c00, c01 = flat[yi * w + xa], flat[(yi + 1) * w + xa]
    c10, c11 = flat[yi * w + xb], flat[(yi + 1) * w + xb]
    w00 = (1 - fx) * (1 - fy)
    w01 = (1 - fx) * fy
    w10 = fx * (1 - fy)
    w11 = fx * fy
    return tuple(c00[:, c] * w00 + c01[:, c] * w01 + c10[:, c] * w10 + c11[:, c] * w11
                 for c in range(3))


def _bin(x, n: int):
    """clip(int32(x * n), 0, n - 1): XLA's cast truncates and takes NaN to 0."""
    return torch.clamp(torch.nan_to_num(x * n, nan=0.0), 0, n - 1).to(torch.int64)


def sampled_light_pdf(pdf: torch.Tensor, u, v):
    """The solid-angle pdf of a light sample at (u, v), before the light
    selection's 1/n (env_pdf_planes)."""
    hm, wm = SAMPLE_MAP_H, SAMPLE_MAP_W
    pdf_tab = pdf[_bin(v, hm) * wm + _bin(u, wm)]
    s = torch.sin(_PI * v)
    inv_s = torch.where(s > 0, 1.0 / torch.clamp_min(s, 1e-12), 0.0)
    return div(pdf_tab * inv_s, 2.0 * _PI * _PI)


def sample_alias(env: EnvMap, n: int, u_in, offset):
    """One alias-table draw with sample reuse -> (index int64, remapped u)."""
    u = u_in * n
    i = torch.clamp(torch.nan_to_num(u, nan=0.0), 0, n - 1).to(torch.int64)
    ur = u - torch.floor(u)
    k = i + offset
    prob = env.alias_prob[k]
    alias = env.alias_idx[k].to(torch.int64)
    take_self = ur < prob
    index = torch.where(take_self, i, alias)
    uu = torch.where(take_self, ur / torch.clamp_min(prob, 1e-12),
                     (ur - prob) / torch.clamp_min(1.0 - prob, 1e-12))
    return index, torch.clamp(uu, 0.0, U_TOP)


def sample_envmap(env: EnvMap, u2a, u2b, inv_n: float):
    """An importance-sampled light direction from draws (u2a, u2b) (u2b
    picks the row, u2a the column) -> (wi3, dist, pdf, radiance3), the pdf
    times the light selection's inv_n (sample_light_planes :363-381)."""
    hm, wm = SAMPLE_MAP_H, SAMPLE_MAP_W
    sy_i, sy_u = sample_alias(env, hm, u2b, 0)
    sx_i, sx_u = sample_alias(env, wm, u2a, hm + sy_i * wm)
    eu = div(sx_i.to(torch.float32) + sx_u, float(wm))
    ev = div(sy_i.to(torch.float32) + sy_u, float(hm))
    pdf_tab = env.pdf[sy_i * wm + sx_i]
    s = torch.sin(_PI * ev)
    inv_s = torch.where(s > 0, 1.0 / torch.clamp_min(s, 1e-12), 0.0)
    pdf = div(pdf_tab * inv_s, 2.0 * _PI * _PI) * inv_n
    dist = torch.full_like(eu, 1e30)
    return uv_to_direction(eu, ev), dist, pdf, texture_sample(env.texture, eu, ev)


def env_miss_add(env: EnvMap, d, pdf_prev, miss, inv_n: float):
    """The env's radiance along the rays d where `miss`, MIS-weighted against
    the BSDF pdf pdf_prev (1e30: none) -> (r, g, b) addends
    (env_miss_add_planes)."""
    u, v = direction_to_uv(d)
    pdf_env = sampled_light_pdf(env.pdf, u, v) * inv_n
    mis = pdf_prev / torch.clamp_min(pdf_prev + pdf_env, 1e-4)
    rad = texture_sample(env.texture, u, v)
    return tuple(torch.where(miss, mis * rad[c], 0.0) for c in range(3))


def env_sampled_light_pdf(env: EnvMap, d):
    """The pdf of sample_envmap having drawn direction d, before the light
    selection's 1/n (JAX envmap.py:271)."""
    u, v = direction_to_uv(d)
    return sampled_light_pdf(env.pdf, u, v)


def env_radiance(env: EnvMap, d):
    """The env's radiance along direction d, the miss shader's lookup (JAX
    envmap.py:283) -> (r, g, b)."""
    u, v = direction_to_uv(d)
    return texture_sample(env.texture, u, v)
