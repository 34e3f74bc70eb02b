"""Bilinear material fetch (CLAMP addressing, v flipped), and the texel a
gradient tap splats into.

Port of zdr_tpu/integrators/pallas_bounce.py:1569-1598
(`read_quads_planes`). The JAX package first packs every 2x2 quad into one
16-float row (`texture.pack_quads`) because a TPU row gather is priced per
row; here the four texels are read straight from the (H, W, 4) material,
with read_quads_planes' clamp, weights and summation order.

The gradient side: `splat_ids` (the one-corner splat of pallas_loop.py:
544-572) and `scatter_add4`, the meaning of texture.segment_scatter_add4,
in the (H*W, 4) layout of the material rather than JAX's channel-major
(4, H*W), which was a TPU layout choice; its bf16 packing (`round_bf16`,
`pack_bf16_pair`, `unpack_bf16_pair`, texture.py:112-125) and the
weighted-reservoir merge of two taps (`reservoir_merge_taps`, :231-262),
the plain versions of the kernels' splat knobs (kernels/csrc/splat.cuh).

The unfused estimators' side (texture.py:383-593): `read_bsdf`, the fetch
with nearest filtering too and the generic corners of a material under 2x2,
differentiable in the material through JAX's own VJP (`ReadBsdf`), and the
splats `write_bsdf_grad`, `write_bsdf_grad_stochastic` and
`stochastic_corner_ids`. JAX's bf16 quad table (`texture_bf16`) is a TPU
gather knob and is not ported.
"""

from __future__ import annotations

import torch


def read_bilinear(material: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor):
    """(H, W, 4) material at uv (N,) -> 4 (N,) planes: diffuse rgb, roughness."""
    h, w = material.shape[0], material.shape[1]
    x = ux * (w - 1)
    y = (1.0 - uy) * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    # the integer clamp only matters for a NaN uv, whose int cast is undefined
    xi = torch.clamp(x0.to(torch.int64), 0, w - 2)
    yi = torch.clamp(y0.to(torch.int64), 0, h - 2)
    flat = material.reshape(h * w, 4)
    base = yi * w + xi
    c00 = flat[base]
    c01 = flat[base + w]
    c10 = flat[base + 1]
    c11 = flat[base + w + 1]
    w00 = (1 - fx) * (1 - fy)
    w01 = (1 - fx) * fy
    w10 = fx * (1 - fy)
    w11 = fx * fy
    return [
        c00[:, c] * w00 + c01[:, c] * w01 + c10[:, c] * w10 + c11[:, c] * w11
        for c in range(4)
    ]


def splat_ids(ux: torch.Tensor, uy: torch.Tensor, u: torch.Tensor, h: int, w: int):
    """The one texel a gradient tap splats into: the bilinear corner whose
    weight interval holds u (pallas_loop.py:546-570) -> (N,) int64 in
    [0, H*W). Unlike read_bilinear the floor is unclamped and the corners
    are clipped to [0, W-1], as in the JAX kernel, so at uv_x = 1 or
    uv_y = 0 the two pick different texels."""
    x = ux * (w - 1)
    y = (1.0 - uy) * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = _to_int(x0, w)
    y0i = _to_int(y0, h)
    xa = torch.clamp(x0i, 0, w - 1)
    ya = torch.clamp(y0i, 0, h - 1)
    xb = torch.clamp(x0i + 1, 0, w - 1)
    yb = torch.clamp(y0i + 1, 0, h - 1)
    w00 = (1 - fx) * (1 - fy)
    w01 = (1 - fx) * fy
    w10 = fx * (1 - fy)
    c0 = w00
    c1 = c0 + w01
    c2 = c1 + w10
    return torch.where(
        u < c0, ya * w + xa,
        torch.where(u < c1, yb * w + xa, torch.where(u < c2, ya * w + xb, yb * w + xb)),
    )


def _to_int(x: torch.Tensor, n: int) -> torch.Tensor:
    """XLA's saturating float -> int cast (NaN -> 0), clipped to [-1, n]:
    the corners it feeds are clipped to [0, n-1] anyway."""
    return torch.clamp(torch.where(torch.isnan(x), 0.0, x), -1, n).to(torch.int64)


def scatter_add4(ids: torch.Tensor, vals: torch.Tensor, n_bins: int, packed: bool = False,
                 prepacked: bool = False) -> torch.Tensor:
    """Sum (M, 4) values into (n_bins, 4) rows by (M,) id; id n_bins is the
    sentinel of a tap that splats nowhere, and its row is dropped. The
    meaning of the JAX package's texture.segment_scatter_add4, in the
    (texel, channel) layout: with `packed` each texel's total is rounded to
    bf16; with `prepacked` each entry is rounded to bf16 first, as
    splat_buffer_row packs it at emission (a no-op on entries already
    rounded)."""
    if prepacked:
        vals = round_bf16(vals)
    buf = torch.zeros((n_bins + 1, 4), dtype=vals.dtype, device=vals.device)
    buf.index_add_(0, ids, vals)
    return round_bf16(buf[:n_bins]) if packed else buf[:n_bins]


# the samples whose taps the direct and collocated backwards gather before a
# packed flush (the JAX package's SCATTER_BATCH, path_persistent.py:30)
SPLAT_BATCH = 4


def add_taps(grad, scratch, it: int, n_samples: int, ids, vals, n_bins: int, packed: bool):
    """Sample `it`'s taps, (M,) ids and (M, 4) values, into the (n_bins, 4)
    grad in place: straight in, or with `packed` as the JAX package's
    buffered direct and collocated backwards flush them
    (direct_fused.py:319-345): each value rounded to bf16 (NaN -> 0) into
    scratch, whose texels are rounded to bf16 and added into grad after
    every SPLAT_BATCH samples and after the last."""
    if not packed:
        grad += scatter_add4(ids, vals, n_bins)
        return
    vals = round_bf16(vals)
    scratch += scatter_add4(ids, torch.where(torch.isnan(vals), 0.0, vals), n_bins)
    if it % SPLAT_BATCH == SPLAT_BATCH - 1 or it == n_samples - 1:
        grad += round_bf16(scratch)
        scratch.zero_()


# the bits of a bf16 in the high half of a float32's
_HIGH = -0x10000  # 0xFFFF0000 as int32


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 (ties to even), as float32: JAX's
    x.astype(bfloat16).astype(float32), with denormals kept, values past
    bf16's largest rounding to inf and NaN kept. Integer arithmetic on the
    bits, as the kernels' zdr::round_bf16 (splat.cuh) does it: add 0x7FFF
    and the lowest kept bit, then drop the low 16 bits."""
    u = x.contiguous().view(torch.int32)
    r = (u + (0x7FFF + ((u >> 16) & 1))) & _HIGH
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> one float32 whose bits are bf16(a) << 16 |
    bf16(b) (texture.py:112)."""
    hi = round_bf16(a).view(torch.int32)
    lo = (round_bf16(b).view(torch.int32) >> 16) & 0xFFFF
    return (hi | lo).view(torch.float32)


def unpack_bf16_pair(p: torch.Tensor):
    """pack_bf16_pair's inverse -> (a, b) float32 (texture.py:121)."""
    u = p.contiguous().view(torch.int32)
    return (u & _HIGH).view(torch.float32), (u << 16).view(torch.float32)


def reservoir_merge_taps(pend, new, u: torch.Tensor, n_bins: int):
    """Weighted-reservoir merge of two taps a lane into one (texture.py:231):
    pend and new are (ids, g0, g1, g2, g3), ids with the sentinel n_bins
    for no tap; keeps one with probability its L1 weight by the uniform u,
    rescaled by total / its weight, so the merge is unbiased, and exact
    (scale 1) where one side weighs 0; a pair of weight 0 becomes the
    sentinel. The same operations in the same order as JAX's, so the
    result is its bit for bit."""
    ids_p, *p = pend
    ids_n, *q = new
    wp = torch.abs(p[0]) + torch.abs(p[1]) + torch.abs(p[2]) + torch.abs(p[3])
    wn = torch.abs(q[0]) + torch.abs(q[1]) + torch.abs(q[2]) + torch.abs(q[3])
    wp = torch.where(ids_p < n_bins, wp, 0.0)
    wn = torch.where(ids_n < n_bins, wn, 0.0)
    tot = wp + wn
    take_p = u * tot < wp
    sp = tot / torch.clamp_min(wp, 1e-30)
    sn = tot / torch.clamp_min(wn, 1e-30)
    ids = torch.where(take_p, ids_p, ids_n)
    gs = tuple(torch.where(take_p, a * sp, b * sn) for a, b in zip(p, q))
    ids = torch.where(tot > 0, ids, torch.full_like(ids, n_bins))
    return (ids, *gs)


# ----------------------------------------------- the unfused estimators' side


def nearest_ids(ux: torch.Tensor, uy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The texel a nearest fetch reads (texture.py:389-391) -> (N,) int64."""
    x = torch.clamp(_to_int(ux * (w - 1) + 0.4999, w), 0, w - 1)
    y = torch.clamp(_to_int((1.0 - uy) * (h - 1) + 0.4999, h), 0, h - 1)
    return y * w + x


def bilinear_corners(ux: torch.Tensor, uy: torch.Tensor, h: int, w: int):
    """The four corners of the generic bilinear fetch and its VJP, with the
    floor unclamped and the corners clipped (texture.py:35-59) -> (ids,
    weights), 4 (N,) int64 and 4 (N,) float32: (x0, y0), (x0, y0+1),
    (x0+1, y0), (x0+1, y0+1)."""
    x = ux * (w - 1)
    y = (1.0 - uy) * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = _to_int(x0, w)
    y0i = _to_int(y0, h)
    xa, ya = torch.clamp(x0i, 0, w - 1), torch.clamp(y0i, 0, h - 1)
    xb, yb = torch.clamp(x0i + 1, 0, w - 1), torch.clamp(y0i + 1, 0, h - 1)
    ids = (ya * w + xa, yb * w + xa, ya * w + xb, yb * w + xb)
    weights = ((1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy)
    return ids, weights


def _read_bsdf_impl(uv: torch.Tensor, material: torch.Tensor, bilinear: bool) -> torch.Tensor:
    h, w = material.shape[0], material.shape[1]
    flat = material.reshape(h * w, 4)
    if not bilinear:
        return flat[nearest_ids(uv[:, 0], uv[:, 1], h, w)]
    if h >= 2 and w >= 2:
        return torch.stack(read_bilinear(material, uv[:, 0], uv[:, 1]), dim=1)
    ids, ws = bilinear_corners(uv[:, 0], uv[:, 1], h, w)
    out = flat[ids[0]] * ws[0][:, None]
    for k in range(1, 4):
        out = out + flat[ids[k]] * ws[k][:, None]
    return out


class ReadBsdf(torch.autograd.Function):
    """The material at uv, differentiable in the material: its backward is
    JAX's _read_bsdf_bwd (texture.py:537-551), the scatter of the cotangent
    into the texel the nearest fetch read, or into the four bilinear corners
    (unclamped floor, clipped corners) by their weights. uv carries no
    gradient."""

    @staticmethod
    def forward(uv, material, bilinear):
        return _read_bsdf_impl(uv, material, bilinear)

    @staticmethod
    def setup_context(ctx, inputs, output):
        uv, material, bilinear = inputs
        ctx.save_for_backward(uv)
        ctx.shape = material.shape
        ctx.bilinear = bilinear

    @staticmethod
    def backward(ctx, g):
        (uv,) = ctx.saved_tensors
        d_mat = write_bsdf_grad(uv, g, torch.zeros(ctx.shape, dtype=g.dtype, device=g.device),
                                ctx.bilinear)
        return None, d_mat, None


def read_bsdf(uv: torch.Tensor, material: torch.Tensor, bilinear: bool = True) -> torch.Tensor:
    """The (H, W, 4) material at uv (N, 2) -> (N, 4), bilinear (CLAMP, v
    flipped) or nearest; differentiable in the material (texture.py:581)."""
    return ReadBsdf.apply(uv, material, bool(bilinear))


def write_bsdf_grad(uv: torch.Tensor, dmat: torch.Tensor, d_material: torch.Tensor,
                    bilinear: bool = True) -> torch.Tensor:
    """d_material (H, W, 4) plus the per-sample gradients dmat (N, 4)
    scattered to the texel read (nearest) or the bilinear corners by their
    weights (texture.py:402): read_bsdf's VJP."""
    h, w = d_material.shape[0], d_material.shape[1]
    if not bilinear:
        add = scatter_add4(nearest_ids(uv[:, 0], uv[:, 1], h, w), dmat, h * w)
    else:
        ids, ws = bilinear_corners(uv[:, 0], uv[:, 1], h, w)
        add = scatter_add4(torch.cat(ids), torch.cat([wk[:, None] * dmat for wk in ws]),
                           h * w)
    return d_material + add.reshape(h, w, 4)


def stochastic_corner_ids(uv: torch.Tensor, u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One bilinear corner per sample, picked with probability its weight by
    the uniform u (texture.py:495) -> (N,) int64: splat_ids."""
    return splat_ids(uv[:, 0], uv[:, 1], u, h, w)


def write_bsdf_grad_stochastic(uv: torch.Tensor, dmat: torch.Tensor, d_material: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """The unbiased single-corner splat (texture.py:433): each sample's
    whole gradient into the corner stochastic_corner_ids picks."""
    h, w = d_material.shape[0], d_material.shape[1]
    add = scatter_add4(stochastic_corner_ids(uv, u, h, w), dmat, h * w)
    return d_material + add.reshape(h, w, 4)
