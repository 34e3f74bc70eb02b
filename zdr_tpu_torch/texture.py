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
(4, H*W), which was a TPU layout choice.
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


def scatter_add4(ids: torch.Tensor, vals: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Sum (M, 4) values into (n_bins, 4) rows by (M,) id; id n_bins is the
    sentinel of a tap that splats nowhere, and its row is dropped. The
    meaning of the JAX package's texture.segment_scatter_add4 (unpacked),
    in the (texel, channel) layout."""
    buf = torch.zeros((n_bins + 1, 4), dtype=vals.dtype, device=vals.device)
    buf.index_add_(0, ids, vals)
    return buf[:n_bins]
