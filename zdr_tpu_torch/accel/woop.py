"""Woop rows and tile boxes of a triangle table, for the sweep variants.

Counterparts of zdr_tpu/integrators/pallas_bounce.py::build_woop_pack
(:350-428) and tools/profile_mxu_variants.py::make_boxes (:341), without
the TPU's transposed (48, T_pad) layout: one row of WOOP_COLS floats a
triangle, in global order, and one box a tile of `tile` triangles.

The Woop test is an affine change of basis: with M = inv([e1 e2 n]) (rows
m_u, m_v, m_w) and a triangle's row [m_u | -m_u.p0 | m_v | -m_v.p0 | m_w |
-m_w.p0], a ray's o' = M (o - p0) and d' = M d give t = -o'_w / d'_w,
u = o'_u + t d'_u and v = o'_v + t d'_v: three 4-dots and three 3-dots a
test, where Möller–Trumbore takes two cross products a ray and triangle
(kernels/csrc/sweep_variants.cuh woop_hit).
"""

from __future__ import annotations

import torch

from ..vec import vcross

WOOP_COLS = 12  # m_u | -m_u.p0, m_v | -m_v.p0, m_w | -m_w.p0 (48 bytes)


def _aug(r, p0):
    """(3 (T,) components of a Woop row, p0) -> (T, 4) [r | -r.p0]."""
    dot = r[0] * p0[0] + r[1] * p0[1] + r[2] * p0[2]
    return torch.stack([r[0], r[1], r[2], -dot], dim=1)


def woop_rows(geom: torch.Tensor) -> torch.Tensor:
    """(T, >= 9) geometry rows p0, e1, e2 -> (T, WOOP_COLS) float32 Woop
    rows; a degenerate triangle (|e1 x e2|^2 <= 1e-24) gets zeros, which no
    ray hits."""
    c = [geom[:, k] for k in range(9)]
    p0, e1, e2 = tuple(c[0:3]), tuple(c[3:6]), tuple(c[6:9])
    n = vcross(e1, e2)
    det = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]  # det([e1 e2 n]) = |n|^2
    inv_det = torch.where(det > 1e-24, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    ru = tuple(x * inv_det for x in vcross(e2, n))
    rv = tuple(x * inv_det for x in vcross(n, e1))
    rw = tuple(x * inv_det for x in n)
    return torch.cat([_aug(ru, p0), _aug(rv, p0), _aug(rw, p0)], dim=1).contiguous()


def tile_boxes(geom: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, >= 9) geometry rows -> (ceil(T / tile), 6) float32 boxes lo xyz,
    hi xyz over each tile's non-degenerate triangles, in global order; a
    tile with none gets lo 1e30, hi -1e30, which no slab test hits."""
    n_tris = geom.shape[0]
    p0, e1, e2 = geom[:, 0:3], geom[:, 3:6], geom[:, 6:9]
    n = vcross(e1.unbind(1), e2.unbind(1))
    valid = (n[0] * n[0] + n[1] * n[1] + n[2] * n[2]) > 1e-24
    corners = torch.stack([p0, p0 + e1, p0 + e2], dim=1)  # (T, 3, 3)
    lo = torch.where(valid[:, None], corners.amin(dim=1), 1e30)
    hi = torch.where(valid[:, None], corners.amax(dim=1), -1e30)
    n_tiles = -(-n_tris // tile)
    pad = n_tiles * tile - n_tris
    lo = torch.cat([lo, lo.new_full((pad, 3), 1e30)]).reshape(n_tiles, tile, 3).amin(dim=1)
    hi = torch.cat([hi, hi.new_full((pad, 3), -1e30)]).reshape(n_tiles, tile, 3).amax(dim=1)
    return torch.cat([lo, hi], dim=1).contiguous()
