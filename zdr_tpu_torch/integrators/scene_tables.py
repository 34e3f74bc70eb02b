"""Per-triangle and per-light rows that the path loop reads.

Port of zdr_tpu/integrators/pallas_bounce.py:246-321 (`build_fused_const`)
and pallas_loop.py:883-900 (the light-instance and point-light rows),
without the TPU's row padding:

  triangles   (T, 31): p0 e1 e2 | uv0 du1 du2 | n0 dn1 dn2 | ng | emission |
                       n_total * instance_tri_count * area
  light tris  (L, 16): p0 e1 e2 | emission | ng | n_total * tc * area
  light insts (n_lights, 2): first light-tri row, triangle count
  points      (n_point, 6): position | intensity
"""

from __future__ import annotations

import torch

from ..scenedata import SceneData
from ..vec import vcross

SCENE_COLS = 31
LIGHT_COLS = 16
CAM_COLS = 16


def table_floats(meta) -> int:
    """Floats of the scene, light, light-instance, point and camera rows."""
    return (meta.num_tris * SCENE_COLS + len(meta.light_tri_ids) * LIGHT_COLS
            + meta.n_lights * 2 + meta.n_point * 6 + CAM_COLS)


def _norm(c):
    return torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2])


def _cross(a, b):
    return torch.stack(vcross(a.unbind(1), b.unbind(1)), dim=1)


def _normalized(c):
    return c / torch.clamp_min(_norm(c), 1e-20)[:, None]


def scene_table(data: SceneData) -> torch.Tensor:
    g = data.geom
    i0, i1, i2 = g.triangles.unbind(1)
    p0 = g.positions[i0]
    e1 = g.positions[i1] - p0
    e2 = g.positions[i2] - p0
    uv0 = g.uvs[i0]
    du1 = g.uvs[i1] - uv0
    du2 = g.uvs[i2] - uv0
    n0 = g.normals[i0]
    dn1 = g.normals[i1] - n0
    dn2 = g.normals[i2] - n0
    c = _cross(e1, e2)
    area = 0.5 * _norm(c)
    em = data.emission[g.tri_inst]
    tc = g.inst_tri_count[g.tri_inst].to(torch.float32)
    inv_pdf_const = float(data.meta.n_total) * tc * area
    return torch.cat(
        [p0, e1, e2, uv0, du1, du2, n0, dn1, dn2, _normalized(c), em,
         inv_pdf_const[:, None]], dim=1,
    ).to(torch.float32).contiguous()


def light_table(data: SceneData) -> torch.Tensor:
    ids = list(data.meta.light_tri_ids)
    if not ids:
        return torch.zeros((0, LIGHT_COLS), dtype=torch.float32, device=data.device)
    g = data.geom
    lids = torch.tensor(ids, dtype=torch.int64, device=data.device)
    i0, i1, i2 = g.triangles[lids].unbind(1)
    lv0 = g.positions[i0]
    le1 = g.positions[i1] - lv0
    le2 = g.positions[i2] - lv0
    inst = g.tri_inst[lids]
    lc = _cross(le1, le2)
    l_area = 0.5 * _norm(lc)
    l_tc = g.inst_tri_count[inst].to(torch.float32)
    l_inv_pdf = float(data.meta.n_total) * l_tc * l_area
    return torch.cat(
        [lv0, le1, le2, data.emission[inst], _normalized(lc), l_inv_pdf[:, None]],
        dim=1,
    ).to(torch.float32).contiguous()


def light_inst_table(data: SceneData) -> torch.Tensor:
    m = data.meta
    rows = [[float(o), float(t)] for o, t in zip(m.light_offsets, m.light_tcs)]
    return torch.tensor(rows, dtype=torch.float32, device=data.device).reshape(-1, 2)


def point_table(data: SceneData) -> torch.Tensor:
    n = data.meta.n_point
    return torch.cat(
        [data.point_pos[:n], data.point_intensity[:n]], dim=1
    ).to(torch.float32).contiguous()
