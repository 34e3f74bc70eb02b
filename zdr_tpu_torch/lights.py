"""Light sampling for the unfused estimators: a uniform pick among the
environment, the point and the mesh lights, and the pdf that MIS weighs an
emitter hit with (port of zdr_tpu/lights.py).

Every lane draws the same dimensions whichever light it picks (u_select,
u_prim, u2), so that a replay of the stream is exact. Vectors are component
tuples of (N,) tensors. The light selection is 1 / (env + point + mesh)
everywhere, the JAX package's documented deviation from the reference
(lights.py:133-144).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .envmap import sample_envmap
from .interaction import gather_rows, triangle_vertices
from .vec import div, vcross, vdot, vnormalize, vsub


class LightSample(NamedTuple):
    wi: tuple  # unit direction toward the sample
    dist: torch.Tensor  # the shadow ray's end
    pdf: torch.Tensor  # solid-angle pdf, the selection's 1/n included
    eval: tuple  # radiance


def _n_lights(data) -> int:
    return data.meta.n_env + data.meta.n_point + data.meta.n_lights


def light_selection_pdf(data) -> float:
    """The probability of picking any one light: 1 / (env + point + mesh),
    at least one light counted. Scales the env's pdf at the miss-MIS
    sites."""
    return 1.0 / max(_n_lights(data), 1)


def sample_uniform_triangle(ux, uy):
    """Low-distortion uniform barycentrics (a, b, 1 - a - b)."""
    a = torch.where(ux < uy, 0.5 * ux, ux - 0.5 * uy)
    b = torch.where(ux < uy, uy - 0.5 * ux, 0.5 * uy)
    return a, b, 1.0 - a - b


def light_instances(data) -> torch.Tensor:
    """The emissive instances, in light order (the JAX SceneData's
    light_insts), as int64 on the scene's device."""
    m = data.meta
    first = [m.light_tri_ids[o] for o in m.light_offsets]
    ids = torch.tensor(first, dtype=torch.int64, device=data.device)
    return data.geom.tri_inst[ids]


def _length_squared(v):
    return vdot(v, v)


def sample_light(data, origin, sampler):
    """One light sample per lane from `origin` -> (LightSample, sampler)."""
    u_sel, sampler = sampler.next1()
    u_prim, sampler = sampler.next1()
    (u2x, u2y), sampler = sampler.next2_xy()

    n_env, n_point, n_mesh = data.meta.n_env, data.meta.n_point, data.meta.n_lights
    n_i = n_env + n_point + n_mesh
    n = float(max(n_i, 1))
    idx = torch.clamp((u_sel * n).to(torch.int32), 0, max(n_i - 1, 0))

    zero = torch.zeros_like(u_sel)
    wi, dist, pdf, ev = (zero, zero, zero + 1.0), zero, zero + 1.0, (zero, zero, zero)
    if n_mesh > 0:
        g = data.geom
        mesh_idx = torch.clamp(idx - n_env - n_point, 0, n_mesh - 1).long()
        inst = light_instances(data)[mesh_idx]
        tc = g.inst_tri_count[inst]
        prim_local = torch.clamp((u_prim * tc).to(torch.int64), 0, None)
        prim_local = torch.minimum(prim_local, torch.clamp_min(tc - 1, 0))
        p0, p1, p2 = triangle_vertices(g, g.inst_tri_offset[inst] + prim_local)
        a, b, c = sample_uniform_triangle(u2x, u2y)
        p_light = tuple(a * p0[k] + b * p1[k] + c * p2[k] for k in range(3))
        emission = gather_rows(data.emission, inst)
        cr = vcross(vsub(p1, p0), vsub(p2, p0))
        light_normal = vnormalize(cr)
        delta = vsub(p_light, origin)
        wi = vnormalize(delta)
        cos_light = -vdot(light_normal, wi)
        sqr_dist = _length_squared(delta)
        area = div(torch.sqrt(_length_squared(cr)), 2.0)
        pdf = sqr_dist / torch.clamp_min(n * tc.to(torch.float32) * area * cos_light, 1e-12)
        ev = tuple(torch.where(cos_light > 1e-4, e, 0.0) for e in emission)
        dist = 0.9999 * torch.sqrt(sqr_dist)

    if n_point > 0:
        p_idx = torch.clamp(idx - n_env, 0, n_point - 1).long()
        delta = vsub(gather_rows(data.point_pos, p_idx), origin)
        p_sqr = _length_squared(delta)
        is_point = (idx >= n_env) & (idx < n_env + n_point)
        p_wi = vnormalize(delta)
        p_ev = gather_rows(data.point_intensity, p_idx)
        wi = tuple(torch.where(is_point, x, y) for x, y in zip(p_wi, wi))
        dist = torch.where(is_point, 0.9999 * torch.sqrt(p_sqr), dist)
        pdf = torch.where(is_point, div(p_sqr, n), pdf)
        ev = tuple(torch.where(is_point, x, y) for x, y in zip(p_ev, ev))

    if n_env > 0:
        e_wi, e_dist, e_pdf, e_ev = sample_envmap(data.env, u2x, u2y, 1.0 / n)
        is_env = idx < n_env
        wi = tuple(torch.where(is_env, x, y) for x, y in zip(e_wi, wi))
        dist = torch.where(is_env, e_dist, dist)
        pdf = torch.where(is_env, e_pdf, pdf)
        ev = tuple(torch.where(is_env, x, y) for x, y in zip(e_ev, ev))
    return LightSample(wi=wi, dist=dist, pdf=pdf, eval=ev), sampler


def sample_light_pdf(data, origin, inst, prim, p) -> torch.Tensor:
    """The pdf of sample_light having drawn the point p on triangle prim of
    instance inst, from origin (the env's own pdf is the miss branch's)."""
    g = data.geom
    n = float(max(_n_lights(data), 1))
    tc = g.inst_tri_count[torch.clamp_min(inst, 0).long()]
    p0, p1, p2 = triangle_vertices(g, torch.clamp_min(prim, 0))
    delta = vsub(p, origin)
    wi = vnormalize(delta)
    cr = vcross(vsub(p1, p0), vsub(p2, p0))
    cos_light = -vdot(vnormalize(cr), wi)
    sqr_dist = _length_squared(delta)
    area = div(torch.sqrt(_length_squared(cr)), 2.0)
    return sqr_dist / torch.clamp_min(n * tc.to(torch.float32) * area * cos_light, 1e-12)


__all__ = ["LightSample", "light_selection_pdf", "sample_uniform_triangle", "sample_light",
           "sample_light_pdf"]
