"""Hit -> surface information, batched (port of zdr_tpu/interaction.py).

Geometry is in world space already (geometry/mesh.py): three vertex
gathers a hit and barycentric interpolation. The vectors are component
tuples of (N,) tensors, as everywhere in the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .accel.types import Hit
from .geometry.mesh import Geometry
from .vec import vcross, vnormalize, vsub


class Interaction(NamedTuple):
    p: tuple  # hit position
    uv: tuple  # texture coordinates
    ns: tuple  # shading normal (interpolated)
    ng: tuple  # geometric normal


def gather_rows(table: torch.Tensor, idx: torch.Tensor):
    """Rows idx (N,) of an (M, C) table -> C (N,) columns."""
    return tuple(table[idx].unbind(1))


def interpolate(hit: Hit, a0, a1, a2):
    """(1 - u - v) a0 + u a1 + v a2 per component (JAX Hit.interpolate)."""
    w0 = 1.0 - hit.bary_u - hit.bary_v
    return tuple(w0 * x0 + hit.bary_u * x1 + hit.bary_v * x2 for x0, x1, x2 in zip(a0, a1, a2))


def triangle_vertices(geom: Geometry, prim: torch.Tensor):
    """The corners p0, p1, p2 of global triangles prim (N,)."""
    tri = geom.triangles[prim.long()]
    return tuple(gather_rows(geom.positions, tri[:, k]) for k in range(3))


def surface_interact(hit: Hit, geom: Geometry) -> Interaction:
    """A miss interacts with triangle 0: callers mask by hit.miss."""
    prim = torch.clamp_min(hit.prim, 0).long()
    tri = geom.triangles[prim]
    i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
    p0, p1, p2 = (gather_rows(geom.positions, i) for i in (i0, i1, i2))
    uv = interpolate(hit, *(gather_rows(geom.uvs, i) for i in (i0, i1, i2)))
    ns = vnormalize(interpolate(hit, *(gather_rows(geom.normals, i) for i in (i0, i1, i2))))
    ng = vnormalize(vcross(vsub(p1, p0), vsub(p2, p0)))
    return Interaction(p=interpolate(hit, p0, p1, p2), uv=uv, ns=ns, ng=ng)
