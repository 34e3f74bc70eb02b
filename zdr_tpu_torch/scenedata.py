"""SceneData: the scene as tensors on one device, plus static light metadata.

Port of zdr_tpu/scenedata.py (`SceneData`), zdr_tpu/scene.py:42-73
(`_build_fused_meta`) and pallas_bounce.py:71-88 (`FusedMeta`). Only what
the kernels read is kept: geometry, per-instance emission, point lights and
the environment map (JAX scenedata.py:31-45: `env`, `env_count`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .accel.types import Accel
from .envmap import EnvMap
from .geometry.mesh import Geometry


@dataclasses.dataclass(frozen=True)
class LightMeta:
    """Light structure as python ints (FusedMeta's fields): the light-triangle
    ids of every emissive instance in instance order, and the counts."""

    n_lights: int  # number of mesh light instances
    light_tri_ids: Tuple[int, ...]  # global tri ids of all light triangles
    light_offsets: Tuple[int, ...]  # per light instance: first index above
    light_tcs: Tuple[int, ...]  # per light instance: triangle count
    num_tris: int
    n_env: int = 0
    n_point: int = 0

    @property
    def n_total(self) -> int:
        """Light-selection denominator: env + point + mesh lights, at least 1."""
        return max(self.n_env + self.n_point + self.n_lights, 1)


def build_light_meta(geom: Geometry, light_insts: Sequence[int], n_point: int = 0,
                     n_env: int = 0) -> LightMeta:
    offs = geom.inst_tri_offset.tolist()
    cnts = geom.inst_tri_count.tolist()
    tri_ids, offsets, tcs = [], [], []
    for inst in light_insts:
        offsets.append(len(tri_ids))
        tcs.append(int(cnts[inst]))
        tri_ids.extend(range(int(offs[inst]), int(offs[inst]) + int(cnts[inst])))
    return LightMeta(
        n_lights=len(light_insts),
        light_tri_ids=tuple(tri_ids),
        light_offsets=tuple(offsets),
        light_tcs=tuple(tcs),
        num_tris=int(geom.num_triangles),
        n_env=int(n_env),
        n_point=int(n_point),
    )


@dataclasses.dataclass
class SceneData:
    geom: Geometry
    emission: torch.Tensor  # (I, 3) float32 per-instance radiance
    meta: LightMeta
    point_pos: torch.Tensor  # (P, 3) float32; the first meta.n_point rows count
    point_intensity: torch.Tensor  # (P, 3) float32
    # the intersection structure of the render: a "bvh" Accel sends every
    # sweep through the BVH; None or a dense one, the dense sweeps over the
    # kernels' shared-memory scene table
    accel: Optional[Accel] = None
    # the (T, 31) scene rows (integrators/scene_tables.scene_table), kept by
    # a Scene and rebuilt when its lights change; None: built per render
    table: Optional[torch.Tensor] = None
    # the environment light (meta.n_env 1), its sampling tables built once
    # per Scene.add_envmap; None: no env (meta.n_env 0)
    env: Optional[EnvMap] = None

    @property
    def device(self) -> torch.device:
        return self.emission.device
