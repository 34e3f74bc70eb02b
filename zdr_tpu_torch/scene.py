"""Scene: the user-facing API (port of zdr_tpu/scene.py:84-302), on torch.

    scene = Scene([(obj_file, transform_or_None, emission_or_None), ...],
                  integrator="direct", device="cuda")
    scene.camera = Camera(fov=..., origin=..., target=..., up=...)
    image = scene.render(material, res=(W, H), spp=64, seed=0)   # (H, W, 4)

    material.requires_grad_()
    image = scene.render(material, res=(W, H), spp=64, seed=0)
    image[..., :3].sum().backward()                                # material.grad

The scene's tensors live on its device ("cuda" unless the caller asks for
"cpu"), the material must too, and a render runs there (on "cuda" the CUDA
kernels: direct and, for the backward, direct_grad; collocated and
collocated_grad for the collocated integrator; path_loop and path_loop_grad
for the path integrator; on "cpu" their plain versions). The render is
differentiable in the material: the backward re-estimates the texture
gradient at seed + 1 (Path Replay Backprop for the path integrator).
add_envmap lights the scene with an environment map (the direct
integrator; the path kernels do not read it yet, ROADMAP A11).

`accel` picks the route of the sweeps (JAX's names): "bruteforce" or
"pallas", the dense sweep over the kernels' shared-memory scene table;
"bvh" or "stream", the BVH in device memory (the big-mesh
route); "auto" (the default), dense below the integrator's measured
crossover (accel/build.DENSE_MAX_TRIS) while its kernels hold the table in
shared memory, else the BVH. The BVH is built once per Scene, at
first need, and the scene rows once per light setup: update_lights and
add_point_light rebuild the rows, never the tree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import dataclasses

import numpy as np
import torch

from .accel.build import METHODS, build_accel, dense_route
from .dtypes import default_camera
from .envmap import build_envmap
from .geometry.load_obj import ObjMesh
from .geometry.mesh import build_geometry
from .integrators.scene_tables import scene_table, table_floats
from .integrators.wrapper import RenderConfig, RenderFunction
from .scenedata import SceneData, build_light_meta

MAX_INSTANCES = 10000


def _normalize_emission(e) -> np.ndarray:
    if e is None:
        return np.zeros(3, np.float32)
    if np.ndim(e) == 0:
        return np.full(3, float(e), np.float32)
    return np.asarray(e, dtype=np.float32).reshape(3)


class Scene:
    """A triangle scene rendered on one device.

    Args:
        models: list of (obj_file_or_ObjMesh, transform_4x4_or_None,
            emission_or_None). Emission > 0 marks an instance as an area light.
        integrator: 'direct' (default) | 'collocated' | 'path'.
        sampler: 'pmj02bn' (default) | 'lcg'.
        accel: 'auto' (default) | 'bruteforce' | 'pallas' | 'bvh' | 'stream'.
        device: torch device of the scene and of every render: the card
            ("cuda", the default) or "cpu" for the plain versions.
    """

    def __init__(
        self,
        models: Sequence[Tuple[Union[str, ObjMesh], Optional[np.ndarray], object]],
        integrator: str = "direct",
        sampler: str = "pmj02bn",
        *,
        accel: str = "auto",
        device="cuda",
    ):
        if len(models) > MAX_INSTANCES:
            raise RuntimeError("exceeding maximum number of mesh instances")
        self.device = torch.device(device)
        geom = build_geometry([(src, t) for (src, t, _e) in models], self.device)
        self.emissions = [_normalize_emission(e) for (_s, _t, e) in models]
        self._data = SceneData(
            geom=geom,
            emission=torch.as_tensor(np.stack(self.emissions), device=self.device),
            meta=build_light_meta(geom, self._light_insts()),
            point_pos=torch.zeros((0, 3), dtype=torch.float32, device=self.device),
            point_intensity=torch.zeros((0, 3), dtype=torch.float32, device=self.device),
        )
        self._data.table = scene_table(self._data)
        if accel not in METHODS:
            raise ValueError(f"unknown accel method {accel!r}")
        self.accel = accel
        if accel in ("bvh", "stream"):
            self._with_bvh()
        self.camera = default_camera()
        self.integrator = integrator
        self.sampler = sampler
        self.use_tent_filter = True
        self.use_mis = True
        self.max_depth = 16
        self.rr_depth = 2
        self.bilinear = True
        # PRB scatter knobs; the port takes only 1 and False (ROADMAP A17)
        self.splat_merge = 1
        self.packed_splat = False

    def _with_bvh(self) -> SceneData:
        """The scene's data with its BVH, built at the first call."""
        if self._data.accel is None:
            self._data = dataclasses.replace(self._data, accel=build_accel(self._data.geom, "bvh"))
        return self._data

    def _render_data(self, integrator: str) -> SceneData:
        """The scene's data with the accel of a render's route: the BVH, or
        none for the dense sweep."""
        if self.accel not in METHODS:
            raise ValueError(f"unknown accel method {self.accel!r}")
        d = self._data
        dense = self.accel in ("bruteforce", "pallas") or (
            self.accel == "auto"
            and dense_route(d.meta.num_tris, table_floats(d.meta), integrator))
        if dense:
            return dataclasses.replace(d, accel=None) if d.accel is not None else d
        return self._with_bvh()

    def _light_insts(self):
        return [i for i, e in enumerate(self.emissions) if (e > 0).any()]

    def update_lights(self, emissions) -> None:
        """Rewrite the per-instance emission (light-stage switching; JAX
        scene.py:161-186)."""
        n_inst = self._data.geom.inst_tri_count.shape[0]
        if len(emissions) != n_inst:
            raise ValueError(f"{len(emissions)} emissions for {n_inst} instances")
        self.emissions = [_normalize_emission(e) for e in emissions]
        self._data = dataclasses.replace(
            self._data,
            emission=torch.as_tensor(np.stack(self.emissions), device=self.device),
            meta=build_light_meta(self._data.geom, self._light_insts(),
                                  self._data.meta.n_point, self._data.meta.n_env),
        )
        # the scene rows carry the emission and the light count; the BVH stays
        self._data.table = scene_table(self._data)

    def add_point_light(self, position, intensity) -> None:
        """Add a point light (JAX scene.py:188-217).

        Args:
            position: world-space (3,).
            intensity: radiant intensity (3,) or scalar.
        """
        pos = torch.as_tensor(np.asarray(position, np.float32).reshape(1, 3),
                              device=self.device)
        inten = torch.as_tensor(_normalize_emission(intensity).reshape(1, 3),
                                device=self.device)
        d = self._data
        self._data = dataclasses.replace(
            d,
            point_pos=torch.cat([d.point_pos, pos]),
            point_intensity=torch.cat([d.point_intensity, inten]),
            meta=dataclasses.replace(d.meta, n_point=d.meta.n_point + 1),
        )
        self._data.table = scene_table(self._data)

    def add_envmap(self, img, compensate_mis: bool = True) -> None:
        """Light the scene with an equirect environment map (JAX
        scene.py:219-245): its sampling tables are built once, here.

        Args:
            img: (H, W, 3 or 4) float array, 1:2 or 1:1; a 3-channel image
                gets alpha 1.
            compensate_mis: sample the map less its sin-weighted mean
                (envmap.build_envmap).
        """
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 3 and img.shape[2] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        d = self._data
        self._data = dataclasses.replace(
            d,
            env=build_envmap(img, compensate_mis, self.device),
            meta=dataclasses.replace(d.meta, n_env=1),
        )
        # the scene rows carry the light count; the BVH stays
        self._data.table = scene_table(self._data)

    def _config(self, res, spp) -> RenderConfig:
        return RenderConfig(
            res=tuple(int(r) for r in res),
            spp=int(spp),
            integrator=self.integrator,
            sampler=self.sampler,
            use_tent_filter=bool(self.use_tent_filter),
            use_mis=bool(self.use_mis),
            max_depth=int(self.max_depth),
            rr_depth=int(self.rr_depth),
            bilinear=bool(self.bilinear),
            splat_merge=int(self.splat_merge),
            packed_splat=bool(self.packed_splat),
        )

    def render(self, material: torch.Tensor, *, res, spp, seed=0) -> torch.Tensor:
        """Render -> (H, W, 4) float32 image on the scene's device;
        differentiable w.r.t. material.

        Args:
            material: (H_tex, W_tex, 4) float32 tensor on the scene's device:
                diffuse RGB + roughness A.
            res: (width, height).
            spp: samples per pixel.
            seed: sampler seed; the backward pass uses seed + 1.
        """
        if material.ndim != 3 or material.shape[2] != 4:
            raise ValueError(f"material must be (H, W, 4), got {tuple(material.shape)}")
        if material.dtype != torch.float32:
            raise TypeError(f"material must be float32, got {material.dtype}")
        if material.device != self.device:
            raise ValueError(
                f"material is on {material.device}, the scene on {self.device}"
            )
        cfg = self._config(res, spp)
        return RenderFunction.apply(
            material.contiguous(), self._render_data(cfg.integrator), self.camera, int(seed), cfg,
        )
