"""Parameters and scene state carried across from the JAX package.

The JAX package hands its arrays over as numpy (`np.asarray` of its
`SceneData` fields and of a material); these build the port's tensors on a
given device. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.types import GEOM_COLS, Accel
from .geometry.mesh import geometry_from_numpy
from .scenedata import LightMeta, SceneData

GEOMETRY_KEYS = (
    "positions", "uvs", "normals", "triangles", "tri_inst",
    "inst_tri_offset", "inst_tri_count",
)


def material_from_numpy(mat, device) -> torch.Tensor:
    """(H, W, 4) material -> contiguous float32 tensor on `device`."""
    mat = np.asarray(mat)
    if mat.ndim != 3 or mat.shape[2] != 4:
        raise ValueError(f"material must be (H, W, 4), got {mat.shape}")
    return torch.as_tensor(np.array(mat, np.float32, order="C"), device=device)


def material_to_numpy(mat: torch.Tensor) -> np.ndarray:
    return mat.detach().to("cpu", torch.float32).numpy()


def scene_from_numpy(arrays: dict, meta, device) -> SceneData:
    """SceneData from host arrays and light metadata.

    Args:
        arrays: GEOMETRY_KEYS plus "emission" (I, 3), "point_pos" (P, 3),
            "point_intensity" (P, 3) and "point_count" (); point lights past
            point_count are ignored.
        meta: an object or dict with FusedMeta's fields (n_lights,
            light_tri_ids, light_offsets, light_tcs, num_tris, n_env,
            n_point).
        device: torch device of the tensors.
    """
    def field(k):
        return meta[k] if isinstance(meta, dict) else getattr(meta, k)

    if int(field("n_env")) != 0:
        raise NotImplementedError("envmap: ROADMAP A11")
    n_point = int(arrays["point_count"])
    light_meta = LightMeta(
        n_lights=int(field("n_lights")),
        light_tri_ids=tuple(int(x) for x in field("light_tri_ids")),
        light_offsets=tuple(int(x) for x in field("light_offsets")),
        light_tcs=tuple(int(x) for x in field("light_tcs")),
        num_tris=int(field("num_tris")),
        n_env=0,
        n_point=n_point,
    )
    if int(field("n_point")) != n_point:
        raise ValueError("meta.n_point disagrees with point_count")

    def f32(k):
        return torch.as_tensor(np.array(arrays[k], np.float32).reshape(-1, 3), device=device)

    return SceneData(
        geom=geometry_from_numpy({k: arrays[k] for k in GEOMETRY_KEYS}, device),
        emission=f32("emission"),
        meta=light_meta,
        point_pos=f32("point_pos")[:n_point],
        point_intensity=f32("point_intensity")[:n_point],
    )


def scene_to_numpy(data: SceneData):
    """The inverse of scene_from_numpy -> (arrays, meta dict)."""
    g = data.geom
    arrays = {k: getattr(g, k).cpu().numpy() for k in GEOMETRY_KEYS}
    arrays["emission"] = data.emission.cpu().numpy()
    arrays["point_pos"] = data.point_pos.cpu().numpy()
    arrays["point_intensity"] = data.point_intensity.cpu().numpy()
    arrays["point_count"] = np.asarray(data.meta.n_point, np.int32)
    m = data.meta
    meta = dict(
        n_lights=m.n_lights, light_tri_ids=m.light_tri_ids,
        light_offsets=m.light_offsets, light_tcs=m.light_tcs,
        num_tris=m.num_tris, n_env=m.n_env, n_point=m.n_point,
    )
    return arrays, meta


def accel_from_jax(arrays: dict, device) -> Accel:
    """The port's Accel from the numpy arrays of a JAX Accel: "p0", "e1",
    "e2" (S, 3), "tri_perm" (S,), "tri_inst" (T,), "method", and for
    method "bvh" its "node_packed" (M, 8) rows, whose escape and leaf slots
    hold int32 bits in float32 (zdr_tpu/accel/bvh.py::to_stackless)."""
    method = str(arrays["method"])
    if method not in ("bruteforce", "pallas", "bvh"):
        raise ValueError(f"no port Accel for a JAX {method!r} accel (no tree to carry)")
    rows = np.zeros((np.asarray(arrays["p0"]).shape[0], GEOM_COLS), np.float32)
    for k, name in enumerate(("p0", "e1", "e2")):
        rows[:, 3 * k:3 * k + 3] = np.asarray(arrays[name], np.float32)
    if method == "bvh":
        packed = np.ascontiguousarray(np.asarray(arrays["node_packed"], np.float32))
        box, link = packed[:, 0:6], packed[:, 6:8].view(np.int32)
    else:
        box, link = np.zeros((0, 6), np.float32), np.zeros((0, 2), np.int32)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    return Accel(method=method, geom=t(rows, np.float32),
                 tri_perm=t(arrays["tri_perm"], np.int32), tri_inst=t(arrays["tri_inst"], np.int64),
                 node_box=t(box, np.float32), node_link=t(link, np.int32))
