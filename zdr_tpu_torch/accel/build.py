"""Accel construction from Geometry (port of zdr_tpu/accel/build.py).

Methods, by the JAX package's names:
  "bruteforce", "pallas"   the dense sweep: every ray against every
                           triangle, from the kernels' shared-memory tables;
  "bvh", "stream"          the escape-link BVH (the native binned-SAH
                           build): on the card the BVH is the big-mesh
                           trace, so "stream" builds it too;
  "auto"                   dense below DENSE_MAX_TRIS["direct"] triangles
                           while the direct kernels hold the triangle rows
                           in shared memory (kernels.check_table_fits), else
                           the BVH. A Scene decides "auto" per render
                           instead, with its integrator and its lights
                           (scene.py), by the same rule (dense_route).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.mesh import Geometry
from ..integrators.scene_tables import SCENE_COLS
from .bvh import LEAF_SIZE, to_stackless
from .native import build_bvh_native
from .types import GEOM_COLS, Accel

METHODS = ("auto", "bruteforce", "pallas", "bvh", "stream")

# accel="auto" keeps the dense shared-memory sweep for scenes of fewer
# triangles than this, a route, and walks the BVH from there: the crossover
# of the iteration (Scene.render + loss.backward(), pmj02bn, 512x512, 64 spp,
# 1024^2 material of 0.5) of chip_smoke.py phase 15, dense vs BVH, on an
# NVIDIA H100 80GB HBM3 at 700.00 W. Direct, dense / BVH ms: 12 triangles
# 13.86 / 16.22, 26: 18.47 / 21.44, 50: 23.00 / 24.20, 122: 40.24 / 30.65,
# 226: 66.28 / 34.50, 962: 250.06 / 48.74, 4762: 2246.91 / 63.71. Path: 12
# triangles 51.29 / 62.31, 26: 29.06 / 35.38, 50: 39.91 / 45.27, 122: 72.07
# / 54.55, 226: 119.17 / 62.42, 962: 1184.84 / 79.96, 1850: 2245.45 / 88.23.
# The times meet between 50 and 122 triangles: at 58 (direct) and 67 (path)
# by linear interpolation.
DENSE_MAX_TRIS = {"direct": 58, "path": 67}


def dense_route(n_tris: int, n_floats: int, integrator: str) -> bool:
    """Whether accel="auto" sweeps a scene of n_tris triangles (n_floats of
    tables) densely for `integrator`'s kernels: below its DENSE_MAX_TRIS
    and while the tables fit their shared memory."""
    return n_tris < DENSE_MAX_TRIS[integrator] and fits_shared_memory(n_tris, n_floats,
                                                                      integrator)


def fits_shared_memory(n_tris: int, n_floats: int, integrator: str) -> bool:
    """Whether the kernels of `integrator` hold n_floats of tables, of which
    n_tris triangle rows, in shared memory."""
    from ..kernels import check_table_fits

    try:
        check_table_fits(n_tris, n_floats, integrator)
    except NotImplementedError:
        return False
    return True


def _rows(v0, v1, v2) -> np.ndarray:
    """(T, GEOM_COLS) float32 rows p0, e1, e2, 0, 0, 0; edges rounded as the
    scene table's (scene_tables.scene_table) are."""
    rows = np.zeros((v0.shape[0], GEOM_COLS), np.float32)
    rows[:, 0:3] = v0
    rows[:, 3:6] = v1 - v0
    rows[:, 6:9] = v2 - v0
    return rows


def _vertices(geom: Geometry):
    """The corners v0, v1, v2 of every triangle, (T, 3) float32 numpy."""
    tris = geom.triangles.cpu().numpy()
    pos = geom.positions.cpu().numpy().astype(np.float32)
    return pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]


def build_accel(geom: Geometry, method: str = "auto") -> Accel:
    """Build an intersection structure for `geom`, on its device.
    Hit.prim is always a global triangle id: `tri_perm` maps the accel's
    slots to them."""
    if method not in METHODS:
        raise ValueError(f"unknown accel method {method!r}")
    dev = geom.positions.device
    v0, v1, v2 = _vertices(geom)
    n = v0.shape[0]
    if method == "auto":
        method = "bruteforce" if dense_route(n, n * SCENE_COLS, "direct") else "bvh"
    if method == "stream":
        method = "bvh"

    if method in ("bruteforce", "pallas"):
        return Accel(
            method=method,
            geom=torch.as_tensor(_rows(v0, v1, v2), device=dev),
            tri_perm=torch.arange(n, dtype=torch.int32, device=dev),
            tri_inst=geom.tri_inst,
            node_box=torch.zeros((0, 6), dtype=torch.float32, device=dev),
            node_link=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        )
    return pack_bvh(geom, build_bvh_native(v0, v1, v2, LEAF_SIZE))


def pack_bvh(geom: Geometry, b) -> Accel:
    """The escape-link "bvh" Accel of `geom` over `b`, its tree as
    build_bvh_native returns it, at any leaf width."""
    dev = geom.positions.device
    packed = to_stackless(b).node_packed
    perm = b.tri_perm
    safe = np.maximum(perm, 0)
    rows = np.where(perm[:, None] >= 0, _rows(*_vertices(geom))[safe], 0.0).astype(np.float32)
    return Accel(
        method="bvh",
        geom=torch.as_tensor(rows, device=dev),
        tri_perm=torch.as_tensor(perm, device=dev),
        tri_inst=geom.tri_inst,
        node_box=torch.as_tensor(np.ascontiguousarray(packed[:, 0:6]), device=dev),
        node_link=torch.as_tensor(np.ascontiguousarray(packed[:, 6:8]).view(np.int32),
                                  device=dev),
    )
