"""Accel construction from Geometry (port of zdr_tpu/accel/build.py).

Methods, by the JAX package's names:
  "bruteforce", "pallas"   the dense sweep: every ray against every
                           triangle, from the kernels' shared-memory tables;
  "bvh", "stream"          the BVH (the native binned-SAH build) in the
                           ordered walk's layout (bvh.to_child_nodes): on
                           the card the BVH is the big-mesh trace, so
                           "stream" builds it too;
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
from .bvh import NODE_COLS, to_child_nodes
from .native import build_bvh_native
from .types import GEOM_COLS, ID_COL, Accel

METHODS = ("auto", "bruteforce", "pallas", "bvh", "stream")

# accel="auto" keeps the dense shared-memory sweep for scenes of fewer
# triangles than this, a route, and walks the BVH from there: the crossover
# of the iteration (Scene.render + loss.backward(), pmj02bn, 512x512, 64 spp,
# 1024^2 material of 0.5) of chip_smoke.py phase 15, dense vs BVH, on an
# NVIDIA H100 80GB HBM3 at 700.00 W, with the ordered BVH walk at leaf 4.
# Direct (the dense kernels' compact sweep), dense / BVH ms in three runs:
# 12 triangles 10.07 / 11.67, 10.91 / 12.14 and 10.04 / 12.98; 26: 13.76 /
# 14.65, 13.70 / 14.28 and 14.41 / 14.82; 38: 15.38 / 14.54, 16.46 / 16.52
# and 17.24 / 15.53; 50: 17.54 / 15.79, 18.59 / 16.66 and 18.30 / 17.30;
# 962: 198.49 / 27.61 (the first); the times meet at 32.2, 38.4 and 28.3
# triangles by linear interpolation (33: the ceiling of their mean). Path:
# 12 triangles 33.32 / 41.93, 26: 22.48 / 21.46, 50: 31.18 / 24.74, 122:
# 56.26 / 33.09, 226: 95.41 / 36.21, 962: 691.21 / 42.45, 1850: 1306.06 /
# 46.78; they meet at 24.5.
DENSE_MAX_TRIS = {"direct": 33, "path": 25}
# the BVH's triangles a leaf at most: JAX's tree is built at 8
# (accel/bvh.LEAF_SIZE), the port's at 4, the fastest of 2, 4 and 8 for the
# four BVH kernels by studies/walk_split.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W (direct_bvh / direct_grad_bvh ms on the reference's protocol and
# on the big mesh, path_loop_bvh / path_loop_grad_bvh on the big mesh; the
# walk with a skip on pop, which measured slower and went: PERF.md):
# leaf 2 47.95 / 60.97, 25.05 / 29.06, 33.41 / 41.12; leaf 4 47.60 /
# 59.96, 23.99 / 27.98, 31.71 / 39.67; leaf 8 49.02 / 61.97, 24.68 /
# 27.99, 33.05 / 39.78.
BVH_LEAF = 4


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
            nodes=torch.zeros((0, NODE_COLS), dtype=torch.float32, device=dev),
        )
    return pack_bvh(geom, build_bvh_native(v0, v1, v2, BVH_LEAF))


def pack_bvh(geom: Geometry, b) -> Accel:
    """The "bvh" Accel of `geom` over `b`, its binary tree as
    build_bvh_native returns it, at any leaf width: the ordered walk's
    layout, built once per Scene. Raises if the tree is deeper than the
    walk's stack (to_child_nodes)."""
    cn = to_child_nodes(b)
    rows = _rows(*_vertices(geom))[cn.tri_perm]
    rows[:, ID_COL] = cn.tri_perm.view(np.float32)
    dev = geom.positions.device
    return Accel(
        method="bvh",
        geom=torch.as_tensor(rows, device=dev),
        tri_perm=torch.as_tensor(cn.tri_perm, device=dev),
        tri_inst=geom.tri_inst,
        nodes=torch.as_tensor(cn.nodes, device=dev),
        leaf_size=cn.leaf_size,
        depth=cn.depth,
    )
