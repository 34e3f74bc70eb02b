"""Accel construction from Geometry (port of zdr_tpu/accel/build.py).

Methods, by the JAX package's names:
  "bruteforce", "pallas"   the dense sweep: every ray against every
                           triangle, from the kernels' shared-memory tables;
  "bvh", "stream"          the escape-link BVH (the native binned-SAH
                           build): on the card the BVH is the big-mesh
                           trace, so "stream" builds it too;
  "auto"                   dense while the direct kernels hold the
                           triangle rows in shared memory
                           (kernels.check_table_fits), else the BVH. A
                           Scene decides "auto" per render instead, with
                           its integrator and its lights (scene.py).
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


def build_accel(geom: Geometry, method: str = "auto") -> Accel:
    """Build an intersection structure for `geom`, on its device.
    Hit.prim is always a global triangle id: `tri_perm` maps the accel's
    slots to them."""
    if method not in METHODS:
        raise ValueError(f"unknown accel method {method!r}")
    dev = geom.positions.device
    tris = geom.triangles.cpu().numpy()
    pos = geom.positions.cpu().numpy().astype(np.float32)
    v0, v1, v2 = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    n = tris.shape[0]
    if method == "auto":
        method = "bruteforce" if fits_shared_memory(n, n * SCENE_COLS, "direct") else "bvh"
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

    b = build_bvh_native(v0, v1, v2, LEAF_SIZE)
    packed = to_stackless(b).node_packed
    perm = b.tri_perm
    safe = np.maximum(perm, 0)
    rows = np.where(perm[:, None] >= 0, _rows(v0, v1, v2)[safe], 0.0).astype(np.float32)
    return Accel(
        method="bvh",
        geom=torch.as_tensor(rows, device=dev),
        tri_perm=torch.as_tensor(perm, device=dev),
        tri_inst=geom.tri_inst,
        node_box=torch.as_tensor(np.ascontiguousarray(packed[:, 0:6]), device=dev),
        node_link=torch.as_tensor(np.ascontiguousarray(packed[:, 6:8]).view(np.int32),
                                  device=dev),
    )
