"""Accel and Hit: the intersection structure and a batch of hit records.

Port of zdr_tpu/accel/types.py. `Accel` holds tensors on one device. A
BVH's nodes are rows of 16 float32 whose last four hold int32 bits (the
children's references), and a BVH's geometry rows hold their triangle's
global id as int32 bits in column 9, so that the kernels read a node and a
triangle with 16-byte loads alone. Those bits are only copied, never used in
float arithmetic (some are denormals); `node_refs` reads the references
back as integers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

GEOM_COLS = 12  # a triangle's row: p0, e1, e2 and 3 floats of padding (48 bytes)
ID_COL = 9  # a BVH's rows: the global triangle id's int32 bits (trace.cuh load_row)


class Hit(NamedTuple):
    """Batched hit record (JAX's Hit): p = (1-u-v) p0 + u p1 + v p2."""

    t: torch.Tensor  # (N,) float32; 1e30 on a miss
    prim: torch.Tensor  # (N,) int32 global triangle id; -1 on a miss
    inst: torch.Tensor  # (N,) int32 instance id; -1 on a miss
    bary_u: torch.Tensor  # (N,) float32
    bary_v: torch.Tensor  # (N,) float32

    @property
    def miss(self) -> torch.Tensor:
        return self.prim < 0


@dataclasses.dataclass(frozen=True)
class Accel:
    """Triangles ready for intersection, with the BVH where there is one.

    method "bruteforce" / "pallas": the dense sweep; `geom` holds the rows in
    global triangle order and there are no nodes. method "bvh": the BVH in
    the ordered walk's layout (bvh.to_child_nodes): `nodes` its internal
    nodes, each with both children's boxes and references, `geom` the rows
    in leaf order, no pads, each with its global id's bits in column
    ID_COL.
    """

    method: str
    geom: torch.Tensor  # (S, GEOM_COLS) float32 rows, in accel order
    tri_perm: torch.Tensor  # (S,) int32: accel slot -> global triangle id
    tri_inst: torch.Tensor  # (T,) int64: instance of each global triangle id
    # (M, NODE_COLS) float32: lo0 xyz hi0 xyz lo1 xyz hi1 xyz, the children's
    # references' int32 bits, 0, 0; DFS preorder (bvh.ChildNodes)
    nodes: torch.Tensor
    leaf_size: int = 0  # the most rows a leaf holds (0: no BVH)
    depth: int = 0  # the most internal nodes on a root-to-leaf path (bvh.MAX_DEPTH at most)

    @property
    def is_bvh(self) -> bool:
        return self.method == "bvh"

    @property
    def node_refs(self) -> torch.Tensor:
        """(M, 2) int32: each node's children's references."""
        return self.nodes.view(torch.int32)[:, 12:14]

    @property
    def num_triangles(self) -> int:
        return self.tri_inst.shape[0]
