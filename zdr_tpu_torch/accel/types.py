"""Accel and Hit: the intersection structure and a batch of hit records.

Port of zdr_tpu/accel/types.py. `Accel` holds tensors on one device. The
node links are int32 tensors, not float bit patterns as in JAX's packed
rows (bvh.to_stackless): an index stored in a float slot is a denormal, and
integers stay integers end to end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

GEOM_COLS = 12  # a triangle's row: p0, e1, e2 and 3 floats of padding (48 bytes)


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
    global triangle order and there are no nodes. method "bvh": the
    escape-link BVH; `geom` holds the rows in leaf order, leaf_slots a leaf
    (accel/bvh.LEAF_SIZE for build_accel's trees), padded with zero rows
    whose `tri_perm` is -1.
    """

    method: str
    geom: torch.Tensor  # (S, GEOM_COLS) float32 rows, in accel order
    tri_perm: torch.Tensor  # (S,) int32: accel slot -> global triangle id, -1 = pad
    tri_inst: torch.Tensor  # (T,) int64: instance of each global triangle id
    node_box: torch.Tensor  # (M, 6) float32: lo xyz, hi xyz, DFS preorder
    # (M, 2) int32: escape (the node after this subtree), and for a leaf its
    # first slot + 1 (0 for an internal node, whose next node is id + 1)
    node_link: torch.Tensor

    @property
    def is_bvh(self) -> bool:
        return self.method == "bvh"

    @property
    def leaf_slots(self) -> int:
        """A BVH's slots a leaf, from its shapes alone: its M nodes form a
        binary tree, whose (M + 1) / 2 leaves own the same number of the S
        slots each (build_bvh_native's layout)."""
        leaves = (self.node_box.shape[0] + 1) // 2
        slots, rem = divmod(self.geom.shape[0], leaves)
        if rem:
            raise ValueError(f"{self.geom.shape[0]} slots do not split into {leaves} leaves")
        return slots

    @property
    def num_triangles(self) -> int:
        return self.tri_inst.shape[0]
