"""Host-side BVH construction (numpy); a copy of zdr_tpu/accel/bvh.py.

Replaces the reference's external OptiX BVH (luisa.Accel, render.py:74,109).
Build runs once per scene on host; the output is a flat node array plus a
triangle permutation. The port traverses it with the escape-link walk of
accel/trace.py (plain version) and kernels/csrc/trace.cuh (the kernels).
The packed node rows of `to_stackless` keep JAX's layout, links as float
bit patterns; accel/build.py splits them into float boxes and int32 links.

Design (from the TPU traversal, kept so that both packages build one tree):
  * Fixed leaf size LEAF: every leaf owns exactly LEAF consecutive slots in
    the reordered triangle array (padded with degenerate triangles). Leaf
    processing is then a fixed-shape gather + LEAF Möller–Trumbore tests per
    lane per step — no data-dependent shapes anywhere.
  * Median split on the largest centroid axis (cheap, balanced); SAH binning
    can slot in later without changing the traversal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 8
MAX_STACK = 64


class BVHArrays(NamedTuple):
    node_lo: np.ndarray  # (M, 3) float32
    node_hi: np.ndarray  # (M, 3) float32
    node_left: np.ndarray  # (M,) int32: internal -> left child; leaf -> tri start
    node_right: np.ndarray  # (M,) int32: internal -> right child; leaf -> tri count
    node_is_leaf: np.ndarray  # (M,) bool
    tri_perm: np.ndarray  # (T_padded,) int32 into original triangle ids; -1 = pad


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = LEAF_SIZE) -> BVHArrays:
    """Build a BVH over triangles given their world-space vertices (T,3) each."""
    T = v0.shape[0]
    tri_lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroids = (tri_lo + tri_hi) * 0.5

    node_lo, node_hi = [], []
    node_left, node_right, node_is_leaf = [], [], []
    tri_perm: list = []

    def new_node():
        node_lo.append(np.zeros(3, np.float32))
        node_hi.append(np.zeros(3, np.float32))
        node_left.append(0)
        node_right.append(0)
        node_is_leaf.append(False)
        return len(node_lo) - 1

    # iterative build with an explicit stack of (node_id, tri index array)
    root = new_node()
    stack = [(root, np.arange(T, dtype=np.int64))]
    while stack:
        nid, idx = stack.pop()
        lo = tri_lo[idx].min(axis=0)
        hi = tri_hi[idx].max(axis=0)
        node_lo[nid] = lo
        node_hi[nid] = hi
        if len(idx) <= leaf_size:
            start = len(tri_perm)
            tri_perm.extend(idx.tolist())
            tri_perm.extend([-1] * (leaf_size - len(idx)))
            node_left[nid] = start
            node_right[nid] = leaf_size
            node_is_leaf[nid] = True
            continue
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        li, ri = idx[order[:half]], idx[order[half:]]
        lchild, rchild = new_node(), new_node()
        node_left[nid] = lchild
        node_right[nid] = rchild
        node_is_leaf[nid] = False
        stack.append((rchild, ri))
        stack.append((lchild, li))

    return BVHArrays(
        node_lo=np.stack(node_lo).astype(np.float32),
        node_hi=np.stack(node_hi).astype(np.float32),
        node_left=np.array(node_left, dtype=np.int32),
        node_right=np.array(node_right, dtype=np.int32),
        node_is_leaf=np.array(node_is_leaf, dtype=bool),
        tri_perm=np.array(tri_perm, dtype=np.int32),
    )


class StacklessArrays(NamedTuple):
    """Escape-link (threaded) BVH for the stackless TPU traversal.

    Nodes are reordered to DFS preorder (left child first), so the "hit"
    successor of an internal node is implicitly node+1 and the "miss" /
    after-leaf successor is the escape link. One packed (M, 8) f32 row per
    node keeps a node visit to a single row-gather on TPU:
        [lo.xyz, hi.xyz, bitcast(escape), bitcast(is_leaf ? tri_start+1 : 0)]
    """

    node_packed: np.ndarray  # (M, 8) float32
    tri_perm: np.ndarray  # same as BVHArrays.tri_perm


def to_stackless(b: BVHArrays) -> StacklessArrays:
    """Reorder any BVHArrays into DFS preorder and thread escape links."""
    m = b.node_lo.shape[0]
    order = np.empty(m, np.int32)  # new id -> old id
    nxt = 0
    stack = [0]
    while stack:  # DFS preorder, left child first
        old = stack.pop()
        order[nxt] = old
        nxt += 1
        if not b.node_is_leaf[old]:
            stack.append(int(b.node_right[old]))
            stack.append(int(b.node_left[old]))
    old2new = np.empty(m, np.int32)
    old2new[order] = np.arange(m, dtype=np.int32)
    # preorder => each subtree occupies a contiguous id range; a reverse
    # sweep accumulates subtree sizes, and escape = id just past my subtree
    size = np.ones(m, np.int64)
    for new in range(m - 1, -1, -1):
        old = order[new]
        if not b.node_is_leaf[old]:
            size[new] = (
                1 + size[old2new[b.node_left[old]]] + size[old2new[b.node_right[old]]]
            )
    escape = np.arange(m, dtype=np.int64) + size
    packed = np.zeros((m, 8), np.float32)
    packed[:, 0:3] = b.node_lo[order]
    packed[:, 3:6] = b.node_hi[order]
    packed[:, 6] = escape.astype(np.int32).view(np.float32)
    leafw = np.where(
        b.node_is_leaf[order], b.node_left[order].astype(np.int32) + 1, 0
    ).astype(np.int32)
    packed[:, 7] = leafw.view(np.float32)
    return StacklessArrays(node_packed=packed, tri_perm=b.tri_perm)
