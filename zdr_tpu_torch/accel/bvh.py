"""Host-side BVH construction (numpy); a copy of zdr_tpu/accel/bvh.py.

Replaces the reference's external OptiX BVH (luisa.Accel, render.py:74,109).
Build runs once per scene on host; the output is a flat node array plus a
triangle permutation, the same binary tree as JAX's. The port does not
walk it as JAX does (its escape-link threading, to_stackless): it derives
the child-box layout of `to_child_nodes`, which the ordered walk of
accel/trace.py (plain version) and kernels/csrc/trace.cuh (the kernels)
traverse, near child first, the far child on a short stack.

Design (from the TPU traversal, kept so that both packages build one tree):
  * Fixed leaf size LEAF: every leaf owns exactly LEAF consecutive slots in
    the reordered triangle array (padded with -1). The TPU's leaf step was
    then a fixed-shape gather; to_child_nodes drops the pads, and a leaf
    keeps its first row and its count.
  * Median split on the largest centroid axis (cheap, balanced); the native
    builder (native.py) splits by binned SAH.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 8


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


# the deepest tree the ordered walk takes: internal nodes on a root-to-leaf
# path, each of which may push one entry on the walk's stack
# (kernels/csrc/trace.cuh kStackDepth); JAX's ordered walk's MAX_STACK
MAX_DEPTH = 64
# a leaf child's reference: ~(first row << COUNT_BITS | count - 1), so a
# leaf holds 1 to 2**COUNT_BITS rows (trace.cuh kCountBits)
COUNT_BITS = 4
NODE_COLS = 16


class ChildNodes(NamedTuple):
    """The ordered walk's layout of a binary BVH: internal nodes only, each a
    row of NODE_COLS float32 that holds both children (Aila and Laine,
    "Understanding the efficiency of ray traversal on GPUs", HPG 2009), so
    that one visit is four 16-byte loads and tests both child boxes:
        [lo0 xyz, hi0 xyz, lo1 xyz, hi1 xyz, bits(ref0), bits(ref1), 0, 0]
    A child's reference is its row (>= 0) when it is internal, and
    ~(first << COUNT_BITS | count - 1) when it is a leaf of `count` rows of
    the leaf-ordered triangles from `first`. Rows are numbered in DFS
    preorder, left child first, and leaves' triangles in the same order, so
    a subtree's rows and triangles are contiguous. A tree whose root is a
    leaf has no rows: its triangles are the root's one leaf."""

    nodes: np.ndarray  # (M, NODE_COLS) float32
    tri_perm: np.ndarray  # (S,) int32: leaf-ordered slot -> global id, no pads
    depth: int  # the most internal nodes on a root-to-leaf path
    leaf_size: int  # the build's slots a leaf, the most rows a leaf holds


def leaf_ref(first, count):
    """A leaf child's reference (works on numpy arrays too)."""
    return ~((first << COUNT_BITS) | (count - 1))


def to_child_nodes(b: BVHArrays) -> ChildNodes:
    """Derive the ordered walk's layout from a binary tree as build_bvh and
    build_bvh_native return it (any node order, leaves padded with -1).
    Raises if the tree is deeper than the walk's stack (MAX_DEPTH): every
    Accel of this layout comes through here."""
    m = b.node_lo.shape[0]
    leaf = b.node_is_leaf
    leaf_size = int(b.node_right[leaf].max())
    if leaf_size > 1 << COUNT_BITS:
        raise ValueError(f"leaves of {leaf_size} slots pass the {1 << COUNT_BITS} a leaf "
                         f"reference holds")
    new_id = np.full(m, -1, np.int64)
    first = np.zeros(m, np.int64)
    count = np.zeros(m, np.int64)
    order, perm = [], []
    depth = 0
    stack = [(0, 0)]
    while stack:  # DFS preorder, left child first
        old, d = stack.pop()
        if leaf[old]:
            slots = b.tri_perm[b.node_left[old]:b.node_left[old] + b.node_right[old]]
            real = slots[slots >= 0]
            if real.size == 0:
                raise ValueError(f"leaf {old} holds no triangle")
            first[old], count[old] = len(perm), real.size
            perm.extend(real.tolist())
            continue
        new_id[old] = len(order)
        order.append(old)
        depth = max(depth, d + 1)
        stack.append((int(b.node_right[old]), d + 1))
        stack.append((int(b.node_left[old]), d + 1))
    if depth > MAX_DEPTH:
        raise ValueError(f"the BVH is {depth} internal nodes deep; the walk's stack holds "
                         f"{MAX_DEPTH} (accel/bvh.MAX_DEPTH, trace.cuh kStackDepth)")
    order = np.asarray(order, np.int64)
    nodes = np.zeros((order.size, NODE_COLS), np.float32)
    refs = np.where(leaf, leaf_ref(first, count), new_id).astype(np.int32)
    for k, child in enumerate((b.node_left[order], b.node_right[order])):
        nodes[:, 6 * k:6 * k + 3] = b.node_lo[child]
        nodes[:, 6 * k + 3:6 * k + 6] = b.node_hi[child]
        nodes[:, 12 + k] = refs[child].view(np.float32)
    return ChildNodes(nodes=nodes, tri_perm=np.asarray(perm, np.int32), depth=depth,
                      leaf_size=leaf_size)
