"""ctypes bridge to the native C++ BVH builder (accel/csrc/bvh_builder.cpp).

The port's copy of zdr_tpu/accel/native.py. The library is compiled with
g++ at first use into zdr_tpu_torch/kernels/_build/ (listed in .gitignore),
named by a hash of the source and the flags, with the JAX package's flags,
so that both packages build the same binned-SAH tree. A failed build raises
with the compiler's output; nothing falls back to the Python median-split
builder (bvh.build_bvh), which stays callable by name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from .bvh import BVHArrays

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "kernels", "_build")
# zdr_tpu/accel/native.py's flags
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _library_path() -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(("g++",) + FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libzdr_bvh-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load_builder() -> ctypes.CDLL:
    """Build (if needed) and load the builder library; raise if g++ fails."""
    out = _library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"BVH builder build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    f, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.zdr_build_bvh.restype = ctypes.c_int
    lib.zdr_build_bvh.argtypes = [
        f, f, f,  # v0, v1, v2
        ctypes.c_int, ctypes.c_int,  # n_tris, leaf_size
        f, f,  # node_lo, node_hi
        i32, i32,  # node_left, node_right
        ctypes.POINTER(ctypes.c_uint8),  # node_is_leaf
        i32,  # tri_perm
        ctypes.c_int32, ctypes.c_int32,  # max_nodes, max_perm
        i32, i32,  # out_n_nodes, out_n_perm
    ]
    return lib


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int) -> BVHArrays:
    """Binned-SAH build of the (T, 3) world-space vertices; raises if the
    library cannot be built or the build fails."""
    lib = load_builder()
    n = v0.shape[0]
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    max_nodes = 4 * (n // leaf_size + 2) + 8 + 2 * n
    max_perm = 2 * n * leaf_size + 4 * leaf_size
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    node_left = np.empty(max_nodes, np.int32)
    node_right = np.empty(max_nodes, np.int32)
    node_is_leaf = np.empty(max_nodes, np.uint8)
    tri_perm = np.empty(max_perm, np.int32)
    out_nodes, out_perm = ctypes.c_int32(0), ctypes.c_int32(0)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.zdr_build_bvh(
        p(v0, ctypes.c_float), p(v1, ctypes.c_float), p(v2, ctypes.c_float), n, leaf_size,
        p(node_lo, ctypes.c_float), p(node_hi, ctypes.c_float),
        p(node_left, ctypes.c_int32), p(node_right, ctypes.c_int32),
        p(node_is_leaf, ctypes.c_uint8), p(tri_perm, ctypes.c_int32),
        max_nodes, max_perm, ctypes.byref(out_nodes), ctypes.byref(out_perm),
    )
    if rc != 0:
        raise RuntimeError(f"native BVH build of {n} triangles failed (code {rc})")
    m, k = out_nodes.value, out_perm.value
    return BVHArrays(
        node_lo=node_lo[:m].copy(),
        node_hi=node_hi[:m].copy(),
        node_left=node_left[:m].copy(),
        node_right=node_right[:m].copy(),
        node_is_leaf=node_is_leaf[:m].astype(bool),
        tri_perm=tri_perm[:k].copy(),
    )
