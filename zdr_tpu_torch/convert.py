"""Parameters, scene and optimizer state carried across from the JAX package.

The JAX package hands its arrays over as numpy (`np.asarray` of its
`SceneData` fields, of a material and of optax.adam's state leaves); these
build the port's tensors on a given device, and back. Nothing here imports
the JAX package or optax.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import NODE_COLS, BVHArrays, to_child_nodes
from .accel.types import GEOM_COLS, ID_COL, Accel
from .envmap import EnvMap
from .geometry.mesh import geometry_from_numpy
from .scenedata import LightMeta, SceneData

GEOMETRY_KEYS = (
    "positions", "uvs", "normals", "triangles", "tri_inst",
    "inst_tri_offset", "inst_tri_count",
)
# the environment map's arrays (the fields of JAX's envmap.EnvMap), by key
ENV_KEYS = {"env_texture": "texture", "env_alias_prob": "alias_prob",
            "env_alias_idx": "alias_idx", "env_pdf": "pdf"}


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
            point_count are ignored. With meta's n_env 1, also the envmap's
            ENV_KEYS: "env_texture" (H, W, 4), "env_alias_prob" and
            "env_alias_idx" (256 + 256 * 512,), "env_pdf" (256 * 512,),
            the arrays of JAX's SceneData.env.
        meta: an object or dict with FusedMeta's fields (n_lights,
            light_tri_ids, light_offsets, light_tcs, num_tris, n_env,
            n_point).
        device: torch device of the tensors.
    """
    def field(k):
        return meta[k] if isinstance(meta, dict) else getattr(meta, k)

    n_env = int(field("n_env"))
    if n_env not in (0, 1):
        raise ValueError(f"a scene has 0 or 1 envmaps, not {n_env}")
    n_point = int(arrays["point_count"])
    light_meta = LightMeta(
        n_lights=int(field("n_lights")),
        light_tri_ids=tuple(int(x) for x in field("light_tri_ids")),
        light_offsets=tuple(int(x) for x in field("light_offsets")),
        light_tcs=tuple(int(x) for x in field("light_tcs")),
        num_tris=int(field("num_tris")),
        n_env=n_env,
        n_point=n_point,
    )
    if int(field("n_point")) != n_point:
        raise ValueError("meta.n_point disagrees with point_count")

    def f32(k):
        return torch.as_tensor(np.array(arrays[k], np.float32).reshape(-1, 3), device=device)

    env = None
    if n_env:
        types = {"alias_idx": np.int32}
        env = EnvMap(**{f: torch.as_tensor(np.array(arrays[k], types.get(f, np.float32)),
                                           device=device)
                        for k, f in ENV_KEYS.items()})
    return SceneData(
        geom=geometry_from_numpy({k: arrays[k] for k in GEOMETRY_KEYS}, device),
        emission=f32("emission"),
        meta=light_meta,
        point_pos=f32("point_pos")[:n_point],
        point_intensity=f32("point_intensity")[:n_point],
        env=env,
    )


def scene_to_numpy(data: SceneData):
    """The inverse of scene_from_numpy -> (arrays, meta dict)."""
    g = data.geom
    arrays = {k: getattr(g, k).cpu().numpy() for k in GEOMETRY_KEYS}
    arrays["emission"] = data.emission.cpu().numpy()
    arrays["point_pos"] = data.point_pos.cpu().numpy()
    arrays["point_intensity"] = data.point_intensity.cpu().numpy()
    arrays["point_count"] = np.asarray(data.meta.n_point, np.int32)
    if data.env is not None:
        for k, f in ENV_KEYS.items():
            arrays[k] = getattr(data.env, f).cpu().numpy()
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
    hold int32 bits in float32 (zdr_tpu/accel/bvh.py::to_stackless). The
    escape-link tree is read back as the binary tree it threads and laid out
    for the ordered walk (accel/bvh.to_child_nodes), as build_accel does,
    which raises on a tree deeper than the walk's stack."""
    method = str(arrays["method"])
    if method not in ("bruteforce", "pallas", "bvh"):
        raise ValueError(f"no port Accel for a JAX {method!r} accel (no tree to carry)")
    rows = np.zeros((np.asarray(arrays["p0"]).shape[0], GEOM_COLS), np.float32)
    for k, name in enumerate(("p0", "e1", "e2")):
        rows[:, 3 * k:3 * k + 3] = np.asarray(arrays[name], np.float32)
    perm = np.asarray(arrays["tri_perm"], np.int32)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    tri_inst = t(arrays["tri_inst"], np.int64)
    if method != "bvh":
        return Accel(method=method, geom=t(rows, np.float32), tri_perm=t(perm, np.int32),
                     tri_inst=tri_inst, nodes=t(np.zeros((0, NODE_COLS)), np.float32))
    cn = to_child_nodes(_tree_of(np.asarray(arrays["node_packed"], np.float32), perm))
    by_id = np.zeros((tri_inst.shape[0], GEOM_COLS), np.float32)
    by_id[perm[perm >= 0]] = rows[perm >= 0]
    rows = by_id[cn.tri_perm]
    rows[:, ID_COL] = cn.tri_perm.view(np.float32)
    return Accel(method="bvh", geom=t(rows, np.float32), tri_perm=t(cn.tri_perm, np.int32),
                 tri_inst=tri_inst, nodes=t(cn.nodes, np.float32), leaf_size=cn.leaf_size,
                 depth=cn.depth)


def _tree_of(packed: np.ndarray, perm: np.ndarray) -> BVHArrays:
    """The binary tree that JAX's escape-link rows thread: in DFS preorder an
    internal node's left child is the next row and its right child the left
    child's escape; a leaf's slots start at its second link less 1."""
    packed = np.ascontiguousarray(packed)
    m = packed.shape[0]
    escape, leafw = packed[:, 6].view(np.int32), packed[:, 7].view(np.int32)
    is_leaf = leafw > 0
    leaf_size = perm.shape[0] // int(is_leaf.sum())
    ids = np.arange(m, dtype=np.int32)
    left = np.where(is_leaf, leafw - 1, ids + 1).astype(np.int32)
    right = np.where(is_leaf, leaf_size, escape[np.minimum(ids + 1, m - 1)]).astype(np.int32)
    return BVHArrays(node_lo=packed[:, 0:3].copy(), node_hi=packed[:, 3:6].copy(),
                     node_left=left, node_right=right, node_is_leaf=is_leaf, tri_perm=perm)


# optax.adam's state leaves in its tree order (ScaleByAdamState's count, mu,
# nu; its EmptyState has none), and torch.optim.Adam's state keys for them
ADAM_LEAVES = ("count", "mu", "nu")
ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def adam_state_from_numpy(leaves, device, step_device="cpu") -> dict:
    """optax.adam's state leaves as numpy arrays, in ADAM_LEAVES' order ->
    torch.optim.Adam's state of its one parameter: "step" a float32 scalar
    on `step_device` (the CPU, where torch keeps it unless the optimizer is
    capturable or fused), "exp_avg" and "exp_avg_sq" float32 on `device`."""
    if len(leaves) != len(ADAM_LEAVES):
        raise ValueError(f"optax.adam's state has {len(ADAM_LEAVES)} leaves "
                         f"{ADAM_LEAVES}, got {len(leaves)}")
    count, mu, nu = (np.asarray(x) for x in leaves)
    if count.shape != () or mu.shape != nu.shape:
        raise ValueError(f"adam leaves of shapes {count.shape}, {mu.shape}, {nu.shape}")
    return {
        "step": torch.tensor(float(count), dtype=torch.float32, device=step_device),
        "exp_avg": torch.as_tensor(np.array(mu, np.float32), device=device),
        "exp_avg_sq": torch.as_tensor(np.array(nu, np.float32), device=device),
    }


def adam_state_to_numpy(state: dict, like: torch.Tensor) -> list:
    """The inverse of adam_state_from_numpy -> [count int32 (), mu, nu]; an
    empty state (no step taken) is optax.adam's init: 0 and zeros like
    `like`."""
    if not state:
        zeros = np.zeros(tuple(like.shape), np.float32)
        return [np.asarray(0, np.int32), zeros, zeros.copy()]
    extra = set(state) - set(ADAM_KEYS)
    if extra:
        raise ValueError(f"no optax.adam leaf for Adam state {sorted(extra)} "
                         f"(amsgrad is not optax.adam)")
    return [np.asarray(int(state["step"]), np.int32),
            state["exp_avg"].detach().to("cpu", torch.float32).numpy(),
            state["exp_avg_sq"].detach().to("cpu", torch.float32).numpy()]
