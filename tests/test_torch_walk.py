"""The ordered BVH walk of the port (accel/bvh.to_child_nodes' layout, the
plain walk of accel/trace.py and its g++ build, kernels/csrc/trace.cuh)
against the JAX package's tree and traces, at the leaf widths the kernels
are measured at.

Scene: the reference's protocol sphere (16 x 32, 960 triangles) over a
2-triangle quad; 2048 rays made from a seed with numpy. The port's own
comparisons are exact: the walk's hits do not depend on its visit order,
and the plain walk and the g++ build run the same formulas in the same
operand order. Against JAX the hit triangle and the occlusion are equal,
and t, u, v are held at tests/test_torch_accel.py's bars (XLA sums the dot
products in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu.accel import build_accel as jax_build_accel
from zdr_tpu.accel import trace_any as jax_trace_any
from zdr_tpu.accel import trace_closest as jax_trace_closest
from zdr_tpu.accel.bvh import BVHArrays as JaxBVHArrays
from zdr_tpu.accel.bvh import to_stackless as jax_to_stackless
from zdr_tpu.accel.native import build_bvh_native as jax_build_bvh_native
from zdr_tpu.geometry.mesh import build_geometry as jax_build_geometry
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere

from zdr_tpu_torch import convert, kernels
from zdr_tpu_torch.accel import build_accel
from zdr_tpu_torch.accel import bvh as tbvh
from zdr_tpu_torch.accel import trace as ttrace
from zdr_tpu_torch.accel import variants as tv
from zdr_tpu_torch.accel.build import _rows, _vertices, pack_bvh
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.geometry.mesh import build_geometry
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
import zdr_tpu_torch as zt

LEAVES = (2, 4, 8)
N_RAYS = 2048


def _jax_geom():
    return jax_build_geometry([(make_uv_sphere(0.5, 16, 32), None),
                               (make_quad(size=1.0, y=-2.0), None)])


def _port_geom():
    return build_geometry([(tproc.make_uv_sphere(0.5, 16, 32), None),
                           (tproc.make_quad(size=1.0, y=-2.0), None)], "cpu")


def _rays(seed=21):
    """Origins around the unit ball, random directions, a per-ray t_max in
    [0.5, 3) for the any-hit trace."""
    rs = np.random.RandomState(seed)
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rs.randn(N_RAYS, 3) * 0.8).astype(np.float32)
    return o, d, rs.uniform(0.5, 3.0, N_RAYS).astype(np.float32)


@pytest.fixture(scope="module")
def jax_hits():
    """JAX's closest hit (prim, t, u, v) and any hit at the per-ray t_max,
    by its escape-link BVH and by its dense sweep."""
    o, d, t_max = (jnp.asarray(x) for x in _rays())
    out = {}
    for method in ("bvh", "bruteforce"):
        acc = jax_build_accel(_jax_geom(), method)
        hit = jax_trace_closest(acc, o, d)
        occ = jax_trace_any(acc, o, d, t_min=1e-4, t_max=t_max)
        out[method] = (np.asarray(hit.prim), np.asarray(hit.t), np.asarray(hit.bary_u),
                       np.asarray(hit.bary_v), np.asarray(occ))
    return out


def _host_walk(acc, o, d, t_min, t_max, closest):
    """The g++ build of trace.cuh's walk -> (outputs as the plain walk's,
    [tests, visits])."""
    lib = kernels.load_host_library()
    n = o.shape[0]
    t_lo, t_hi = torch.full((n,), t_min), t_max.contiguous()
    counts = torch.zeros((2,), dtype=torch.int64)
    nodes, geom, m, rows = kernels.bvh_args(acc, torch.device("cpu"))
    args = (1, geom, rows, nodes, m, o.data_ptr(), d.data_ptr(), t_lo.data_ptr(),
            t_hi.data_ptr())
    if closest:
        t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
        prim = torch.empty(n, dtype=torch.int32)
        assert lib.zdr_trace_closest_host(*args, t.data_ptr(), u.data_ptr(), v.data_ptr(),
                                          prim.data_ptr(), counts.data_ptr(), n) == 0
        return (t, prim, u, v), counts.tolist()
    occ = torch.empty(n, dtype=torch.int32)
    assert lib.zdr_trace_any_host(*args, occ.data_ptr(), counts.data_ptr(), n) == 0
    return occ != 0, counts.tolist()


@pytest.mark.parametrize("leaf", LEAVES)
def test_layout_follows_jax_tree(leaf):
    """Walking the port's nodes from the root beside JAX's binary tree of the
    same leaf width: each internal node's two child boxes are JAX's
    children's boxes, an internal child's reference leads to the row of
    JAX's internal node, and a leaf child's (first, count) to JAX's leaf's
    triangles without its pads, in slot order, with JAX's geometry and
    their ids in column 9."""
    v = [np.asarray(x) for x in _jax_vertices()]
    jb = jax_build_bvh_native(*v, leaf)
    acc = tv.leaf_accel(_port_geom(), leaf)
    nodes = acc.nodes.numpy()
    refs = acc.node_refs.numpy()
    rows = acc.geom.numpy()
    assert nodes.shape[0] == int((~jb.node_is_leaf).sum()) and acc.leaf_size == leaf
    seen, leaves = 0, 0
    stack = [(0, 0)]
    while stack:
        row, old = stack.pop()
        seen += 1
        for k, child in enumerate((jb.node_left[old], jb.node_right[old])):
            np.testing.assert_array_equal(nodes[row, 6 * k:6 * k + 3], jb.node_lo[child])
            np.testing.assert_array_equal(nodes[row, 6 * k + 3:6 * k + 6], jb.node_hi[child])
            ref = int(refs[row, k])
            if not jb.node_is_leaf[child]:
                assert ref >= 0
                stack.append((ref, int(child)))
                continue
            e = ~ref
            first, count = e >> tbvh.COUNT_BITS, (e & ((1 << tbvh.COUNT_BITS) - 1)) + 1
            slots = jb.tri_perm[jb.node_left[child]:jb.node_left[child] + leaf]
            np.testing.assert_array_equal(acc.tri_perm[first:first + count].numpy(),
                                          slots[slots >= 0])
            np.testing.assert_array_equal(acc.geom.view(torch.int32)[first:first + count, 9].numpy(),
                                          slots[slots >= 0])
            want = np.concatenate([v[0], v[1] - v[0], v[2] - v[0]], axis=1)[slots[slots >= 0]]
            np.testing.assert_array_equal(rows[first:first + count, 0:9], want)
            leaves += 1
    assert seen == nodes.shape[0] and leaves == int(jb.node_is_leaf.sum())


def _jax_vertices():
    g = _jax_geom()
    tris, pos = np.asarray(g.triangles), np.asarray(g.positions)
    return pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]


@pytest.mark.parametrize("leaf", LEAVES)
def test_walk_matches_jax(jax_hits, leaf):
    """The plain ordered walk and its g++ build against JAX's trace_closest
    and trace_any by its BVH (escape links, leaf 8) and by its dense sweep:
    prim and the occlusion equal for every ray, t at rtol 1e-5 / atol 1e-6
    and u, v at rtol 1e-5 / atol 5e-5 (test_torch_accel.py's bars and
    reason); the plain walk and its g++ build equal bit for bit, with equal
    counts of tests and visits."""
    o, d, t_max = (torch.as_tensor(x) for x in _rays())
    acc = tv.leaf_accel(_port_geom(), leaf)
    (t, prim, u, v), work = ttrace.trace_closest_plain(acc, o, d, 0.0, 1e30)
    occ, any_work = ttrace.trace_any_plain(acc, o, d, 1e-4, t_max)
    host, counts = _host_walk(acc, o, d, 0.0, torch.full_like(t_max, 1e30), True)
    host_occ, any_counts = _host_walk(acc, o, d, 1e-4, t_max, False)
    assert all(torch.equal(a, b) for a, b in zip(host, (t, prim, u, v)))
    assert torch.equal(host_occ, occ)
    assert counts == [int(x) for x in work] and any_counts == [int(x) for x in any_work]
    miss = prim < 0
    t = torch.where(miss, 1e30, t)
    for method in ("bvh", "bruteforce"):
        jprim, jt, ju, jv, jocc = jax_hits[method]
        np.testing.assert_array_equal(prim.numpy(), jprim)
        np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-6)
        hit = ~miss.numpy()
        np.testing.assert_allclose(u.numpy()[hit], ju[hit], rtol=1e-5, atol=5e-5)
        np.testing.assert_allclose(v.numpy()[hit], jv[hit], rtol=1e-5, atol=5e-5)
        np.testing.assert_array_equal(occ.numpy(), jocc)
    assert miss.any() and not miss.all() and occ.any() and not occ.all()
    # near child first: fewer visits than the tree has rows, a few leaves
    assert 0 < work[1] < N_RAYS * acc.nodes.shape[0] // 20


def _caterpillar(depth):
    """A binary tree whose right spine has `depth` internal nodes, each with
    a leaf of one triangle on its left (and two at the bottom), over
    depth + 1 triangles in a row -> (geometry, tree)."""
    quads = [(tproc.make_quad(size=0.1, y=0.0), None)] * ((depth + 2) // 2)
    geom = build_geometry(quads, "cpu")
    n_tris = depth + 1
    m = 2 * depth + 1
    lo, hi = np.zeros((m, 3), np.float32), np.ones((m, 3), np.float32)
    left, right = np.zeros(m, np.int32), np.zeros(m, np.int32)
    is_leaf = np.zeros(m, bool)
    for k in range(depth):  # internal node 2k: left leaf 2k + 1, right 2k + 2
        left[2 * k], right[2 * k] = 2 * k + 1, 2 * k + 2
        is_leaf[2 * k + 1] = True
        left[2 * k + 1], right[2 * k + 1] = k, 1
    is_leaf[m - 1] = True
    left[m - 1], right[m - 1] = depth, 1
    perm = np.arange(n_tris, dtype=np.int32)
    return geom, tbvh.BVHArrays(lo, hi, left, right, is_leaf, perm)


def test_a_tree_deeper_than_the_stack_raises():
    """pack_bvh takes a tree of MAX_DEPTH internal nodes on a path (the
    walk's stack, trace.cuh kStackDepth) and raises on one deeper: nothing
    overflows or falls back."""
    geom, tree = _caterpillar(tbvh.MAX_DEPTH)
    acc = pack_bvh(geom, tree)
    assert acc.nodes.shape[0] == tbvh.MAX_DEPTH
    geom, tree = _caterpillar(tbvh.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="deep"):
        pack_bvh(geom, tree)


def test_a_deep_jax_tree_raises_on_conversion():
    """convert.accel_from_jax lays a JAX tree out as pack_bvh does: a tree
    of MAX_DEPTH internal nodes on a path converts to pack_bvh's layout of
    it, and one deeper raises (accel/bvh.to_child_nodes), so that no Accel
    of the ordered layout is deeper than the walk's stack."""
    for depth in (tbvh.MAX_DEPTH, tbvh.MAX_DEPTH + 1):
        geom, tree = _caterpillar(depth)
        rows = _rows(*_vertices(geom))[tree.tri_perm]
        arrays = {"p0": rows[:, 0:3], "e1": rows[:, 3:6], "e2": rows[:, 6:9],
                  "tri_perm": tree.tri_perm, "tri_inst": geom.tri_inst.numpy(),
                  "method": "bvh",
                  "node_packed": jax_to_stackless(JaxBVHArrays(*tree)).node_packed}
        if depth > tbvh.MAX_DEPTH:
            with pytest.raises(ValueError, match="deep"):
                convert.accel_from_jax(arrays, "cpu")
            continue
        got, want = convert.accel_from_jax(arrays, "cpu"), pack_bvh(geom, tree)
        assert got.depth == want.depth == depth
        for k in ("geom", "nodes"):
            assert torch.equal(getattr(got, k).view(torch.int32),
                               getattr(want, k).view(torch.int32)), k


def test_a_tree_of_one_leaf_walks_its_rows():
    """A scene no larger than a leaf (the cornell box's 10 triangles at leaf
    16) has no internal node: the walk tests the root's leaf, plain and g++
    alike, and finds the dense sweep's hits."""
    geom = build_geometry([(tproc.make_cornell_box(), None)], "cpu")
    acc = tv.leaf_accel(geom, 16)
    assert acc.nodes.shape[0] == 0 and acc.geom.shape[0] == 10
    o, d, t_max = (torch.as_tensor(x[:256]) for x in _rays(seed=4))
    o = o * 2.0
    dense = build_accel(geom, "bruteforce")
    want, _w = ttrace.trace_closest_plain(dense, o, d, 0.0, 1e30)
    got, work = ttrace.trace_closest_plain(acc, o, d, 0.0, 1e30)
    host, counts = _host_walk(acc, o, d, 0.0, torch.full((256,), 1e30), True)
    assert (want[1] >= 0).any()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(host, want))
    assert counts == [int(x) for x in work] == [256 * 10, 0]


@pytest.mark.parametrize("leaf", [2, 8])
def test_host_build_of_the_direct_bvh_kernels_at_leaf_widths(leaf):
    """The g++ build of direct_bvh / direct_grad_bvh (zdr_direct_bvh_host)
    through trees of leaf 2 and 8 against the plain direct render and
    backward on the protocol scene, 8x8, 4 spp, roughness in [0.5, 0.9],
    at the bars of tests/test_torch_direct.py's host test: the
    render within mean abs diff 1e-6 and 99% of values within 1e-5
    (glibc's sinf and torch's differ by ulps), the gradient within
    max|a - b| / max|a| < 1e-5; the tap mode's radiance equal to the
    forward's; the walk tests a small share of the triangles."""
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 16, 32), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)],
                 integrator="direct", accel="bvh", device="cpu")
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    cfg = s._config((8, 8), 4)
    tb = pl.build_loop_tables(s._render_data("direct"), s.camera, cfg, 5)
    tb = dataclasses.replace(tb, bvh=tv.leaf_accel(s._data.geom, leaf))
    lanes = pl.pixel_lanes(cfg.res, cfg.spp, "cpu")
    rs = np.random.RandomState(leaf)
    mat = rs.uniform(0.1, 0.9, (16, 16, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.5, 0.9, (16, 16))
    mat = torch.as_tensor(mat)
    le = torch.as_tensor(rs.rand(3, lanes.shape[1]).astype(np.float32))
    lib = kernels.load_host_library()
    tables, params = kernels.pack_tables(tb), kernels.loop_params(tb, mat)
    n = lanes.shape[1]
    out = {}
    for name, adj in (("fwd", None), ("grad", le)):
        acc, grad = torch.empty((3, n)), torch.zeros_like(mat)
        counts = torch.zeros((2,), dtype=torch.int64)
        assert lib.zdr_direct_bvh_host(
            params, tables.data_ptr(), tables.numel(), 1, tb.bn.data_ptr(), mat.data_ptr(),
            lanes.data_ptr(), None if adj is None else adj.data_ptr(), acc.data_ptr(),
            None if adj is None else grad.data_ptr(), *kernels.bvh_args(tb.bvh, torch.device("cpu")),
            counts.data_ptr(), n) == 0
        out[name] = (acc, grad, counts.tolist())
    want = dr.render_direct_plain(tb, lanes, mat)
    want_g, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    diff = (out["fwd"][0] - want).abs()
    assert float(diff.mean()) <= 1e-6 and float((diff <= 1e-5).float().mean()) >= 0.99
    assert torch.equal(out["grad"][0], out["fwd"][0])
    got_g = out["grad"][1]
    assert float(want_g.abs().max()) > 0
    assert float((got_g - want_g).abs().max() / want_g.abs().max()) < 1e-5
    tests, visits = out["fwd"][2]
    assert 0 < tests < n * tb.spp * 3 * s._data.meta.num_tris // 20 and visits > 0
