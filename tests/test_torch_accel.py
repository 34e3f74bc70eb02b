"""The port's intersection (zdr_tpu_torch/accel, and the per-ray code of
kernels/csrc/trace.cuh built with g++) against the JAX package's
(zdr_tpu/accel): the same BVH build, and the same hits as its four trace
methods, "bruteforce", "bvh", "pallas" (B7/B8 in Pallas interpret mode) and
"stream" (B5/B6 in interpret mode), on the same rays made from a seed with
numpy.

Scenes: a uv sphere of 16 x 32 (960 triangles) and one of 32 x 50 (3100)
over a 2-triangle quad. Tolerances are stated at each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu.accel import build_accel as jax_build_accel
from zdr_tpu.accel import trace_any as jax_trace_any
from zdr_tpu.accel import trace_closest as jax_trace_closest
from zdr_tpu.accel.bvh import build_bvh as jax_build_bvh
from zdr_tpu.accel.native import build_bvh_native as jax_build_bvh_native
from zdr_tpu.geometry.mesh import build_geometry as jax_build_geometry
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere

from zdr_tpu_torch import convert, kernels
from zdr_tpu_torch.accel import Accel, build_accel, trace_any, trace_closest
from zdr_tpu_torch.accel import bvh as tbvh
from zdr_tpu_torch.accel import variants as tv
from zdr_tpu_torch.accel.build import BVH_LEAF, DENSE_MAX_TRIS
from zdr_tpu_torch.accel.types import ID_COL
from zdr_tpu_torch.accel import native as tnative
from zdr_tpu_torch.accel import trace as ttrace
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.geometry.mesh import build_geometry
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

SCENES = {"sphere960": (16, 32), "sphere3k": (32, 50)}
N_RAYS = 4096
# the JAX methods each scene is traced with: interpret-mode B5-B8 only on
# the smaller sphere, to keep the file near a minute
METHODS = {"sphere960": ("bruteforce", "bvh", "pallas", "stream"),
           "sphere3k": ("bruteforce", "bvh")}
CASES = [(s, m) for s in SCENES for m in METHODS[s]]
ROUTES = ("plain-dense", "plain-bvh", "host-dense", "host-bvh")


def _jax_geom(scene):
    lat, lon = SCENES[scene]
    return jax_build_geometry([(make_uv_sphere(0.5, lat, lon), None),
                               (make_quad(size=1.0, y=-2.0), None)])


def _port_geom(scene):
    lat, lon = SCENES[scene]
    return build_geometry([(tproc.make_uv_sphere(0.5, lat, lon), None),
                           (tproc.make_quad(size=1.0, y=-2.0), None)], "cpu")


def _vertices(geom):
    tris, pos = np.asarray(geom.triangles), np.asarray(geom.positions)
    return pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]


def _rays(seed=5):
    """Origins around the unit ball, random directions, a per-ray t_max in
    [0.5, 3) for the any-hit trace."""
    rs = np.random.RandomState(seed)
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rs.randn(N_RAYS, 3) * 0.8).astype(np.float32)
    t_max = rs.uniform(0.5, 3.0, N_RAYS).astype(np.float32)
    return o, d, t_max


_JAX = {}


def _jax_hits(scene, method):
    """JAX's closest hit (t, prim, inst, u, v) and any hit with the per-ray
    t_max, cached over the module."""
    if (scene, method) not in _JAX:
        o, d, t_max = (jnp.asarray(x) for x in _rays())
        acc = jax_build_accel(_jax_geom(scene), method)
        hit = jax_trace_closest(acc, o, d)
        occ = jax_trace_any(acc, o, d, t_min=1e-4, t_max=t_max)
        _JAX[(scene, method)] = [np.asarray(x) for x in hit] + [np.asarray(occ)]
    return _JAX[(scene, method)]


_PORT = {}


def _port_accel(scene, mode):
    if (scene, mode) not in _PORT:
        _PORT[(scene, mode)] = build_accel(_port_geom(scene), "bvh" if mode == "bvh" else
                                           "bruteforce")
    return _PORT[(scene, mode)]


def _host_trace(accel: Accel, o, d, t_min, t_max, closest: bool):
    """The g++ build of trace.cuh -> (t, prim, u, v) or occ, and the work."""
    lib = kernels.load_host_library()
    n = o.shape[0]
    t_lo = torch.full((n,), float(t_min)) if np.ndim(t_min) == 0 else torch.as_tensor(t_min)
    t_hi = torch.full((n,), float(t_max)) if np.ndim(t_max) == 0 else torch.as_tensor(t_max)
    counts = torch.zeros((2,), dtype=torch.int64)
    mode = (int(accel.is_bvh), accel.geom.data_ptr(), accel.geom.shape[0],
            accel.nodes.data_ptr() if accel.is_bvh else None, accel.nodes.shape[0])
    args = (o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr())
    if closest:
        t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
        prim = torch.empty(n, dtype=torch.int32)
        assert lib.zdr_trace_closest_host(*mode, *args, t.data_ptr(), u.data_ptr(), v.data_ptr(),
                                          prim.data_ptr(), counts.data_ptr(), n) == 0
        return (t, prim, u, v), counts
    occ = torch.empty(n, dtype=torch.int32)
    assert lib.zdr_trace_any_host(*mode, *args, occ.data_ptr(), counts.data_ptr(), n) == 0
    return occ != 0, counts


def _port_closest(route, scene):
    """The route's closest hit of _rays as JAX's Hit fields (t 1e30 and inst
    -1 on a miss)."""
    o, d, _t_max = (torch.as_tensor(x) for x in _rays())
    acc = _port_accel(scene, route.split("-")[1])
    if route.startswith("plain"):
        h = trace_closest(acc, o, d)
        return [h.t.numpy(), h.prim.numpy(), h.inst.numpy(), h.bary_u.numpy(), h.bary_v.numpy()]
    (t, prim, u, v), _work = _host_trace(acc, o, d, 0.0, 1e30, True)
    miss = prim < 0
    inst = torch.where(miss, -1, acc.tri_inst[prim.clamp(min=0).long()])
    return [torch.where(miss, 1e30, t).numpy(), prim.numpy(), inst.numpy(), u.numpy(), v.numpy()]


def _port_any(route, scene):
    o, d, t_max = (torch.as_tensor(x) for x in _rays())
    acc = _port_accel(scene, route.split("-")[1])
    if route.startswith("plain"):
        return trace_any(acc, o, d, 1e-4, t_max).numpy()
    return _host_trace(acc, o, d, 1e-4, t_max, False)[0].numpy()


# ----------------------------------------------------------------- the build


@pytest.mark.parametrize("scene", list(SCENES))
def test_bvh_build_matches_jax(scene):
    """The Python median-split build and the native binned-SAH build equal
    JAX's, array for array; build_accel("bvh") lays out JAX's binary tree
    for the ordered walk: each internal node's two child boxes are JAX's
    nodes' boxes, each leaf's rows JAX's leaf's triangles without its pads,
    in JAX's slot order, with their ids (tests/test_torch_walk.py follows
    every node)."""
    v = _vertices(_jax_geom(scene))
    for mine, theirs in ((tbvh.build_bvh(*v), jax_build_bvh(*v)),
                         (tnative.build_bvh_native(*v, BVH_LEAF),
                          jax_build_bvh_native(*v, BVH_LEAF))):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    ja = jax_build_bvh_native(*v, BVH_LEAF)
    ta = _port_accel(scene, "bvh")
    internal = ~np.asarray(ja.node_is_leaf)
    assert ta.nodes.shape[0] == int(internal.sum())
    # the root's children, and every child box among JAX's node boxes
    root = ta.nodes[0].numpy()
    for k, child in enumerate((ja.node_left[0], ja.node_right[0])):
        np.testing.assert_array_equal(root[6 * k:6 * k + 3], ja.node_lo[child])
        np.testing.assert_array_equal(root[6 * k + 3:6 * k + 6], ja.node_hi[child])
    jax_boxes = {tuple(np.concatenate([lo, hi]).tolist())
                 for lo, hi in zip(ja.node_lo[1:], ja.node_hi[1:])}
    port_boxes = {tuple(b) for b in ta.nodes[:, 0:12].reshape(-1, 6).tolist()}
    assert port_boxes == jax_boxes
    np.testing.assert_array_equal(np.sort(ta.tri_perm.numpy()), np.arange(ta.num_triangles))
    np.testing.assert_array_equal(ta.geom.view(torch.int32)[:, ID_COL].numpy(),
                                  ta.tri_perm.numpy())
    jp = jax_build_accel(_jax_geom(scene), "bvh")
    rows = np.concatenate([np.asarray(jp.p0), np.asarray(jp.e1), np.asarray(jp.e2)], axis=1)
    jperm = np.asarray(jp.tri_perm)
    by_id = dict(zip(jperm[jperm >= 0].tolist(), rows[jperm >= 0]))
    np.testing.assert_array_equal(ta.geom[:, 0:9].numpy(),
                                  np.stack([by_id[g] for g in ta.tri_perm.tolist()]))
    assert ta.geom.shape[0] == ta.num_triangles and ta.leaf_size == BVH_LEAF


@pytest.mark.parametrize("method", ["bruteforce", "bvh"])
def test_accel_from_jax_equals_the_ports_build(method):
    """convert.accel_from_jax carries JAX's Accel across: the same tables as
    the port's own build of the same tree (build_accel's, or for a BVH
    variants.leaf_accel's at JAX's leaf width, accel/bvh.LEAF_SIZE)."""
    ja = jax_build_accel(_jax_geom("sphere960"), method)
    arrays = {k: np.asarray(getattr(ja, k)) for k in ("p0", "e1", "e2", "tri_perm", "tri_inst")}
    arrays["method"] = ja.method
    if method == "bvh":
        arrays["node_packed"] = np.asarray(ja.node_packed)
    got = convert.accel_from_jax(arrays, "cpu")
    want = (tv.leaf_accel(_port_geom("sphere960"), tbvh.LEAF_SIZE) if method == "bvh"
            else _port_accel("sphere960", "dense"))
    assert got.method == want.method
    for k in ("tri_perm", "tri_inst"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    # bit for bit: the nodes' references and the rows' ids are int32 bits
    for k in ("geom", "nodes"):
        assert torch.equal(getattr(got, k).view(torch.int32), getattr(want, k).view(torch.int32)), k
    assert (got.leaf_size, got.depth) == (want.leaf_size, want.depth)
    stream = jax_build_accel(_jax_geom("sphere960"), "stream")
    with pytest.raises(ValueError, match="stream"):
        convert.accel_from_jax({**arrays, "method": stream.method}, "cpu")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's output; nothing falls
    back to the Python builder."""
    tnative.load_builder.cache_clear()
    monkeypatch.setattr(tnative, "FLAGS", tnative.FLAGS + ("-no-such-flag",))
    monkeypatch.setattr(tnative, "_library_path", lambda: str(tmp_path / "libzdr_bvh.so"))
    try:
        with pytest.raises(RuntimeError, match="BVH builder build failed"):
            tnative.build_bvh_native(*_vertices(_jax_geom("sphere960")), tbvh.LEAF_SIZE)
    finally:
        tnative.load_builder.cache_clear()


# ----------------------------------------------------------------- the hits


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scene,method", CASES)
def test_closest_matches_jax(route, scene, method):
    """Miss, prim and inst equal, and t at rtol 1e-5 / atol 1e-6 (t of a
    miss 1e30, as JAX's). u and v: against the stream route at the same
    bar; against the others at atol 5e-5, rtol 1e-5: XLA's CPU code sums
    the trailing-axis dot products of jnp.cross / jnp.sum in another order
    than x + y + z, and u = f * (s . h) with f = 1 / a amplifies that on
    grazing rays (measured up to 2.5e-5 on 4 of 717 hits of the 3k sphere;
    the streamed route's planes round as the port does, 0 difference)."""
    want = _jax_hits(scene, method)
    got = _port_closest(route, scene)
    miss = want[1] < 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    uv_atol = 1e-6 if method == "stream" else 5e-5
    for k in (3, 4):
        np.testing.assert_allclose(got[k][~miss], want[k][~miss], rtol=1e-5, atol=uv_atol)
    assert miss.any() and (~miss).sum() > N_RAYS // 10


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scene,method", CASES)
def test_any_matches_jax(route, scene, method):
    """Any hit at t in (1e-4, t_max) with a per-ray t_max: equal to JAX's
    for every ray."""
    want = _jax_hits(scene, method)[5]
    np.testing.assert_array_equal(_port_any(route, scene), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("mode", ["dense", "bvh"])
def test_host_build_matches_plain_bit_for_bit(mode):
    """The g++ build of trace.cuh and the plain version agree to the bit
    (one formula, one operand order, no FMA contraction), and count the
    same work: tests and node visits."""
    o, d, t_max = (torch.as_tensor(x) for x in _rays(seed=7))
    acc = _port_accel("sphere3k", mode)
    n = o.shape[0]
    (want, want_work) = ttrace.trace_closest_plain(acc, o, d, 0.0, 1e30)
    got, counts = _host_trace(acc, o, d, 0.0, 1e30, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [int(x) for x in want_work] == counts.tolist()
    occ, any_work = ttrace.trace_any_plain(acc, o, d, 1e-4, t_max)
    got_occ, any_counts = _host_trace(acc, o, d, 1e-4, t_max, False)
    assert torch.equal(got_occ, occ)
    assert [int(x) for x in any_work] == any_counts.tolist()
    n_tris = acc.num_triangles
    if mode == "dense":
        assert counts.tolist() == [n * n_tris, 0]
        assert any_counts[0] < n * n_tris and any_counts[1] == 0
    else:
        # the walk tests a few leaves a ray and visits far fewer nodes than
        # the tree holds
        assert 0 < counts[0] < n * n_tris // 20
        assert 0 < counts[1] < n * acc.nodes.shape[0] // 10
        assert any_counts[0] < counts[0] and any_counts[1] < counts[1]


def test_equal_nearest_hits_take_the_smallest_id():
    """Twenty copies of one quad, so that equal nearest t lie in several
    leaves: every route, and JAX's dense sweep, take the smallest global id
    (the first copy's triangle), and the walk visits more than one leaf."""
    quad = tproc.make_quad(size=1.0, y=0.0)
    geom = build_geometry([(quad, None)] * 20, "cpu")
    rs = np.random.RandomState(3)
    o = np.concatenate([rs.uniform(-0.9, 0.9, (256, 1)), np.full((256, 1), 2.0),
                        rs.uniform(-0.9, 0.9, (256, 1))], axis=1).astype(np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (256, 1))
    jg = jax_build_geometry([(make_quad(size=1.0, y=0.0), None)] * 20)
    want = np.asarray(jax_trace_closest(jax_build_accel(jg, "bruteforce"), jnp.asarray(o),
                                        jnp.asarray(d)).prim)
    assert set(want.tolist()) <= {0, 1}
    for mode in ("bruteforce", "bvh"):
        acc = build_accel(geom, mode)
        hit = trace_closest(acc, torch.as_tensor(o), torch.as_tensor(d))
        np.testing.assert_array_equal(hit.prim.numpy(), want)
        (_t, prim, _u, _v), counts = _host_trace(acc, torch.as_tensor(o), torch.as_tensor(d),
                                                 0.0, 1e30, True)
        np.testing.assert_array_equal(prim.numpy(), want)
        if mode == "bvh":
            assert counts[0] > 256 * BVH_LEAF  # several leaves a ray


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """Given CPU tensors, kernels.trace_closest and trace_any run the plain
    versions and count no launch; "auto" keeps a scene below
    DENSE_MAX_TRIS["direct"] (the cornell box) dense and builds the BVH
    from there (the 960-triangle sphere) and past shared memory; "stream"
    builds the BVH."""
    o, d, t_max = (torch.as_tensor(x[:256]) for x in _rays(seed=9))
    before = (kernels.trace_closest.launches, kernels.trace_any.launches)
    for mode in ("dense", "bvh"):
        acc = _port_accel("sphere960", mode)
        got = kernels.trace_closest(acc, o, d, 0.0, 1e30)
        want, _work = ttrace.trace_closest_plain(acc, o, d, 0.0, 1e30)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(kernels.trace_any(acc, o, d, 1e-4, t_max),
                           ttrace.trace_any_plain(acc, o, d, 1e-4, t_max)[0])
    assert (kernels.trace_closest.launches, kernels.trace_any.launches) == before
    geom = _port_geom("sphere960")
    box = build_geometry([(tproc.make_cornell_box(), None)], "cpu")
    assert 12 < DENSE_MAX_TRIS["direct"] <= 960
    assert build_accel(box, "auto").method == "bruteforce"
    assert build_accel(geom, "auto").is_bvh
    assert build_accel(geom, "stream").is_bvh
    big = build_geometry([(tproc.make_uv_sphere(0.5, 40, 100), None)], "cpu")
    assert build_accel(big, "auto").is_bvh
    with pytest.raises(ValueError, match="accel method"):
        build_accel(geom, "octree")
