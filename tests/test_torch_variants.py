"""The sweep variants (zdr_tpu_torch/accel/woop.py, accel/variants.py and the
per-ray code of kernels/csrc/sweep_variants.cuh built with g++) against the
JAX package's Woop tables and Woop sweep (pallas_bounce.py build_woop_pack,
fused_trace_interact with woop= in Pallas interpret mode) and against the
port's own dense sweep, on the reference protocol's scene: a uv sphere of
16 x 32 (960 triangles) over a 2-triangle quad light. Rays are made from a
seed with numpy. Tolerances are stated at each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere
from zdr_tpu.integrators.pallas_bounce import (
    LANES,
    build_fused_const,
    build_woop_pack,
    fused_trace_interact,
    planes_rows,
)

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel import build_accel
from zdr_tpu_torch.accel import trace as ttrace
from zdr_tpu_torch.accel import variants as tv
from zdr_tpu_torch.accel.build import BVH_LEAF
from zdr_tpu_torch.accel.woop import tile_boxes, woop_rows
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators.bounce import trace_interact_plain
from zdr_tpu_torch.integrators.scene_tables import scene_table
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

CAM = dict(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
N_RAYS = 2048
# the hit modes each ray set is traced with: closest hit on the primaries and
# the bounce rays, any hit on the shadow rays (whose origins lie on the
# surface, where only a t_min keeps a ray off its own triangle) and the
# bounce rays
SET_MODES = {"primary": ("closest",), "bounce": ("closest", "any"), "shadow": ("any",)}


@pytest.fixture(scope="module")
def port():
    """The port's scene, its tables and the three ray sets of 512 rays."""
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 16, 32), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], device="cpu")
    s.camera = zt.Camera(**CAM)
    table = scene_table(s._data)
    geom = build_accel(s._data.geom, "bruteforce").geom
    prim = tv.primary_rays(s, res=(32, 16))
    rays = {"primary": prim, "bounce": tv.bounce_rays(512, "cpu"),
            "shadow": tv.shadow_rays(geom, table, prim)}
    return dict(scene=s, table=table, geom=geom, woop=woop_rows(geom), rays=rays)


@pytest.fixture(scope="module")
def jax_pack():
    s = Scene([(make_uv_sphere(0.5, 16, 32), None, None),
               (make_quad(size=1.0, y=-2.0), None, 40.0)], integrator="direct")
    s.camera = Camera(fov=CAM["fov"], origin=float3(*CAM["origin"]),
                      target=float3(*CAM["target"]))
    scene_pack, _ = build_fused_const(s._data, s._data.fused_meta)
    return scene_pack, s._data.fused_meta.num_tris


def _equal(got, want):
    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _host(port, rays, mode, tile=512, woop=False, cull=False):
    """The g++ build of sweep_variants.cuh -> (outputs, [tests, box tests])."""
    lib = kernels.load_host_library()
    r, act = rays
    n = r.shape[1]
    rows = port["woop"] if woop else port["geom"]
    boxes = tile_boxes(port["geom"], tile)
    n_f, n_i = kernels._VARIANT_PLANES[mode]
    f_out, i_out = torch.empty((n_f, n)), torch.empty((n_i, n), dtype=torch.int32)
    counts = torch.zeros((2,), dtype=torch.int64)
    assert lib.zdr_sweep_variant_host(
        tv.MODES.index(mode), tile, int(woop), int(cull), rows.data_ptr(),
        port["geom"].data_ptr(), port["table"].data_ptr(), boxes.data_ptr(), rows.shape[0],
        r.data_ptr(), act.data_ptr(), f_out.data_ptr(), i_out.data_ptr(), counts.data_ptr(),
        n) == 0
    return kernels.variant_outputs(mode, f_out, i_out), counts.tolist()


# ------------------------------------------------------------- the tables


def test_woop_rows_and_boxes_match_jax(port, jax_pack):
    """accel/woop.py against build_woop_pack on the protocol's scene: the 12
    Woop rows at rtol 1e-6 (atol 1e-6 of the row's largest value: the
    translation column -m.p0 sums three products and cancels to ~0 on some
    rows), and the tile boxes of tiles 128, 256 and 512 equal."""
    scene_pack, n_tris = jax_pack
    assert port["geom"].shape[0] == n_tris == 962
    gat = np.asarray(build_woop_pack(scene_pack)[0])
    want = gat[0:12, :n_tris].T
    got = port["woop"].numpy()
    scale = np.abs(want).reshape(n_tris, 3, 4).max(axis=2).repeat(4, axis=1)
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-6 * scale)
    for tile in (128, 256, 512):
        boxes = np.asarray(build_woop_pack(scene_pack, tile=tile)[1])
        mine = tile_boxes(port["geom"], tile).numpy()
        np.testing.assert_array_equal(mine, boxes[:mine.shape[0], 0:6])


# --------------------------------------------------------- the plain sweeps


@pytest.mark.parametrize("mode", tv.MODES)
def test_sweep_variant_plain_equals_the_dense_sweep(port, mode):
    """sweep_variant_plain is the port's dense sweep bit for bit:
    trace_closest / trace_any's plain versions, and trace_interact_plain for
    the epilogue modes, on every ray set."""
    for name, (rays, act) in port["rays"].items():
        got, work = tv.sweep_variant_plain(port["geom"], port["table"], rays, act, mode)
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        acc = build_accel(port["scene"]._data.geom, "bruteforce")
        if mode == "closest":
            want, want_work = ttrace.trace_closest_plain(acc, o, d, 0.0, rays[7])
        elif mode == "any":
            want, want_work = ttrace.trace_any_plain(acc, o, d, 1e-4, rays[7])
        else:
            want = trace_interact_plain(port["table"], (*rays[0:7], act), lite=mode == "lite")
            want_work = (rays.shape[1] * 962, 0)
        assert _equal(got, want), name
        assert [int(x) for x in work] == [int(x) for x in want_work]


@pytest.mark.parametrize("woop", [False, True])
@pytest.mark.parametrize("tile", [128, 256, 512])
def test_aabb_sweep_plain_equals_the_unculled_sweep(port, tile, woop):
    """The culled sweep finds the unculled sweep's hits bit for bit, closest
    (t, prim, u, v) and any, MT or Woop, with fewer ray-triangle tests on the
    coherent rays and one box test a tile for each open ray."""
    for name, (rays, act) in port["rays"].items():
        for mode in SET_MODES[name]:
            rows = port["woop"] if woop else port["geom"]
            got, (tests, boxes) = tv.aabb_sweep_plain(rows, port["geom"],
                                                      tile_boxes(port["geom"], tile), tile,
                                                      rays, act, mode, woop)
            if woop:
                want, (want_tests, _b) = tv.woop_sweep_plain(port["woop"], port["geom"],
                                                             port["table"], rays, act, mode)
            else:
                want, (want_tests, _b) = tv.sweep_variant_plain(port["geom"], port["table"],
                                                                rays, act, mode)
            assert _equal(got, want), (name, mode)
            assert 0 < int(tests) <= int(want_tests)
            if mode == "closest":
                assert int(boxes) == rays.shape[1] * -(-962 // tile)
            if name != "bounce":
                assert int(tests) < int(want_tests)


def test_woop_sweep_plain_against_mt(port):
    """The Woop sweep re-derives its winner by Möller–Trumbore: where it
    picks the MT sweep's triangle, t, u and v are equal bit for bit; it
    picks another triangle (a near-coplanar winner flip, ROADMAP) on at
    most 1 ray in 500 of each set (measured: 0 of 512 primaries, 0 of 512
    bounce rays). The occlusion differs only on rays whose first hit lies
    within 1e-5 of t_max, relatively: the shadow rays end on a point of the
    light, which the two tests place on either side of t_max by an ulp
    (measured: 23 of 512 shadow rays, 0 bounce rays)."""
    g, t, w = port["geom"], port["table"], port["woop"]
    for name, (rays, act) in port["rays"].items():
        for mode in SET_MODES[name]:
            got, _w = tv.woop_sweep_plain(w, g, t, rays, act, mode)
            want, _w = tv.sweep_variant_plain(g, t, rays, act, mode)
            if mode == "any":
                near, far = rays.clone(), rays.clone()
                near[7] *= 1.0 - 1e-5
                far[7] *= 1.0 + 1e-5
                edge = (tv.sweep_variant_plain(g, t, near, act, "any")[0]
                        != tv.sweep_variant_plain(g, t, far, act, "any")[0])
                assert not bool(((got != want) & ~edge).any()), name
                continue
            same = got[1] == want[1]
            assert int((~same).sum()) <= rays.shape[1] // 500, name
            for k in (0, 2, 3):
                assert torch.equal(got[k][same], want[k][same]), name


def test_woop_sweep_plain_matches_jax_woop_kernel(port, jax_pack):
    """woop_sweep_plain with the re-derive and the full epilogue against
    fused_trace_interact(woop=build_woop_pack(...)) in interpret mode on
    tests/test_stream.py's rays (one JAX block: 16384 rays from seed 3):
    floats at rtol 1e-5, atol 1e-6, shade and miss equal, except on rays
    whose winner flips between JAX's (bf16x3-free, "highest") dot order and
    the port's: at most 1 in 1000 (measured: 0)."""
    scene_pack, n_tris = jax_pack
    rows = planes_rows(N_RAYS)
    n = rows * LANES
    rs = np.random.RandomState(3)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rs.randn(n, 3).astype(np.float32) * 0.8
    big = np.full((n,), 1e30, np.float32)
    act = np.ones((n,), np.int32)
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], big]
    jrays = [jnp.asarray(x.reshape(rows, LANES)) for x in planes] + \
        [jnp.asarray(act.reshape(rows, LANES))]
    want = [np.asarray(x).reshape(-1) for x in fused_trace_interact(
        scene_pack, n_tris, jrays, interpret=True, woop=build_woop_pack(scene_pack))]
    rays = torch.as_tensor(np.stack(planes + [big]))
    got, _w = tv.woop_sweep_plain(port["woop"], port["geom"], port["table"], rays,
                                  torch.as_tensor(act), "interact")
    got = [x.numpy() for x in got]
    bad = np.zeros((n,), bool)
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype == np.int32:
            bad |= a != b
        else:
            bad |= ~np.isclose(a, b, rtol=1e-5, atol=1e-6)
    assert int(bad.sum()) <= n // 1000
    assert (want[15] == 0).any() and (want[15] == 1).any()


# ------------------------------------------------------------ the g++ build


def _assert_same(got, want, mode, what):
    """Closest and any hit bit for bit; the epilogue modes as
    tests/test_torch_direct.py holds the host trace_interact: ints equal,
    floats within atol 1e-6 (the shading normal's normalisation rounds an
    ulp apart between g++ and torch on some rays)."""
    if mode in ("closest", "any"):
        assert _equal(got, want), what
        return
    for a, b in zip(got, want):
        if a.dtype == torch.int32:
            assert torch.equal(a, b), what
        else:
            torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6, msg=what)


@pytest.mark.parametrize("mode", tv.MODES)
def test_host_build_of_the_variants_matches_plain(port, mode):
    """The g++ build of the kernels' per-ray code against the plain versions
    with equal counts: sweep_variant at kTile 128 and 1024 (the tile changes
    nothing), woop_sweep, and aabb_sweep at kTile 128, MT and Woop (its
    warps of 32 rays skip the same tiles); closest and any hit bit for bit,
    the epilogues at _assert_same's bar."""
    g, t = port["geom"], port["table"]
    for name, rays in port["rays"].items():
        if mode in ("closest", "any") and mode not in SET_MODES[name]:
            continue
        want, work = tv.sweep_variant_plain(g, t, *rays, mode)
        for tile in (128, 1024):
            got, counts = _host(port, rays, mode, tile)
            _assert_same(got, want, mode, (name, tile))
            assert counts == [int(x) for x in work]
        want, work = tv.woop_sweep_plain(port["woop"], g, t, *rays, mode)
        got, counts = _host(port, rays, mode, woop=True)
        _assert_same(got, want, mode, name)
        assert counts == [int(x) for x in work]
        if mode in ("closest", "any"):
            for woop in (False, True):
                rows = port["woop"] if woop else g
                want, work = tv.aabb_sweep_plain(rows, g, tile_boxes(g, 128), 128, *rays, mode,
                                                 woop)
                got, counts = _host(port, rays, mode, 128, woop, cull=True)
                _assert_same(got, want, mode, (name, woop))
                assert counts == [int(x) for x in work]


def test_wrappers_run_the_plain_versions_on_cpu_tensors(port):
    """Given CPU tensors the four wrappers run their plain versions and
    count no launch; a mode the culled sweep does not run raises."""
    names = ("sweep_variant", "woop_sweep", "aabb_sweep", "floor_probe")
    before = [getattr(kernels, k).launches for k in names]
    rays, act = port["rays"]["bounce"]
    g, t, w = port["geom"], port["table"], port["woop"]
    assert _equal(kernels.sweep_variant(g, t, rays, act, "lite", 128, 4),
                  tv.sweep_variant_plain(g, t, rays, act, "lite")[0])
    assert _equal(kernels.woop_sweep(w, g, t, rays, act, "closest"),
                  tv.woop_sweep_plain(w, g, t, rays, act, "closest")[0])
    boxes = tile_boxes(g, 256)
    assert _equal(kernels.aabb_sweep(g, g, boxes, 256, rays, act, "any"),
                  tv.aabb_sweep_plain(g, g, boxes, 256, rays, act, "any")[0])
    assert torch.equal(kernels.floor_probe(rays[0], rays[1]), rays[0] + rays[1])
    assert [getattr(kernels, k).launches for k in names] == before
    with pytest.raises(ValueError, match="closest or any"):
        tv.aabb_sweep_plain(g, g, boxes, 256, rays, act, "interact")


# -------------------------------------------------------------- leaf widths


def _host_walk(acc, o, d, t_min, t_max, closest):
    """The g++ build of trace.cuh's walk at the tree's leaf width ->
    (outputs as the plain walk's, [tests, visits])."""
    lib = kernels.load_host_library()
    n = o.shape[0]
    t_lo, t_hi = torch.full((n,), t_min), t_max.contiguous()
    counts = torch.zeros((2,), dtype=torch.int64)
    nodes, geom, m, rows = kernels.bvh_args(acc, torch.device("cpu"))
    mode = (1, geom, rows, nodes, m, o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr())
    if closest:
        t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
        prim = torch.empty(n, dtype=torch.int32)
        assert lib.zdr_trace_closest_host(*mode, t.data_ptr(), u.data_ptr(), v.data_ptr(),
                                          prim.data_ptr(), counts.data_ptr(), n) == 0
        return (t, prim, u, v), counts.tolist()
    occ = torch.empty(n, dtype=torch.int32)
    assert lib.zdr_trace_any_host(*mode, occ.data_ptr(), counts.data_ptr(), n) == 0
    return occ != 0, counts.tolist()


@pytest.mark.parametrize("leaf", [2, 4, 8, 16])
def test_leaf_width_trees_walk_to_the_dense_hits(port, leaf):
    """The leaf-width measurement's trees (variants.leaf_accel): the walk
    reads each leaf's count from its reference, and the plain walk and its
    g++ build find the dense sweep's hits bit for bit on every ray set, with
    equal counts; at BVH_LEAF the tree is build_accel's."""
    geom = port["scene"]._data.geom
    acc = tv.leaf_accel(geom, leaf)
    assert acc.leaf_size == leaf
    if leaf == BVH_LEAF:
        prod = build_accel(geom, "bvh")
        assert torch.equal(acc.tri_perm, prod.tri_perm)
        for k in ("geom", "nodes"):  # bit for bit: they hold int32 bits
            assert torch.equal(getattr(acc, k).view(torch.int32), getattr(prod, k).view(torch.int32))
    for name, (rays, act) in port["rays"].items():
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        for mode in SET_MODES[name]:
            want, _w = tv.sweep_variant_plain(port["geom"], port["table"], rays, act, mode)
            if mode == "closest":
                got, work = ttrace.trace_closest_plain(acc, o, d, 0.0, rays[7])
            else:
                got, work = ttrace.trace_any_plain(acc, o, d, 1e-4, rays[7])
            assert _equal(got, want), (name, mode)
            host, counts = _host_walk(acc, o, d, 0.0 if mode == "closest" else 1e-4, rays[7],
                                      mode == "closest")
            assert _equal(host, got), (name, mode)
            assert counts == [int(x) for x in work]


# ------------------------------------------------------------------ routing


def test_auto_routes_by_the_measured_crossover():
    """accel="auto" keeps the dense sweep below accel/build.DENSE_MAX_TRIS of
    the render's integrator, while the tables fit shared memory, and takes
    the BVH from there: Scene._render_data and build_accel read the one
    constant."""
    from zdr_tpu_torch.accel.build import DENSE_MAX_TRIS, dense_route

    for integrator, limit in DENSE_MAX_TRIS.items():
        assert dense_route(max(limit - 1, 0), 0, integrator) == (limit > 0)
        assert not dense_route(limit, 0, integrator)
        assert not dense_route(1, 10**6, integrator)  # past shared memory
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 16, 32), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], device="cpu")
    for integrator in ("direct", "path"):
        dense = 962 < DENSE_MAX_TRIS[integrator]
        assert (s._render_data(integrator).accel is None) == dense
    geom = s._data.geom
    assert build_accel(geom, "auto").is_bvh == (962 >= DENSE_MAX_TRIS["direct"])
