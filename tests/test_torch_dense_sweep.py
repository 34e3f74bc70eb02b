"""The direct kernels' dense sweeps at their edges, through the g++ build of
their code (kernels.load_host_library()): the compact sweep with and
without its early out (direct_step.cuh CompactSweep, each lane's own
branch), on crafted rays over a table of a few triangles: through vertices and along
the edge that two triangles share (the tie rule: the first of equal
nearest t), parallel to a triangle's plane and past it by a hair, grazing,
with u, v or u + v at 0 or 1 after rounding or one ulp past, with t at the
sweeps' t_min and t_max, reversed and degenerate. Each sweep is held bit
for bit against the port's plain accel/trace.py (dense_closest, dense_any
over mt), with its test counts, and that MT against JAX's
zdr_tpu/accel/trace.py::_moller_trumbore on every ray and row: t, u, v
within 1e-6 (1e-5 near 0) where either hits (XLA's CPU rounds the products
in another order) and the same hits wherever they agree bit for bit; then
zdr_trace_interact_host, full and lite, against the plain trace_interact
on the same rays. The plain model of the early out (accel/trace.py
early_planes, whose stages set chip_smoke.py's bound of the kernels that
take it) is held to the same sweeps: its tests are theirs, and every hit
reaches the division."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu.accel.trace import _moller_trumbore
from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel.trace import (
    dense_any,
    dense_closest,
    early_planes,
    early_stages,
    mt_rows,
)
from zdr_tpu_torch.integrators.bounce import trace_interact_plain
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

SHADOW_T_MIN = np.float32(1e-4)


def _triangles():
    """(T, 3, 3) float32 vertices: the unit square at z = 0 as two triangles
    sharing the diagonal, the first again (an exact tie), a triangle at
    z = 1 over it, one standing in the plane x = 0.5, a sliver, one
    facing the other way, and a far one at odd coordinates."""
    return np.array([
        [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
        [[0, 0, 0], [1, 1, 0], [0, 1, 0]],
        [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
        [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
        [[0.5, -1, -1], [0.5, 2, -1], [0.5, 0.5, 2]],
        [[0.25, 0.25, 0.5], [0.75, 0.25 + 1e-6, 0.5], [0.5, 0.25 + 2e-6, 0.5]],
        [[0, 0, 2], [0, 1, 2], [1, 0, 2]],
        [[0.1, 0.3, 3.7], [1.3, 0.2, 3.1], [0.7, 1.9, 3.3]],
    ], np.float32)


def _rows(tris):
    """(T, 12) float32 geometry rows p0, e1, e2 and three zeros."""
    rows = np.zeros((tris.shape[0], 12), np.float32)
    rows[:, 0:3] = tris[:, 0]
    rows[:, 3:6] = tris[:, 1] - tris[:, 0]
    rows[:, 6:9] = tris[:, 2] - tris[:, 0]
    return rows


def _ray_families():
    """(N, 3) origins and directions: each family of the module's
    docstring."""
    up = np.float32(1.0)

    def nxt(x, step):
        """x one ulp towards x + step; 0 by 2^-30 (XLA's CPU flushes
        subnormals, which would change JAX's result, not the sweeps')."""
        if not step:
            return np.float32(x)
        if x == 0.0:
            return np.float32(step * 2.0**-30)
        return np.nextafter(np.float32(x), np.float32(x + step))

    pts, dirs = [], []
    # vertices, edges and the shared diagonal of the square, exactly and
    # one ulp inside and outside, from below and from above (a < 0)
    coords = [0.0, 0.125, 0.25, 0.5, 0.75, 1.0]
    for x in coords:
        for y in coords:
            for dx, dy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)):
                px, py = nxt(x, dx), nxt(y, dy)
                pts.append((px, py, -1.0))
                dirs.append((0.0, 0.0, up))
                pts.append((px, py, 3.0))
                dirs.append((0.0, 0.0, -up))
    # parallel to the square's plane, in it and a hair off it; a direction
    # whose z makes |a| straddle 1e-12
    for z in (0.0, 1e-7, -1e-7, 1e-13):
        for dz in (0.0, 1e-12, 1.0000001e-12, 9.999999e-13, -1e-12, 1e-30):
            pts.append((-1.0, 0.4, z))
            dirs.append((1.0, 0.1, dz))
    # grazing: nearly parallel, crossing the square's plane inside it
    for k in range(1, 9):
        eps = np.float32(10.0 ** -k)
        pts.append((-0.5, 0.3, -eps * 0.5))
        dirs.append((1.0, 0.2, eps))
    # along and across the standing triangle's plane x = 0.5
    for y in (-1.0, 0.0, 0.5, 2.0):
        pts.append((0.5, y, -2.0))
        dirs.append((0.0, 0.0, 1.0))
        pts.append((-1.0, y, 0.5))
        dirs.append((1.0, 0.0, 0.0))
    # the sliver edge-on and through it
    pts += [(0.5, 0.25, 0.0), (0.3, 0.2500005, 1.0)]
    dirs += [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0)]
    # degenerate and non-finite rays
    pts += [(0.5, 0.5, -1.0), (0.5, 0.5, -1.0), (1e30, 0.5, -1.0), (0.5, 0.5, -1.0)]
    dirs += [(0.0, 0.0, 0.0), (0.0, 0.0, 1e-30), (-1.0, 0.0, 0.0), (np.nan, 0.0, 1.0)]
    # random rays from around the table into it
    rs = np.random.RandomState(5)
    o = rs.uniform(-1.5, 2.5, (64, 3))
    d = rs.uniform(-0.2, 1.2, (64, 3)) - o
    pts += [tuple(x) for x in o]
    dirs += [tuple(x) for x in d]
    # rays at the vertices and edges of the triangles at odd coordinates,
    # from random origins: their computed u, v and u + v scatter by a few
    # ulps around 0 and 1, where 1/a rounds
    tris = _triangles()[4:]
    s_t = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5], [0.25, 0.75]],
                   np.float32)
    for tri in tris:
        target = tri[0] + s_t[:, :1] * (tri[1] - tri[0]) + s_t[:, 1:] * (tri[2] - tri[0])
        for _rep in range(24):
            o = target + rs.uniform(-3.0, 3.0, target.shape).astype(np.float32)
            pts += [tuple(x) for x in o]
            dirs += [tuple(x) for x in (target - o)]
    return np.array(pts, np.float32), np.array(dirs, np.float32)


def _rays(t_max_kind):
    """(N, 3) origins and directions, (N,) t_max: each family of
    _ray_families; t_max 1e30, or the ray's own nearest hit's t as the
    plain sweep computes it (1 for a miss) and its float neighbours, so
    that the hit sits at t_max."""
    o, d = _ray_families()
    t_max = np.full(len(o), 1e30, np.float32)
    if t_max_kind != "far":
        tt = lambda x: tuple(torch.as_tensor(c) for c in x.T)  # noqa: E731
        (t0, prim, _u, _v), _w = dense_closest(torch.as_tensor(_rows(_triangles())), tt(o),
                                               tt(d), torch.zeros(len(o)),
                                               torch.as_tensor(t_max))
        t0 = np.where(prim.numpy() >= 0, t0.numpy(), np.float32(1.0)).astype(np.float32)
        step = {"at": t0, "below": np.nextafter(t0, np.float32(-np.inf)),
                "above": np.nextafter(t0, np.float32(np.inf))}
        t_max = step[t_max_kind].astype(np.float32)
    return o, d, t_max


def _shift_origin_to_t_min(o, d):
    """Origins moved back along the ray so that the square's plane lies
    at t = 1e-4 (or a rounding off it): the shadow sweep's t_min."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(d[:, 2] != 0, -o[:, 2] / d[:, 2], 0.0).astype(np.float32)
    t0 = np.where(np.isfinite(t0), t0, np.float32(0.0))
    shift = (t0 - SHADOW_T_MIN)[:, None]
    return (o + shift * d).astype(np.float32)


def _host_sweep(rows, o, d, t_max, any_hit, early):
    """zdr_sweep_host: CompactSweep<false>, or with `early` <true> -> (t, u,
    v (3, N), prim or occlusion, tests)."""
    lib = kernels.load_host_library()
    n = o.shape[0]
    rays = torch.as_tensor(np.ascontiguousarray(np.concatenate([o.T, d.T, t_max[None]]),
                                                np.float32))
    f_out = torch.zeros((3, n))
    i_out = torch.zeros((n,), dtype=torch.int32)
    counts = torch.zeros((1,), dtype=torch.int64)
    table = torch.as_tensor(rows)
    assert lib.zdr_sweep_host(table.data_ptr(), rows.shape[0], rays.data_ptr(), n,
                              int(any_hit), int(early), f_out.data_ptr(), i_out.data_ptr(),
                              counts.data_ptr()) == 0
    return f_out, i_out, int(counts[0])


def _jax(rows, o, d, t_min, t_max):
    """JAX's Möller–Trumbore of every ray against every row -> (t, u, v,
    valid) as (N, T) numpy arrays."""
    p0, e1, e2 = (jnp.asarray(rows[None, :, k:k + 3]) for k in (0, 3, 6))
    out = _moller_trumbore(jnp.asarray(o[:, None]), jnp.asarray(d[:, None]), p0, e1, e2,
                           jnp.asarray(t_min[:, None]), jnp.asarray(t_max[:, None]))
    return tuple(np.asarray(x) for x in out)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_jax_mt(rows, o, d, t_min, t_max):
    """JAX's Möller–Trumbore against the port's (accel/trace.py mt, whose
    operand order the sweeps keep) on every ray and row: t, u, v within
    rtol 1e-6 and atol 1e-5 (a u or v near 0 is a difference of terms near
    1) where either finds a hit at t in (t_min, t_max) (XLA's CPU rounds
    the cross and dot products in another order, so some pairs differ in
    their last bits), and the same hit wherever the three agree bit for
    bit, as nearly all do."""
    jt, ju, jv, valid = _jax(rows, o, d, t_min, t_max)
    ok, u, v, t = mt_rows(torch.as_tensor(rows), tuple(torch.as_tensor(c) for c in o.T),
                          tuple(torch.as_tensor(c) for c in d.T))
    t, u, v = t.numpy(), u.numpy(), v.numpy()
    hit = ok.numpy() & (t > t_min[:, None]) & (t < t_max[:, None])
    same = np.ones(hit.shape, bool)
    for got, want in ((jt, t), (ju, u), (jv, v)):
        np.testing.assert_allclose(got[hit | valid], want[hit | valid], rtol=1e-6, atol=1e-5)
        same &= (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert np.array_equal(valid[same], hit[same])
    assert same.mean() > 0.9  # 0.932 of the pairs measured


@pytest.mark.parametrize("early", [False, True], ids=["compact", "early"])
@pytest.mark.parametrize("t_max_kind", ["far", "at", "below", "above"])
def test_closest_sweep_at_its_edges(early, t_max_kind):
    """The closest sweep at t in (0, t_max): hit, t, u, v bit for bit and
    the tests equal to the plain dense_closest's, whose MT is JAX's
    (_assert_jax_mt)."""
    rows = _rows(_triangles())
    o, d, t_max = _rays(t_max_kind)
    f_out, prim, tests = _host_sweep(rows, o, d, t_max, False, early)
    tt = lambda x: tuple(torch.as_tensor(c) for c in x.T)  # noqa: E731
    (t, p, u, v), (p_tests, _v) = dense_closest(
        torch.as_tensor(rows), tt(o), tt(d), torch.zeros(len(o)), torch.as_tensor(t_max))
    assert torch.equal(prim, p)
    for got, want in ((f_out[0], t), (f_out[1], u), (f_out[2], v)):
        assert np.array_equal(_bits(got), _bits(want))
    assert tests == int(p_tests) == len(o) * rows.shape[0]
    _assert_jax_mt(rows, o, d, np.zeros(len(o), np.float32), t_max)
    # the crafted rays reach both sides of the edges they aim at; with t_max
    # at or below a ray's nearest t, nothing is hit
    hits = int((prim >= 0).sum())
    assert (0 < hits < len(o)) if t_max_kind in ("far", "above") else hits == 0


@pytest.mark.parametrize("early", [False, True], ids=["compact", "early"])
@pytest.mark.parametrize("t_max_kind", ["far", "at", "below", "above"])
@pytest.mark.parametrize("at_t_min", [False, True], ids=["t", "t_min"])
def test_shadow_sweep_at_its_edges(early, t_max_kind, at_t_min):
    """The shadow sweep at t in (1e-4, dist), stopping at its first hit:
    the occlusion and the tests (each ray's up to and including its first
    hit) equal to the plain dense_any's, whose MT is JAX's (_assert_jax_mt);
    with at_t_min the square's plane lies at t = 1e-4 of each ray."""
    rows = _rows(_triangles())
    o, d, t_max = _rays(t_max_kind)
    if at_t_min:
        o = _shift_origin_to_t_min(o, d)
    _f, occ, tests = _host_sweep(rows, o, d, t_max, True, early)
    tt = lambda x: tuple(torch.as_tensor(c) for c in x.T)  # noqa: E731
    t_min = np.full(len(o), SHADOW_T_MIN, np.float32)
    p_occ, (p_tests, _v) = dense_any(torch.as_tensor(rows), tt(o), tt(d),
                                     torch.as_tensor(t_min), torch.as_tensor(t_max))
    assert torch.equal(occ != 0, p_occ)
    assert tests == int(p_tests)
    _assert_jax_mt(rows, o, d, t_min, t_max)
    hits = int(occ.sum())
    if t_max_kind in ("far", "above"):
        assert 0 < hits < len(o)
    else:  # no hit below the ray's nearest t (t_max is the unmoved ray's)
        assert hits < len(o) if at_t_min else hits == 0


@pytest.mark.parametrize("t_max_kind", ["far", "at", "below", "above"])
@pytest.mark.parametrize("sweep", ["closest", "shadow", "shadow_t_min"])
def test_early_out_stages_at_the_edges(sweep, t_max_kind):
    """The plain model of the early out (early_planes, early_stages) on the
    crafted rays: its tests are the plain sweep's, in count and per ray,
    its hits are the host build's CompactSweep's, every hit reaches the
    division, and each of the three stages ends some tests."""
    rows = _rows(_triangles())
    o, d, t_max = _rays(t_max_kind)
    any_hit = sweep != "closest"
    if sweep == "shadow_t_min":
        o = _shift_origin_to_t_min(o, d)
    tt = lambda x: tuple(torch.as_tensor(c) for c in x.T)  # noqa: E731
    table, tm = torch.as_tensor(rows), torch.as_tensor(t_max)
    (tested, hit, left1, left2), = early_planes(table, tt(o), tt(d), tm, any_hit)
    stages = early_stages(table, tt(o), tt(d), tm, any_hit)
    assert torch.equal(stages, torch.stack([(tested & left1).sum(), (tested & left2).sum(),
                                            (tested & ~left1 & ~left2).sum()]))
    assert bool((hit <= (tested & ~left1 & ~left2)).all())
    assert bool((stages > 0).all())
    _f, got, tests = _host_sweep(rows, o, d, t_max, any_hit, True)
    assert int(stages.sum()) == int(tested.sum()) == tests
    if any_hit:
        p_occ, (p_tests, _v) = dense_any(table, tt(o), tt(d),
                                         torch.full((len(o),), float(SHADOW_T_MIN)), tm)
        assert torch.equal(hit.any(1), p_occ) and torch.equal(hit.any(1), got != 0)
        assert tests == int(p_tests)
    else:
        # the last of a ray's hits is its nearest
        last = torch.where(hit.any(1), hit.shape[1] - 1 - hit.flip(1).int().argmax(1), -1)
        assert torch.equal(last.to(torch.int32), got)


@pytest.mark.parametrize("name", ["cbox", "sphere"])
def test_early_work_counts_the_kernels_tests(name):
    """chip_smoke.py's count of the early out's tests by the place they
    leave (_early_work, the plain model over the rays the plain direct
    samples sweep) on every 3rd lane of a 16x16, 4 spp render: its sum is
    the g++ build's test count on those lanes with the early out, which is
    the count without it; its tests cost fewer operations than MT_OPS."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry import procedural as proc
    from zdr_tpu_torch.integrators import path_loop as pl

    if name == "cbox":
        s = zt.Scene([(proc.make_cornell_box(), None, None),
                      (proc.make_cornell_light(), None, 15.0)], accel="bruteforce",
                     device="cpu")
        s.camera = zt.Camera(fov=0.87, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))
    else:
        s = zt.Scene([(proc.make_uv_sphere(0.5, 8, 16), None, None),
                      (proc.make_quad(size=1.0, y=-2.0), None, 40.0)], accel="bruteforce",
                     device="cpu")
        s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    mat = torch.as_tensor(np.random.RandomState(3).uniform(0.2, 0.9, (32, 32, 4))
                          .astype(np.float32))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((16, 16), 4), 0)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    stages, sub = cs._early_work(tb, lanes, mat, stride=3)
    lib = kernels.load_host_library()
    tables = kernels.direct_tables(tb)
    counts = []
    for early in (True, False):
        acc, tests = torch.empty((3, sub.shape[1])), torch.zeros((1,), dtype=torch.int64)
        assert lib.zdr_direct_host(
            kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
            mat.data_ptr(), sub.data_ptr(), None, acc.data_ptr(), None, tests.data_ptr(),
            sub.shape[1], int(early)) == 0
        counts.append(int(tests))
    assert int(stages.sum()) == counts[0] == counts[1]
    assert bool((stages > 0).all())
    assert cs.EARLY_OPS[0] < cs._test_ops(stages) < cs.MT_OPS


@pytest.mark.parametrize("lite", [False, True])
def test_trace_interact_host_at_the_edges(lite):
    """zdr_trace_interact_host (the compact sweep) on the crafted rays over
    a scene table of the same triangles against the plain trace_interact:
    ints equal, the hit's point, uv, geometric normal and emission bit for
    bit, the shading normal within 1e-6 (its normalisation rounds by an
    ulp apart in torch and in glibc)."""
    from test_torch_direct import _host_trace

    tris = _triangles()
    rows = _rows(tris)
    rs = np.random.RandomState(9)
    table = np.zeros((tris.shape[0], 31), np.float32)
    table[:, 0:9] = rows[:, 0:9]
    table[:, 9:24] = rs.uniform(-1.0, 1.0, (tris.shape[0], 15))  # uv0, duv, n0, dn
    n_g = np.cross(rows[:, 3:6], rows[:, 6:9])
    table[:, 24:27] = n_g / np.maximum(np.linalg.norm(n_g, axis=1, keepdims=True), 1e-20)
    table[[3, 6], 27:30] = 5.0  # two emitters
    table[:, 30] = rs.uniform(0.5, 2.0, tris.shape[0])  # area
    o, d, _t = _rays("far")
    n = len(o)
    pdf = np.where(np.arange(n) % 5 == 0, 1e30, 0.5).astype(np.float32)
    act = (np.arange(n) % 7 != 3).astype(np.int32)
    rays = [torch.as_tensor(np.ascontiguousarray(x)) for x in (*o.T, *d.T, pdf)] + [
        torch.as_tensor(act)]
    table = torch.as_tensor(table)
    got = _host_trace(table, rays, lite)
    want = trace_interact_plain(table, rays, lite)
    assert len(got) == len(want)
    shading_normal = () if lite else (5, 6, 7)
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy(), b.numpy()
        if a.dtype == np.int32:
            assert np.array_equal(a, b.astype(np.int32))
        elif k in shading_normal:
            np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-6)
        else:
            assert np.array_equal(np.isnan(a), np.isnan(b))
            assert np.array_equal(_bits(np.nan_to_num(a)), _bits(np.nan_to_num(b)))
