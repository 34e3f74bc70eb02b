"""The port's direct integrator (zdr_tpu_torch/integrators/bounce.py,
direct.py and the per-lane code of kernels/csrc/direct_step.cuh) against
the JAX package's fused direct route (integrators/direct_fused.py with
pallas_bounce.py's kernels in Pallas interpret mode), on inputs made from a
seed with numpy.

Scenes: the cornell box + ceiling light (12 triangles) and a uv sphere of
8 x 16 (224 triangles) over a quad light, both under the 256 triangles
where the JAX package sweeps triangle by triangle (pallas_bounce.py:336).
Tolerances are stated at each test; torch's and XLA's sin/cos differ by
ulps, which only the GGX sample reads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import CAM, _material, _port_camera, _port_data

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import (
    make_cornell_box,
    make_cornell_light,
    make_quad,
    make_uv_sphere,
)
from zdr_tpu.integrators import direct_fused as jdf
from zdr_tpu.integrators.pallas_bounce import (
    BLOCK_ROWS,
    LANES,
    build_fused_const,
    fused_shade,
    fused_trace_interact,
)

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.bounce import shade_plain, trace_interact_plain
from zdr_tpu_torch.integrators.scene_tables import scene_table
from zdr_tpu_torch.integrators.wrapper import RenderConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N = BLOCK_ROWS * LANES  # one block of the JAX kernels: 16384 rays
SPHERE_CAM = dict(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))


def _jax_scene(name, sampler="pmj02bn", point_light=False):
    if name == "cbox":
        s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                  integrator="direct", sampler=sampler)
        cam = CAM
    else:
        s = Scene([(make_uv_sphere(0.5, 8, 16), None, None),
                   (make_quad(size=1.0, y=-2.0), None, 40.0)],
                  integrator="direct", sampler=sampler)
        cam = SPHERE_CAM
    s.camera = Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                      target=float3(*cam["target"]))
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), 6.0)
    s.fused, s.packed_splat = "force", False
    return s


def _port_scene(name, sampler="pmj02bn", point_light=False):
    """The port's scene `name` by the dense route (JAX's fused direct
    sweeps densely; "auto" walks the BVH past DENSE_MAX_TRIS)."""
    if name == "cbox":
        s = zt.Scene([(tproc.make_cornell_box(), None, None),
                      (tproc.make_cornell_light(), None, 15.0)],
                     sampler=sampler, accel="bruteforce", device="cpu")
        s.camera = _port_camera()
    else:
        s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None),
                      (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)],
                     sampler=sampler, accel="bruteforce", device="cpu")
        s.camera = zt.Camera(**SPHERE_CAM)
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), 6.0)
    return s


def _rays(name, seed):
    """N rays: 8 float32/int32 numpy planes o3, d3, pdf_prev, active.
    Cornell box: origins inside the room; sphere: origins around it, aimed
    near its centre. A fifth of the rays carry no BSDF pdf (1e30) and a
    tenth are inactive."""
    rs = np.random.RandomState(seed)
    if name == "cbox":
        o = rs.uniform([-2.8, 0.2, -5.6], [2.3, 5.1, -0.4], (N, 3))
        d = rs.normal(size=(N, 3))
    else:
        o = rs.normal(size=(N, 3))
        o = 1.6 * o / np.linalg.norm(o, axis=1, keepdims=True)
        d = rs.uniform(-0.5, 0.5, (N, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pdf = np.where(rs.rand(N) < 0.2, 1e30, rs.uniform(0.1, 10.0, N))
    act = (rs.rand(N) > 0.1).astype(np.int32)
    f = [x.astype(np.float32) for x in (*o.T, *d.T, pdf)]
    return f + [act]


def _jax_planes(planes):
    return [jnp.asarray(p.reshape(BLOCK_ROWS, LANES)) for p in planes]


def _np(outs):
    return [np.asarray(x).reshape(-1) for x in outs]


def _assert_planes(got, want, atol, rtol=0.0):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=f"plane {k}")
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"plane {k}")


_JAX_TRACE = {}


def _jax_trace_interact(name, rays, lite=False):
    """fused_trace_interact in interpret mode over the scene `name`'s pack,
    on the planes of `rays` -> its outputs as numpy; jitted once for each
    scene and mode, so that the tests share one compilation (the eager
    call's values, bit for bit)."""
    if (name, lite) not in _JAX_TRACE:
        js = _jax_scene(name)
        meta = js._data.fused_meta
        scene_pack, _ = build_fused_const(js._data, meta)
        _JAX_TRACE[name, lite] = jax.jit(lambda planes: fused_trace_interact(
            scene_pack, meta.num_tris, planes, interpret=True, woop=None, lite=lite))
    return _np(_JAX_TRACE[name, lite](_jax_planes(rays)))


@pytest.mark.parametrize("name", ["cbox", "sphere"])
@pytest.mark.parametrize("lite", [False, True])
def test_trace_interact_plain_matches_jax_kernel(name, lite):
    """Ints equal, floats within atol 1e-5 and rtol 1e-5: the same
    arithmetic in the same order and no transcendental function, but XLA's
    CPU code rounds the sweep's products otherwise on a few grazing rays of
    the sphere (measured: t 1e-6 relative in 6 of 16384 rays, the shading
    normal up to 7.8e-6; the cornell box within 1e-6)."""
    js = _jax_scene(name)
    rays = _rays(name, 1)
    want = _jax_trace_interact(name, rays, lite)
    table = scene_table(_port_data(js))
    got = trace_interact_plain(table, [torch.as_tensor(r) for r in rays], lite)
    _assert_planes(got, want, atol=1e-5, rtol=1e-5)
    assert (want[-1] != 0).any() and (want[-1] == 0).any()  # hits and misses


def _shade_inputs(name, seed, rough_lo=0.2):
    """Shade's ray, NEE and draw planes on the hits of _rays: random
    materials, throughputs, depths 0..3, light samples and draws."""
    js = _jax_scene(name)
    meta = js._data.fused_meta
    scene_pack, _ = build_fused_const(js._data, meta)
    rays = _rays(name, seed)
    k1 = _jax_trace_interact(name, rays)
    rs = np.random.RandomState(seed + 10)
    f32 = np.float32
    mat = rs.uniform(0.1, 0.9, (4, N)).astype(f32)
    mat[3] = rs.uniform(rough_lo, 0.9, N)
    beta = rs.uniform(0.2, 1.5, (3, N)).astype(f32)
    depth = rs.randint(0, 4, N).astype(np.int32)
    ray = [*k1[0:3], *k1[5:8], *k1[8:11], *rays[3:6], k1[11], *mat, *beta, depth, *k1[12:15]]
    wl = rs.normal(size=(3, N))
    wl = (wl / np.linalg.norm(wl, axis=0)).astype(f32)
    lev = np.where(rs.rand(3, N) < 0.1, 0.0, rs.uniform(0.0, 15.0, (3, N))).astype(f32)
    nee = [*wl, rs.uniform(0.5, 6.0, N).astype(f32), rs.uniform(0.05, 20.0, N).astype(f32),
           *lev]
    draws = list(rs.rand(4, N).astype(f32))
    grad = [(rs.rand(N) > 0.1).astype(np.int32), *rs.uniform(0.0, 2.0, (3, N)).astype(f32),
            *rs.rand(3, N).astype(f32), k1[3], k1[4], rs.rand(N).astype(f32)]
    return js, scene_pack, meta, ray, nee, draws, grad


def _shade_jax(scene_pack, meta, ray, nee, draws, **kw):
    if "grad_planes" in kw:
        kw["grad_planes"] = _jax_planes(kw["grad_planes"])
    if kw.get("occ_in") is not None:
        kw["occ_in"] = _jax_planes([kw["occ_in"]])[0]
    return _np(fused_shade(scene_pack, meta.num_tris, _jax_planes(ray), _jax_planes(nee),
                           _jax_planes(draws), 2, 16, 16, 16, interpret=True, **kw))


def _shade_port(js, ray, nee, draws, **kw):
    def t(planes):
        return [torch.as_tensor(np.array(x)) for x in planes]

    if "grad" in kw:
        kw["grad"] = t(kw["grad"])
    if kw.get("occ_in") is not None:
        kw["occ_in"] = torch.as_tensor(kw["occ_in"])
    return shade_plain(scene_table(_port_data(js)), t(ray), t(nee), t(draws), 2, 16, 16, 16,
                       **kw)


# shade's float outputs, by plane: (first, last + 1, atol, rtol). Torch's
# and XLA's sin/cos differ by ulps in the VNDF sample, and at roughness 0.2
# (alpha 0.04) the lobe amplifies that: measured over both scenes, radiance
# 1.9e-5 abs / 3.3e-5 rel, pdf_bounce 2.9e-4 rel (1.4e-7 abs below 1e-4),
# beta_next = b / pdf 8.0e-3 rel where the pdf is near 0 (values ~1e3),
# next_d 1.7e-5 abs.
SHADE_BARS = ((0, 3, 2e-5, 1e-4), (3, 6, 1e-6, 1e-2), (6, 7, 1e-6, 1e-3), (7, 13, 2e-5, 1e-4),
              (14, 17, 2e-5, 1e-4))


def _assert_shade(got, want):
    for lo, hi, atol, rtol in SHADE_BARS[: 5 if len(want) > 15 else 4]:
        _assert_planes(got[lo:hi], want[lo:hi], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(got[13].numpy(), want[13])  # alive


@pytest.mark.parametrize("name", ["cbox", "sphere"])
def test_shade_plain_matches_jax_kernel(name):
    """Forward with want_occ, roughness in [0.2, 0.9]: the ints (alive,
    occlusion) equal, the floats within SHADE_BARS."""
    js, scene_pack, meta, ray, nee, draws, _g = _shade_inputs(name, 2)
    want = _shade_jax(scene_pack, meta, ray, nee, draws, want_occ=True)
    got = _shade_port(js, ray, nee, draws, want_occ=True)
    assert len(got) == len(want) == 15
    _assert_shade(got, want)
    np.testing.assert_array_equal(got[14].numpy(), want[14])
    assert (want[14] != 0).any() and (want[14] == 0).any()  # occluded and clear
    assert (want[13] != 0).any()


@pytest.mark.parametrize("name", ["cbox", "sphere"])
def test_shade_plain_taps_match_jax_kernel(name):
    """Tap mode with a given occlusion, roughness in [0.5, 0.9]: the
    forward planes and le_rem_next within SHADE_BARS, the splat ids equal,
    and each gradient channel within max|a - b| / max|a| < 1e-5 (the bar of
    tests/test_torch_grad_bridge.py; measured up to 3.6e-6)."""
    js, scene_pack, meta, ray, nee, draws, grad = _shade_inputs(name, 3, rough_lo=0.5)
    occ = (np.random.RandomState(4).rand(N) < 0.3).astype(np.int32)
    want = _shade_jax(scene_pack, meta, ray, nee, draws, grad_planes=grad, occ_in=occ)
    got = _shade_port(js, ray, nee, draws, grad=grad, occ_in=occ)
    assert len(got) == len(want) == 22
    _assert_shade(got, want)
    np.testing.assert_array_equal(got[21].numpy(), want[21])
    for k in range(17, 21):
        w = want[k]
        assert np.abs(w).max() > 0
        assert np.abs(got[k].numpy() - w).max() / np.abs(w).max() < 1e-5, k


def test_sample_draw_order():
    """One direct sample draws, in order: the camera's 2, NEE's 4 and the
    BSDF's 3 (no roulette draw), and the splat salt is taken from the state
    after them (direct_fused.py:124-186, :260): replaying that sequence on
    a fresh sampler gives the sample's camera ray, its light sample and its
    bounce, and the g++ build of the kernels' per-lane code takes the same
    draws (its render equals the plain one, test_host_direct_matches_plain)."""
    s = _port_scene("cbox", "lcg")
    cfg = s._config((8, 8), 4)
    tb = pl.build_loop_tables(s._data, s.camera, cfg, 5)
    lanes = pl.pixel_lanes(cfg.res, cfg.spp, "cpu")
    idx = torch.full((64,), 2, dtype=torch.int32)
    smp = pl._sampler(tb, lanes, *pl._fresh_state(tb, lanes, idx))
    draws = []
    for k in (2, 1, 1, 2, 1, 2):
        if k == 1:
            u, smp = smp.next1()
            draws.append(u)
        else:
            (ux, uy), smp = smp.next2_xy()
            draws += [ux, uy]
    assert len(draws) == 9
    o, d = pl.camera_ray(tb.cam, lanes[0], lanes[1], draws[0], draws[1], tb.res, tb.use_tent)
    trace = trace_interact_plain(tb.scene, (*o, *d, torch.full((64,), 1e30),
                                            torch.ones(64, dtype=torch.int32)))
    # the sample's light selection consumes draws 2..5
    smp2 = pl._sampler(tb, lanes, *pl._fresh_state(tb, lanes, idx))
    _uv, smp2 = smp2.next2_xy()
    (_wl, _ld, _lp, _le), smp2 = pl.nee_select(tb, trace[0:3], smp2)
    u_lobe, smp2 = smp2.next1()
    (u0, u1), smp2 = smp2.next2_xy()
    assert torch.equal(u_lobe, draws[6]) and torch.equal(u0, draws[7])
    assert torch.equal(u1, draws[8])
    assert torch.equal(smp2.salt(), smp.salt())


@pytest.mark.parametrize("sampler,name,point_light", [
    ("lcg", "cbox", True), ("pmj02bn", "cbox", False), ("pmj02bn", "sphere", False)])
def test_render_matches_jax_fused_direct(sampler, name, point_light):
    """Scene(integrator="direct", device="cpu").render against the JAX
    Scene with fused="force" at 16x16, 4 spp, seed 3: atol 2e-4, rtol 1e-4
    (measured: up to 3.5e-6 abs on the sphere, 1.5e-7 on the box)."""
    js = _jax_scene(name, sampler, point_light)
    mat = _material(seed=1)
    want = np.asarray(js.render(jnp.asarray(mat), res=(16, 16), spp=4, seed=3))
    ts = _port_scene(name, sampler, point_light)
    calls = dr.render_direct_plain.calls
    got = ts.render(torch.as_tensor(mat), res=(16, 16), spp=4, seed=3).numpy()
    assert dr.render_direct_plain.calls == calls + 1
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _checker(res=16):
    y, x = np.mgrid[0:res, 0:res]
    c = ((x // 4 + y // 4) % 2).astype(np.float32)
    return np.stack([0.2 + 0.6 * c, 0.7 - 0.5 * c, 0.4 * np.ones_like(c),
                     0.3 + 0.4 * c], -1)


def test_golden_direct_cbox():
    """tools/gen_golden.py's direct_cbox (the JAX package's unfused direct
    on the CPU; checker material, 32x32, 16 spp, seed 7), tighter than the
    fused route's bars of tests/test_fused.py:171-172 (atol 2e-3, mean abs
    difference < 1e-5): atol 1e-5 and mean < 1e-6 (measured 4.7e-6 and
    6.1e-8; the fused route's NEE gate and offset-origin pdf deviate only
    at the epsilon level)."""
    s = _port_scene("cbox")
    s.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
    got = s.render(torch.as_tensor(_checker()), res=(32, 32), spp=16, seed=7).numpy()
    expected = np.load(os.path.join(GOLDEN, "direct_cbox.npy"))
    np.testing.assert_allclose(got, expected, atol=1e-5)
    assert np.abs(got - expected).mean() < 1e-6


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("rough_lo,bar", [(0.5, 1e-5), (0.2, 5e-5)])
def test_backward_matches_jax_grad(rough_lo, bar):
    """loss = sum(image[..., :3] * w) through Scene.render and
    loss.backward() against jax.grad of the same loss through the JAX Scene
    (fused="force", packed_splat=False) at 16x16, 4 spp: max|a - b| /
    max|a| within 1e-5 at roughness >= 0.5 and 5e-5 at >= 0.2 (the bars of
    tests/test_torch_grad_bridge.py; measured 2.6e-6 and 1.7e-5)."""
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(rough_lo, 0.9, (16, 16))
    js = _jax_scene("cbox")
    want = np.asarray(jax.grad(lambda m: jnp.sum(
        js.render(m, res=(16, 16), spp=4, seed=3)[..., :3] * w))(jnp.asarray(mat)))
    ts = _port_scene("cbox")
    tmat = torch.as_tensor(mat).requires_grad_()
    calls = dr.render_direct_backward_plain.calls
    img = ts.render(tmat, res=(16, 16), spp=4, seed=3)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert dr.render_direct_backward_plain.calls == calls + 1
    assert np.abs(want).max() > 0
    assert _rel(want, tmat.grad.numpy()) < bar


# ------------------------------------------------- the g++ build of the kernels' code

def _host_trace(table, rays, lite):
    lib = kernels.load_host_library()
    n = rays[0].shape[0]
    f_in = torch.stack(rays[:7]).contiguous()
    f_out = torch.empty((3 if lite else 14, n))
    i_out = torch.empty((1 if lite else 2, n), dtype=torch.int32)
    params = kernels.pack_params("lcg", 1, 0, counts=(table.shape[0], 0, 0, 0))
    rc = lib.zdr_trace_interact_host(params, table.data_ptr(), table.numel(), f_in.data_ptr(),
                                     rays[7].data_ptr(), f_out.data_ptr(), i_out.data_ptr(),
                                     n, int(lite))
    assert rc == 0
    if lite:
        return (*f_out.unbind(0), i_out[0])
    return (*f_out[0:11].unbind(0), i_out[0], *f_out[11:14].unbind(0), i_out[1])


def _host_direct(tb, lanes, mat, le_grad=None, early=None):
    """zdr_direct_host, the sweeps with the early out or without
    (None: kernels.direct_early's rule) -> (acc (3, N), grad or None,
    ray-triangle tests)."""
    if early is None:
        early = kernels.direct_early(tb.scene.shape[0])
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    acc = torch.empty((3, n))
    grad = torch.zeros_like(mat)
    tests = torch.zeros((1,), dtype=torch.int64)
    tables = kernels.pack_tables(tb)
    rc = lib.zdr_direct_host(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), None if le_grad is None else le_grad.data_ptr(),
        acc.data_ptr(), grad.data_ptr(), tests.data_ptr(), n, int(early))
    assert rc == 0
    return acc, (None if le_grad is None else grad), int(tests)


@pytest.mark.parametrize("lite", [False, True])
def test_host_trace_interact_matches_plain(lite):
    """The sphere's rays: ints equal, floats within atol 1e-6."""
    table = scene_table(_port_scene("sphere")._data)
    rays = [torch.as_tensor(r) for r in _rays("sphere", 5)]
    _assert_planes(_host_trace(table, rays, lite),
                   [x.numpy() for x in trace_interact_plain(table, rays, lite)], atol=1e-6)


@pytest.mark.parametrize("early", [False, True], ids=["sweep", "early"])
@pytest.mark.parametrize("sampler,name", [("pmj02bn", "cbox"), ("lcg", "sphere")])
def test_host_direct_matches_plain(sampler, name, early):
    """24x24, 8 spp, roughness in [0.5, 0.9], a random adjoint: the render
    within mean abs diff 1e-6 and 99% of pixels within 1e-5 (glibc's
    sinf and torch's differ by ulps), the gradient within max|a - b| /
    max|a| < 1e-5, the tap mode's radiance equal to the forward's, and
    the test count between the bounds of the sweeps; with and without the
    sweeps' early out (direct_step.cuh CompactSweep)."""
    s = _port_scene(name, sampler)
    mat = _material(seed=6)
    mat[..., 3] = np.random.RandomState(7).uniform(0.5, 0.9, mat.shape[:2])
    mat = torch.as_tensor(mat)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((24, 24), 8), 11)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    acc, _g, tests = _host_direct(tb, lanes, mat, early=early)
    want = dr.render_direct_plain(tb, lanes, mat)
    diff = (acc - want).abs().max(dim=0).values / tb.spp
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.99
    t = tb.scene.shape[0]
    n_samples = lanes.shape[1] * tb.spp
    assert n_samples * t <= tests <= 3 * n_samples * t
    g_acc, grad, g_tests = _host_direct(tb, lanes, mat, le, early)
    assert torch.equal(g_acc, acc) and g_tests == tests
    want_g, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    assert torch.equal(want_acc, want)
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5


FD_EPS = 0.01


def _fd_error(sampler, spp):
    """|AD - FD| / |FD| on the diffuse texel of largest |gradient|, the
    gate of tests/test_fused.py:174-191 on the g++ build: 24x24, a 16^2
    material in [0.25, 0.75], loss = sum(image[..., :3]); AD is the tap
    mode at seed + 1 with the adjoint 1 / spp, FD the two-sided difference
    of renders at seed 3, eps 0.01."""
    s = _port_scene("cbox", sampler)
    mat = torch.as_tensor(np.random.RandomState(0).uniform(0.25, 0.75, (16, 16, 4))
                          .astype(np.float32))
    lanes = pl.pixel_lanes((24, 24), spp, "cpu")

    def tables(seed):
        return pl.build_loop_tables(s._data, s.camera, s._config((24, 24), spp), seed)

    def loss(m):
        return float(_host_direct(tables(3), lanes, m)[0].double().sum()) / spp

    g = _host_direct(tables(4), lanes, mat, torch.full((3, 576), 1.0 / spp))[1]
    ti = np.unravel_index(int(g[..., 0].abs().argmax()), (16, 16)) + (0,)
    up, down = mat.clone(), mat.clone()
    up[ti] += FD_EPS
    down[ti] -= FD_EPS
    fd = (loss(up) - loss(down)) / (2 * FD_EPS)
    return abs(float(g[ti]) - fd) / max(abs(fd), 1e-9)


@pytest.mark.parametrize("sampler", ["lcg", "pmj02bn"])
def test_fd_error_shrinks_with_spp(sampler):
    """The AD-vs-FD gap at 96 spp within test_fused.py's 10%, and smaller
    at 1024 spp (measured: lcg 0.024 -> 0.0096, pmj02bn 0.027 -> 0.0071)."""
    e96, e1024 = _fd_error(sampler, 96), _fd_error(sampler, 1024)
    assert e96 <= 0.1, (e96, e1024)
    assert e1024 < e96, (e96, e1024)


def test_scope_gates_raise():
    s = _port_scene("cbox")
    mat = torch.full((8, 8, 4), 0.5)
    s.use_mis = False
    with pytest.raises(NotImplementedError, match="A10"):
        s.render(mat, res=(4, 4), spp=1)
    s.use_mis = True
    # the direct integrator renders under an envmap; the path kernels do not
    # read one yet
    s.add_envmap(np.ones((4, 8, 3), np.float32))
    assert s.render(mat, res=(4, 4), spp=1).shape == (4, 4, 4)
    s.integrator = "path"
    with pytest.raises(NotImplementedError, match="A11"):
        s.render(mat, res=(4, 4), spp=1)
    s.integrator = "direct"
    s.sampler = "corrmj"
    with pytest.raises(NotImplementedError, match="A4"):
        s.render(mat, res=(4, 4), spp=4)
    s.sampler = "pmj02bn"
    with pytest.raises(NotImplementedError, match="A4"):
        s.render(mat, res=(4, 4), spp=3)
    s.bilinear = False
    with pytest.raises(NotImplementedError, match="A6"):
        s.render(mat, res=(4, 4), spp=1)
    s.bilinear = True
    with pytest.raises(NotImplementedError, match="A6"):
        s.render(torch.full((1, 8, 4), 0.5), res=(4, 4), spp=1)
    s.packed_splat = True
    with pytest.raises(NotImplementedError, match="A17"):
        s.render(mat, res=(4, 4), spp=1)
    s.packed_splat = False
    s.splat_merge = 4  # the direct integrator never merges splats
    assert s.render(mat, res=(4, 4), spp=1).shape == (4, 4, 4)
    # past the kernels' shared memory: the dense sweep raises, naming the
    # BVH route; "auto" (the default) takes it
    big = zt.Scene([(tproc.make_uv_sphere(0.5, 40, 100), None, None)], accel="bruteforce",
                   device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        big.render(mat, res=(4, 4), spp=1)
    big.accel = "auto"
    assert bool(torch.isfinite(big.render(mat, res=(4, 4), spp=1)).all())
    with pytest.raises(ValueError, match="instances"):
        s.update_lights([1.0])


def test_table_limit_follows_each_kernels_layout():
    """The shared-memory limit counts the rows each kernel keeps there:
    3100 triangles fit the direct kernels' 12-float geometry rows, not the
    path loop's whole 31-float rows; the largest tables that fit 227 KB."""
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 32, 50), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], accel="bruteforce",
                 device="cpu")
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    mat = torch.full((8, 8, 4), 0.5)
    assert s._data.meta.num_tris == 3102
    img = s.render(mat, res=(2, 2), spp=1)
    assert img.shape == (2, 2, 4) and bool(torch.isfinite(img).all())
    s.integrator = "path"
    with pytest.raises(NotImplementedError, match="A13"):
        s.render(mat, res=(2, 2), spp=1)
    floats = kernels.MAX_TABLE_BYTES // 4
    kernels.check_table_fits(floats // 31, floats // 31 * 31, "path")
    kernels.check_table_fits(floats // 12, floats // 12 * 31, "direct")
    with pytest.raises(NotImplementedError, match="A13"):
        kernels.check_table_fits(floats // 31 + 1, (floats // 31 + 1) * 31, "path")
    with pytest.raises(NotImplementedError, match="A13"):
        kernels.check_table_fits(floats // 12 + 1, (floats // 12 + 1) * 31, "direct")


def test_point_light_and_update_lights_match_jax():
    """add_point_light and update_lights carry the JAX scene's light
    metadata and tables: switching the ceiling light off leaves the point
    light, and the render matches the JAX one (atol 2e-4, rtol 1e-4)."""
    js = _jax_scene("cbox", "lcg", point_light=True)
    js.update_lights([0.0, 0.0])
    ts = _port_scene("cbox", "lcg", point_light=True)
    ts.update_lights([0.0, 0.0])
    jm, tm = js._data.fused_meta, ts._data.meta
    for field in ("n_lights", "light_tri_ids", "n_point", "n_total"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert tm.n_lights == 0 and tm.n_point == 1
    mat = _material(seed=2)
    want = np.asarray(js.render(jnp.asarray(mat), res=(8, 8), spp=2, seed=1))
    got = ts.render(torch.as_tensor(mat), res=(8, 8), spp=2, seed=1).numpy()
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """Given CPU tensors, trace_interact, direct and direct_grad run their
    plain versions and count no launch."""
    s = _port_scene("cbox")
    mat = torch.as_tensor(_material(seed=2))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((8, 8), 2), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.full((3, 64), 0.25)
    before = (kernels.trace_interact.launches, kernels.direct.launches,
              kernels.direct_grad.launches)
    calls = (dr.render_direct_plain.calls, dr.render_direct_backward_plain.calls)
    assert torch.equal(kernels.direct(tb, lanes, mat), dr.render_direct_plain(tb, lanes, mat))
    g, acc = kernels.direct_grad(tb, lanes, mat, le)
    want_g, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    assert torch.equal(g, want_g) and torch.equal(acc, want_acc)
    rays = [torch.as_tensor(r[:64]) for r in _rays("cbox", 6)]
    for lite in (False, True):
        got = kernels.trace_interact(tb.scene, rays, lite)
        want = trace_interact_plain(tb.scene, rays, lite)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (kernels.trace_interact.launches, kernels.direct.launches,
            kernels.direct_grad.launches) == before
    assert (dr.render_direct_plain.calls, dr.render_direct_backward_plain.calls) == (
        calls[0] + 2, calls[1] + 2)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        kernels.direct(tb, lanes.to("meta"), mat)


def test_direct_is_the_default_as_in_jax():
    """Scene and RenderConfig default to the direct integrator with MIS, as
    the JAX package's do, and JAX sends both test scenes down its fused
    direct route."""
    assert RenderConfig(res=(4, 4), spp=1).integrator == "direct"
    s = _port_scene("cbox")
    assert s.integrator == "direct" and s._config((4, 4), 1).use_mis
    for name in ("cbox", "sphere"):
        js = _jax_scene(name)
        assert js.integrator == "direct"
        assert jdf.direct_fused_eligible(js._data, js._config((4, 4), 1))
