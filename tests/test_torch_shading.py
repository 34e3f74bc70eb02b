"""The port's per-lane shading math against the JAX package's, elementwise on
random batches made with numpy: GGX, the ONB, the camera, the interaction
epilogue, the dense sweeps and the bilinear fetch.

Tolerance rtol=1e-5, atol=1e-6: torch and XLA compute sqrt, sin and cos to
within ulps of each other, not identically."""

import jax.numpy as jnp
import numpy as np
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu.integrators import pallas_bounce as pb
from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.texture import pack_quads

import zdr_tpu_torch as zt
from zdr_tpu_torch import camera as tcam
from zdr_tpu_torch import microfacet as tmf
from zdr_tpu_torch.integrators import path_loop as tpl
from zdr_tpu_torch.texture import read_bilinear
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)


def _unit(rs, n=N, upper=False):
    v = rs.normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    if upper:
        v[2] = np.abs(v[2])
    return v


def _j(a):
    return tuple(jnp.asarray(x) for x in a)


def _t(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(x)) for x in a)


def _close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_ggx_brdf_sample_pdf():
    rs = np.random.RandomState(0)
    wo = _unit(rs, upper=True)
    wi = _unit(rs)
    dif = rs.uniform(0, 1, (3, N)).astype(np.float32)
    rough = rs.uniform(0.05, 1.0, N).astype(np.float32)
    u = rs.uniform(0, 1, (3, N)).astype(np.float32)
    _close(tmf.ggx_brdf(_t(wo), _t(wi), _t(dif), torch.as_tensor(rough)),
           pb._ggx_brdf(_j(wo), _j(wi), _j(dif), jnp.asarray(rough)))
    got = tmf.ggx_sample(_t(wo), torch.as_tensor(rough), *_t(u))
    want = pb._ggx_sample(_j(wo), jnp.asarray(rough), *_j(u))
    # The VNDF sample's pz = sqrt(1 - px^2 - py^2) turns an ulp of sin/cos
    # into ~1e-6 where pz -> 0 (one element in 4096 here): at most 0.1% of
    # the components may leave TOL, and none may be 1e-5 off.
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.mean(~np.isclose(g, w, **TOL)) <= 1e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    wi_up = _unit(rs, upper=True)
    _close([tmf.ggx_sample_pdf(_t(wo), _t(wi_up), torch.as_tensor(rough))],
           [pb._ggx_sample_pdf(_j(wo), _j(wi_up), jnp.asarray(rough))])


def test_onb_and_frames():
    rs = np.random.RandomState(1)
    n = _unit(rs)
    v = _unit(rs)
    t, b = tmf.make_onb(_t(n))
    jt, jb = pb._make_onb(_j(n))
    _close(t + b, jt + jb)
    _close(tmf.to_local(t, b, _t(n), _t(v)), pb._to_local(jt, jb, _j(n), _j(v)))
    _close(tmf.to_world(t, b, _t(n), _t(v)), pb._to_world(jt, jb, _j(n), _j(v)))


def test_camera_const_and_ray():
    rs = np.random.RandomState(2)
    cam = dict(fov=0.87, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))
    jc = plp.camera_const(Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                                 target=float3(*cam["target"])))
    tc = tcam.camera_const(zt.Camera(**cam))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc).reshape(-1), **TOL)
    res = (48, 32)
    px = rs.randint(0, res[0], N).astype(np.int32)
    py = rs.randint(0, res[1], N).astype(np.int32)
    u0, u1 = rs.uniform(0, 1, (2, N)).astype(np.float32)
    for tent in (True, False):
        jo, jd = plp._camera_ray(jc, jnp.asarray(px), jnp.asarray(py), jnp.asarray(u0),
                                 jnp.asarray(u1), res, tent)
        to, td = tcam.camera_ray(tc, torch.as_tensor(px), torch.as_tensor(py),
                                 torch.as_tensor(u0), torch.as_tensor(u1), res, tent)
        _close(to + td, jo + jd)


def test_interact_epilogue():
    rs = np.random.RandomState(3)
    o = rs.uniform(-3, 3, (3, N)).astype(np.float32)
    d = _unit(rs)
    pdf_prev = np.where(rs.rand(N) < 0.3, 1e30, rs.uniform(0.01, 5, N)).astype(np.float32)
    active = rs.rand(N) < 0.8
    miss = rs.rand(N) < 0.2
    best_t = np.where(miss, 1e30, rs.uniform(0.1, 8, N)).astype(np.float32)
    bu, bv = rs.uniform(0, 0.5, (2, N)).astype(np.float32)
    av = rs.uniform(-1, 1, (22, N)).astype(np.float32)
    av[18:21] = np.where(rs.rand(3, N) < 0.3, rs.uniform(0, 15, (3, N)), 0.0)
    av[21] = rs.uniform(0.5, 20, N)
    av[:, miss] = 0.0
    want = pb._interact_epilogue(_j(o), _j(d), jnp.asarray(pdf_prev), jnp.asarray(active),
                                 jnp.asarray(best_t), jnp.asarray(bu), jnp.asarray(bv),
                                 jnp.asarray(miss), _j(av))
    p, uv, ns, ng, shade, ae = tpl.interact_epilogue(
        _t(o), _t(d), torch.as_tensor(pdf_prev), torch.as_tensor(active),
        torch.as_tensor(best_t), torch.as_tensor(bu), torch.as_tensor(bv),
        torch.as_tensor(miss), _t(av))
    _close(p + uv + ns + ng, want[0:11])
    np.testing.assert_array_equal(shade.numpy(), np.asarray(want[11]) != 0)
    _close(ae, want[12:15])


def _cbox_pack():
    s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
              integrator="path")
    meta = s._data.fused_meta
    scene_pack, _ = pb.build_fused_const(s._data, meta)
    return meta, scene_pack


def _rays(rs):
    o = np.stack([rs.uniform(-2.9, 2.4, N), rs.uniform(0.1, 5.2, N),
                  rs.uniform(-5.7, -0.3, N)]).astype(np.float32)
    return o, _unit(rs)


def test_dense_closest_sweep():
    rs = np.random.RandomState(4)
    meta, scene_pack = _cbox_pack()
    o, d = _rays(rs)
    pdf_prev = rs.uniform(0.01, 5, N).astype(np.float32)
    active = rs.rand(N) < 0.9
    want = plp._closest_interact(scene_pack, None, None, meta.num_tris, _j(o), _j(d),
                                 jnp.asarray(pdf_prev), jnp.asarray(active), None)
    table = torch.as_tensor(np.array(scene_pack)[: meta.num_tris, :31])
    p, uv, ns, ng, shade, ae = tpl.closest_interact(
        table, _t(o), _t(d), torch.as_tensor(pdf_prev), torch.as_tensor(active))
    _close(p + uv + ns + ng, want[0:11])
    np.testing.assert_array_equal(shade.numpy(), np.asarray(want[11]) != 0)
    _close(ae, want[12:15])


def test_dense_occlusion_sweep():
    rs = np.random.RandomState(5)
    meta, scene_pack = _cbox_pack()
    p, wi = _rays(rs)
    dist = rs.uniform(0.01, 8, N).astype(np.float32)
    ns = _unit(rs)
    shade = np.ones(N, bool)
    ones = np.ones((3, N), np.float32)
    want = plp._occ_sweep(scene_pack, None, None, meta.num_tris, _j(p), _j(ns),
                          jnp.asarray(shade), _j(wi), jnp.asarray(dist), _j(ones))
    table = torch.as_tensor(np.array(scene_pack)[: meta.num_tris, :31])
    got = tpl.occluded(table, _t(p), _t(wi), torch.as_tensor(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.float().mean() < 1


def test_bilinear_fetch_matches_packed_quads():
    rs = np.random.RandomState(6)
    mat = rs.uniform(0, 1, (13, 17, 4)).astype(np.float32)
    ux, uy = rs.uniform(-0.1, 1.1, (2, N)).astype(np.float32)
    want = pb.read_quads_planes(jnp.asarray(ux), jnp.asarray(uy),
                                pack_quads(jnp.asarray(mat)), 13, 17)
    got = read_bilinear(torch.as_tensor(mat), torch.as_tensor(ux), torch.as_tensor(uy))
    _close(got, want)
