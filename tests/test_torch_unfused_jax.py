"""The port's unfused estimators against the JAX package's on the CPU, at
8x8 on inputs made from a seed with numpy: the nearest-filtered images of
the three integrators, the direct integrator without MIS (image and
gradient), the path walk's exact four-corner splat (image and gradient) and
path_stats' counts. JAX is jitted once a configuration, with one jax.vjp
for its image and gradient. Tolerances are stated at each test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light, make_uv_sphere
from zdr_tpu.integrators.wrapper import build_render

import zdr_tpu_torch as zt
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators.wrapper import RenderFunction
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

RES, SPP, SEED = (8, 8), 4, 3
BOX_CAM = dict(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))
SPHERE_CAM = dict(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))


def _material(seed=4):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, size=(16, 16, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.5, 0.9, size=(16, 16))
    return mat


def _scenes(name, integrator):
    """The same scene in both packages -> (JAX Scene, port Scene)."""
    if name == "cbox":
        js = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                   integrator=integrator)
        ts = zt.Scene([(tproc.make_cornell_box(), None, None),
                       (tproc.make_cornell_light(), None, 15.0)], integrator=integrator,
                      device="cpu")
        cam = BOX_CAM
    else:  # a sphere of 8 x 16 over the cornell light
        js = Scene([(make_uv_sphere(0.5, 8, 16), None, None)], integrator=integrator)
        ts = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None)], integrator=integrator,
                      accel="bruteforce", device="cpu")
        cam = SPHERE_CAM
    js.camera = Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                       target=float3(*cam["target"]))
    ts.camera = zt.Camera(**cam)
    for s in (js, ts):
        s.fused, s.splat_merge, s.packed_splat = False, 1, False
    return js, ts


def _jax_vjp(js, cfg, mat, w):
    """JAX's image and the gradient of sum(image[..., :3] * w) by one
    jax.vjp of its render at cfg (a jitted build_render)."""
    f = build_render(cfg)
    img, vjp = jax.vjp(lambda m: f(m, js._data, js.camera, jnp.int32(SEED)), jnp.asarray(mat))
    ct = jnp.concatenate([jnp.asarray(w), jnp.zeros(img.shape[:2] + (1,), jnp.float32)], -1)
    return np.asarray(img), np.asarray(vjp(ct)[0])


def _port(ts, cfg, mat, w):
    m = torch.as_tensor(mat).requires_grad_()
    img = RenderFunction.apply(m, ts._render_data(cfg.integrator), ts.camera, SEED, cfg)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    return img.detach().numpy(), m.grad.numpy()


def _weights():
    return np.random.RandomState(2).uniform(0.0, 2.0, RES[::-1] + (3,)).astype(np.float32)


def _port_cfg(ts, jcfg):
    return dataclasses.replace(ts._config(RES, SPP), stochastic_splat=jcfg.stochastic_splat,
                               persistent=jcfg.persistent)


def _grad_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("integrator,name", [("path", "cbox"), ("direct", "cbox"),
                                             ("collocated", "sphere")])
def test_nearest_images_match_jax(integrator, name):
    """bilinear = False: the JAX package's nearest fetch (texture.py:389)
    in each unfused estimator; the images within the golden bar (atol 2e-4,
    rtol 1e-4). The collocated gradient too, whose JAX backward splats to
    the texel read (collocated.py:80-87), within 1e-5 of its largest."""
    js, ts = _scenes(name, integrator)
    js.bilinear = ts.bilinear = False
    mat, w = _material(), _weights()
    jcfg = js._config(RES, SPP)
    if integrator == "collocated":
        want, want_g = _jax_vjp(js, jcfg, mat, w)
    else:
        want = np.asarray(build_render(jcfg)(jnp.asarray(mat), js._data, js.camera,
                                             jnp.int32(SEED)))
    got, got_g = _port(ts, _port_cfg(ts, jcfg), mat, w)
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    if integrator == "collocated":
        assert _grad_rel(got_g, want_g) <= 1e-5


def test_direct_without_mis_matches_jax():
    """use_mis = False, light sampling only (JAX direct.py:52, :145): the
    image within the golden bar, the gradient (the stochastic splat at the
    same salt) within 1e-5 of its largest texel, roughness >= 0.5."""
    js, ts = _scenes("cbox", "direct")
    js.use_mis = ts.use_mis = False
    mat, w = _material(), _weights()
    jcfg = js._config(RES, SPP)
    want, want_g = _jax_vjp(js, jcfg, mat, w)
    got, got_g = _port(ts, _port_cfg(ts, jcfg), mat, w)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    assert np.abs(want_g).max() > 0 and _grad_rel(got_g, want_g) <= 1e-5


def test_path_exact_splat_matches_jax():
    """The persistent path walk with the exact four-corner splat
    (stochastic_splat=False, JAX path_persistent.py:339-342): the image
    within the golden bar, the gradient within 1e-5 of its largest texel,
    roughness >= 0.5 (JAX's flush sums by cumsum differences, the port by
    index_add_)."""
    js, ts = _scenes("cbox", "path")
    mat, w = _material(), _weights()
    jcfg = dataclasses.replace(js._config(RES, SPP), stochastic_splat=False)
    want, want_g = _jax_vjp(js, jcfg, mat, w)
    got, got_g = _port(ts, _port_cfg(ts, jcfg), mat, w)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    assert np.abs(want_g).max() > 0 and _grad_rel(got_g, want_g) <= 1e-5


def test_path_stats_counts_match_jax():
    """path_stats (JAX path.py:335, bench.py's ray accounting) on the cornell
    box's camera rays at 16x16, 1 spp: the closest and shadow traces over
    the 256 lanes within one of JAX's (measured 675 against 676 closest
    traces: one path of the 256 takes a bounce more in jitted JAX, a
    float-level flip; the walk op by op, unjitted, gives equal counts)."""
    from zdr_tpu.integrators.path import path_stats as jax_stats
    from zdr_tpu.integrators.wrapper import _pixel_grid, _primary_rays
    from zdr_tpu.samplers import make_sampler as jax_sampler

    from zdr_tpu_torch.camera import camera_const
    from zdr_tpu_torch.integrators.path import path_stats
    from zdr_tpu_torch.integrators.wrapper import pixel_grid, primary_rays, with_accel
    from zdr_tpu_torch.samplers import make_sampler

    js, ts = _scenes("cbox", "path")
    res, n = (16, 16), 256
    mat = _material()
    coords = _pixel_grid(res)
    o, d, smp = _primary_rays(coords, js.camera, jax_sampler("pmj02bn", coords, 0, 1, 0), res,
                              True)
    want = jax.jit(lambda m: jax_stats(js._data, m, o, d, smp))(jnp.asarray(mat))
    tc = pixel_grid(res, "cpu")
    to, td, tsmp = primary_rays(tc, camera_const(ts.camera), make_sampler("pmj02bn", tc, 0, 1, 0),
                                res, True)
    got = path_stats(with_accel(ts._render_data("path")), torch.as_tensor(mat), to, td,
                     tsmp)
    assert got[0] > 1.0 and got[1] > 0.5
    for g, w_ in zip(got, want):
        assert abs(round(g * n) - round(float(w_) * n)) <= 1
