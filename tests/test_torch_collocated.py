"""The port's collocated integrator (zdr_tpu_torch/integrators/collocated.py
and the per-lane code of kernels/csrc/collocated_step.cuh) against the JAX
package's (zdr_tpu/integrators/collocated.py: collocated_estimator and the
hand-written collocated_backward with its stochastic single-corner splat,
the route the JAX package takes on the CPU), on inputs made from a seed with
numpy. Tolerances are stated at each test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_direct import SPHERE_CAM, _checker
from test_torch_loop import CAM, _material

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light, make_uv_sphere

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import collocated as co
from zdr_tpu_torch.integrators import path_loop as pl

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_CAM = dict(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))


def _jax_scene(name):
    if name == "cbox":
        s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                  integrator="collocated")
        cam = CAM
    else:
        s = Scene([(make_uv_sphere(0.5, 8, 16), None, None)], integrator="collocated")
        cam = SPHERE_CAM
    s.camera = Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                      target=float3(*cam["target"]))
    return s


def _port_scene(name, accel="auto"):
    if name == "cbox":
        s = zt.Scene([(tproc.make_cornell_box(), None, None),
                      (tproc.make_cornell_light(), None, 15.0)], integrator="collocated",
                     accel=accel, device="cpu")
        s.camera = zt.Camera(**CAM)
    elif name == "sphere":
        s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None)], integrator="collocated",
                     accel=accel, device="cpu")
        s.camera = zt.Camera(**SPHERE_CAM)
    else:  # tools/gen_golden.py's collocated_sphere: 960 triangles
        s = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator="collocated",
                     accel=accel, device="cpu")
        s.camera = zt.Camera(**GOLDEN_CAM)
    return s


def test_golden_collocated_sphere():
    """tools/gen_golden.py's collocated_sphere (the JAX package's unfused
    collocated estimator on the CPU: checker material, 32x32, 16 spp, seed
    7) at the golden bar, atol 2e-4 and rtol 1e-4 (measured: max abs
    difference 2.9e-6), by the dense route; the BVH's image is the same bit
    for bit (test_dense_and_bvh_routes_are_equal)."""
    s = _port_scene("golden", "bruteforce")
    got = s.render(torch.as_tensor(_checker()), res=(32, 32), spp=16, seed=7).numpy()
    expected = np.load(os.path.join(GOLDEN, "collocated_sphere.npy"))
    np.testing.assert_allclose(got, expected, atol=2e-4, rtol=1e-4)


def _grad_close(got, want):
    """Phase 7's bars of chip_smoke.py: per-channel sums within rtol 1e-5,
    and every texel whose gradient (largest |channel|) passes 1e-3 of the
    largest within rtol 1e-4 of it."""
    np.testing.assert_allclose(got.sum((0, 1)), want.sum((0, 1)), rtol=1e-5)
    mag = np.abs(want).max(-1)
    big = mag > 1e-3 * mag.max()
    assert big.sum() > 10
    rel = np.abs(got - want).max(-1)[big] / mag[big]
    assert rel.max() <= 1e-4, rel.max()


@pytest.mark.parametrize("name", ["sphere", "cbox"])
def test_render_and_grad_match_jax(name):
    """Scene(integrator="collocated", device="cpu") against the JAX Scene on
    the CPU (collocated_estimator; the gradient by jax.grad through its
    custom_vjp, collocated_backward with the stochastic splat at the same
    salt) at 16x16, 4 spp, seed 3, roughness in [0.2, 0.9]: the image within
    atol 2e-4 and rtol 1e-4, the texel gradient of loss = sum(image[...,
    :3] * w) at _grad_close's bars."""
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    js = _jax_scene(name)
    want = np.asarray(js.render(jnp.asarray(mat), res=(16, 16), spp=4, seed=3))
    want_g = np.asarray(jax.grad(lambda m: jnp.sum(
        js.render(m, res=(16, 16), spp=4, seed=3)[..., :3] * w))(jnp.asarray(mat)))
    ts = _port_scene(name)
    tmat = torch.as_tensor(mat).requires_grad_()
    calls = (co.render_collocated_plain.calls, co.render_collocated_backward_plain.calls)
    img = ts.render(tmat, res=(16, 16), spp=4, seed=3)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert (co.render_collocated_plain.calls, co.render_collocated_backward_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(img.detach().numpy(), want, atol=2e-4, rtol=1e-4)
    _grad_close(tmat.grad.numpy(), want_g)


def test_both_forms_of_the_shaded_set_agree():
    """On the cornell box with its ceiling light in view, seen from outside
    its open side (some rays miss, some meet a wall's back), the shaded set
    by B3's split (shade | add_emit > 0, the fused route's) equals the
    unfused estimator's front-facing tests on ng and ns, sample by sample,
    and emissive hits are among it."""
    s = _port_scene("cbox")
    s.camera = zt.Camera(fov=1.2, origin=(-0.2, 2.6, 4.0), target=(-0.2, 2.6, -5.0))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((24, 24), 4), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    emissive = 0
    for it in range(tb.spp):
        _d, _t, k1, _smp = co._hit(tb, lanes, it)
        fused = (k1[11] != 0) | (k1[12] > 0) | (k1[13] > 0) | (k1[14] > 0)
        assert torch.equal(fused, co.valid_front(tb, lanes, it))
        emissive += int(((k1[12] > 0) & fused).sum())
        assert bool(fused.any()) and not bool(fused.all())
    assert emissive > 0


def test_dense_and_bvh_routes_are_equal():
    """The golden sphere (960 triangles) by the dense sweep and through the
    BVH: the images and the texture gradients equal bit for bit."""
    mat = _material(seed=5)
    out = []
    for accel in ("bruteforce", "bvh"):
        s = _port_scene("golden", accel)
        assert (s._render_data("collocated").accel is None) == (accel == "bruteforce")
        tmat = torch.as_tensor(mat).requires_grad_()
        img = s.render(tmat, res=(12, 12), spp=2, seed=1)
        img[..., :3].sum().backward()
        out.append((img.detach(), tmat.grad))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_host_collocated_matches_plain(route):
    """The g++ build of the kernels' per-lane code (collocated_step.cuh,
    zdr_collocated_host) on the 8 x 16 sphere, 16x16, 4 spp, by the dense
    sweep and through the BVH: the render within mean abs diff 1e-6 and 99%
    of pixels within 1e-5 (glibc's sinf and torch's differ by ulps), the
    gradient within max|a - b| / max|a| < 1e-5, the tap mode's radiance and
    counts equal to the forward's, one test a triangle a sample on the
    dense route."""
    s = _port_scene("sphere", "bvh" if route == "bvh" else "bruteforce")
    mat = torch.as_tensor(_material(seed=6))
    tb = pl.build_loop_tables(s._render_data("collocated"), s.camera, s._config((16, 16), 4), 11)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    lib = kernels.load_host_library()
    cpu = torch.device("cpu")
    bvh = (None, None, 0, 0) if tb.bvh is None else kernels.bvh_args(tb.bvh, cpu)

    def run(adjoint):
        n = lanes.shape[1]
        acc, grad = torch.empty((3, n)), torch.zeros_like(mat)
        counts = torch.zeros((2,), dtype=torch.int64)
        tables = kernels.pack_tables(tb)
        rc = lib.zdr_collocated_host(
            kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
            mat.data_ptr(), lanes.data_ptr(), None if adjoint is None else adjoint.data_ptr(),
            acc.data_ptr(), grad.data_ptr(), counts.data_ptr(), n, *bvh)
        assert rc == 0
        return acc, grad, counts.tolist()

    acc, _g, counts = run(None)
    want_g, want = co.render_collocated_backward_plain(tb, lanes, mat, le)
    diff = (acc - want).abs().max(dim=0).values / tb.spp
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.99
    g_acc, grad, g_counts = run(le)
    assert torch.equal(g_acc, acc) and g_counts == counts
    if route == "dense":
        assert counts == [lanes.shape[1] * tb.spp * tb.scene.shape[0], 0]
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """Given CPU tensors, collocated and collocated_grad run their plain
    versions and count no launch."""
    s = _port_scene("sphere")
    mat = torch.as_tensor(_material(seed=2))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((8, 8), 2), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.full((3, 64), 0.25)
    before = (kernels.collocated.launches, kernels.collocated_grad.launches)
    assert torch.equal(kernels.collocated(tb, lanes, mat),
                       co.render_collocated_plain(tb, lanes, mat))
    g, acc = kernels.collocated_grad(tb, lanes, mat, le)
    want_g, want_acc = co.render_collocated_backward_plain(tb, lanes, mat, le)
    assert torch.equal(g, want_g) and torch.equal(acc, want_acc)
    # the tap mode's radiance is the forward's
    assert torch.equal(want_acc, co.render_collocated_plain(tb, lanes, mat))
    assert (kernels.collocated.launches, kernels.collocated_grad.launches) == before
