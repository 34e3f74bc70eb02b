"""The port's big-mesh route (Scene(accel=...) past the kernels' shared
memory: every sweep an ordered BVH walk) against its dense route and
against the JAX package's big-mesh route, the streamed sweeps B5/B6 of
direct_fused.py / path_fused.py in Pallas interpret mode, forced on a small
sphere by patching pallas_bounce.FUSED_MAX_TRIS to 64 inside the test, as
tests/test_stream.py does; nothing in the JAX package changes.

Scenes: the reference's protocol sphere (16 x 32, 960 triangles) over a
quad light of 40, and a 32 x 50 sphere (3102 triangles in all), past the
path kernels' 227 KB of shared memory. Tolerances are stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere
from zdr_tpu.integrators import pallas_bounce as pb

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel.build import DENSE_MAX_TRIS
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl

CAM = dict(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
RES, SPP = (16, 16), 4


def _port_scene(integrator, accel, stacks=(16, 32)):
    s = zt.Scene([(tproc.make_uv_sphere(0.5, *stacks), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)],
                 integrator=integrator, accel=accel, device="cpu")
    s.camera = zt.Camera(**CAM)
    return s


def _material(seed=4, rough_lo=0.5, res=16):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, (res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(rough_lo, 0.9, (res, res))
    return mat


def _weights():
    return np.random.RandomState(2).uniform(0.0, 2.0, (*RES[::-1], 3)).astype(np.float32)


def _port_iteration(scene, mat):
    """Scene.render and loss.backward() of loss = sum(image[..., :3] * w)
    -> (image, gradient) as numpy."""
    tm = torch.as_tensor(mat).requires_grad_()
    img = scene.render(tm, res=RES, spp=SPP, seed=3)
    (img[..., :3] * torch.as_tensor(_weights())).sum().backward()
    return img.detach().numpy(), tm.grad.numpy()


_JAX = {}
_BVH = {}


def _bvh_iteration(integrator):
    """_port_iteration of the protocol scene through accel="bvh" with
    _material(), cached over the module: the tests against the dense route
    and against JAX share it."""
    if integrator not in _BVH:
        s = _port_scene(integrator, "bvh")
        calls = pl.render_path_loop_plain.calls
        _BVH[integrator] = (s, *_port_iteration(s, _material()),
                            pl.render_path_loop_plain.calls - calls)
    return _BVH[integrator]


def _jax_streamed(integrator):
    """JAX's Scene with fused="force" down its streamed route: the image
    and jax.vjp's gradient of the same loss, cached over the module."""
    if integrator not in _JAX:
        js = Scene([(make_uv_sphere(0.5, 16, 32), None, None),
                    (make_quad(size=1.0, y=-2.0), None, 40.0)], integrator=integrator)
        js.camera = Camera(fov=CAM["fov"], origin=float3(*CAM["origin"]),
                           target=float3(*CAM["target"]))
        js.fused, js.splat_merge, js.packed_splat = "force", 1, False
        old = pb.FUSED_MAX_TRIS
        pb.FUSED_MAX_TRIS = 64  # the 962 triangles take the streamed trace
        try:
            img, vjp = jax.vjp(lambda m: js.render(m, res=RES, spp=SPP, seed=3),
                               jnp.asarray(_material()))
            cot = jnp.concatenate([jnp.asarray(_weights()), jnp.zeros((*RES[::-1], 1))], -1)
            (grad,) = vjp(cot)
        finally:
            pb.FUSED_MAX_TRIS = old
        _JAX[integrator] = (np.asarray(img), np.asarray(grad))
    return _JAX[integrator]


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_bvh_route_equals_the_dense_route(integrator):
    """accel="bvh" against accel="bruteforce" through Scene.render and
    loss.backward(): the image and the gradient bit for bit (the walk finds
    the dense sweep's triangle, and the rest of the math is shared)."""
    bvh, img, grad, plain_calls = _bvh_iteration(integrator)
    if integrator == "path":
        assert plain_calls == 1
    dense_img, dense_grad = _port_iteration(_port_scene(integrator, "bruteforce"), _material())
    assert bvh._data.accel.is_bvh and img[..., :3].max() > 0
    np.testing.assert_array_equal(img, dense_img)
    np.testing.assert_array_equal(grad, dense_grad)
    assert np.abs(grad).max() > 0


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_render_matches_jax_streamed_route(integrator):
    """The port's BVH route against JAX's streamed route at 16x16, 4 spp,
    seed 3: atol 2e-4, rtol 1e-4, the bar of the dense route's
    test_torch_direct.py (measured 3.3e-6 direct, 3.8e-6 path). B5's packed
    key keeps t to 14 bits; it flips no winner here."""
    want, _g = _jax_streamed(integrator)
    _s, got, _g, _c = _bvh_iteration(integrator)
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_gradient_matches_jax_streamed_route(integrator):
    """loss = sum(image[..., :3] * w): loss.backward() on the port's BVH
    route against jax.vjp through JAX's streamed route, roughness in
    [0.5, 0.9]: max|a - b| / max|a| < 1e-5, the bar of PR 2 and 3's
    gradient tests (measured 2.4e-6 for both)."""
    _img, want = _jax_streamed(integrator)
    _s, _img, got, _c = _bvh_iteration(integrator)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def _host_bvh(tb, lanes, mat, le_grad, integrator, small_shared=True,
              k_near=kernels.GRAD_NEAR_ROWS["bvh"]):
    """The g++ build of the BVH instantiations, the small tables from a copy
    (small_shared, the kernels' shared memory) or from the packed tables
    (the kernels' global memory), the path gradient's first k_near tap rows
    apart from the rest -> (radiance sums (3, N), gradient or None,
    counts)."""
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    tables, params = kernels.pack_tables(tb), kernels.loop_params(tb, mat)
    a = tb.bvh
    bvh = kernels.bvh_args(a, torch.device("cpu"))
    counts = torch.zeros((2,), dtype=torch.int64)
    grad = torch.zeros_like(mat)
    le = None if le_grad is None else le_grad.data_ptr()
    g = None if le_grad is None else grad.data_ptr()
    if integrator == "direct":
        acc = torch.empty((3, n))
        assert lib.zdr_direct_bvh_host(params, tables.data_ptr(), tables.numel(),
                                       int(small_shared), tb.bn.data_ptr(), mat.data_ptr(), lanes.data_ptr(), le,
                                       acc.data_ptr(), g, *bvh, counts.data_ptr(), n) == 0
    else:
        carry = pl.init_carry(lanes)
        f_out, i_out = torch.empty_like(carry.f), torch.empty_like(carry.i)
        k_near = min(k_near, tb.max_depth)
        far = torch.empty((tb.max_depth - k_near, kernels.GRAD_ROW_PLANES, n))
        assert lib.zdr_path_loop_bvh_host(
            params, tables.data_ptr(), tables.numel(), int(small_shared), tb.bn.data_ptr(),
            mat.data_ptr(), lanes.data_ptr(), le, carry.f.data_ptr(), carry.i.data_ptr(),
            f_out.data_ptr(), i_out.data_ptr(), far.data_ptr(), g, n, tb.n_steps, k_near,
            *bvh, counts.data_ptr()) == 0
        acc = f_out[0:3]
    return acc, (None if le_grad is None else grad), counts


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_host_build_of_the_bvh_kernels_matches_plain(integrator):
    """The g++ build of the BVH instantiations (direct_step.cuh /
    path_loop_step.cuh through trace.cuh's walk) against the plain versions
    on the 3102-triangle scene, 12x12, 4 spp, roughness in [0.5, 0.9], a
    random adjoint: the render within mean abs diff 1e-6 and 99% of pixels
    within 1e-5 (glibc's sinf and torch's differ by ulps), the gradient
    within max|a - b| / max|a| < 1e-5, the tap mode's radiance equal to the
    forward's; the walk visits nodes and tests fewer triangles than a sweep."""
    s = _port_scene(integrator, "bvh", stacks=(32, 50))
    cfg = s._config((12, 12), 4)
    tb = pl.build_loop_tables(s._render_data(integrator), s.camera, cfg, 11)
    assert tb.bvh is not None
    lanes = pl.pixel_lanes(cfg.res, cfg.spp, "cpu")
    mat = torch.as_tensor(_material(seed=6))
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    acc, _g, counts = _host_bvh(tb, lanes, mat, None, integrator)
    if integrator == "direct":
        want = dr.render_direct_plain(tb, lanes, mat)
        want_g, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    else:
        want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        want_g, carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
        want_acc = carry.f[0:3]
    assert torch.equal(want_acc, want)
    diff = (acc - want).abs().amax(0) / cfg.spp
    assert float(diff.mean()) <= 1e-6 and float((diff <= 1e-5).float().mean()) >= 0.99
    g_acc, grad, g_counts = _host_bvh(tb, lanes, mat, le, integrator)
    assert torch.equal(g_acc, acc) and torch.equal(g_counts, counts)
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5
    n_samples = lanes.shape[1] * cfg.spp
    assert counts[1] > n_samples and counts[0] < n_samples * s._data.meta.num_tris


def test_auto_routes_past_shared_memory():
    """The 3102-triangle scene, past accel/build.DENSE_MAX_TRIS of both
    integrators and past the path kernels' 227 KB of shared memory: "auto"
    sends both through the BVH, built once; "bruteforce" keeps the direct
    integrator dense (12-float rows fit 227 KB) and raises for path, naming
    the limit and accel='auto'. update_lights and add_point_light keep the
    tree."""
    s = _port_scene("direct", "auto", stacks=(32, 50))
    mat = torch.full((8, 8, 4), 0.5)
    assert s._data.meta.num_tris == 3102 >= max(DENSE_MAX_TRIS.values())
    s.render(mat, res=(2, 2), spp=1)
    tree = s._data.accel
    assert tree.is_bvh and s._render_data("direct").accel is tree
    s.integrator = "path"
    img = s.render(mat, res=(4, 4), spp=1)
    assert img.shape == (4, 4, 4) and bool(torch.isfinite(img).all())
    assert s._data.accel is tree and s._render_data("path").accel is tree
    s.update_lights([0.0, 20.0])
    s.add_point_light((0.0, 2.0, 0.0), 3.0)
    assert s._data.accel is tree
    s.accel = "bruteforce"
    assert s._render_data("direct").accel is None
    with pytest.raises(NotImplementedError, match="accel='auto'"):
        s.render(mat, res=(2, 2), spp=1)
    with pytest.raises(ValueError, match="accel method"):
        _port_scene("path", "kdtree")


def test_bvh_wrappers_run_the_plain_versions_on_cpu_tensors():
    """Given CPU tensors and tables with a BVH, the four megakernel wrappers
    run their plain versions, which walk the BVH, and count no launch."""
    names = ("path_loop", "path_loop_grad", "direct", "direct_grad", "path_loop_bvh",
             "path_loop_grad_bvh", "direct_bvh", "direct_grad_bvh")
    before = [getattr(kernels, k).launches for k in names]
    s = _port_scene("direct", "bvh")
    tb = pl.build_loop_tables(s._data, s.camera, s._config((4, 4), 2), 1)
    dense = dataclasses.replace(tb, bvh=None)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    mat = torch.as_tensor(_material(seed=2))
    le = torch.full((3, 16), 0.25)
    assert torch.equal(kernels.direct(tb, lanes, mat), kernels.direct_bvh(tb, lanes, mat))
    assert torch.equal(kernels.direct(tb, lanes, mat), dr.render_direct_plain(dense, lanes, mat))
    g, acc = kernels.direct_grad(tb, lanes, mat, le)
    g2, acc2 = kernels.direct_grad_bvh(tb, lanes, mat, le)
    assert torch.equal(g, g2) and torch.equal(acc, acc2)
    c0 = pl.init_carry(lanes)
    c1 = kernels.path_loop(tb, lanes, mat, c0, tb.n_steps)
    assert torch.equal(c1.f, kernels.path_loop_bvh(tb, lanes, mat, c0, tb.n_steps).f)
    assert torch.equal(c1.f, pl.render_path_loop_plain(dense, lanes, mat, c0, tb.n_steps).f)
    pg, _c = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    assert torch.equal(pg, kernels.path_loop_grad_bvh(tb, lanes, mat, le, tb.n_steps)[0])
    assert [getattr(kernels, k).launches for k in names] == before
