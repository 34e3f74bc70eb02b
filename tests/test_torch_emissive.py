"""A scene whose light rows pass a block's shared memory: an emissive uv
sphere of 48 x 48 (4512 light triangles, 288,768 bytes of light rows)
over a floor quad. accel="auto" takes the BVH, whose kernels then read the
light, light-instance, point and camera rows from global memory
(kernels.small_tables_shared); the dense route still refuses the scene,
naming its limit.

The port against the JAX package's Scene: the direct integrator by its
fused route (fused="force", Pallas interpret mode) with the dense
per-triangle sweep, direct_fused.MXU_MIN_TRIS patched past the scene inside
the test (the MXU sweep and the streamed one take minutes a render in
interpret mode; nothing in the JAX package changes); the path integrator by
the route JAX takes on the CPU, its unfused walk (path_persistent.py, whose
PRB backward the loop backward matches to float rounding). And the g++
build of the BVH instantiations, the small tables read where the packed
tables hold them, against the plain walk. Tolerances are stated at each
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere
from zdr_tpu.integrators import direct_fused

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.scene_tables import SCENE_COLS, table_floats
from test_torch_bigmesh import _host_bvh
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

CAM = dict(fov=0.9, origin=(1.6, 0.6, 0.4), target=(0.0, -0.3, 0.0))
RES, SPP = (8, 8), 2
SPHERE, EMISSION, FLOOR = (0.5, 48, 48), 4.0, dict(size=2.0, y=-0.7)


def _port_scene(integrator, accel="auto"):
    s = zt.Scene([(tproc.make_uv_sphere(*SPHERE), None, EMISSION),
                  (tproc.make_quad(**FLOOR), None, None)],
                 integrator=integrator, accel=accel, device="cpu")
    s.camera = zt.Camera(**CAM)
    return s


def _material(seed=5):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, (16, 16, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.5, 0.9, (16, 16))
    return mat


def _weights():
    return np.random.RandomState(4).uniform(0.0, 2.0, (*RES[::-1], 3)).astype(np.float32)


_JAX = {}
_PORT = {}


def _jax_reference(integrator):
    """JAX's Scene (direct: fused with the dense sweep; path: its CPU route):
    the image and jax.vjp's gradient of sum(image[..., :3] * w), cached."""
    if integrator not in _JAX:
        js = Scene([(make_uv_sphere(*SPHERE), None, EMISSION), (make_quad(**FLOOR), None, None)],
                   integrator=integrator)
        js.camera = Camera(fov=CAM["fov"], origin=float3(*CAM["origin"]),
                           target=float3(*CAM["target"]))
        js.splat_merge, js.packed_splat = 1, False
        if integrator == "direct":
            js.fused = "force"
        old = direct_fused.MXU_MIN_TRIS
        direct_fused.MXU_MIN_TRIS = 1 << 30  # the dense fori sweep, not the MXU's
        try:
            img, vjp = jax.vjp(lambda m: js.render(m, res=RES, spp=SPP, seed=3),
                               jnp.asarray(_material()))
            cot = jnp.concatenate([jnp.asarray(_weights()), jnp.zeros((*RES[::-1], 1))], -1)
            (grad,) = vjp(cot)
        finally:
            direct_fused.MXU_MIN_TRIS = old
        _JAX[integrator] = (np.asarray(img), np.asarray(grad))
    return _JAX[integrator]


def _port(integrator):
    """Scene.render and loss.backward() by accel="auto", cached -> (scene,
    image, gradient)."""
    if integrator not in _PORT:
        s = _port_scene(integrator)
        tm = torch.as_tensor(_material()).requires_grad_()
        img = s.render(tm, res=RES, spp=SPP, seed=3)
        (img[..., :3] * torch.as_tensor(_weights())).sum().backward()
        _PORT[integrator] = (s, img.detach().numpy(), tm.grad.numpy())
    return _PORT[integrator]


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_emissive_sphere_renders_by_auto_and_matches_jax(integrator):
    """Past a block's shared memory in light rows alone: accel="auto" walks
    the BVH with the small tables in global memory and renders; the image
    within atol 2e-4, rtol 1e-4 of JAX's, the gradient of sum(image * w)
    within max|a - b| / max|a| < 1e-5 (roughness in [0.5, 0.9]): the bars
    of the direct integrator's tests against JAX (tests/test_torch_direct.py;
    measured here: image 1.1e-6 direct, 9.5e-7 path; gradient 5.2e-7,
    7.5e-7)."""
    s, img, grad = _port(integrator)
    meta = s._data.meta
    assert len(meta.light_tri_ids) == 4512 and meta.num_tris == 4514
    assert s._render_data(integrator).accel.is_bvh
    small = table_floats(meta) - meta.num_tris * SCENE_COLS
    assert small * 4 > kernels.MAX_TABLE_BYTES and not kernels.small_tables_shared(small)
    want_img, want_grad = _jax_reference(integrator)
    assert want_img[..., :3].max() > 0 and np.abs(want_grad).max() > 0
    np.testing.assert_allclose(img, want_img, atol=2e-4, rtol=1e-4)
    assert np.abs(grad - want_grad).max() / np.abs(want_grad).max() < 1e-5


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_host_build_reads_the_light_rows_from_global_memory(integrator):
    """The g++ build of the BVH instantiations with small_shared 0 (the
    kernels' launch for this scene: light rows read from the packed tables)
    against the plain walk at the Scene's tables, seed 3, with the image's
    adjoint 1 / spp: the radiance within mean abs diff 1e-6 and 99% of
    pixels within 1e-5 a sample (glibc's sinf and torch's differ by ulps),
    the gradient within max|a - b| / max|a| < 1e-5, and the same as with a
    copy of the small tables (small_shared 1) bit for bit."""
    s, _img, _grad = _port(integrator)
    cfg = s._config(RES, SPP)
    tb = pl.build_loop_tables(s._render_data(integrator), s.camera, cfg, 3)
    lanes = pl.pixel_lanes(cfg.res, cfg.spp, "cpu")
    mat = torch.as_tensor(_material())
    le = torch.full((3, lanes.shape[1]), 1.0 / SPP)
    acc, grad, _c = _host_bvh(tb, lanes, mat, le, integrator, small_shared=False)
    acc_s, grad_s, _c = _host_bvh(tb, lanes, mat, le, integrator, small_shared=True)
    assert torch.equal(acc, acc_s) and torch.equal(grad, grad_s)
    if integrator == "direct":
        want_g, want = dr.render_direct_backward_plain(tb, lanes, mat, le)
    else:
        want_g, carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
        want = carry.f[0:3]
    diff = (acc - want).abs().amax(0) / SPP
    assert float(want.max()) > 0
    assert float(diff.mean()) <= 1e-6 and float((diff <= 1e-5).float().mean()) >= 0.99
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5


def test_dense_route_past_shared_memory_names_its_limit():
    """accel="bruteforce" still refuses the scene, for both integrators:
    its message names the dense route's bytes and triangles and the route
    without the limit."""
    mat = torch.full((8, 8, 4), 0.5)
    for integrator in ("direct", "path"):
        s = _port_scene(integrator, "bruteforce")
        with pytest.raises(NotImplementedError,
                           match=rf"{kernels.MAX_TABLE_BYTES} bytes.*at most 0 triangles"
                                 r".*accel='auto' or 'bvh'"):
            s.render(mat, res=(2, 2), spp=1)
