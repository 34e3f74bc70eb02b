"""The port's PRB backward against the JAX package's one-walk loop backward
(integrators/pallas_loop.py:render_path_backward_loop) in Pallas interpret
mode, at splat_merge=1 and packed_splat=False: the JAX package's exact
estimator and its own parity setting (tests/test_fused.py:465-483).

The bar is test_fused.py's: max|a - b| / max|a| < 1e-5. The taps agree to
float rounding (tests/test_torch_grad.py) and are summed in another order.
The materials keep roughness in [0.5, 0.9] at that bar. Below it the GGX
lobe's roughness derivative amplifies the ulps by which torch's and XLA's
sin/cos differ, so roughness in [0.2, 0.9] has a bar of its own,
LOW_ROUGHNESS_BAR.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _jax_scene, _material, _port_camera, _port_data

from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.integrators.wrapper import _pixel_grid

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.wrapper import RenderConfig


# max|a - b| / max|a| against JAX with roughness in [0.2, 0.9], at 16x16,
# 4 spp, max_depth 4, over 4 material/adjoint seeds and both
# configurations: up to 2.73e-5 (JAX itself lies up to 1.54e-5 from the
# float64 walk). Controls: the bounce's roughness taps S set to zero,
# 6.2e-2 to 5.9e-1; the roughness derivative taken through alpha, 1.6e-2
# to 4.3e-1.
LOW_ROUGHNESS_BAR = 5e-5


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def _smooth_material(seed, lo=0.5):
    """(16, 16, 4): diffuse in [0.1, 0.9], roughness in [lo, 0.9]."""
    mat = _material(seed=seed)
    mat[..., 3] = np.random.RandomState(seed + 100).uniform(lo, 0.9, (16, 16))
    return mat


def _backward_rel_err(sampler, point_light, mat, le_seed):
    """16x16, 4 spp, max_depth 4, seed 3, and a random per-pixel adjoint
    made with numpy: JAX's loop backward and the port's -> max|a-b|/max|a|."""
    s = _jax_scene(point_light, sampler)
    s.max_depth = 4
    cfg = dataclasses.replace(s._config((16, 16), 4), fused="force", splat_merge=1,
                              packed_splat=False)
    le = np.random.RandomState(le_seed).rand(16 * 16, 3).astype(np.float32)
    want = np.asarray(plp.render_path_backward_loop(
        s._data, jnp.asarray(mat), s.camera, jnp.int32(3), cfg, _pixel_grid(cfg.res),
        jnp.asarray(le)))

    tcfg = RenderConfig(res=(16, 16), spp=4, sampler=sampler, max_depth=4)
    calls = pl.render_path_backward_loop_plain.calls
    got = pl.render_path_backward_loop(
        _port_data(s), torch.as_tensor(mat), _port_camera(), 3, tcfg,
        torch.as_tensor(le.T.copy())).numpy()
    assert pl.render_path_backward_loop_plain.calls == calls + 1
    assert got.shape == want.shape == (16, 16, 4)
    assert np.abs(want).max() > 0
    return _rel(want, got)


@pytest.mark.parametrize("sampler,point_light", [("pmj02bn", False), ("lcg", True)])
def test_plain_backward_matches_jax_loop_backward(sampler, point_light):
    """Roughness in [0.5, 0.9], at test_fused.py's bar."""
    assert _backward_rel_err(sampler, point_light, _smooth_material(3), 1) < 1e-5


@pytest.mark.parametrize("sampler,point_light", [("pmj02bn", False), ("lcg", True)])
def test_plain_backward_matches_jax_at_low_roughness(sampler, point_light):
    """Roughness in [0.2, 0.9], as the chip smoke's materials, at
    LOW_ROUGHNESS_BAR."""
    err = _backward_rel_err(sampler, point_light, _smooth_material(4, lo=0.2), 2)
    assert err < LOW_ROUGHNESS_BAR


def test_autograd_bridge_matches_jax_grad():
    """Scene.render of a material that requires grad, and a weighted loss:
    mat.grad against jax.grad of the same loss through a JAX Scene at
    16x16, 4 spp (max_depth 16); the image within the forward's 2e-5."""
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _smooth_material(4)
    js = _jax_scene()
    js.fused, js.splat_merge, js.packed_splat = "force", 1, False
    want_img = np.asarray(js.render(jnp.asarray(mat), res=(16, 16), spp=4, seed=3))
    want = np.asarray(jax.grad(lambda m: jnp.sum(
        js.render(m, res=(16, 16), spp=4, seed=3)[..., :3] * w))(jnp.asarray(mat)))

    ts = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                  integrator="path", device="cpu")
    ts.camera = _port_camera()
    tmat = torch.as_tensor(mat).requires_grad_()
    launches = kernels.path_loop_grad.launches
    img = ts.render(tmat, res=(16, 16), spp=4, seed=3)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert kernels.path_loop_grad.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(img.detach().numpy(), want_img, atol=2e-5)
    assert tmat.grad.shape == (16, 16, 4) and np.abs(want).max() > 0
    assert _rel(want, tmat.grad.numpy()) < 1e-5


def test_backward_reestimates_at_the_next_seed():
    """The bridge's gradient is the plain backward's at seed + 1 with the
    adjoint d_image / spp; seed 2**32 - 1 wraps to 0 as JAX's int32 does."""
    ts = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                  integrator="path", sampler="lcg", device="cpu")
    ts.camera = _port_camera()
    ts.max_depth = 3
    mat = torch.as_tensor(_material(seed=5))
    for seed in (7, 2**32 - 1):
        m = mat.clone().requires_grad_()
        ts.render(m, res=(8, 8), spp=2, seed=seed)[..., :3].sum().backward()
        tb = pl.build_loop_tables(ts._data, ts.camera, ts._config((8, 8), 2),
                                  (seed + 1) & 0xFFFFFFFF)
        lanes = pl.pixel_lanes((8, 8), 2, "cpu")
        want, _ = pl.render_path_backward_loop_plain(
            tb, lanes, mat, torch.full((3, 64), 0.5), tb.n_steps)
        assert torch.equal(m.grad, want)
