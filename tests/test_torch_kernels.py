"""The port's CUDA kernels against their plain PyTorch versions on the card.
Marked `cuda`: each test skips without a CUDA device. chip_smoke.py runs the
same checks, and the main path, on an H100."""

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.samplers import sampler_probe_plain
from zdr_tpu_torch.samplers.pmj02bn import bluenoise

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(dev, sampler="pmj02bn"):
    s = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                 sampler=sampler, device=dev)
    s.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
    return s


def _material(dev, res=64, seed=0):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, (res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.2, 0.9, (res, res))
    return torch.as_tensor(mat, device=dev)


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_sampler_probe_bit_exact(dev, kind):
    rs = np.random.RandomState(1)
    n = 4096
    lanes = torch.as_tensor(np.stack([
        rs.randint(0, 1024, n), rs.randint(0, 1024, n),
        rs.randint(-2**31, 2**31, n), rs.randint(0, 64, n)]).astype(np.int32), device=dev)
    bn = bluenoise(dev)
    got = kernels.sampler_probe(kind, 64, lanes, 6, bn)
    assert torch.equal(got, sampler_probe_plain(kind, 64, lanes, 6, bn))


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_one_step_matches_loop_step(dev, kind):
    s = _scene(dev, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    carry = pl.init_carry(lanes)
    for _ in range(3):
        got = kernels.path_loop(tb, lanes, mat, carry, 1)
        want = pl.loop_step(carry, tb, lanes, mat)
        torch.cuda.synchronize()
        assert torch.equal(got.i, want.i)
        torch.testing.assert_close(got.f, want.f, rtol=1e-6, atol=1e-6, equal_nan=True)
        carry = want


def test_render_matches_plain(dev):
    """64x64, 8 spp: mean abs diff <= 1e-6, 99.9% of pixels within 1e-5."""
    s = _scene(dev)
    mat = _material(dev)
    before = kernels.path_loop.launches
    img = s.render(mat, res=(64, 64), spp=8, seed=2)
    assert kernels.path_loop.launches == before + 1
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 2)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    plain = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want = (plain.f[0:3] / torch.tensor(8.0, device=dev)).T.reshape(64, 64, 3)
    diff = (img[..., :3] - want).abs()
    assert float(diff.mean()) <= 1e-6
    assert float((diff.amax(-1) <= 1e-5).float().mean()) >= 0.999


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_grad_kernel_matches_plain_backward(dev, kind):
    """64x64, 8 spp, a random adjoint: per-channel sums within rtol 1e-5,
    texels past 1e-3 of the largest gradient within rtol 1e-4 (float
    atomics sum in a run-dependent order); the kernel's radiance equals the
    forward kernel's bit for bit."""
    s = _scene(dev, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 3)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    before = kernels.path_loop_grad.launches
    got, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    assert kernels.path_loop_grad.launches == before + 1
    fwd = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    assert torch.equal(carry.f[0:3], fwd.f[0:3])
    torch.testing.assert_close(got.double().sum((0, 1)), want.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((got - want).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


def test_scene_backward_launches_the_grad_kernel(dev):
    s = _scene(dev)
    mat = _material(dev).requires_grad_()
    before = kernels.path_loop_grad.launches
    s.render(mat, res=(32, 32), spp=4, seed=1)[..., :3].sum().backward()
    assert kernels.path_loop_grad.launches == before + 1
    assert bool(torch.isfinite(mat.grad).all()) and float(mat.grad.abs().max()) > 0
