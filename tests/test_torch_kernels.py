"""The port's CUDA kernels against their plain PyTorch versions on the card:
the path loop's (path_loop, path_loop_grad, sampler_probe) and the direct
integrator's (trace_interact, direct, direct_grad). Marked `cuda`: each
test skips without a CUDA device. chip_smoke.py runs the same checks, and
the main paths, on an H100."""

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import bounce
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.scene_tables import scene_table
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
                 integrator="path", sampler=sampler, device=dev)
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


def _direct_scene(dev, name, sampler="pmj02bn"):
    if name == "cbox":
        s = _scene(dev, sampler)
        s.integrator = "direct"
        return s
    # "bigsphere": 3102 triangles, a 149 KB shared-memory table (past the
    # 48 KB a launch gets without opting in)
    stacks, slices = (32, 50) if name == "bigsphere" else (16, 32)
    s = zt.Scene([(tproc.make_uv_sphere(0.5, stacks, slices), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], sampler=sampler, device=dev)
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    return s


@pytest.mark.parametrize("name", ["cbox", "sphere", "bigsphere"])
def test_trace_interact_matches_plain(dev, name):
    """16384 random rays, full and lite: ints equal, floats within 1e-6."""
    s = _direct_scene(dev, name)
    table = scene_table(s._data)
    g = torch.Generator().manual_seed(3)
    n = 16384
    o = torch.randn((n, 3), generator=g) * 0.5 + torch.tensor([-0.2, 2.6, -3.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    if name != "cbox":
        o = 1.6 * torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
        d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g) - 0.5 - o, dim=1)
    pdf = 0.1 + 10.0 * torch.rand(n, generator=g)
    act = (torch.rand(n, generator=g) > 0.1).to(torch.int32)
    rays = [x.contiguous().to(dev) for x in (*o.T, *d.T, pdf)] + [act.to(dev)]
    for lite in (False, True):
        before = kernels.trace_interact.launches
        got = kernels.trace_interact(table, rays, lite)
        assert kernels.trace_interact.launches == before + 1
        want = bounce.trace_interact_plain(table, rays, lite)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.dtype == torch.int32:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kind", [("cbox", "lcg"), ("sphere", "pmj02bn"),
                                       ("bigsphere", "pmj02bn")])
def test_direct_matches_plain(dev, name, kind):
    """64x64, 8 spp: mean abs diff <= 1e-6, 99.9% of pixels within 1e-5."""
    s = _direct_scene(dev, name, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 2)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    before = kernels.direct.launches
    got = kernels.direct(tb, lanes, mat)
    assert kernels.direct.launches == before + 1
    want = dr.render_direct_plain(tb, lanes, mat)
    torch.cuda.synchronize()
    diff = (got - want).abs().amax(0) / 8
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.999
    assert int(kernels.direct.tests) >= lanes.shape[1] * 8 * tb.scene.shape[0]


@pytest.mark.parametrize("name", ["cbox", "sphere", "bigsphere"])
def test_direct_grad_matches_plain_backward(dev, name):
    """64x64, 8 spp, a random adjoint: per-channel sums within rtol 1e-5,
    texels past 1e-3 of the largest gradient within rtol 1e-4 (float
    atomics); the kernel's radiance equals direct's bit for bit."""
    s = _direct_scene(dev, name)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 3)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    before = kernels.direct_grad.launches
    got, acc = kernels.direct_grad(tb, lanes, mat, le)
    assert kernels.direct_grad.launches == before + 1
    fwd = kernels.direct(tb, lanes, mat)
    want, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    torch.cuda.synchronize()
    assert torch.equal(acc, fwd)
    torch.testing.assert_close(got.double().sum((0, 1)), want.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((got - want).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


def test_scene_direct_backward_launches_the_direct_kernels(dev):
    """The default integrator: render + backward launch direct and
    direct_grad once each and no plain version."""
    s = _direct_scene(dev, "sphere")
    mat = _material(dev).requires_grad_()
    before = (kernels.direct.launches, kernels.direct_grad.launches)
    calls = (dr.direct_sample_plain.calls, bounce.trace_interact_plain.calls,
             bounce.shade_plain.calls)
    s.render(mat, res=(32, 32), spp=4, seed=1)[..., :3].sum().backward()
    assert (kernels.direct.launches, kernels.direct_grad.launches) == (
        before[0] + 1, before[1] + 1)
    assert (dr.direct_sample_plain.calls, bounce.trace_interact_plain.calls,
            bounce.shade_plain.calls) == calls
    assert bool(torch.isfinite(mat.grad).all()) and float(mat.grad.abs().max()) > 0
