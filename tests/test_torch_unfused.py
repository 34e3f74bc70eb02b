"""The port's unfused estimators (zdr_tpu_torch/integrators/path.py,
path_persistent.py, the unfused direct_estimator / direct_backward and
collocated_estimator / collocated_backward, lights.py, interaction.py and
texture.read_bsdf), which Scene.render takes with fused = False, nearest
filtering, a material under 2x2 or the direct integrator without MIS: the
goldens, the PRB walk against torch.autograd of the forward estimator, the
walk against the plain loop of the kernel route, the routing, and the C3
repair of the kernels' roughness derivative. Port only; the comparisons
with the JAX package are in test_torch_unfused_jax.py. Tolerances are
stated at each test."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.envmap import make_test_envmap
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import get_integrator
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.wrapper import (kernel_route, pixel_grid, render_forward_rays,
                                               render_grad_rays, with_accel)
from zdr_tpu_torch.microfacet import ggx_brdf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BOX_CAM = dict(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))
SPHERE_CAM = dict(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A module's torch on one thread (the port's test files import this
    autouse fixture): the test runner's workers share the CPU's cores, and
    a thread pool in each oversubscribes them (this module ran 3x slower so
    beside six busy processes: 78 s against 25)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checker(res=16):
    y, x = np.mgrid[0:res, 0:res]
    c = ((x // 4 + y // 4) % 2).astype(np.float32)
    return np.stack([0.2 + 0.6 * c, 0.7 - 0.5 * c, 0.4 * np.ones_like(c), 0.3 + 0.4 * c], -1)


def _material(res=16, seed=0, lo=0.2):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, size=(res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(lo, 0.9, size=(res, res))
    return torch.as_tensor(mat)


def _cbox(integrator, sampler="pmj02bn"):
    s = zt.Scene([(tproc.make_cornell_box(), None, None),
                  (tproc.make_cornell_light(), None, 15.0)], integrator=integrator,
                 sampler=sampler, device="cpu")
    s.camera = zt.Camera(**BOX_CAM)
    return s


def _sphere(integrator, env=False):
    s = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator=integrator,
                 accel="bruteforce", device="cpu")
    if env:
        s.add_envmap(make_test_envmap())
    s.camera = zt.Camera(**SPHERE_CAM)
    return s


def _grad_close(got, want, sums_rtol=1e-5, texel_rtol=1e-4):
    """Phase 7's bars of chip_smoke.py by default: per-channel sums within
    rtol 1e-5, and every texel whose gradient (largest |channel|) passes
    1e-3 of the largest within rtol 1e-4 of it."""
    np.testing.assert_allclose(got.sum((0, 1)), want.sum((0, 1)), rtol=sums_rtol)
    mag = np.abs(want).max(-1)
    big = mag > 1e-3 * mag.max()
    assert big.sum() > 10
    rel = np.abs(got - want).max(-1)[big] / mag[big]
    assert rel.max() <= texel_rtol, rel.max()


@pytest.mark.parametrize("name", ["collocated_sphere", "direct_cbox", "path_cbox",
                                  "direct_env_sphere"])
def test_goldens_through_the_unfused_route(name):
    """tools/gen_golden.py's four scenes (checker material, 32x32, 16 spp,
    seed 7; the JAX package's unfused estimators on the CPU) with
    scene.fused = False, at the golden bar: atol 2e-4, rtol 1e-4."""
    integrator = name.split("_")[0]
    s = _cbox(integrator) if name.endswith("cbox") else _sphere(integrator, env="env" in name)
    s.fused = False
    mat = torch.as_tensor(_checker())
    assert not kernel_route(s._config((32, 32), 16), mat)
    got = s.render(mat, res=(32, 32), spp=16, seed=7).numpy()
    expected = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    np.testing.assert_allclose(got, expected, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("bilinear", [True, False])
def test_prb_equals_autograd_of_the_estimator(bilinear):
    """tests/test_prb_algebra.py's gate on the port: the cornell box at
    24x24, 8 spp, seed 3, max_depth 3, rr_depth 99 (the roulette out of
    play), the per-sample walk (persistent=False) with the exact splat
    (stochastic_splat=False): path_backward against torch.autograd of
    path_estimator on the same stream, diffuse channels within 1e-5 of the
    largest (the JAX package's measured 1.6e-6 for its bilinear case).
    Under nearest filtering too: the port's backward splats to the texel
    the forward read, so the PRB walk stays the derivative of its forward
    (the JAX package's splats to the bilinear corners there and is 0.12
    off; README "Differences")."""
    s = _cbox("path")
    s.rr_depth, s.max_depth, s.bilinear = 99, 3, bilinear
    cfg = dataclasses.replace(s._config((24, 24), 8), persistent=False, stochastic_splat=False,
                              fused=False)
    mat = _material(24, seed=0, lo=0.25)
    data, coords = with_accel(s._render_data("path")), pixel_grid((24, 24), "cpu")
    le = torch.full((24 * 24, 3), 1.0 / 8)
    estimator, backward = get_integrator("path")
    g_prb = render_grad_rays(data, mat, s.camera, 3, le, cfg, estimator, backward, coords)
    g_pure = render_grad_rays(data, mat, s.camera, 3, le, cfg, estimator, None, coords)
    scale = float(g_pure[..., :3].abs().max())
    assert scale > 0
    rel = float((g_prb[..., :3] - g_pure[..., :3]).abs().max()) / scale
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("sampler", ["lcg", "pmj02bn", "corrmj"])
def test_walk_matches_the_plain_loop(sampler):
    """The persistent walk (fused = False) against the kernel route's plain
    version (path_loop.render_path_loop_plain and its backward, which the
    kernels' wrappers run on the CPU) on the cornell box at 16x16, 4 spp,
    seed 1: the same stream, salts and taps; the image at the golden bar
    (atol 2e-4, rtol 1e-4); the texture gradient of loss = sum(image[...,
    :3]) with per-channel sums within rtol 3e-5 and texels within rtol 3e-4,
    three times phase 7's bars (1e-5, 1e-4), which this pair misses: the
    two backwards take a bounce's remaining radiance differently, the loop
    as a suffix sum of the later bounces, the walk as Le less the earlier
    ones, and round differently. Measured: sums 9.0e-6 / 1.47e-5 / 2.3e-6
    and worst texels 1.29e-4 (1 of 211 past 1e-4) / 3.9e-5 / 2.7e-5 for
    lcg / pmj02bn / corrmj."""
    s = _cbox("path", sampler)
    out = {}
    for fused in ("auto", False):
        s.fused = fused
        mat = _material(16, seed=2).requires_grad_()
        calls = pl.render_path_loop_plain.calls
        img = s.render(mat, res=(16, 16), spp=4, seed=1)
        img[..., :3].sum().backward()
        assert (pl.render_path_loop_plain.calls > calls) == (fused == "auto")
        out[fused] = (img.detach().numpy(), mat.grad.numpy())
    np.testing.assert_allclose(out[False][0], out["auto"][0], atol=2e-4, rtol=1e-4)
    _grad_close(out[False][1], out["auto"][1], sums_rtol=3e-5, texel_rtol=3e-4)


def test_persistent_walk_equals_the_per_sample_walk():
    """The persistent forward and backward against the per-sample walk
    (path_estimator and path_backward over each sample, persistent=False)
    at 8x8, 4 spp: the same sample streams and splat salts, so the image
    and the stochastic-splat gradient agree to summation order (image atol
    1e-6; gradient within 1e-5 of its largest texel)."""
    s = _cbox("path")
    cfg = dataclasses.replace(s._config((8, 8), 4), fused=False)
    mat = _material(16, seed=6)
    data, coords = with_accel(s._render_data("path")), pixel_grid((8, 8), "cpu")
    le = torch.as_tensor(np.random.RandomState(1).uniform(0, 1, (64, 3)).astype(np.float32))
    estimator, backward = get_integrator("path")
    out = []
    for persistent in (True, False):
        c = dataclasses.replace(cfg, persistent=persistent)
        out.append((render_forward_rays(data, mat, s.camera, 5, c, estimator, coords),
                    render_grad_rays(data, mat, s.camera, 5, le, c, estimator, backward, coords)))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(), atol=1e-6)
    scale = float(out[1][1].abs().max())
    assert float((out[0][1] - out[1][1]).abs().max()) <= 1e-5 * scale


def test_routing_and_the_scope_gates():
    """Nearest filtering, a material under 2x2, fused = False and direct
    without MIS take the unfused estimators around the trace kernels
    (integrators.wrapper.kernel_route); fused "auto" and "force" keep the
    kernel routes; an unknown fused value raises; the splat knobs (A17)
    render by the unfused walk, and its gradient follows them."""
    s = _cbox("direct")
    mat = torch.full((8, 8, 4), 0.5)
    cfg = s._config((4, 4), 1)
    assert kernel_route(cfg, mat)
    assert kernel_route(dataclasses.replace(cfg, fused="force"), mat)
    for c, m in ((dataclasses.replace(cfg, fused=False), mat),
                 (dataclasses.replace(cfg, bilinear=False), mat),
                 (dataclasses.replace(cfg, use_mis=False), mat), (cfg, mat[:1])):
        assert not kernel_route(c, m)
    calls = kernels.trace_closest.launches
    s.use_mis = False
    img = s.render(mat, res=(4, 4), spp=1)
    assert bool(torch.isfinite(img).all())
    s.use_mis = True
    assert bool(torch.isfinite(s.render(torch.full((1, 1, 4), 0.5), res=(4, 4), spp=1)).all())
    assert kernels.trace_closest.launches == calls  # the CPU runs the plain traces
    s.fused = "bogus"
    with pytest.raises(ValueError, match="fused"):
        s.render(mat, res=(4, 4), spp=1)
    s.integrator, s.fused = "path", False
    grads = []
    for merge in (1, 4):
        s.splat_merge = merge
        m = mat.clone().requires_grad_(True)
        img = s.render(m, res=(4, 4), spp=2)
        img[..., :3].sum().backward()
        assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(m.grad).all())
        grads.append(m.grad)
    assert not torch.equal(grads[0], grads[1])


def _ieee_sqrt():
    """torch.sqrt correctly rounded, as on the card, with torch's own
    backward (grad / (2 * result)): torch's vectorised CPU sqrt rounds
    a few ulps-near-ties the other way, which the ill-conditioned roughness
    derivative amplifies."""
    sqrt = torch.sqrt

    class Sqrt(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return sqrt(x.double()).float()

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(output)

        @staticmethod
        def backward(ctx, g):
            (r,) = ctx.saved_tensors
            return g / (2 * r)

    return Sqrt.apply


def test_c3_kernel_roughness_derivative_is_torch_funcs(monkeypatch):
    """C3: the g++ build of the kernels' ggx_spec_droughness (the reverse
    chain of ggx_brdf in roughness, kernels/csrc/path_loop_step.cuh) against
    torch.func of the plain microfacet.ggx_brdf on 100,000 random local
    directions, roughness in [0.2, 0.9], random channel cotangents: within
    1e-6 relative at the 99.9th percentile (measured: bit for bit; the
    earlier hand-written form: 1.5e-4), with torch's sqrt correctly rounded
    as the card's. torch's own vectorised CPU sqrt is not, and varies from
    run to run here (two torch.func calls on the same inputs in one process
    differed in 1 of 12 runs): against it the 99.9th percentile read
    2.0e-6, once 0.053."""
    lib = kernels.load_host_library()
    rs = np.random.RandomState(11)
    n = 100_000

    def dirs():
        v = rs.normal(size=(n, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.05
        return torch.as_tensor((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))

    wo, wi = dirs(), dirs()
    rough = torch.as_tensor(rs.uniform(0.2, 0.9, n).astype(np.float32))
    ct = torch.as_tensor(rs.uniform(0.0, 1.0, (n, 3)).astype(np.float32))
    dif = torch.as_tensor(rs.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    wz = wi[:, 2]
    g_spec = ((ct[:, 2] * wz + ct[:, 1] * wz) + ct[:, 0] * wz).contiguous()
    got = torch.empty(n)
    assert lib.zdr_ggx_droughness_host(wo.data_ptr(), wi.data_ptr(), rough.data_ptr(),
                                       g_spec.data_ptr(), got.data_ptr(), n) == 0

    def plain():
        wo3, wi3 = tuple(wo.unbind(1)), tuple(wi.unbind(1))
        _out, vjp = torch.func.vjp(lambda a, b, c, r: ggx_brdf(wo3, wi3, (a, b, c), r),
                                   *dif.unbind(1), rough)
        return vjp(tuple(ct.unbind(1)))[3]

    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt())
    want = plain()
    assert float(((got - want).abs() / want.abs()).quantile(0.999)) <= 1e-6
