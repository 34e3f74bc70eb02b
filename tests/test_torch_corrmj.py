"""The samplers the port took last: corrmj (the JAX loop kernel's sampler
kind 3, and its generic class) and pmj02bn at a spp that is no power of
two, through every integrator, against the JAX package's fused="force"
routes (path_fused.py, direct_fused.py, collocated_fused.py, with
pallas_bounce.py's kernels in Pallas interpret mode), and the kernels'
per-lane code (the g++ builds of their kGen instantiations) against the
plain versions, on inputs made from a seed with numpy.

At a corrmj spp that is no square, on a grid side that is no power of two
(12 here), some row strata pass the grid and the JAX package's rejection
loop never ends on them; the JAX reference then runs with that loop stopped
at the port's bound (test_torch_samplers._jax_permutation_bounded, exact on
every lane the JAX loop finishes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_collocated import SPHERE_CAM
from test_torch_direct import _host_direct, _rel
from test_torch_grad_host import _host_grad
from test_torch_loop import CAM, _assert_carry_close, _material
from test_torch_samplers import _jax_permutation_bounded, row_can_stall

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light, make_uv_sphere
from zdr_tpu.samplers import corrmj as jcmj

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import collocated as co
from zdr_tpu_torch.integrators import path_loop as pl
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

RES, SEED = (16, 16), 3


@pytest.fixture
def bounded(monkeypatch):
    """-> f(sampler, spp): bounds JAX's corrmj permutation where it can stall."""
    def at(sampler, spp):
        if sampler == "corrmj" and row_can_stall(spp):
            monkeypatch.setattr(jcmj, "permutation_element", _jax_permutation_bounded)
    return at


_JAX = {}


def _jax_scene(integrator, sampler, name="cbox"):
    """The JAX Scene on its fused route, built once a file per
    (integrator, sampler, name); exact splats."""
    key = (integrator, sampler, name)
    if key not in _JAX:
        if name == "cbox":
            s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                      integrator=integrator, sampler=sampler)
            cam = CAM
        else:
            s = Scene([(make_uv_sphere(0.5, 8, 16), None, None)], integrator=integrator,
                      sampler=sampler)
            cam = SPHERE_CAM
        s.camera = Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                          target=float3(*cam["target"]))
        s.fused, s.packed_splat, s.splat_merge = "force", False, 1
        _JAX[key] = s
    return _JAX[key]


def _port_scene(integrator, sampler, name="cbox", accel="bruteforce"):
    if name == "cbox":
        s = zt.Scene([(tproc.make_cornell_box(), None, None),
                      (tproc.make_cornell_light(), None, 15.0)], integrator, accel, sampler,
                     device="cpu")
        s.camera = zt.Camera(**CAM)
    else:
        s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None)], integrator, accel,
                     sampler, device="cpu")
        s.camera = zt.Camera(**SPHERE_CAM)
    return s


@pytest.mark.parametrize("integrator,sampler,spp,name", [
    ("path", "corrmj", 4, "cbox"), ("path", "corrmj", 12, "cbox"),
    ("path", "pmj02bn", 12, "cbox"), ("direct", "corrmj", 12, "cbox"),
    ("collocated", "corrmj", 12, "sphere")])
def test_render_matches_jax_fused(integrator, sampler, spp, name, bounded):
    """Scene(device="cpu").render against the JAX Scene with fused="force"
    at 16x16, seed 3, at the golden bar (atol 2e-4, rtol 1e-4): corrmj at 4
    spp (both of its permutations' loop-free form) and at 12 (grid side 3:
    the rejection loops, and row strata past the grid), pmj02bn at 12."""
    bounded(sampler, spp)
    mat = _material(seed=1)
    want = np.asarray(_jax_scene(integrator, sampler, name).render(
        jnp.asarray(mat), res=RES, spp=spp, seed=SEED))
    got = _port_scene(integrator, sampler, name).render(
        torch.as_tensor(mat), res=RES, spp=spp, seed=SEED).numpy()
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_path_backward_matches_jax_vjp():
    """corrmj at 4 spp (the JAX loop kernel's sampler kind 3), the cornell
    box, 16x16, roughness in [0.5, 0.9]: the gradient of loss =
    sum(image[..., :3] * w) through loss.backward() against jax.vjp's
    (fused="force", packed_splat=False, splat_merge=1) at max|a - b| /
    max|a| < 1e-5 (measured 4.1e-6). The splat corner comes from corrmj's
    salt, so a wrong salt moves this gradient and no image. (At 12 spp, seed
    3, one tap of the walk lies 2.8e-5 from a corner's bound in u, and a uv
    that differs by ~2e-6 between torch and XLA sends it to the diagonal
    corner: CHANGES.md.)"""
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(0.5, 0.9, (16, 16))
    js = _jax_scene("path", "corrmj")
    want, vjp = jax.vjp(lambda m: js.render(m, res=RES, spp=4, seed=SEED), jnp.asarray(mat))
    cot = np.zeros((16, 16, 4), np.float32)
    cot[..., :3] = w
    (want_g,) = vjp(jnp.asarray(cot))
    tmat = torch.as_tensor(mat).requires_grad_()
    img = _port_scene("path", "corrmj").render(tmat, res=RES, spp=4, seed=SEED)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    assert _rel(np.asarray(want_g), tmat.grad.numpy()) < 1e-5


@pytest.mark.parametrize("sampler,spp", [("corrmj", 12), ("corrmj", 16), ("pmj02bn", 12)])
def test_host_path_loop_matches_plain(sampler, spp):
    """The path kernels' kGen instantiation (path_loop_step.cuh, g++):
    loop_step from the same carry for 8 steps at 12x12, the sampler's three
    rows equal; then the whole forward, and the tap mode's gradient against
    the plain backward (channel sums rtol 1e-5, texels rtol 1e-4, the bars
    of the card's checks). sinf/cosf of glibc and torch differ by ulps."""
    lib = kernels.load_host_library()
    s = _port_scene("path", sampler)
    mat = torch.as_tensor(_material(seed=1))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((12, 12), spp), 5)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    tables = kernels.pack_tables(tb)
    params = kernels.loop_params(tb, mat)
    assert lib.zdr_gen_sampler_host(params) == 1
    assert lib.zdr_gen_sampler_host(kernels.pack_params("pmj02bn", 16, 0)) == 0

    def host(carry, n_steps):
        f, i = torch.empty_like(carry.f), torch.empty_like(carry.i)
        rc = lib.zdr_path_loop_host(
            params, tables.data_ptr(), tables.numel(), tb.bn.data_ptr(), mat.data_ptr(),
            lanes.data_ptr(), carry.f.data_ptr(), carry.i.data_ptr(), f.data_ptr(),
            i.data_ptr(), lanes.shape[1], n_steps)
        assert rc == 0
        return pl.Carry(f, i)

    carry = pl.init_carry(lanes)
    for _ in range(8):
        want = pl.loop_step(carry, tb, lanes, mat)
        _assert_carry_close(host(carry, 1), want)
        carry = want
    smp2 = want.i[pl.I_IDX["smp2"]]
    assert bool((smp2 != 0).any()) == (sampler == "corrmj")
    full = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    got = host(pl.init_carry(lanes), tb.n_steps)
    np.testing.assert_array_equal(got.i[0].numpy(), full.i[0].numpy())
    assert float((got.f[0:3] - full.f[0:3]).abs().max(dim=0).values.mean()) <= 1e-6

    le_grad = torch.as_tensor(np.random.RandomState(6).uniform(0.5, 1.5, (3, lanes.shape[1]))
                              .astype(np.float32))
    g_host, _ = _host_grad(tb, lanes, mat, le_grad)
    g_plain, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le_grad, tb.n_steps)
    assert float(g_plain.abs().max()) > 0
    np.testing.assert_allclose(g_host.sum((0, 1)).numpy(), g_plain.sum((0, 1)).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g_host.numpy(), g_plain.numpy(), rtol=1e-4,
                               atol=1e-4 * float(g_plain.abs().max()))


def _host_collocated(tb, lanes, mat, le_grad=None):
    """zdr_collocated_host by the dense sweep -> (acc (3, N), grad)."""
    n = lanes.shape[1]
    acc, grad = torch.empty((3, n)), torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    tables = kernels.pack_tables(tb)
    rc = kernels.load_host_library().zdr_collocated_host(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), None if le_grad is None else le_grad.data_ptr(),
        acc.data_ptr(), grad.data_ptr(), counts.data_ptr(), n, None, None, 0, 0)
    assert rc == 0
    return acc, grad


@pytest.mark.parametrize("integrator", ["direct", "collocated"])
def test_host_direct_and_collocated_match_plain(integrator):
    """The direct and collocated kernels' kGen instantiations (g++), on the
    cornell box and on the 8 x 16 sphere, with corrmj at 12 spp, 12x12: the forward's sums of
    clamped radiance and the tap mode's gradient against the plain
    versions, at the card's bars."""
    s = _port_scene(integrator, "corrmj", "cbox" if integrator == "direct" else "sphere")
    mat = torch.as_tensor(_material(seed=2))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((12, 12), 12), 7)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le_grad = torch.as_tensor(np.random.RandomState(8).uniform(0.5, 1.5, (3, lanes.shape[1]))
                              .astype(np.float32))
    if integrator == "direct":
        from zdr_tpu_torch.integrators import direct as dr

        acc, grad = _host_direct(tb, lanes, mat)[0], _host_direct(tb, lanes, mat, le_grad)[1]
        want = dr.render_direct_plain(tb, lanes, mat)
        want_g = dr.render_direct_backward_plain(tb, lanes, mat, le_grad)[0]
    else:
        acc, grad = _host_collocated(tb, lanes, mat)[0], _host_collocated(tb, lanes, mat,
                                                                          le_grad)[1]
        want = co.render_collocated_plain(tb, lanes, mat)
        want_g = co.render_collocated_backward_plain(tb, lanes, mat, le_grad)[0]
    assert float(want.abs().max()) > 0 and float(want_g.abs().max()) > 0
    np.testing.assert_allclose(acc.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(grad.sum((0, 1)).numpy(), want_g.sum((0, 1)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want_g.abs().max()))


@pytest.mark.parametrize("integrator", ["path", "direct", "collocated"])
def test_dense_and_bvh_routes_are_equal(integrator):
    """corrmj at 12 spp on the cornell box, by the dense sweep and forced
    through the BVH: images and texture gradients bit for bit (the path
    integrator at 4x4: its plain BVH walk is the slow one)."""
    mat = _material(seed=5)
    res = (4, 4) if integrator == "path" else (8, 8)
    out = []
    for accel in ("bruteforce", "bvh"):
        tmat = torch.as_tensor(mat).requires_grad_()
        img = _port_scene(integrator, "corrmj", accel=accel).render(
            tmat, res=res, spp=12, seed=1)
        img[..., :3].sum().backward()
        out.append((img.detach(), tmat.grad))
    assert float(out[0][0][..., :3].max()) > 0 and float(out[0][1].abs().max()) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
