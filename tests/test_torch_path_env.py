"""The path integrator under an environment map (the env terms of
zdr_tpu_torch/integrators/path_loop.loop_step and the kEnv instantiations of
kernels/csrc/path_loop.cu / path_loop_grad.cu) against the JAX package's
route for path + env: path_fused.py with pallas_bounce.py's kernels in
Pallas interpret mode (fused="force"), on inputs made from a seed with
numpy. Also the Scene API's shape against JAX's: the positional order of
Scene's arguments and add_envmap of a path.

make_test_envmap()'s default 64 x 128 is built once per module, by the
port, and both packages' scenes take those tables (they equal JAX's bit for
bit: tests/test_torch_envmap_tables.py); both stop paths at max_depth 4.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_direct import _rel
from test_torch_envmap import _env_img
from test_torch_loop import CAM, _assert_carry_close, _material

import zdr_tpu.scene as jscene
from zdr_tpu import Camera, Scene, float3
from zdr_tpu import envmap as jenv
from zdr_tpu.geometry.procedural import (
    make_cornell_box,
    make_cornell_light,
    make_uv_sphere,
)

import zdr_tpu_torch as zt
import zdr_tpu_torch.scene as tscene
from zdr_tpu_torch import envmap as tenv
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import path_loop as pl
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

MAX_DEPTH = 4
RES, SPP, SEED = (16, 16), 2, 3
SPHERE_CAM = dict(fov=50 / 180 * np.pi, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))


_TABLES = {}


def _port_build(img, compensate_mis=True, device="cpu"):
    """The port's envmap of `img`, built once per module on the CPU."""
    img = np.asarray(img, np.float32)
    key = (img.shape, img.tobytes(), bool(compensate_mis))
    if key not in _TABLES:
        _TABLES[key] = tenv.build_envmap(img, compensate_mis)
    return _TABLES[key]


def _jax_build(img, compensate_mis=True):
    """JAX's EnvMap of the same tables."""
    import jax.numpy as jnp

    e = _port_build(img, compensate_mis)
    return jenv.EnvMap(texture=jnp.asarray(e.texture.numpy()),
                       alias_prob=jnp.asarray(e.alias_prob.numpy()),
                       alias_idx=jnp.asarray(e.alias_idx.numpy()),
                       pdf=jnp.asarray(e.pdf.numpy()))


@pytest.fixture(autouse=True)
def _one_build(monkeypatch):
    monkeypatch.setattr(jscene, "build_envmap", _jax_build)
    monkeypatch.setattr(tscene, "build_envmap", _port_build)


def _jax_scene(name, sampler, point_light=False):
    """The JAX Scene on its route for path + env (fused="force", exact
    splats) under make_test_envmap()."""
    if name == "cbox":
        s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                  integrator="path", sampler=sampler)
        cam = CAM
    else:
        s = Scene([(make_uv_sphere(0.5, 8, 16), None, None)], integrator="path",
                  sampler=sampler)
        cam = SPHERE_CAM
    s.camera = Camera(fov=cam["fov"], origin=float3(*cam["origin"]),
                      target=float3(*cam["target"]))
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), 6.0)
    s.add_envmap(_env_img())
    s.fused, s.packed_splat, s.splat_merge = "force", False, 1
    s.max_depth = MAX_DEPTH
    return s


def _port_scene(name, sampler, point_light=False, accel="auto"):
    """The port's counterpart of _jax_scene on the CPU: the cornell box by
    the dense route (14 triangles, below DENSE_MAX_TRIS["path"]), the sphere
    (224 triangles) through the BVH."""
    if name == "cbox":
        s = zt.Scene([(tproc.make_cornell_box(), None, None),
                      (tproc.make_cornell_light(), None, 15.0)],
                     "path", accel, sampler, device="cpu")
        s.camera = zt.Camera(**CAM)
    else:
        s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None)], "path", accel,
                     sampler, device="cpu")
        s.camera = zt.Camera(**SPHERE_CAM)
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), 6.0)
    s.add_envmap(_env_img())
    s.max_depth = MAX_DEPTH
    return s


@pytest.mark.parametrize("name", ["cbox", "sphere"])
def test_render_matches_jax_fused_path_under_env(name):
    """Scene(integrator="path", device="cpu") with add_envmap against the JAX
    Scene with fused="force" at 16x16, 2 spp, seed 3, pmj02bn, at the golden
    bar (atol 2e-4, rtol 1e-4): the cornell box with its light under the
    env (env + mesh), and the env-only sphere of 8 x 16 (apps/example.py's
    workflow, tests/test_fused.py:421-432: the env is the only light, and
    the port walks the sphere's BVH). The lcg case with a point light is
    test_backward_matches_jax_vjp_under_env's image."""
    import jax.numpy as jnp

    mat = _material(seed=1)
    js = _jax_scene(name, "pmj02bn")
    want = np.asarray(js.render(jnp.asarray(mat), res=RES, spp=SPP, seed=SEED))
    ts = _port_scene(name, "pmj02bn")
    assert (ts._render_data("path").accel is None) == (name == "cbox")
    got = ts.render(torch.as_tensor(mat), res=RES, spp=SPP, seed=SEED).numpy()
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_backward_matches_jax_vjp_under_env():
    """The cornell box with its light and a point light under the env (env
    + point + mesh), lcg, 16x16, 2 spp, seed 3, roughness in [0.5, 0.9]:
    the image against the JAX Scene's (fused="force", packed_splat=False,
    splat_merge=1) at atol 2e-4 and rtol 1e-4, and the gradient of loss =
    sum(image[..., :3] * w) through loss.backward() against jax.vjp's at
    max|a - b| / max|a| < 1e-5 (the bar at which JAX holds its one-walk loop
    backward against its two-walk fused one)."""
    import jax
    import jax.numpy as jnp

    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(0.5, 0.9, (16, 16))
    js = _jax_scene("cbox", "lcg", point_light=True)
    want, vjp = jax.vjp(lambda m: js.render(m, res=RES, spp=SPP, seed=SEED), jnp.asarray(mat))
    cot = np.zeros((16, 16, 4), np.float32)
    cot[..., :3] = w
    (want_g,) = vjp(jnp.asarray(cot))
    ts = _port_scene("cbox", "lcg", point_light=True)
    assert ts._data.meta.n_env == 1 and ts._data.meta.n_point == 1
    tmat = torch.as_tensor(mat).requires_grad_()
    calls = pl.render_path_backward_loop_plain.calls
    img = ts.render(tmat, res=RES, spp=SPP, seed=SEED)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert pl.render_path_backward_loop_plain.calls == calls + 1
    assert np.asarray(want)[..., :3].max() > 0 and np.abs(want_g).max() > 0
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    assert _rel(np.asarray(want_g), tmat.grad.numpy()) < 1e-5


def test_dense_and_bvh_routes_are_equal_under_env():
    """The cornell box with its light under the env, by the dense sweep and
    forced through the BVH (accel="bvh" below DENSE_MAX_TRIS["path"]): the
    images and the texture gradients equal bit for bit."""
    mat = _material(seed=5)
    out = []
    for accel in ("bruteforce", "bvh"):
        s = _port_scene("cbox", "pmj02bn", accel=accel)
        assert (s._render_data("path").accel is None) == (accel == "bruteforce")
        tmat = torch.as_tensor(mat).requires_grad_()
        img = s.render(tmat, res=(12, 12), spp=2, seed=1)
        img[..., :3].sum().backward()
        out.append((img.detach(), tmat.grad))
    assert float(out[0][0][..., :3].max()) > 0 and float(out[0][1].abs().max()) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_scene_takes_jax_positional_order():
    """Scene(models, "path", "bvh", "lcg") puts the integrator, accel and
    sampler where the JAX package's Scene puts them (zdr_tpu/scene.py:96-102);
    the device is the port's keyword."""
    models = [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)]
    js = Scene(models, "path", "bvh", "lcg")
    ts = zt.Scene([(tproc.make_cornell_box(), None, None),
                   (tproc.make_cornell_light(), None, 15.0)], "path", "bvh", "lcg",
                  device="cpu")
    assert (ts.integrator, ts.accel, ts.sampler) == ("path", "bvh", "lcg")
    assert (js.integrator, js._data.accel.method, js.sampler) == (ts.integrator, ts.accel,
                                                                 ts.sampler)
    assert ts._data.accel is not None and ts._data.accel.is_bvh
    with pytest.raises(TypeError):
        zt.Scene(models, "path", "bvh", "lcg", "cpu")


def test_add_envmap_reads_a_path_as_jax_does(tmp_path, monkeypatch):
    """add_envmap of a file path reads it with imageio as JAX's does
    (zdr_tpu/scene.py:225-228): both packages hand build_envmap the same
    array (a 3-channel uint8 PNG, given alpha 1)."""
    import imageio.v2 as imageio

    path = str(tmp_path / "env.png")
    rgb = np.random.RandomState(6).randint(0, 256, (4, 8, 3)).astype(np.uint8)
    imageio.imwrite(path, rgb)
    seen = {}

    def record(tag):
        def build(img, *args, **kw):
            seen[tag] = np.array(img)
            return None
        return build

    monkeypatch.setattr(jscene, "build_envmap", record("jax"))
    monkeypatch.setattr(tscene, "build_envmap", record("port"))
    Scene([(make_cornell_box(), None, None)], integrator="path").add_envmap(path)
    s = zt.Scene([(tproc.make_cornell_box(), None, None)], "path", device="cpu")
    s.add_envmap(path)
    assert s._data.meta.n_env == 1
    assert seen["port"].dtype == np.float32 and seen["port"].shape == (4, 8, 4)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(seen["port"][..., :3], rgb.astype(np.float32))


# ------------------------------------------------- the g++ build of the kernels' code

def _host_env(tb, lanes, mat, carry, n_steps, le=None):
    """zdr_path_loop_env_host: the kernels' env instantiations built with g++
    -> (the carry after n_steps, the gradient or None, counts)."""
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    cpu = torch.device("cpu")
    tables, params = kernels.pack_tables(tb), kernels.loop_params(tb, mat)
    f_out, i_out = torch.empty_like(carry.f), torch.empty_like(carry.i)
    k_near = min(kernels.GRAD_NEAR_ROWS["bvh" if tb.bvh is not None else "dense"], tb.max_depth)
    far = torch.empty((tb.max_depth - k_near, kernels.GRAD_ROW_PLANES, n))
    grad = torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    bvh = (None, None, 0, 0) if tb.bvh is None else kernels.bvh_args(tb.bvh, cpu)
    rc = lib.zdr_path_loop_env_host(
        params, tables.data_ptr(), tables.numel(), 1, tb.bn.data_ptr(), mat.data_ptr(),
        lanes.data_ptr(), None if le is None else le.data_ptr(), carry.f.data_ptr(),
        carry.i.data_ptr(), f_out.data_ptr(), i_out.data_ptr(), far.data_ptr(),
        grad.data_ptr(), n, n_steps, k_near, *bvh, counts.data_ptr(),
        *kernels.env_args(tb.env, cpu))
    assert rc == 0
    return pl.Carry(f_out, i_out), (None if le is None else grad), counts.tolist()


@pytest.mark.parametrize("accel", ["bruteforce", "bvh"])
def test_host_path_env_matches_plain(accel):
    """The g++ build of the env instantiations of the path kernels
    (path_loop_step.cuh loop_step<kGrad, Tracer, kEnv = true>) on the
    cornell box with its light and a point light under the env, by the
    dense sweep and through the BVH, 16x16, 4 spp, roughness in [0.5, 0.9],
    a random adjoint: each of 6 steps against loop_step from the same carry
    (tests/test_torch_loop.py's bars), and the whole render within mean abs
    diff 1e-6 with 99% of pixels within 1e-5, the bar of the other host
    builds: glibc's sinf, acosf and atan2f and torch's differ by ulps
    (measured: 59 of 256 lanes differ, by at most 2.9e-6; the card's build
    is bit for bit, chip_smoke.py phase 19). The BVH walk's render equals
    the dense sweep's bit for bit; the gradient within max|a - b| / max|a| <
    1e-5, the tap mode's radiance and counts equal to the forward's."""
    s = _port_scene("cbox", "pmj02bn", point_light=True, accel=accel)
    mat = _material(seed=6)
    mat[..., 3] = np.random.RandomState(7).uniform(0.5, 0.9, mat.shape[:2])
    mat = torch.as_tensor(mat)
    tb = pl.build_loop_tables(s._render_data("path"), s.camera, s._config((16, 16), 4), 11)
    assert (tb.bvh is not None) == (accel == "bvh") and tb.env is not None
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    carry = pl.init_carry(lanes)
    for _ in range(6):
        want = pl.loop_step(carry, tb, lanes, mat)
        _assert_carry_close(_host_env(tb, lanes, mat, carry, 1)[0], want)
        carry = want
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    got, _g, counts = _host_env(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want_g, want_carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    assert torch.equal(want_carry.f[0:3], want.f[0:3])
    np.testing.assert_array_equal(got.i[0].numpy(), want.i[0].numpy())
    diff = (got.f[0:3] - want.f[0:3]).abs().amax(0) / tb.spp
    assert float(diff.mean()) <= 1e-6 and float((diff <= 1e-5).float().mean()) >= 0.99
    if accel == "bvh":
        dense = dataclasses.replace(tb, bvh=None)
        got_dense = _host_env(dense, lanes, mat, pl.init_carry(lanes), tb.n_steps)[0]
        assert torch.equal(got.f, got_dense.f) and torch.equal(got.i, got_dense.i)
    g_carry, grad, g_counts = _host_env(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps, le)
    assert torch.equal(g_carry.f[0:3], got.f[0:3]) and g_counts == counts
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5
