"""The port's environment map (zdr_tpu_torch/envmap.py, the env branch of
integrators/path_loop.nee_select, the env terms of integrators/direct.py and
the envmap section of kernels/csrc/path_loop_step.cuh) against the JAX
package's fused route (integrators/fused_glue.py; direct_fused.py with
pallas_bounce.py's kernels in Pallas interpret mode), on inputs made from a
seed with numpy. The tables' bit-for-bit test is
tests/test_torch_envmap_tables.py.

Each envmap is built once per module (a JAX build takes seconds on the CPU):
the scenes' build_envmap is wrapped in a cache for these tests.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_direct import _checker, _jax_scene, _port_scene, _rel
from test_torch_loop import _material

import zdr_tpu.scene as jscene
from zdr_tpu import envmap as jenv
from zdr_tpu.integrators import fused_glue as fg
from zdr_tpu.integrators.pallas_bounce import build_fused_const

import zdr_tpu_torch as zt
import zdr_tpu_torch.scene as tscene
from zdr_tpu_torch import convert, kernels
from zdr_tpu_torch import envmap as tenv
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N = 4096
_BUILT = {}


def _cached(tag, build):
    def cached(img, compensate_mis=True, *args):
        img = np.asarray(img, np.float32)
        key = (tag, img.shape, img.tobytes(), bool(compensate_mis), args)
        if key not in _BUILT:
            _BUILT[key] = build(img, compensate_mis, *args)
        return _BUILT[key]
    return cached


@pytest.fixture(autouse=True)
def _one_build_each(monkeypatch):
    monkeypatch.setattr(jscene, "build_envmap", _cached("jax", jenv.build_envmap))
    monkeypatch.setattr(tscene, "build_envmap", _cached("port", tenv.build_envmap))


def _env_img():
    return jenv.make_test_envmap()


def _port_env():
    return tscene.build_envmap(_env_img(), True, torch.device("cpu"))


def _jax_env():
    return jscene.build_envmap(_env_img(), compensate_mis=True)


def _unit(rs, n):
    d = rs.normal(size=(n, 3))
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1],
             [1e-8, 1, 0], [0, -1, -1e-8]]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_scene_envmap_equals_jax_bit_for_bit():
    """The scenes' envmap, make_test_envmap() (64x128) with the MIS
    compensation, as each package builds it: its tables equal bit for bit
    (tests/test_torch_envmap_tables.py holds the other sizes and modes)."""
    from test_torch_envmap_tables import assert_tables_equal

    assert_tables_equal(_port_env(), _jax_env(), True)


def test_env_lookups_match_fused_glue():
    """On seeded directions, uv and draws: the uv <-> direction maps, the
    bilinear fetch (the port reads texels where the JAX glue reads its
    quad-packed rows), the pdf and the alias draws against fused_glue's
    functions: indices and bins equal, floats within rtol 1e-6 (atol 1e-7;
    acos, atan2, sin and cos of torch and XLA differ by ulps)."""
    rs = np.random.RandomState(0)
    penv, jenv_ = _port_env(), _jax_env()
    d = _unit(rs, N)
    ju, jv = fg._env_direction_to_uv(tuple(jnp.asarray(d[:, k]) for k in range(3)))
    tu, tv = tenv.direction_to_uv(tuple(torch.as_tensor(d[:, k]) for k in range(3)))
    _close(tu, ju)
    _close(tv, jv)
    u = rs.rand(N).astype(np.float32)
    v = rs.rand(N).astype(np.float32)
    u[:4], v[:4] = [0.0, 0.999999, 0.5, 1e-7], [0.0, 0.999999, 1.0, 1e-7]
    jd = fg._env_uv_to_direction(jnp.asarray(u), jnp.asarray(v))
    td = tenv.uv_to_direction(torch.as_tensor(u), torch.as_tensor(v))
    for a, b in zip(td, jd):
        _close(a, b, atol=1e-6)
    tex = np.asarray(jenv_.texture)
    jrad = fg.env_fetch_planes(fg.pack_env_quads(jenv_.texture), tex.shape[:2], jnp.asarray(u),
                               jnp.asarray(v))
    trad = tenv.texture_sample(penv.texture, torch.as_tensor(u), torch.as_tensor(v))
    for a, b in zip(trad, jrad):
        _close(a, b)
    _close(tenv.sampled_light_pdf(penv.pdf, torch.as_tensor(u), torch.as_tensor(v)),
           fg.env_pdf_planes(jenv_.pdf, jnp.asarray(u), jnp.asarray(v)))
    alias = jnp.stack([jenv_.alias_prob, jenv_.alias_idx.astype(jnp.float32)], axis=-1)
    rows = rs.randint(0, tenv.SAMPLE_MAP_H, N)
    for n, offset in ((tenv.SAMPLE_MAP_H, np.zeros(N, np.int64)),
                      (tenv.SAMPLE_MAP_W, tenv.SAMPLE_MAP_H + rows * tenv.SAMPLE_MAP_W)):
        ji, juu = fg._sample_alias_planes(alias, n, jnp.asarray(u), jnp.asarray(offset))
        ti, tuu = tenv.sample_alias(penv, n, torch.as_tensor(u), torch.as_tensor(offset))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tuu, juu)


def test_env_miss_matches_fused_glue():
    """env_miss_add against env_miss_add_planes on seeded directions, BSDF
    pdfs (a fifth of them 1e30, none) and miss flags, with 3 lights: the
    pdf's bins equal, floats within rtol 1e-5 (measured: 4 of 4096 past
    1e-6, at most 2.3e-6, where an ulp of acos or atan2 moves the bilinear
    weights on the sun's steep edge). The bin is truncated from the
    direction's uv, so an ulp at a bin's edge could move it and jump the MIS
    weight; these directions meet no such edge."""
    rs = np.random.RandomState(1)
    penv, jenv_ = _port_env(), _jax_env()
    d = _unit(rs, N)
    pdf = np.where(rs.rand(N) < 0.2, 1e30, rs.uniform(0.05, 20.0, N)).astype(np.float32)
    miss = rs.rand(N) < 0.7
    meta = SimpleNamespace(n_total=3)
    tables = SimpleNamespace(env_pdf=jenv_.pdf, env_quads=fg.pack_env_quads(jenv_.texture))
    want = fg.env_miss_add_planes(meta, tables, tuple(jenv_.texture.shape[:2]),
                                  tuple(jnp.asarray(d[:, k]) for k in range(3)),
                                  jnp.asarray(pdf), jnp.asarray(miss))
    td = tuple(torch.as_tensor(d[:, k]) for k in range(3))
    got = tenv.env_miss_add(penv, td, torch.as_tensor(pdf), torch.as_tensor(miss), 1.0 / 3)
    ju, jv = fg._env_direction_to_uv(tuple(jnp.asarray(d[:, k]) for k in range(3)))
    tu, tv = tenv.direction_to_uv(td)
    for t, j, n in ((tu, ju, tenv.SAMPLE_MAP_W), (tv, jv, tenv.SAMPLE_MAP_H)):
        np.testing.assert_array_equal(tenv._bin(t, n).numpy(),
                                      np.clip((np.asarray(j) * n).astype(np.int32), 0, n - 1))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5)
    assert float(got[0].max()) > 0 and bool((got[0] == 0).any())


class _Draws:
    """A sampler stub that hands out given draws in order, for both
    packages' light selection (JAX's _next2_xy, the port's next2_xy)."""

    def __init__(self, draws, wrap):
        self.draws, self.wrap = list(draws), wrap

    def next1(self):
        return self.wrap(self.draws.pop(0)), self

    def next2_xy(self):
        a, b = self.draws.pop(0), self.draws.pop(0)
        return (self.wrap(a), self.wrap(b)), self

    _next2_xy = next2_xy


def test_light_selection_matches_sample_light_planes():
    """The cornell box with its light, a point light and the env (env +
    point + mesh, 3 choices): nee_select against sample_light_planes on
    seeded shading points and draws. The env comes first (u_sel < 1/3),
    then the point, then the mesh light; an env sample runs to 1e30 with its
    pdf over 3. Floats within rtol 1e-5 (atol 1e-6): the env's sin and cos
    of torch and XLA differ by ulps, and a mesh sample's pdf divides by its
    cosine."""
    rs = np.random.RandomState(2)
    js = _jax_scene("cbox", "lcg", point_light=True)
    js.add_envmap(_env_img())
    ts = _port_scene("cbox", "lcg", point_light=True)
    ts.add_envmap(_env_img())
    meta = js._data.fused_meta
    assert (meta.n_env, meta.n_point, meta.n_lights) == (1, 1, 1)
    _scene_pack, light_pack = build_fused_const(js._data, meta)
    tables = fg.build_glue_tables(js._data, meta, light_pack)
    p = rs.uniform([-2.5, 0.5, -5.4], [2.0, 4.8, -0.6], (N, 3)).astype(np.float32)
    draws = list(rs.rand(4, N).astype(np.float32))
    (jwi, jdist, jpdf, jev), _ = fg.sample_light_planes(
        meta, tables, tuple(js._data.env.texture.shape[:2]),
        tuple(jnp.asarray(p[:, k]) for k in range(3)), _Draws(draws, jnp.asarray))
    tb = pl.build_loop_tables(ts._data, ts.camera, ts._config((8, 8), 1), 0)
    (twi, tdist, tpdf, tev), _ = pl.nee_select(
        tb, tuple(torch.as_tensor(p[:, k]) for k in range(3)), _Draws(draws, torch.as_tensor))
    for a, b in zip((*twi, tdist, tpdf, *tev), (*jwi, jdist, jpdf, *jev)):
        _close(a, b, rtol=1e-5, atol=1e-6)
    kind = np.minimum((draws[0] * 3).astype(int), 2)
    assert set(kind) == {0, 1, 2}
    assert (tdist.numpy()[kind == 0] == 1e30).all() and (tdist.numpy()[kind != 0] < 10).all()


def test_render_matches_jax_fused_direct_under_env():
    """Scene(integrator="direct", device="cpu") with add_envmap against the
    JAX Scene with fused="force" at 16x16, 2 spp, seed 3, the sphere of 8 x
    16 over its quad light (env + mesh): atol 2e-4, rtol 1e-4 (the bar of
    tests/test_torch_direct.py). The cornell box's image is held in
    test_backward_matches_jax_grad_under_env."""
    js = _jax_scene("sphere", "pmj02bn")
    js.add_envmap(_env_img())
    ts = _port_scene("sphere", "pmj02bn")
    ts.add_envmap(_env_img())
    mat = _material(seed=1)
    want = np.asarray(js.render(jnp.asarray(mat), res=(16, 16), spp=2, seed=3))
    got = ts.render(torch.as_tensor(mat), res=(16, 16), spp=2, seed=3).numpy()
    assert want[..., :3].max() > 0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_backward_matches_jax_grad_under_env():
    """The cornell box with its light and a point light under the env (env
    + point + mesh), lcg, 16x16, 2 spp, seed 3, roughness >= 0.5: the image
    against the JAX Scene's (fused="force", packed_splat=False) at atol
    2e-4 and rtol 1e-4, and the gradient of loss = sum(image[..., :3] * w)
    through loss.backward() against jax.vjp's at max|a - b| / max|a| within
    1e-5 (the bars of tests/test_torch_direct.py)."""
    import jax

    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(0.5, 0.9, (16, 16))
    js = _jax_scene("cbox", "lcg", point_light=True)
    js.add_envmap(_env_img())
    want, vjp = jax.vjp(lambda m: js.render(m, res=(16, 16), spp=2, seed=3), jnp.asarray(mat))
    cot = np.zeros((16, 16, 4), np.float32)
    cot[..., :3] = w
    (want_g,) = vjp(jnp.asarray(cot))
    ts = _port_scene("cbox", "lcg", point_light=True)
    ts.add_envmap(_env_img())
    tmat = torch.as_tensor(mat).requires_grad_()
    img = ts.render(tmat, res=(16, 16), spp=2, seed=3)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    assert np.asarray(want)[..., :3].max() > 0 and np.abs(want_g).max() > 0
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    assert _rel(np.asarray(want_g), tmat.grad.numpy()) < 1e-5


def test_golden_direct_env_sphere():
    """tools/gen_golden.py's direct_env_sphere (the JAX package's unfused
    direct integrator on the CPU: the 960-triangle sphere under
    make_test_envmap(), checker material, 32x32, 16 spp, seed 7) at the
    golden bar, atol 2e-4 and rtol 1e-4 (measured: max abs difference
    1.6e-6), by the dense route; the BVH's is the same bit for bit
    (test_dense_and_bvh_routes_are_equal_under_env)."""
    s = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator="direct",
                 accel="bruteforce", device="cpu")
    s.add_envmap(_env_img())
    s.camera = zt.Camera(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    got = s.render(torch.as_tensor(_checker()), res=(32, 32), spp=16, seed=7).numpy()
    expected = np.load(os.path.join(GOLDEN, "direct_env_sphere.npy"))
    np.testing.assert_allclose(got, expected, atol=2e-4, rtol=1e-4)


def test_dense_and_bvh_routes_are_equal_under_env():
    """The sphere of 8 x 16 over its quad light under the env, by the dense
    sweep and through the BVH: the images and the texture gradients equal
    bit for bit."""
    mat = _material(seed=5)
    out = []
    for accel in ("bruteforce", "bvh"):
        s = _port_scene("sphere")
        s.accel = accel
        s.add_envmap(_env_img())
        assert (s._render_data("direct").accel is None) == (accel == "bruteforce")
        tmat = torch.as_tensor(mat).requires_grad_()
        img = s.render(tmat, res=(12, 12), spp=2, seed=1)
        img[..., :3].sum().backward()
        out.append((img.detach(), tmat.grad))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_convert_carries_the_env():
    """convert.scene_from_numpy takes the JAX scene's envmap arrays: the
    port renders the converted scene bit for bit as its own Scene with
    add_envmap, and scene_to_numpy gives the arrays back."""
    js = _jax_scene("cbox")
    js.add_envmap(_env_img())
    d = js._data
    arrays = {k: np.asarray(getattr(d.geom, k)) for k in convert.GEOMETRY_KEYS}
    arrays.update(emission=np.asarray(d.emission), point_pos=np.asarray(d.point_pos),
                  point_intensity=np.asarray(d.point_intensity),
                  point_count=np.asarray(d.point_count))
    arrays.update({k: np.asarray(getattr(d.env, f)) for k, f in convert.ENV_KEYS.items()})
    data = convert.scene_from_numpy(arrays, d.fused_meta, "cpu")
    ts = _port_scene("cbox")
    ts.add_envmap(_env_img())
    assert data.meta == ts._data.meta
    for f in ("texture", "alias_prob", "alias_idx", "pdf"):
        assert torch.equal(getattr(data.env, f), getattr(ts._data.env, f)), f
    back, back_meta = convert.scene_to_numpy(data)
    assert back_meta["n_env"] == 1
    for k in convert.ENV_KEYS:
        np.testing.assert_array_equal(back[k], arrays[k])
    cfg = ts._config((8, 8), 2)
    mat = torch.as_tensor(_material(seed=3))
    a = dr.render_direct(data, mat, ts.camera, 1, cfg)
    b = dr.render_direct(ts._data, mat, ts.camera, 1, cfg)
    assert torch.equal(a, b)


def test_path_with_env_raises_and_collocated_ignores_it():
    """The path kernels do not read an env yet: a path render under one
    raises NotImplementedError naming ROADMAP A11. The collocated
    integrator lights by its camera light alone, as the JAX package's does:
    the env leaves its image as it was."""
    s = _port_scene("cbox")
    mat = torch.full((8, 8, 4), 0.5)
    s.integrator = "collocated"
    before = s.render(mat, res=(4, 4), spp=1)
    s.add_envmap(_env_img()[..., :3])
    assert s._data.meta.n_env == 1 and s._data.env.texture.shape == (64, 128, 4)
    assert torch.equal(s.render(mat, res=(4, 4), spp=1), before)
    s.integrator = "path"
    with pytest.raises(NotImplementedError, match="A11"):
        s.render(mat, res=(4, 4), spp=1)


# ------------------------------------------------- the g++ build of the kernels' code

def _host_env(tb, lanes, mat, le=None, early=0):
    """zdr_direct_env_host -> (acc (3, N), grad or None, counts)."""
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    acc = torch.empty((3, n))
    grad = torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    tables = kernels.pack_tables(tb)
    cpu = torch.device("cpu")
    bvh = (None, None, 0, 0) if tb.bvh is None else kernels.bvh_args(tb.bvh, cpu)
    rc = lib.zdr_direct_env_host(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), None if le is None else le.data_ptr(),
        acc.data_ptr(), grad.data_ptr(), counts.data_ptr(), n, early,
        *kernels.env_args(tb.env, cpu), *bvh)
    assert rc == 0
    return acc, (None if le is None else grad), counts.tolist()


@pytest.mark.parametrize("route", ["early", "bvh"])
def test_host_direct_env_matches_plain(route):
    """The g++ build of the env instantiation of the direct kernels
    (direct_step.cuh direct_sample<kGrad, kEnv = true>) on the sphere of 8
    x 16 over its quad light under the env, 16x16, 4 spp, roughness in
    [0.5, 0.9]: by the dense sweep with the early out (the env code is the
    same without it, which the card's tests run) and through the BVH, the
    render within mean abs diff 1e-6 and 99% of pixels within 1e-5
    (glibc's sinf, acosf and atan2f and torch's differ by ulps), the
    gradient within max|a - b| / max|a| < 1e-5, the tap mode's radiance and
    counts equal to the forward's."""
    s = _port_scene("sphere")
    s.add_envmap(_env_img())
    if route == "bvh":
        s.accel = "bvh"
    mat = _material(seed=6)
    mat[..., 3] = np.random.RandomState(7).uniform(0.5, 0.9, mat.shape[:2])
    mat = torch.as_tensor(mat)
    tb = pl.build_loop_tables(s._render_data("direct"), s.camera, s._config((16, 16), 4), 11)
    assert (tb.bvh is not None) == (route == "bvh") and tb.env is not None
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    acc, _g, counts = _host_env(tb, lanes, mat, early=int(route == "early"))
    want_g, want = dr.render_direct_backward_plain(tb, lanes, mat, le)
    diff = (acc - want).abs().max(dim=0).values / tb.spp
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.99
    g_acc, grad, g_counts = _host_env(tb, lanes, mat, le, int(route == "early"))
    assert torch.equal(g_acc, acc) and g_counts == counts
    assert float(want_g.abs().max()) > 0
    assert float((grad - want_g).abs().max() / want_g.abs().max()) < 1e-5
