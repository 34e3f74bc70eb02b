"""The direct integrator's emitter-first bounce lookup in the port
(zdr_tpu_torch/integrators/bounce.py light_hit_plain, bounce_any_plain;
direct.py bounce_emit_plain; kernels/csrc/direct_step.cuh bounce_emit)
against the JAX package's merged bounce_emit mode (pallas_bounce.py
_shade_kernel, in Pallas interpret mode) and its light_hit_planes, against
the port's unfused closest-hit estimator, and the g++ build of the
kernels' code against the plain version.

Scenes: tests/test_fused.py:211-218's uv sphere of 16 x 32 (960
triangles) over a quad light of 25 (2 light triangles), which the JAX
package renders through the merged mode with fused="force"; a sphere over
an unlit floor under two point lights (no light triangle); and the same
under an emissive sphere of 48 triangles (past MERGED_MAX_LIGHT_TRIS).
Tolerances are stated at each test.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _material

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_quad, make_uv_sphere
from zdr_tpu.integrators.fused_glue import light_hit_planes
from zdr_tpu.integrators.pallas_bounce import build_fused_const

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel.trace import bvh_closest, dense_closest, early_stages
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators import scene_tables
from zdr_tpu_torch.integrators.bounce import bounce_any_plain, light_hit_plain
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

# tests/test_fused.py:211-218
MERGED_CAM = dict(fov=0.8, origin=(1.6, 0.2, 0.0), target=(0.0, 0.0, 0.0))


def _jax_merged_scene():
    s = Scene([(make_uv_sphere(0.5, 16, 32), None, None),
               (make_quad(size=1.2, y=-1.5), None, 25.0)], integrator="direct")
    s.camera = Camera(fov=MERGED_CAM["fov"], origin=float3(*MERGED_CAM["origin"]),
                      target=float3(*MERGED_CAM["target"]))
    s.fused, s.packed_splat = "force", False
    return s


def _port_merged_scene(accel="bruteforce"):
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 16, 32), None, None),
                  (tproc.make_quad(size=1.2, y=-1.5), None, 25.0)], accel=accel, device="cpu")
    s.camera = zt.Camera(**MERGED_CAM)
    return s


def _port_points_scene(lit_sphere=False, accel="bruteforce"):
    """A uv sphere of 8 x 16 over an unlit floor quad under two point lights;
    lit_sphere adds an emissive uv sphere of 4 x 8 (48 light triangles)."""
    models = [(tproc.make_uv_sphere(0.5, 8, 16), None, None),
              (tproc.make_quad(size=3.0, y=-0.6), None, None)]
    if lit_sphere:
        lamp = tproc.make_uv_sphere(0.25, 4, 8)
        lamp = lamp._replace(positions=lamp.positions + np.float32([0.0, 1.2, 0.4]))
        models.append((lamp, None, 6.0))
    s = zt.Scene(models, sampler="lcg", accel=accel, device="cpu")
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.6, 0.3), target=(0.0, 0.0, 0.0))
    s.add_point_light((1.0, 2.0, 1.0), 4.0)
    s.add_point_light((-1.5, 1.5, -0.5), 3.0)
    return s


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(a)).max())


# ---------------------------------------------------------------- the light hit


def _light_rays(n, seed):
    """n rays from around the merged scene's quad light (y = -1.5, 1.2 wide)
    aimed at points near it, from above and below, with random BSDF pdfs;
    a tenth inactive -> numpy o (n, 3), d (n, 3), pdf (n,), active (n,)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform([-1.5, -2.5, -1.5], [1.5, 0.5, 1.5], (n, 3))
    target = np.stack([rs.uniform(-0.8, 0.8, n), np.full(n, -1.5), rs.uniform(-0.8, 0.8, n)], 1)
    d = target - o + rs.normal(scale=0.05, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pdf = rs.uniform(0.05, 20.0, n)
    act = (rs.rand(n) > 0.1).astype(np.int32)
    return o.astype(np.float32), d.astype(np.float32), pdf.astype(np.float32), act


def test_light_hit_plain_matches_light_hit_planes():
    """light_hit_plain against the JAX package's light_hit_planes over the
    merged scene's light rows on 16384 seeded rays: has equal, t_e and the
    radiance within atol 1e-5 and rtol 1e-6 (XLA's CPU may round the cross
    and dot products in another order than the port's operand order, as
    tests/test_torch_dense_sweep.py measures for the whole test); a share
    of the rays hits the light from its front and adds, others hit its back
    and add nothing."""
    js = _jax_merged_scene()
    meta = js._data.fused_meta
    _scene_pack, light_pack = build_fused_const(js._data, meta)
    o, d, pdf, act = _light_rays(16384, 0)
    t_j, add_j, has_j = light_hit_planes(
        meta, types.SimpleNamespace(light_pack=light_pack),
        tuple(jnp.asarray(c) for c in d.T), tuple(jnp.asarray(c) for c in o.T),
        jnp.asarray(pdf), jnp.asarray(act))
    ts = _port_merged_scene()
    tb = pl.build_loop_tables(ts._data, ts.camera, ts._config((4, 4), 1), 0)
    assert tb.light_rows is not None and tb.light_rows.tolist() == list(meta.light_tri_ids)
    t_p, add_p, has_p, on_p = light_hit_plain(
        tb.scene, tb.lights, tb.light_rows, tuple(torch.as_tensor(c) for c in o.T),
        tuple(torch.as_tensor(c) for c in d.T), torch.as_tensor(pdf),
        torch.as_tensor(act) != 0)
    np.testing.assert_array_equal(has_p.numpy().astype(np.int32), np.asarray(has_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=1e-5, rtol=1e-6)
    for c in range(3):
        np.testing.assert_allclose(add_p[c].numpy(), np.asarray(add_j[c]), atol=1e-5, rtol=1e-6)
    on = on_p.numpy()
    assert 0.1 < on.mean() < 0.9 and (has_p.numpy() & ~on).any()
    assert not on[act == 0].any()


@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_bounce_any_plain_is_the_capped_any_hit(route):
    """bounce_any_plain on (0, t_max) against the closest hit: a ray is
    occluded iff its nearest hit lies below t_max, on 4096 rays from the
    merged scene's sphere outward and to the light, inactive rays never;
    the g++ bounce_any (zdr_sweep_host's any 2) with and without the early
    out gives the same occlusion and the test count that early_stages
    (from_zero) counts."""
    ts = _port_merged_scene("bvh" if route == "bvh" else "bruteforce")
    tb = pl.build_loop_tables(ts._data, ts.camera, ts._config((4, 4), 1), 0)
    rs = np.random.RandomState(5)
    n = 4096
    o = rs.normal(size=(n, 3))
    o = (0.5 + 1e-4) * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.01, 3.0, n)
    o, d, t_max = (x.astype(np.float32) for x in (o, d, t_max))
    act = torch.as_tensor(rs.rand(n) > 0.2)
    ot, dt_ = tuple(torch.as_tensor(c) for c in o.T), tuple(torch.as_tensor(c) for c in d.T)
    tm = torch.as_tensor(t_max)
    occ = bounce_any_plain(tb.scene, ot, dt_, tm, act, bvh=tb.bvh)
    zero = torch.zeros(n)
    (t, _prim, _u, _v), _w = dense_closest(tb.scene, ot, dt_, zero, zero + 1e30)
    want = act & (t < tm)
    assert torch.equal(occ, want) and 0.05 < float(want.float().mean()) < 0.95
    if route == "bvh":
        return
    rays = torch.as_tensor(np.ascontiguousarray(np.concatenate([o.T, d.T, t_max[None]])))
    stages = early_stages(tb.scene, ot, dt_, tm, any_hit=True, from_zero=True)
    lib = kernels.load_host_library()
    for early in (0, 1):
        f_out, i_out = torch.zeros((3, n)), torch.zeros((n,), dtype=torch.int32)
        counts = torch.zeros((1,), dtype=torch.int64)
        rows = torch.nn.functional.pad(tb.scene[:, :9], (0, 3)).contiguous()
        assert lib.zdr_sweep_host(rows.data_ptr(), rows.shape[0], rays.data_ptr(), n, 2, early,
                                  f_out.data_ptr(), i_out.data_ptr(), counts.data_ptr()) == 0
        assert torch.equal(i_out != 0, t < tm)
        assert int(counts[0]) == int(stages.sum())


# ---------------------------------------------- against JAX's merged bounce_emit


def test_render_and_gradient_match_jax_merged_bounce_emit():
    """The port's plain route (dense, emitter first: L = 2) against the JAX
    Scene with fused="force", which takes the merged bounce_emit mode of
    _shade_kernel here (>= 256 triangles, no env, 1 to 32 light
    triangles), at 16x16, 4 spp: the image within atol 2e-4 and rtol 1e-4,
    the gradient of sum(image[..., :3] * w) within max|a - b| / max|a| <
    1e-5 at roughness >= 0.5 (test_torch_direct.py
    test_backward_matches_jax_grad's bar), from one jax.jit of the render's
    jax.vjp."""
    from zdr_tpu.integrators.pallas_bounce import MXU_MIN_TRIS

    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(0.5, 0.9, (16, 16))
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    js = _jax_merged_scene()
    assert js._data.fused_meta.num_tris >= MXU_MIN_TRIS and js._data.fused_meta.n_env == 0
    assert 0 < len(js._data.fused_meta.light_tri_ids) <= dr_cap()

    def render_vjp(m, ct):
        img, vjp = jax.vjp(lambda x: js.render(x, res=(16, 16), spp=4, seed=3), m)
        return img, vjp(ct)[0]

    ct = np.zeros((16, 16, 4), np.float32)
    ct[..., :3] = w
    want_img, want_g = (np.asarray(x) for x in jax.jit(render_vjp)(jnp.asarray(mat),
                                                                   jnp.asarray(ct)))
    ts = _port_merged_scene()
    tmat = torch.as_tensor(mat).requires_grad_()
    calls = dr.bounce_emit_plain.calls
    img = ts.render(tmat, res=(16, 16), spp=4, seed=3)
    (img[..., :3] * torch.as_tensor(w)).sum().backward()
    # 4 forward and 4 backward samples, each one lookup
    assert dr.bounce_emit_plain.calls == calls + 8
    assert want_img[..., :3].max() > 0 and np.abs(want_g).max() > 0
    np.testing.assert_allclose(img.detach().numpy(), want_img, atol=2e-4, rtol=1e-4)
    assert _rel(want_g, tmat.grad.numpy()) < 1e-5


def dr_cap():
    return scene_tables.MERGED_MAX_LIGHT_TRIS


@pytest.mark.parametrize("accel", ["bruteforce", "bvh"])
def test_matches_the_unfused_closest_hit_estimator(accel):
    """The port's kernel route (emitter first) against its unfused direct
    estimator (scene.fused = False: direct.direct_estimator, the closest
    hit over the scene), at tests/test_fused.py:227-242's bars: the image
    at 24x24, 4 spp within atol 2e-3 and mean abs difference < 1e-5, the
    gradient at 8 spp within atol 3e-3 * max(max|g|, 1)."""
    s = _port_merged_scene(accel)
    mat = torch.as_tensor(np.full((16, 16, 4), 0.5, np.float32))
    calls = dr.bounce_emit_plain.calls
    i_f = s.render(mat, res=(24, 24), spp=4, seed=1).numpy()
    assert dr.bounce_emit_plain.calls > calls
    s.fused = False
    i_u = s.render(mat, res=(24, 24), spp=4, seed=1).numpy()
    np.testing.assert_allclose(i_f, i_u, atol=2e-3)
    assert np.abs(i_f - i_u).mean() < 1e-5

    def grad(fused):
        s.fused = fused
        m = mat.clone().requires_grad_()
        s.render(m, res=(24, 24), spp=8, seed=2)[..., :3].sum().backward()
        return m.grad.numpy()

    g_f, g_u = grad("auto"), grad(False)
    assert np.abs(g_f).sum() > 0
    np.testing.assert_allclose(g_f, g_u, atol=3e-3 * max(np.abs(g_u).max(), 1.0))


# ------------------------------------------------------------ routes and work


def test_eligibility_follows_the_cap(monkeypatch):
    """L <= MERGED_MAX_LIGHT_TRIS (L = 0 included) takes the emitter-first
    lookup: the tables carry the light rows' scene ids, the params' int 23
    is set and the direct tables end with the ids' bits; past the cap, or
    with the cap lowered below L, the closest lookup; the other
    integrators' tables are pack_tables' either way."""
    mat = torch.full((4, 4, 4), 0.5)
    for scene, n_light in ((_port_points_scene(), 0), (_port_merged_scene(), 2),
                           (_port_points_scene(lit_sphere=True), 48)):
        tb = pl.build_loop_tables(scene._data, scene.camera, scene._config((4, 4), 1), 0)
        assert len(scene._data.meta.light_tri_ids) == n_light
        emit = n_light <= scene_tables.MERGED_MAX_LIGHT_TRIS
        assert (tb.light_rows is not None) == emit and kernels.loop_params(tb, mat)[23] == emit
        tables = kernels.direct_tables(tb)
        packed = kernels.pack_tables(tb)
        assert tables.numel() == packed.numel() + (n_light if emit else 0)
        if emit and n_light:
            ids = tables[packed.numel():].view(torch.int32)
            assert ids.tolist() == list(scene._data.meta.light_tri_ids)
    monkeypatch.setattr(scene_tables, "MERGED_MAX_LIGHT_TRIS", -1)
    scene = _port_merged_scene()
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config((4, 4), 1), 0)
    assert tb.light_rows is None and kernels.loop_params(tb, mat)[23] == 0


def _bounce_rays(tb, lanes, mat):
    """The plain direct samples' bounce rays where they go on -> (o, d) of
    every sample's bouncing lanes, concatenated (light_hit_plain's active
    rays)."""
    seen = []
    light_hit = dr.light_hit_plain

    def spy(scene, lights, light_rows, o, d, pdf_prev, active):
        seen.append((tuple(x[active] for x in o), tuple(x[active] for x in d)))
        return light_hit(scene, lights, light_rows, o, d, pdf_prev, active)

    dr.light_hit_plain = spy
    try:
        dr.render_direct_plain(tb, lanes, mat)
    finally:
        dr.light_hit_plain = light_hit
    return tuple(tuple(torch.cat([s[k][c] for s in seen]) for c in range(3)) for k in (0, 1))


def _host_counts(tb, lanes, mat):
    """The g++ direct build's (acc, [tests, visits]) over tb's route."""
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    acc, counts = torch.empty((3, n)), torch.zeros((2,), dtype=torch.int64)
    tables, params = kernels.direct_tables(tb), kernels.loop_params(tb, mat)
    if tb.bvh is None:
        rc = lib.zdr_direct_host(params, tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
                                 mat.data_ptr(), lanes.data_ptr(), None, acc.data_ptr(), None,
                                 counts.data_ptr(), n, 0)
    else:
        rc = lib.zdr_direct_bvh_host(params, tables.data_ptr(), tables.numel(), 1,
                                     tb.bn.data_ptr(), mat.data_ptr(), lanes.data_ptr(), None,
                                     acc.data_ptr(), None,
                                     *kernels.bvh_args(tb.bvh, torch.device("cpu")),
                                     counts.data_ptr(), n)
    assert rc == 0
    return acc, counts.tolist()


@pytest.mark.parametrize("accel", ["bruteforce", "bvh"])
def test_no_light_triangle_walks_no_bounce(accel):
    """L = 0, point lights only, no env: the g++ build emitter first and
    with the closest lookup give the same radiance bit for bit (the bounce
    reaches no emitter either way, its term is 0), and their tests and node
    visits differ by exactly the closest lookup's bounce walks, the plain
    closest walk's work on the bounce rays: the emitter-first build walked
    no bounce ray."""
    s = _port_points_scene(accel=accel)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((12, 12), 2), 3)
    assert tb.light_rows is not None and tb.light_rows.numel() == 0
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    mat = torch.as_tensor(_material(seed=8))
    acc_e, work_e = _host_counts(tb, lanes, mat)
    acc_c, work_c = _host_counts(dataclasses.replace(tb, light_rows=None), lanes, mat)
    assert torch.equal(acc_e, acc_c) and float(acc_e.max()) > 0
    o, d = _bounce_rays(tb, lanes, mat)
    assert o[0].numel() > 0
    zero = torch.zeros_like(o[0])
    if tb.bvh is None:
        bounce = [o[0].numel() * tb.scene.shape[0], 0]
    else:
        _hit, (tests, visits) = bvh_closest(tb.bvh, o, d, zero, zero + 1e30)
        bounce = [int(tests), int(visits)]
    assert [c - e for c, e in zip(work_c, work_e)] == bounce
