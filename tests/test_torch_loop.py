"""The port's path loop (zdr_tpu_torch/integrators/path_loop.py) against the
JAX package's megakernel loop (integrators/pallas_loop.py), run in Pallas
interpret mode on the CPU as the JAX package's own tests run it.

Tolerances: ints (sampler state, sample index, depth, flags) are equal; the
floats agree to atol=1e-5 with rtol=1e-5, because torch and XLA compute
sin/cos to within ulps of each other (l_pdf: see _assert_carry_close).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.integrators.pallas_bounce import read_quads_planes
from zdr_tpu.integrators.path import _depths
from zdr_tpu.integrators.wrapper import _pixel_grid

import zdr_tpu_torch as zt
from zdr_tpu_torch import convert, kernels
from zdr_tpu_torch.geometry.procedural import (
    make_cornell_box as t_make_cornell_box,
    make_cornell_light as t_make_cornell_light,
)
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.wrapper import RenderConfig
from zdr_tpu_torch.samplers import sampler_probe_plain

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CAM = dict(fov=0.87, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))


def _material(res=16, seed=0):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, size=(res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.2, 0.9, size=(res, res))
    return mat


def _jax_scene(point_light=False, sampler="pmj02bn"):
    s = Scene(
        [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator="path", sampler=sampler,
    )
    s.camera = Camera(fov=CAM["fov"], origin=float3(*CAM["origin"]),
                      target=float3(*CAM["target"]))
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), 6.0)
    return s


def _port_data(s, device="cpu"):
    d = s._data
    g = d.geom
    arrays = {k: np.asarray(getattr(g, k)) for k in convert.GEOMETRY_KEYS}
    arrays.update(
        emission=np.asarray(d.emission), point_pos=np.asarray(d.point_pos),
        point_intensity=np.asarray(d.point_intensity),
        point_count=np.asarray(d.point_count),
    )
    return convert.scene_from_numpy(arrays, d.fused_meta, device)


def _port_camera():
    return zt.Camera(fov=CAM["fov"], origin=CAM["origin"], target=CAM["target"])


def _to_port_carry(kind, jc):
    """JAX carry planes -> the port's (F, N) / (I, N) rows."""
    f32_names, i32_names = plp._carry_layout(kind)
    named = dict(zip(f32_names + i32_names, (np.asarray(x).reshape(-1) for x in jc)))
    named["u_rr"] = named["u_rr_bits"].view(np.float32)
    named.setdefault("smp1", np.zeros_like(named["smp0"]))
    f = np.stack([named[n] for n in pl.F_NAMES])
    i = np.stack([named[n] for n in pl.I_NAMES])
    return pl.Carry(torch.as_tensor(f), torch.as_tensor(i.astype(np.int32)))


def _assert_carry_close(got, want):
    """Every int row equal; acc_* of all lanes and every float row of the
    lanes in flight close. l_pdf = dist^2 / (area * cos) is ill-conditioned
    in cos at grazing light samples (an ulp of the hit point moves it by
    1e-5 relative, and by 1e6 on a sample from the light's own plane), so it
    is held at rtol=1e-4 where it is read: on shading lanes whose light
    sample contributes."""
    np.testing.assert_array_equal(got.i.numpy(), want.i.numpy())
    gf, wf = got.f.numpy(), want.f.numpy()
    np.testing.assert_allclose(gf[0:3], wf[0:3], atol=1e-5, rtol=1e-5)
    live = want.i[pl.I_IDX["in_flight"]].numpy() != 0
    assert live.any()
    rows = [k for k, n in enumerate(pl.F_NAMES) if n != "l_pdf"]
    np.testing.assert_allclose(gf[rows][:, live], wf[rows][:, live], atol=1e-5, rtol=1e-5)
    lev = wf[[pl.F_IDX[n] for n in ("lev_r", "lev_g", "lev_b")]]
    used = live & (want.i[pl.I_IDX["shade"]].numpy() != 0) & (lev != 0).any(axis=0)
    k = pl.F_IDX["l_pdf"]
    np.testing.assert_allclose(gf[k, used], wf[k, used], rtol=1e-4)


@pytest.mark.parametrize("sampler,point_light", [("pmj02bn", False), ("lcg", True)])
def test_loop_step_matches_jax_carry_for_carry(sampler, point_light):
    """From JAX's initial carry at 16x16, 4 spp (one 16x512 block, morton
    lanes), each JAX kernel step against loop_step on the same carry."""
    s = _jax_scene(point_light, sampler)
    cfg = s._config((16, 16), 4)
    mat = _material()
    coords = _pixel_grid(cfg.res)
    (meta, scene_pack, light_pack, li, pp, packed, rows, pxp, pyp, real,
     start_idx, stop_idx, woop, _perm) = plp._loop_setup(
        s._data, jnp.asarray(mat), cfg, coords, 0)
    assert woop is None
    md, rr_d = _depths(cfg)
    seed = 3
    cam_c = plp.camera_const(s.camera)
    seed_pl = jnp.zeros((rows, plp.LANES), jnp.int32) + seed
    bn = None
    if sampler == "pmj02bn":
        from zdr_tpu.samplers.pmj02bn import _build_bn_cache

        bn = _build_bn_cache(pxp, pyp, jnp.asarray(seed, jnp.uint32))
    allow = jnp.ones((rows, plp.LANES), jnp.int32)

    @jax.jit
    def jax_step(carry):
        mats = read_quads_planes(
            plp._carry_get(sampler, carry, "uv_x"),
            plp._carry_get(sampler, carry, "uv_y"), packed, 16, 16)
        out, _ = plp._call_loop_kernel(
            sampler, cfg.spp, cfg.res, cfg.use_tent_filter, meta.num_tris,
            rr_d, md, 16, 16, meta, None, scene_pack, light_pack, li, pp,
            cam_c, bn, pxp, pyp, seed_pl, stop_idx, allow, mats, carry, True)
        return out

    tcfg = RenderConfig(res=cfg.res, spp=cfg.spp, sampler=sampler)
    tb = pl.build_loop_tables(_port_data(s), _port_camera(), tcfg, seed)
    lanes = torch.as_tensor(np.stack([
        np.asarray(pxp).reshape(-1), np.asarray(pyp).reshape(-1),
        np.asarray(stop_idx).reshape(-1)]).astype(np.int32))
    material = torch.as_tensor(mat)

    jc = plp._init_carry(sampler, rows, start_idx, stop_idx, real)
    for _ in range(6):
        got = pl.loop_step(_to_port_carry(sampler, jc), tb, lanes, material)
        jc = jax_step(jc)
        _assert_carry_close(got, _to_port_carry(sampler, jc))


def test_render_matches_jax_loop():
    """Scene(device="cpu").render against JAX render_path_loop at 16x16,
    4 spp, seed 3, at the fused-vs-unfused bar (tests/test_fused.py:43)."""
    s = _jax_scene()
    cfg = s._config((16, 16), 4)
    mat = _material()
    want = np.asarray(plp.render_path_loop(
        s._data, jnp.asarray(mat), s.camera, jnp.int32(3), cfg,
        _pixel_grid(cfg.res))).reshape(16, 16, 3)
    ts = zt.Scene([(t_make_cornell_box(), None, None),
                   (t_make_cornell_light(), None, 15.0)], integrator="path", device="cpu")
    ts.camera = _port_camera()
    got = ts.render(torch.as_tensor(mat), res=(16, 16), spp=4, seed=3).numpy()
    np.testing.assert_array_equal(got[..., 3], 1.0)
    np.testing.assert_allclose(got[..., :3], want, atol=2e-5)


def _checker(res=16):
    y, x = np.mgrid[0:res, 0:res]
    c = ((x // 4 + y // 4) % 2).astype(np.float32)
    return np.stack([0.2 + 0.6 * c, 0.7 - 0.5 * c, 0.4 * np.ones_like(c),
                     0.3 + 0.4 * c], -1)


def test_golden_path_cbox():
    """tools/gen_golden.py's path_cbox (checker material, 32x32, 16 spp,
    seed 7) at the golden bar of tests/test_golden.py."""
    s = zt.Scene([(t_make_cornell_box(), None, None),
                  (t_make_cornell_light(), None, 15.0)],
                 integrator="path", device="cpu")
    s.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
    got = s.render(torch.as_tensor(_checker()), res=(32, 32), spp=16, seed=7)
    expected = np.load(os.path.join(GOLDEN, "path_cbox.npy"))
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-4, rtol=1e-4)


def test_scope_gates_raise():
    s = zt.Scene([(t_make_cornell_box(), None, None),
                  (t_make_cornell_light(), None, 15.0)], integrator="path", device="cpu")
    mat = torch.full((8, 8, 4), 0.5)
    s.splat_merge = 4
    with pytest.raises(NotImplementedError, match="A17"):
        s.render(mat.clone().requires_grad_(True), res=(4, 4), spp=1)
    s.splat_merge, s.packed_splat = 1, True
    with pytest.raises(NotImplementedError, match="A17"):
        s.render(mat, res=(4, 4), spp=1)
    s.packed_splat = False
    with pytest.raises(NotImplementedError, match="A4"):
        s.render(mat, res=(4, 4), spp=3)
    s.integrator, s.use_mis = "direct", False
    with pytest.raises(NotImplementedError, match="A10"):
        s.render(mat, res=(4, 4), spp=1)
    s.integrator, s.use_mis = "path", True
    s.sampler = "corrmj"
    with pytest.raises(NotImplementedError, match="A4"):
        s.render(mat, res=(4, 4), spp=4)
    s.sampler = "pmj02bn"
    # add_envmap takes the env; the path kernels do not read one yet
    s.add_envmap(np.ones((4, 8, 3), np.float32))
    with pytest.raises(NotImplementedError, match="A11"):
        s.render(mat, res=(4, 4), spp=1)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    """Given CPU tensors, the kernel wrappers run their plain versions and
    count no launch; a device that is neither cuda nor cpu raises."""
    s = zt.Scene([(t_make_cornell_box(), None, None),
                  (t_make_cornell_light(), None, 15.0)], device="cpu")
    s.camera = _port_camera()
    mat = torch.as_tensor(_material(seed=2))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((8, 8), 4), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    launches, calls = kernels.path_loop.launches, pl.render_path_loop_plain.calls
    got = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    assert torch.equal(got.f, want.f) and torch.equal(got.i, want.i)
    assert (kernels.path_loop.launches, pl.render_path_loop_plain.calls) == (launches, calls + 2)
    rs = np.random.RandomState(4)
    probe = torch.as_tensor(np.stack([
        rs.randint(0, 64, 32), rs.randint(0, 64, 32), rs.randint(-2**31, 2**31, 32),
        rs.randint(0, 16, 32)]).astype(np.int32))
    bn = (tb.bn, tb.bn_res, tb.bn_ntex)
    for kind in ("lcg", "pmj02bn"):
        got = kernels.sampler_probe(kind, 16, probe, 2, bn)
        assert torch.equal(got, sampler_probe_plain(kind, 16, probe, 2, bn))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        kernels.path_loop(tb, lanes.to("meta"), mat, pl.init_carry(lanes), 1)


def test_host_build_of_kernel_step_matches_plain():
    """The kernel's own per-lane code (csrc/path_loop_step.cuh), built with
    g++, against loop_step from the same carry for 8 steps, and over a
    whole render. sinf/cosf of glibc and torch differ by ulps."""
    lib = kernels.load_host_library()
    s = zt.Scene([(t_make_cornell_box(), None, None),
                  (t_make_cornell_light(), None, 15.0)], device="cpu")
    s.camera = _port_camera()
    mat = torch.as_tensor(_material(seed=1))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((24, 24), 8), 5)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    tables = kernels.pack_tables(tb)
    params = kernels.loop_params(tb, mat)

    def host(carry, n_steps):
        f = torch.empty_like(carry.f)
        i = torch.empty_like(carry.i)
        rc = lib.zdr_path_loop_host(
            params, tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
            mat.data_ptr(), lanes.data_ptr(), carry.f.data_ptr(),
            carry.i.data_ptr(), f.data_ptr(), i.data_ptr(), lanes.shape[1], n_steps)
        assert rc == 0
        return pl.Carry(f, i)

    carry = pl.init_carry(lanes)
    for _ in range(8):
        want = pl.loop_step(carry, tb, lanes, mat)
        _assert_carry_close(host(carry, 1), want)
        carry = want
    full = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    got = host(pl.init_carry(lanes), tb.n_steps)
    np.testing.assert_array_equal(got.i[0].numpy(), full.i[0].numpy())
    diff = (got.f[0:3] - full.f[0:3]).abs().max(dim=0).values
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.99
