"""The port's PRB gradient pieces against the JAX package: the sampler salt,
and the tap mode of the path-loop step against JAX's tap-mode kernel
(integrators/pallas_loop.py, want_grad) in Pallas interpret mode.

Tolerances: the salt, splat ids and flags are equal; the float taps agree to
atol=1e-5 with rtol=1e-5, the carry's bar (tests/test_torch_loop.py): torch
and XLA compute sin/cos to within ulps of each other, and the derivatives
are taken by torch.func and jax.vjp through the same formulas. The bounce
taps Q and S have measured bars of their own (_assert_taps_close).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _jax_scene, _material, _port_camera, _port_data, _to_port_carry

from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.integrators.pallas_bounce import read_quads_planes
from zdr_tpu.integrators.path import _depths
from zdr_tpu.integrators.wrapper import _pixel_grid
from zdr_tpu.samplers.hashes import U32
from zdr_tpu.samplers.lcg import LCGSampler as JLCG
from zdr_tpu.samplers.pmj02bn import PMJ02BNSamplerP2 as JPMJ

from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.wrapper import RenderConfig
from zdr_tpu_torch.samplers.lcg import LCGSampler
from zdr_tpu_torch.samplers.pmj02bn import PMJ02BNSamplerP2


def _u32(a):
    return torch.as_tensor(a.astype(np.int64))


def test_salt_bit_exact():
    """lcg: state ^ 0x5F356495; pmj02bn: xxhash32_4(px ^ 0x5F356495, py,
    dimension, seed ^ sample_index), on random states and pixels."""
    rs = np.random.RandomState(7)
    n = 4096
    state = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JLCG(jnp.asarray(state)).salt())
    got = LCGSampler(_u32(state)).salt().numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))

    px = rs.randint(0, 4096, n).astype(np.int32)
    py = rs.randint(0, 4096, n).astype(np.int32)
    sidx = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    dim = rs.randint(0, 64, n).astype(np.uint32)
    for seed in (0, 3, 2**31 + 5):
        jsmp = JPMJ(px=jnp.asarray(px), py=jnp.asarray(py), sample_index=jnp.asarray(sidx),
                    dimension=jnp.asarray(dim), seed=U32(seed), spp=None, w=None,
                    bn_cache=None)
        tsmp = PMJ02BNSamplerP2(px=_u32(px), py=_u32(py), sample_index=_u32(sidx),
                                dimension=_u32(dim), seed=seed, spp=64, bn_rows=None,
                                bn_base=None, n_tex=0)
        want = np.asarray(jsmp.salt()).astype(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(tsmp.salt().numpy(), want)


def _err(x, ref):
    """|x - ref| in units of the bar atol=1e-5 + rtol=1e-5 |ref|."""
    return np.nan_to_num(np.abs(x - ref) / (1e-5 + 1e-5 * np.abs(ref)))


# Q and S bars, in units of atol=1e-5 + rtol=1e-5 |ref| (_err): JAX's
# float32 taps from the float64 step, and the port's from either.
# Measured over 8 material/adjoint seeds, both configurations, 6 steps
# each: JAX from float64 up to 8.2 units, the port from float64 up to 13.0
# and from JAX up to 11.4 (Q alone: 1.9). Controls: a roughness derivative
# taken through alpha instead of the roughness puts S 3.8e4 units off, and
# S set to zero 6.1e5.
JAX_F64_UNITS = 10.0
PORT_UNITS = 25.0


def _assert_taps_close(got, want, ref64, n_bins):
    """ids and flags equal; radiance and u_m of every lane, P of the lanes
    that splat, within atol=1e-5, rtol=1e-5 of JAX.

    Q and S of the lanes that splat depend on the sampled bounce direction,
    which both packages compute with sin/cos that differ by ulps, and the
    GGX lobe amplifies a direction's ulps (D(h) at low roughness, and more
    so its roughness derivative near its zero): JAX's own float32 Q and S
    lie up to 3e-5 and 1e-2 relative from a float64 evaluation of the same
    step. So JAX is held within JAX_F64_UNITS of the float64 step, which
    pins that step to JAX's formulas, and the port within PORT_UNITS of
    both the float64 step and JAX."""
    names = pl.TAP_NAMES
    k_ids, k_flags = names.index("ids"), names.index("flags")
    np.testing.assert_array_equal(got[k_ids].numpy(), want[k_ids].astype(np.int64))
    np.testing.assert_array_equal(got[k_flags].numpy(), want[k_flags])
    splats = want[k_ids] != n_bins
    for k, name in enumerate(names[:14]):
        g, w = got[k].numpy(), want[k]
        if name[0] in "qs":
            g, w, t = g[splats], w[splats], ref64[k].numpy()[splats]
            assert float(_err(w, t).max(initial=0.0)) <= JAX_F64_UNITS, name
            assert float(_err(g, t).max(initial=0.0)) <= PORT_UNITS, name
            assert float(_err(g, w).max(initial=0.0)) <= PORT_UNITS, name
            continue
        sel = splats if name[0] == "p" else slice(None)
        np.testing.assert_allclose(g[sel], w[sel], atol=1e-5, rtol=1e-5, equal_nan=True,
                                   err_msg=name)
    return int(splats.sum())


@pytest.mark.parametrize("sampler,point_light", [("pmj02bn", False), ("lcg", True)])
def test_tap_step_matches_jax_tap_kernel(sampler, point_light):
    """From JAX's initial carry at 16x16, 4 spp, six tap-mode steps of JAX's
    kernel against loop_step(..., le_grad) on the same carry and le_grad."""
    s = _jax_scene(point_light, sampler)
    cfg = s._config((16, 16), 4)
    mat = _material()
    coords = _pixel_grid(cfg.res)
    (meta, scene_pack, light_pack, li, pp, packed, rows, pxp, pyp, real,
     start_idx, stop_idx, woop, _perm) = plp._loop_setup(
        s._data, jnp.asarray(mat), cfg, coords, 0)
    md, rr_d = _depths(cfg)
    seed = 3
    cam_c = plp.camera_const(s.camera)
    seed_pl = jnp.zeros((rows, plp.LANES), jnp.int32) + seed
    bn = None
    if sampler == "pmj02bn":
        from zdr_tpu.samplers.pmj02bn import _build_bn_cache

        bn = _build_bn_cache(pxp, pyp, jnp.asarray(seed, jnp.uint32))
    allow = jnp.ones((rows, plp.LANES), jnp.int32)
    le = np.random.RandomState(5).uniform(-1.0, 1.0, (3, rows * plp.LANES)).astype(np.float32)
    lg = tuple(jnp.asarray(le[c].reshape(rows, plp.LANES)) for c in range(3))

    @jax.jit
    def jax_step(carry):
        mats = read_quads_planes(
            plp._carry_get(sampler, carry, "uv_x"),
            plp._carry_get(sampler, carry, "uv_y"), packed, 16, 16)
        return plp._call_loop_kernel(
            sampler, cfg.spp, cfg.res, cfg.use_tent_filter, meta.num_tris,
            rr_d, md, 16, 16, meta, None, scene_pack, light_pack, li, pp,
            cam_c, bn, pxp, pyp, seed_pl, stop_idx, allow, mats, carry, True, le_grad=lg)

    tcfg = RenderConfig(res=cfg.res, spp=cfg.spp, sampler=sampler)
    tb = pl.build_loop_tables(_port_data(s), _port_camera(), tcfg, seed)
    lanes = torch.as_tensor(np.stack([
        np.asarray(pxp).reshape(-1), np.asarray(pyp).reshape(-1),
        np.asarray(stop_idx).reshape(-1)]).astype(np.int32))
    material = torch.as_tensor(mat)

    jc = plp._init_carry(sampler, rows, start_idx, stop_idx, real)
    n_splats = 0
    for _ in range(6):
        carry = _to_port_carry(sampler, jc)
        _carry, got = pl.loop_step(carry, tb, lanes, material, torch.as_tensor(le))
        _carry, ref64 = pl.loop_step(pl.Carry(carry.f.double(), carry.i), tb, lanes,
                                     material.double(), torch.as_tensor(le).double())
        jc, taps = jax_step(jc)
        n_splats += _assert_taps_close(
            got, [np.asarray(t).reshape(-1) for t in taps], ref64, 16 * 16)
    assert n_splats > 100
