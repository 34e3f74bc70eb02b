"""The port's samplers (zdr_tpu_torch/samplers) against the JAX package's,
bit for bit: the same uint32 hashes and permutations, and the same float32
draws, from the same random (pixel, seed, sample index, dimension)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu.samplers import make_sampler_xy as jax_make_sampler_xy
from zdr_tpu.samplers import hashes as jh
from zdr_tpu.samplers import pmj02bn as jpmj

from zdr_tpu_torch.samplers import hashes as th
from zdr_tpu_torch.samplers import make_sampler_xy, sampler_probe_plain
from zdr_tpu_torch.samplers import pmj02bn as tpmj

N = 2000


def _u32(rs, n=N):
    return rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _np_u32(t):
    return t.numpy().astype(np.uint32)


def test_xxhash32_4_bit_exact():
    rs = np.random.RandomState(0)
    x, y, z, w = (_u32(rs) for _ in range(4))
    want = np.asarray(jh.xxhash32_4(*(jnp.asarray(a) for a in (x, y, z, w))))
    np.testing.assert_array_equal(_np_u32(th.xxhash32_4(_t(x), _t(y), _t(z), _t(w))), want)


@pytest.mark.parametrize("spp", [4, 16, 64])
def test_permutation_element_pow2_bit_exact(spp):
    rs = np.random.RandomState(spp)
    w = th.next_pow2_mask(spp)
    assert w == jh.next_pow2_mask(spp)
    i = rs.randint(0, spp, size=N).astype(np.uint32)
    p = _u32(rs)
    want = np.asarray(jh.permutation_element_pow2(
        jnp.asarray(i), jnp.uint32(w), jnp.asarray(p)))
    np.testing.assert_array_equal(_np_u32(th.permutation_element_pow2(_t(i), w, _t(p))), want)


def test_lcg_helpers_bit_exact():
    s = _u32(np.random.RandomState(1))
    np.testing.assert_array_equal(
        _np_u32(th.lcg_step(_t(s))), np.asarray(jh.lcg_step(jnp.asarray(s))))
    np.testing.assert_array_equal(
        th.lcg_to_unit_float(_t(s)).numpy(),
        np.asarray(jh.lcg_to_unit_float(jnp.asarray(s))))


def test_pmj_point_matches_table_construction():
    rs = np.random.RandomState(2)
    set_idx = rs.randint(0, 5, size=N).astype(np.int32)
    index = rs.randint(0, 65536, size=N).astype(np.uint32)
    jx, jy = jpmj._pmj_point(jnp.asarray(set_idx), jnp.asarray(index))
    tx, ty = tpmj.pmj_point(_t(set_idx), _t(index))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_bluenoise_copy_equals_jax_tables():
    """The port's own blue-noise file holds the JAX package's textures: its
    rows equal jpmj._tables()'s bn_rows, value for value, in the same
    (res, n_tex) layout, read from no file of the JAX package."""
    _pmj, jax_rows, _sets, _samples, n_tex, res = jpmj._tables()
    rows, t_res, t_ntex = tpmj.bluenoise_rows()
    assert (t_res, t_ntex) == (res, n_tex)
    assert rows.dtype == np.float32
    np.testing.assert_array_equal(rows, jax_rows.reshape(-1))
    assert os.path.dirname(tpmj.BLUENOISE_PATH) == os.path.dirname(tpmj.__file__)


def test_bluenoise_row_lookup():
    """The direct bn_rows index equals JAX's per-lane cache at every
    dimension, seeds with the top bit set included."""
    rs = np.random.RandomState(3)
    px = rs.randint(0, 4096, size=N).astype(np.int32)
    py = rs.randint(0, 4096, size=N).astype(np.int32)
    for seed in (0, 7, 2**31 + 12345, 2**32 - 1):
        cache = np.asarray(jpmj._build_bn_cache(
            jnp.asarray(px), jnp.asarray(py), jnp.uint32(seed)))
        rows, res, n_tex = tpmj.bluenoise_rows()
        base = tpmj.bn_base(_t(px), _t(py), seed, res, n_tex).numpy()
        for dim in range(n_tex + 3):
            np.testing.assert_array_equal(rows[base + dim % n_tex], cache[dim % n_tex])


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
@pytest.mark.parametrize("spp", [4, 16, 64])
def test_sampler_streams_bit_exact(kind, spp):
    """next1 / next2 streams over 24 dimensions from random pixels, seeds
    and sample indices."""
    rs = np.random.RandomState(spp + (kind == "lcg"))
    px = rs.randint(0, 1024, size=N).astype(np.int32)
    py = rs.randint(0, 1024, size=N).astype(np.int32)
    si = rs.randint(0, spp, size=N).astype(np.int32)
    seed = int(rs.randint(0, 2**31))
    js = jax_make_sampler_xy(kind, jnp.asarray(px), jnp.asarray(py), seed, spp, jnp.asarray(si))
    ts = make_sampler_xy(kind, torch.as_tensor(px), torch.as_tensor(py), seed, spp,
                         torch.as_tensor(si))
    for k in range(16):
        if k % 2 == 0:
            ju, js = js.next1()
            tu, ts = ts.next1()
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        else:
            (jx, jy), js = js._next2_xy()
            (tx, ty), ts = ts.next2_xy()
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_sampler_probe_plain_matches_jax(kind):
    """The plain version of the sampler-probe kernel: per-lane seeds."""
    rs = np.random.RandomState(5)
    n, k, spp = 512, 4, 16
    lanes = np.stack([
        rs.randint(0, 512, n), rs.randint(0, 512, n),
        rs.randint(-2**31, 2**31, n), rs.randint(0, spp, n),
    ]).astype(np.int32)
    got = sampler_probe_plain(kind, spp, torch.as_tensor(lanes), k).numpy()
    seed = jnp.asarray(lanes[2]).astype(jnp.uint32)
    js = jax_make_sampler_xy(kind, jnp.asarray(lanes[0]), jnp.asarray(lanes[1]), seed, spp,
                             jnp.asarray(lanes[3]))
    want = []
    for _ in range(k):
        u, js = js.next1()
        (ux, uy), js = js._next2_xy()
        want += [np.asarray(u), np.asarray(ux), np.asarray(uy)]
    np.testing.assert_array_equal(got, np.stack(want))


def test_non_pow2_pmj02bn_is_out_of_scope():
    px = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A4"):
        make_sampler_xy("pmj02bn", px, px, 0, 12, 0)
    with pytest.raises(NotImplementedError, match="A4"):
        make_sampler_xy("corrmj", px, px, 0, 16, 0)
