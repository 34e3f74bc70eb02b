"""The port's samplers (zdr_tpu_torch/samplers) against the JAX package's,
bit for bit: the same uint32 hashes and permutations, and the same float32
draws, from the same random (pixel, seed, sample index, dimension)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu.integrators import pallas_loop as jloop
from zdr_tpu.samplers import make_sampler_xy as jax_make_sampler_xy
from zdr_tpu.samplers import corrmj as jcmj
from zdr_tpu.samplers import hashes as jh
from zdr_tpu.samplers import pmj02bn as jpmj

from zdr_tpu_torch.samplers import corrmj as tcmj
from zdr_tpu_torch.samplers import hashes as th
from zdr_tpu_torch.samplers import make_sampler_xy, sampler_probe_plain
from zdr_tpu_torch.samplers import pmj02bn as tpmj
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

N = 2000


def _jax_permutation_bounded(i, l, w, p):
    """JAX's permutation_element (zdr_tpu/samplers/hashes.py:79) with each
    lane's loop also stopped after w + 1 candidates, as the port's: equal to
    it on every lane it finishes (test_permutation_bound_is_exact). The
    JAX loop never ends on a corrmj row stratum past the grid whose
    candidates cycle above l, which a render at a spp that is no square, on
    a grid side that is no power of two, meets at once."""
    i, l, w, p = (jh.u32(x) for x in (i, l, w, p))
    cand = jh._permute_round(i, w, p)

    def go(st):
        c, k = st
        return (c >= l) & (k < w)

    def body(st):
        c, k = st
        g = go(st)
        return jnp.where(g, jh._permute_round(c, w, p), c), k + g.astype(jnp.uint32)

    cand, _ = jax.lax.while_loop(lambda st: jnp.any(go(st)), body,
                                 (cand, jnp.zeros_like(cand)))
    return (cand + p) % l


def row_can_stall(spp: int) -> bool:
    """corrmj at spp: a row index can pass the grid (spp > res^2) and the
    row permutation has a rejection loop (res no power of two)."""
    res = tcmj.grid_side(spp)
    return spp > res * res and res & (res - 1) != 0


@pytest.fixture
def jax_corrmj(monkeypatch):
    """-> f(spp): bounds JAX's corrmj permutation where its loop can stall."""
    def at(spp):
        if row_can_stall(spp):
            monkeypatch.setattr(jcmj, "permutation_element", _jax_permutation_bounded)
    return at


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


def test_permutation_element_bit_exact():
    """The generic permutation, rejection loop and all, against JAX's
    batched while_loop: random (i, l, p) with l in 2..4096, one list length
    a call for every lane, over lengths one past a power of two (the most
    rejections) and powers of two (none) among random ones."""
    rs = np.random.RandomState(11)
    lengths = [2, 3, 5, 12, 17, 65, 96, 129, 1000, 1025, 2049, 4096, 4095]
    lengths += [int(v) for v in rs.randint(2, 4097, size=6)]
    for l in lengths:
        w = th.next_pow2_mask(l)
        i = rs.randint(0, l, size=N).astype(np.uint32)
        p = _u32(rs)
        want = np.asarray(jh.permutation_element(
            jnp.asarray(i), jnp.uint32(l), jnp.uint32(w), jnp.asarray(p)))
        np.testing.assert_array_equal(_np_u32(th.permutation_element(_t(i), l, w, _t(p))), want)
        if l == w + 1:
            np.testing.assert_array_equal(
                _np_u32(th.permutation_element_pow2(_t(i), w, _t(p))), want)


def test_permutation_bound_is_exact():
    """Row strata past corrmj's grid (y >= res): where some candidate of the
    first w + 1 is below l, the bounded loop stops where JAX's does (JAX's
    own permutation_element, on those lanes); where none is, the next
    candidate repeats one of them, so JAX's loop would never end, and the
    port and the bounded JAX reference take the same last candidate."""
    rs = np.random.RandomState(12)
    for spp, res in ((12, 3), (96, 9), (512, 22)):
        w = th.next_pow2_mask(res)
        y = rs.randint(res, (spp - 1) // res + 1, size=N).astype(np.uint32)
        p = _u32(rs) & 0x70FFFFFF
        seq = [th._permute_round(_t(y), w, _t(p))]
        for _ in range(w + 1):
            seq.append(th._permute_round(seq[-1], w, _t(p)))
        seq = torch.stack(seq).numpy()
        ends = (seq[: w + 1] < res).any(0)
        assert 0 < ends.sum() < N
        stuck = ~ends
        assert all(seq[w + 1, k] in seq[: w + 1, k] for k in np.flatnonzero(stuck))
        got = _np_u32(th.permutation_element(_t(y), res, w, _t(p)))
        want = np.asarray(jh.permutation_element(
            jnp.asarray(y[ends]), jnp.uint32(res), jnp.uint32(w), jnp.asarray(p[ends])))
        np.testing.assert_array_equal(got[ends], want)
        bounded = np.asarray(_jax_permutation_bounded(
            jnp.asarray(y), jnp.uint32(res), jnp.uint32(w), jnp.asarray(p)))
        np.testing.assert_array_equal(got, bounded)


def test_corrmj_grid_side_every_spp():
    """The grid side and its mask for every spp in 1..65536 against JAX's
    make_corrmj_sampler_xy (float32 sqrt), and the double formula of the
    JAX kernel's _smp_from_planes, which the in-kernel P2 cases use."""
    spp = np.arange(1, 65537)
    z = jnp.zeros(spp.shape, jnp.int32)
    js = jcmj.make_corrmj_sampler_xy(z, z, 0, jnp.asarray(spp, jnp.uint32), 0)
    res = np.array([tcmj.grid_side(int(v)) for v in spp])
    resw = np.array([th.next_pow2_mask(int(r)) for r in res])
    np.testing.assert_array_equal(res, np.asarray(js.res))
    np.testing.assert_array_equal(resw, np.asarray(js.resw))
    double = np.array([max(1, int((float(v) + 0.4) ** 0.5)) for v in spp])
    np.testing.assert_array_equal(res, double)
    p2 = [int(v) for v in spp if jloop._sampler_in_kernel_ok("corrmj", int(v))]
    assert p2 == [int(v) for v in spp if tcmj.is_p2(int(v))]
    assert p2[:6] == [1, 2, 4, 8, 16, 64]


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


@pytest.mark.parametrize("kind,spp", [
    pytest.param(kind, spp, id=f"{spp}-{kind}")
    for kind, spp in (("lcg", 4), ("lcg", 16), ("lcg", 64),
                      ("pmj02bn", 4), ("pmj02bn", 16), ("pmj02bn", 64),
                      ("pmj02bn", 3), ("pmj02bn", 12), ("pmj02bn", 96),
                      ("corrmj", 4), ("corrmj", 16), ("corrmj", 64),
                      ("corrmj", 12), ("corrmj", 32), ("corrmj", 96))])
def test_sampler_streams_bit_exact(kind, spp, jax_corrmj):
    """next1 / next2 streams over 24 dimensions from random pixels, seeds
    and sample indices: power-of-two spp (the loop-free permutation) and
    others (the rejection loop; corrmj's 32 has a grid side of 5), and the
    samplers' salts at each step."""
    rs = np.random.RandomState(spp + (kind == "lcg"))
    px = rs.randint(0, 1024, size=N).astype(np.int32)
    py = rs.randint(0, 1024, size=N).astype(np.int32)
    si = rs.randint(0, spp, size=N).astype(np.int32)
    seed = int(rs.randint(0, 2**31))
    jax_corrmj(spp)
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
        if kind != "lcg":
            np.testing.assert_array_equal(_np_u32(ts.salt()), np.asarray(js.salt()))
    assert type(ts).__name__ == type(js).__name__


@pytest.mark.parametrize("kind,spp", [
    pytest.param("lcg", 16, id="lcg"), pytest.param("pmj02bn", 16, id="pmj02bn"),
    ("pmj02bn", 12), ("corrmj", 16), ("corrmj", 96)])
def test_sampler_probe_plain_matches_jax(kind, spp, jax_corrmj):
    """The plain version of the sampler-probe kernel: per-lane seeds."""
    rs = np.random.RandomState(5)
    n, k = 512, 4
    lanes = np.stack([
        rs.randint(0, 512, n), rs.randint(0, 512, n),
        rs.randint(-2**31, 2**31, n), rs.randint(0, spp, n),
    ]).astype(np.int32)
    got = sampler_probe_plain(kind, spp, torch.as_tensor(lanes), k).numpy()
    jax_corrmj(spp)
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
    """Every spp >= 1 is in scope for both permuting samplers' factories;
    spp <= 0 raises ValueError in each. (JAX's factories take spp <= 0
    without a check, wrapping it to a uint32: there is nothing there to
    hold the port to.)"""
    px = torch.zeros(4, dtype=torch.int32)
    for kind in ("pmj02bn", "corrmj"):
        for spp in (0, -3):
            with pytest.raises(ValueError, match="spp"):
                make_sampler_xy(kind, px, px, 0, spp, 0)
    assert isinstance(make_sampler_xy("pmj02bn", px, px, 0, 12, 0), tpmj.PMJ02BNSampler)
    assert type(make_sampler_xy("corrmj", px, px, 0, 16, 0)) is tcmj.CorrMJSamplerP2
    assert type(make_sampler_xy("corrmj", px, px, 0, 12, 0)) is tcmj.CorrMJSampler


@pytest.mark.parametrize("kind,spp,n_tex", [
    ("pmj02bn", 16, 5), ("pmj02bn", 64, 12), ("pmj02bn", 64, 16), ("lcg", 16, 0),
    ("pmj02bn", 12, 12), ("pmj02bn", 65, 16), ("corrmj", 16, 0), ("corrmj", 64, 0),
    ("corrmj", 12, 0), ("corrmj", 96, 0), ("corrmj", 65, 0)])
def test_host_build_of_kernel_sampler_matches_plain(kind, spp, n_tex):
    """The kernels' sampler (csrc/path_loop_step.cuh: the hash's rounds over
    the pixel once a lane, a mask for a power-of-two blue-noise count, a
    product by 2^-k for / spp, the point seeds by selects, sobol2 as a sum
    over supersets; the generic instantiation's corrmj draws and
    per-lane rejection loop), built with g++, against the plain sampler bit
    for bit: 4096 random (pixel, seed, sample index) lanes, 12 next1 and 12
    next2 draws each (dimensions 0 to 35), on a random blue-noise table of
    n_tex textures (5 and 12: the modulo path). corrmj at 12 and 96 meets
    row strata past its grid, the loop's bound; at 65 a power-of-two grid
    side under a spp that is none."""
    from zdr_tpu_torch import kernels

    rs = np.random.RandomState(spp + n_tex)
    n, k, res = 4096, 12, 8
    lanes = torch.as_tensor(np.stack([
        rs.randint(0, 4096, n), rs.randint(0, 4096, n), rs.randint(-2**31, 2**31, n),
        rs.randint(0, spp, n)]).astype(np.int32))
    rows = torch.as_tensor(rs.rand(res * res * max(n_tex, 1)).astype(np.float32))
    bn = (rows, res, n_tex) if kind == "pmj02bn" else None
    out = torch.empty((3 * k, n), dtype=torch.float32)
    params = kernels.pack_params(kind, spp, 0, bn_res=res if bn else 0, bn_ntex=n_tex)
    rc = kernels.load_host_library().zdr_sampler_probe_host(
        params, rows.data_ptr() if bn else None, lanes.data_ptr(), n, k, out.data_ptr())
    assert rc == 0
    np.testing.assert_array_equal(out.numpy(), sampler_probe_plain(kind, spp, lanes, k, bn).numpy())


def test_host_build_of_kernel_sampler_covers_every_index():
    """pmj02bn at spp 2^16, the most the kernels take, one pixel and seed,
    every sample index: each draw's permuted index runs through all 2^16
    values, so the kernels' sobol2_vdc (sobol2 as a sum over supersets) is
    held against the plain vdc(sobol2(i)) at every index it can get, bit
    for bit, through the g++ build's sampler."""
    from zdr_tpu_torch import kernels

    spp, n_tex, k, res = 65536, 12, 12, 8
    idx = np.arange(spp)
    lanes = torch.as_tensor(np.stack([np.full(spp, 1234), np.full(spp, 567),
                                      np.full(spp, -98765), idx]).astype(np.int32))
    rows = torch.as_tensor(np.random.RandomState(3).rand(res * res * n_tex).astype(np.float32))
    out = torch.empty((3 * k, spp), dtype=torch.float32)
    params = kernels.pack_params("pmj02bn", spp, 0, bn_res=res, bn_ntex=n_tex)
    rc = kernels.load_host_library().zdr_sampler_probe_host(
        params, rows.data_ptr(), lanes.data_ptr(), spp, k, out.data_ptr())
    assert rc == 0
    want = sampler_probe_plain("pmj02bn", spp, lanes, k, (rows, res, n_tex))
    np.testing.assert_array_equal(out.numpy(), want.numpy())
