"""The gradient splat's knobs, splat_merge > 1 and packed_splat=True, in the
port against the JAX package on the CPU, at tiny sizes on inputs made from
a seed with numpy.

Bars, each with what was measured:
  - bit for bit: round_bf16 and the bf16 pair against JAX's astype(bfloat16)
    and pack_bf16_pair / unpack_bf16_pair on random float32 and the edge
    values (+-0, ties, denormals, near FLT_MAX, inf); the g++ build of the
    kernels' round_bf16 (splat.cuh) against round_bf16; reservoir_merge_taps
    against JAX's on random taps and draws with sentinel and zero-weight
    sides; scatter_add4(packed, prepacked) against segment_scatter_add4 on
    values whose sums are exact in float32;
  - the loop route (the kernels' plain version) against JAX's
    render_path_backward_loop at one window (4x4, max_depth 16, 4 spp, so
    (spp + 2) max_depth <= 256), on the same sampler stream: at (4, False)
    max|a - b| / max|a| < 1e-5, the bar of tests/test_torch_grad_bridge.py
    (measured 7.0e-7 to 1.6e-6: the taps agree to float rounding, JAX sums
    by cumsum differences and the port by index_add_, and no merge choice
    u tot < wp flipped); at (4, True) every texel within one bf16 ulp of
    JAX's or 1e-6 of the largest (measured: 2-3 of ~160 texels differ, by
    4e-7 of the largest), _assert_packed_close;
  - the direct and collocated gradients, packed, at 8 spp (two flush
    groups) against jax.grad through JAX's fused route: _assert_packed_close
    and max|a - b| / max|a| < 1e-5 at roughness >= 0.5 (measured: equal
    bit for bit at 16x16);
  - the unfused persistent walk at (4, True) against JAX's fused=False
    backward: _assert_packed_close (measured: 8 of 520 texels differ, by
    1.0e-7 of the largest);
  - the host build of the packed direct and collocated kernels against
    their plain versions: _assert_packed_close;
  - the twins of JAX's knob gates (tests/test_config_knobs.py:191-233) on
    the port's Scene: the merge's noise under 0.8 of the cross-seed noise
    (measured 0.222 against 0.335), the bits change; packed within 2% of
    the exact gradient's largest texel (measured 0.16%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _jax_scene, _material, _port_camera, _port_data
from test_torch_unfused_jax import _jax_vjp, _port, _port_cfg, _scenes, _weights

from zdr_tpu import texture as jtex
from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.integrators.wrapper import _pixel_grid

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch import texture as ttex
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.wrapper import RenderConfig
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)


def _edge_floats():
    """Random float32 over the whole exponent range, and the edges: +-0,
    ties (1 + 2^-8 rounds down to even, 1 + 3 2^-8 up), denormals, the
    values around bf16's largest and FLT_MAX, +-inf."""
    rs = np.random.RandomState(0)
    mant = rs.uniform(1.0, 2.0, 20000) * rs.choice([-1.0, 1.0], 20000)
    x = (mant * 2.0 ** rs.randint(-149, 128, 20000)).astype(np.float32)
    bits = rs.randint(0, 2**31 - 2**23, 20000).astype(np.int32)  # finite, either sign
    x = np.concatenate([x, bits.view(np.float32), -bits.view(np.float32)])
    edge = np.array([0.0, -0.0, 1.0, 1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1e-40, -1e-40,
                     1e-45, 9.2e-41, 5.9e-39, 3.3895314e38, 3.3961776e38, 3.4028235e38,
                     -3.4028235e38, np.inf, -np.inf], np.float32)
    return np.concatenate([edge, x[np.isfinite(x)]])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_round_bf16_and_pair_bit_exact():
    x = _edge_floats()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(_bits(ttex.round_bf16(torch.as_tensor(x)).numpy()), _bits(want))
    assert bool(torch.isnan(ttex.round_bf16(torch.tensor([float("nan")]))).all())
    a, b = x, np.roll(x, 7)
    jp = np.asarray(jtex.pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    tp = ttex.pack_bf16_pair(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    ja, jb = jtex.unpack_bf16_pair(jnp.asarray(jp))
    ta, tb = ttex.unpack_bf16_pair(torch.as_tensor(tp))
    np.testing.assert_array_equal(_bits(ta.numpy()), _bits(np.asarray(ja)))
    np.testing.assert_array_equal(_bits(tb.numpy()), _bits(np.asarray(jb)))


def test_host_build_of_the_kernels_rounding_matches_plain():
    """splat.cuh's round_bf16, the epilogue's and the kPacked taps', built
    with g++: bit for bit round_bf16's, NaN kept."""
    x = torch.as_tensor(np.concatenate([_edge_floats(), [np.nan]]).astype(np.float32))
    out = torch.empty_like(x)
    assert kernels.load_host_library().zdr_round_bf16_host(x.data_ptr(), out.data_ptr(),
                                                           x.numel()) == 0
    want = ttex.round_bf16(x)
    np.testing.assert_array_equal(_bits(out[:-1].numpy()), _bits(want[:-1].numpy()))
    assert bool(torch.isnan(out[-1]))


def _random_taps(rs, m, n_bins):
    """(ids, g0..g3) with a sentinel on a quarter of the lanes and all-zero
    channels on another quarter, and magnitudes over 12 decades."""
    ids = rs.randint(0, n_bins, m).astype(np.int32)
    ids[rs.rand(m) < 0.25] = n_bins
    g = (rs.randn(4, m) * 10.0 ** rs.uniform(-8, 4, (4, m))).astype(np.float32)
    g[:, rs.rand(m) < 0.25] = 0.0
    g[rs.rand(4, m) < 0.2] = 0.0
    return (ids, *g)


def test_reservoir_merge_bit_exact():
    rs = np.random.RandomState(1)
    m, n_bins = 50000, 97
    pend, new = _random_taps(rs, m, n_bins), _random_taps(rs, m, n_bins)
    u = rs.rand(m).astype(np.float32)
    u[:16] = np.float32(1.0 - 2**-24)
    want = jtex.reservoir_merge_taps(tuple(jnp.asarray(t) for t in pend),
                                     tuple(jnp.asarray(t) for t in new), jnp.asarray(u), n_bins)
    got = ttex.reservoir_merge_taps(tuple(torch.as_tensor(t) for t in pend),
                                    tuple(torch.as_tensor(t) for t in new), torch.as_tensor(u),
                                    n_bins)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))
    # the exact cases: a sentinel or zero-weight side passes the other through
    real = (pend[0] < n_bins) & (np.abs(np.stack(pend[1:])).sum(0) > 0)
    empty = (new[0] == n_bins) & real
    assert empty.sum() > 1000
    for c in range(4):
        np.testing.assert_array_equal(got[1 + c].numpy()[empty], pend[1 + c][empty])


@pytest.mark.parametrize("packed,prepacked", [(False, False), (True, False), (True, True)])
def test_scatter_add4_packed_matches_jax(packed, prepacked):
    """Values on a 2^-10 grid (prepacked: bf16-exact ones), so that every
    sum is exact in float32 and JAX's cumsum differences equal the port's
    index_add_: the rounding then bit for bit."""
    rs = np.random.RandomState(2)
    m, n_bins = 4096, 61
    ids = rs.randint(0, n_bins + 1, m).astype(np.int32)
    step = 2.0 ** -4 if prepacked else 2.0 ** -10
    vals = (rs.randint(-2000, 2000, (m, 4)) * step).astype(np.float32)
    if prepacked:
        vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
        chans = [jtex.pack_bf16_pair(jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])),
                 jtex.pack_bf16_pair(jnp.asarray(vals[:, 2]), jnp.asarray(vals[:, 3]))]
    else:
        chans = [jnp.asarray(vals[:, c]) for c in range(4)]
    want = np.asarray(jtex.segment_scatter_add4(jnp.asarray(ids), chans, n_bins,
                                                packed=packed, prepacked=prepacked)).T
    got = ttex.scatter_add4(torch.as_tensor(ids.astype(np.int64)), torch.tensor(vals),
                            n_bins, packed=packed, prepacked=prepacked).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _bf16_ulp(x):
    """One bf16 ulp of each |x|: 2^(exponent - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _assert_packed_close(got, want):
    """Every texel within one bf16 ulp of the reference's, or 1e-6 of the
    largest: the totals agree to float rounding and are rounded to bf16,
    where a total near a rounding boundary may round to the other side ->
    the count of texels that differ at all."""
    assert np.abs(want).max() > 0
    bar = np.maximum(_bf16_ulp(want), 1e-6 * np.abs(want).max())
    bad = np.abs(got - want) > bar
    assert not bad.any(), (int(bad.sum()), np.abs(got - want).max())
    return int((got != want).sum())


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


_LOOP = {}


def _jax_loop_backward(sampler, point_light, merge, packed):
    """JAX's loop backward at 4x4, 4 spp, max_depth 16, seed 3, one jit a
    configuration -> (its Scene, the function of (material, adjoint))."""
    key = (sampler, point_light, merge, packed)
    if key not in _LOOP:
        s = _jax_scene(point_light, sampler)
        s.max_depth = 16
        cfg = dataclasses.replace(s._config((4, 4), 4), fused="force", splat_merge=merge,
                                  packed_splat=packed)
        _LOOP[key] = (s, jax.jit(lambda mat, le: plp.render_path_backward_loop(
            s._data, mat, s.camera, jnp.int32(3), cfg, _pixel_grid(cfg.res), le)))
    return _LOOP[key]


@pytest.mark.parametrize("sampler,point_light", [("pmj02bn", False), ("lcg", True)])
@pytest.mark.parametrize("packed", [False, True])
def test_loop_backward_matches_jax_at_one_window(sampler, point_light, packed):
    """splat_merge 4: the port's plain backward (the kernels' plain version)
    against JAX's render_path_backward_loop on the same stream, where JAX
    runs one window ((4 + 2) 16 = 96 steps <= LOOP_TAP_CAP)."""
    s, backward = _jax_loop_backward(sampler, point_light, 4, packed)
    mat = _material(seed=3)
    mat[..., 3] = np.random.RandomState(103).uniform(0.5, 0.9, (16, 16))
    le = np.random.RandomState(1).rand(16, 3).astype(np.float32)
    want = np.asarray(backward(jnp.asarray(mat), jnp.asarray(le)))
    tcfg = RenderConfig(res=(4, 4), spp=4, sampler=sampler, max_depth=16, splat_merge=4,
                        packed_splat=packed)
    got = pl.render_path_backward_loop(
        _port_data(s), torch.as_tensor(mat), _port_camera(), 3, tcfg,
        torch.as_tensor(le.T.copy()), pl.pixel_lanes((4, 4), 4, "cpu")).numpy()
    assert (4 + 2) * 16 <= plp.LOOP_TAP_CAP  # one window
    assert _rel(want, got) < 1e-5
    if packed:
        _assert_packed_close(got, want)
    # the merge engaged: fewer texels than the unmerged walk touches
    unmerged = pl.render_path_backward_loop(
        _port_data(s), torch.as_tensor(mat), _port_camera(), 3,
        dataclasses.replace(tcfg, splat_merge=1, packed_splat=False),
        torch.as_tensor(le.T.copy()), pl.pixel_lanes((4, 4), 4, "cpu")).numpy()
    assert (np.abs(got).sum(-1) > 0).sum() < (np.abs(unmerged).sum(-1) > 0).sum()


def _jax_fused_scene(integrator, packed):
    from zdr_tpu import Camera, Scene, float3
    from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light
    from test_torch_loop import CAM

    s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
              integrator=integrator)
    s.camera = Camera(fov=CAM["fov"], origin=float3(*CAM["origin"]),
                      target=float3(*CAM["target"]))
    s.fused, s.packed_splat, s.splat_merge = "force", packed, 4
    return s


def _port_box(integrator, packed, merge=4):
    from test_torch_loop import CAM

    s = zt.Scene([(tproc.make_cornell_box(), None, None),
                  (tproc.make_cornell_light(), None, 15.0)], integrator=integrator,
                 accel="bruteforce", device="cpu")
    s.camera = zt.Camera(**CAM)
    s.packed_splat, s.splat_merge = packed, merge
    return s


@pytest.mark.parametrize("integrator", ["direct", "collocated"])
def test_packed_direct_and_collocated_match_jax(integrator):
    """loss = sum(image[..., :3] * w) at 16x16, 8 spp (two flush groups),
    splat_merge 4 (read by neither), packed: the port's Scene.render +
    backward against jax.grad through JAX's fused route; and the knob
    engages (the packed gradient is not the exact one)."""
    w = np.random.RandomState(2).uniform(0.0, 2.0, (16, 16, 3)).astype(np.float32)
    mat = _material(seed=4)
    mat[..., 3] = np.random.RandomState(5).uniform(0.5, 0.9, (16, 16))
    js = _jax_fused_scene(integrator, True)
    want = np.asarray(jax.grad(lambda m: jnp.sum(
        js.render(m, res=(16, 16), spp=8, seed=3)[..., :3] * w))(jnp.asarray(mat)))

    def port(packed):
        ts = _port_box(integrator, packed)
        tmat = torch.as_tensor(mat).requires_grad_()
        (ts.render(tmat, res=(16, 16), spp=8, seed=3)[..., :3] * torch.as_tensor(w)).sum().backward()
        return tmat.grad.numpy()

    got = port(True)
    assert _rel(want, got) < 1e-5
    _assert_packed_close(got, want)
    assert not np.array_equal(got, port(False))


def test_unfused_walk_matches_jax_merged_and_packed():
    """The persistent walk (fused=False) at splat_merge 4, packed, 8x8, 4
    spp: image and gradient against JAX's path_persistent backward by one
    jax.vjp (the golden bar for the image, _assert_packed_close for the
    gradient); and the knobs engage."""
    js, ts = _scenes("cbox", "path")
    for s in (js, ts):
        s.splat_merge, s.packed_splat = 4, True
    mat, w = _material(seed=4), _weights()
    mat[..., 3] = np.random.RandomState(6).uniform(0.5, 0.9, (16, 16))
    jcfg = js._config((8, 8), 4)
    want, want_g = _jax_vjp(js, jcfg, mat, w)
    cfg = _port_cfg(ts, jcfg)
    assert (cfg.splat_merge, cfg.packed_splat) == (4, True)
    got, got_g = _port(ts, cfg, mat, w)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    _assert_packed_close(got_g, want_g)
    _img, exact = _port(ts, dataclasses.replace(cfg, splat_merge=1, packed_splat=False), mat, w)
    assert not np.array_equal(got_g, exact)


MAT = torch.full((32, 32, 4), 0.5)


def _knob_grad(seed, merge=1, packed=False):
    s = _port_box("path", packed, merge)
    s.accel = "auto"
    m = MAT.clone().requires_grad_()
    s.render(m, res=(24, 24), spp=8, seed=seed)[..., :3].sum().backward()
    return m.grad.numpy()


def test_splat_merge_grad_unbiased_and_close():
    """The twin of tests/test_config_knobs.py:191-219 on the port's Scene
    (the kernel route's plain version): splat_merge 2 changes the bits, and
    its same-seed difference stays under 0.8 of the cross-seed noise."""
    g1, g2 = _knob_grad(3, 1), _knob_grad(3, 2)
    assert not np.array_equal(g1, g2), "splat_merge knob did not engage"
    denom = np.abs(g1).sum()
    assert denom > 0
    merge_noise = np.abs(g1 - g2).sum() / denom
    inherent = np.abs(g1 - _knob_grad(4, 1)).sum() / denom
    assert merge_noise < 0.8 * inherent, (merge_noise, inherent)


def test_packed_splat_grad_close_to_exact():
    """The twin of tests/test_config_knobs.py:221-233: packed within 2% of
    the exact gradient's largest texel."""
    g_packed, g_exact = _knob_grad(5, packed=True), _knob_grad(5)
    scale = np.abs(g_exact).max()
    assert scale > 0
    assert np.abs(g_packed - g_exact).max() <= 0.02 * scale
    assert not np.array_equal(g_packed, g_exact)


# ------------------------------------------- the g++ build of the packed kernels

def _host_run(entry, tb, lanes, mat, le_grad, tail):
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    acc = torch.empty((3, n))
    grad = torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    tables = kernels.direct_tables(tb) if entry == "zdr_direct_host" else kernels.pack_tables(tb)
    rc = getattr(lib, entry)(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), le_grad.data_ptr(), acc.data_ptr(), grad.data_ptr(),
        counts.data_ptr(), n, *tail)
    assert rc == 0
    return grad, acc


@pytest.mark.parametrize("integrator", ["direct", "collocated"])
def test_host_build_of_packed_kernels_matches_plain(integrator):
    """The kPacked instantiations (kernels/csrc/direct_step.cuh,
    collocated_step.cuh), built with g++ and run group by group as the
    card's launches are (splat.cuh host_packed_groups), against the plain
    backward at 16x16, 10 spp (groups of 4, 4 and 2): the radiance sums as
    the unpacked build's, the gradient per texel within one bf16 ulp
    (_assert_packed_close; glibc's sinf and torch's differ by ulps)."""
    from zdr_tpu_torch.integrators import collocated as co
    from zdr_tpu_torch.integrators import direct as dr

    s = _port_box(integrator, True)
    mat = torch.as_tensor(_material(seed=7))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((16, 16), 10), 5)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(9).rand(3, lanes.shape[1]).astype(np.float32))
    entry, tail = ("zdr_direct_host", (0,)) if integrator == "direct" else (
        "zdr_collocated_host", (None, None, 0, 0))
    got, acc = _host_run(entry, tb, lanes, mat, le, tail)
    plain = dr.render_direct_backward_plain if integrator == "direct" else \
        co.render_collocated_backward_plain
    want, want_acc = plain(tb, lanes, mat, le)
    _assert_packed_close(got.numpy(), want.numpy())
    exact, exact_acc = _host_run(entry, dataclasses.replace(tb, packed_splat=False), lanes, mat,
                                 le, tail)
    assert torch.equal(acc, exact_acc)
    assert not torch.equal(got, exact)
    np.testing.assert_allclose(acc.numpy(), want_acc.numpy(), atol=1e-4, rtol=1e-5)
