"""The env tables as the direct env kernels read them and their shade as
redesigned. The plain lookups (zdr_tpu_torch/envmap.py: the texel fetch,
the pdf and the alias draws over the texture and the alias tables, the
kernels' layout) against the JAX package's fused glue
(zdr_tpu/integrators/fused_glue.py: its quad-packed texture and packed
alias rows) bit for bit; and the shade of the direct env kernels
(kernels/csrc/direct_step.cuh direct_sample<kEnv>: the NEE shadow ray
walked only where the light sample lies above the shading hemisphere, the
env sample's pdf and texels read after the walk where NEE counts, in tap
mode) in the g++ build of the kernels' code, against a build of the same
sources that walks every shading lane and reads the env sample at once."""

import ctypes
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_direct import SPHERE_CAM, _port_scene
from test_torch_loop import _material

from zdr_tpu import envmap as jenv
from zdr_tpu.integrators import fused_glue as fg

import zdr_tpu_torch as zt
from zdr_tpu_torch import envmap as tenv
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

N = 4096
HM, WM = tenv.SAMPLE_MAP_H, tenv.SAMPLE_MAP_W
_ENV = {}


def _env():
    """make_test_envmap() (64 x 128), compensated, as the scenes build it:
    once a module."""
    if "env" not in _ENV:
        _ENV["env"] = tenv.build_envmap(jenv.make_test_envmap(), True)
    return _ENV["env"]


def _draws():
    rs = np.random.RandomState(11)
    u = rs.rand(N).astype(np.float32)
    v = rs.rand(N).astype(np.float32)
    u[:4], v[:4] = [0.0, 0.999999, 0.5, 1e-7], [0.0, 0.999999, 1.0, 1e-7]
    return u, v, rs.randint(0, HM, N)


def test_fetch_equals_env_fetch_planes():
    """texture_sample from the texture, texel by texel, equals
    env_fetch_planes from JAX's quad-packed rows on 4,096 seeded (u, v) bit
    for bit (the same anchor, weights and order of the sums)."""
    env = _env()
    u, v, _rows = _draws()
    h, w = env.texture.shape[:2]
    want = fg.env_fetch_planes(fg.pack_env_quads(jnp.asarray(env.texture.numpy())), (h, w),
                               jnp.asarray(u), jnp.asarray(v))
    got = tenv.texture_sample(env.texture, torch.as_tensor(u), torch.as_tensor(v))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pdf_matches_env_pdf_planes():
    """sampled_light_pdf against env_pdf_planes on 4,096 seeded (u, v): the
    table entry each reads (its bins, as XLA's truncating cast takes them)
    bit for bit, the pdf within rtol 1e-6 (atol 1e-7), the bar of
    tests/test_torch_envmap.py: torch's sin and XLA's differ by ulps."""
    env = _env()
    u, v, _rows = _draws()
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    bins = (tenv._bin(tv, HM) * WM + tenv._bin(tu, WM)).numpy()
    want_bins = (np.clip((v * HM).astype(np.int32), 0, HM - 1) * WM
                 + np.clip((u * WM).astype(np.int32), 0, WM - 1))
    np.testing.assert_array_equal(bins, want_bins)
    got = tenv.sampled_light_pdf(env.pdf, tu, tv)
    want = fg.env_pdf_planes(jnp.asarray(env.pdf.numpy()), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("table", ["marginal", "rows"])
def test_alias_draws_equal_sample_alias_planes(table):
    """The marginal's draw and a row's draw from the int32 alias tables
    equal _sample_alias_planes over JAX's packed [marginal | rows] (the
    alias a float value) on 4,096 seeded draws bit for bit: the index and
    the remapped u."""
    env = _env()
    u, _v, rows = _draws()
    alias = jnp.stack([jnp.asarray(env.alias_prob.numpy()),
                       jnp.asarray(env.alias_idx.numpy()).astype(jnp.float32)], axis=-1)
    n, offset = (HM, np.zeros(N, np.int64)) if table == "marginal" else (WM, HM + rows * WM)
    ji, juu = fg._sample_alias_planes(alias, n, jnp.asarray(u), jnp.asarray(offset))
    ti, tuu = tenv.sample_alias(env, n, torch.as_tensor(u), torch.as_tensor(offset))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tuu.numpy(), np.asarray(juu))


# ---------------------------------------------- the g++ build of the redesign

# the reference build's edits of direct_step.cuh: every shading lane walks
# its shadow ray, and the tap mode reads the env sample's pdf and texels at
# once, as the forward does
_WALK_ALL = (
    ("    occ = shade && wll.z >= 1e-4f && tr.any(tb, q, hit.p, nee.wi, nee.dist, &cnt);\n",
     "    occ = shade && tr.any(tb, q, hit.p, nee.wi, nee.dist, &cnt);\n"),
    ("                                   kEnv && kGrad ? &pick : nullptr);\n",
     "                                   nullptr);\n"),
)


@pytest.fixture(scope="module")
def walk_all(tmp_path_factory):
    """zdr_direct_env_host of the kernels' sources under _WALK_ALL, built
    with g++ as load_host_library builds the production one."""
    src = tmp_path_factory.mktemp("walk_all")
    for name in os.listdir(kernels.CSRC):
        if name.endswith((".cuh", ".cpp", ".cu")):
            shutil.copy(os.path.join(kernels.CSRC, name), src)
    path = src / "direct_step.cuh"
    text = path.read_text()
    for old, new in _WALK_ALL:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    out = str(src / "libwalk_all.so")
    subprocess.run(["g++", *kernels.HOST_FLAGS, "-o", out, str(src / "direct_host.cpp")],
                   check=True)
    prod = kernels.load_host_library().zdr_direct_env_host
    return kernels._bind(ctypes.CDLL(out), "zdr_direct_env_host", prod.argtypes)


def _host(entry, tb, lanes, mat, le=None, early=0):
    n = lanes.shape[1]
    acc = torch.empty((3, n))
    grad = torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    tables = kernels.direct_tables(tb)
    cpu = torch.device("cpu")
    bvh = (None, None, 0, 0) if tb.bvh is None else kernels.bvh_args(tb.bvh, cpu)
    rc = entry(kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
               mat.data_ptr(), lanes.data_ptr(), None if le is None else le.data_ptr(),
               acc.data_ptr(), grad.data_ptr(), counts.data_ptr(), n, early,
               *kernels.env_args(tb.env, cpu), *bvh)
    assert rc == 0
    return acc, grad, counts.tolist()


def _shading(tb, lanes, mat):
    """The plain direct samples' shading lanes and, of them, those whose
    shadow ray the kernels skip (the light sample below the hemisphere:
    chip_smoke._ShadeWork, which counts them for the card's bounds)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    with cs._ShadeWork() as work:
        dr.render_direct_plain(tb, lanes, mat)
    return work.walked + work.skipped, work.skipped


@pytest.mark.parametrize("route", ["early", "bvh"])
def test_host_skip_and_late_read_keep_the_image(route, walk_all):
    """The g++ build of direct_sample<kEnv> on the sphere of 8 x 16 over its
    quad light under the env, 16x16, 4 spp, roughness in [0.5, 0.9], by the
    dense sweep with the early out and through the BVH: the image equals the
    walk-every-lane build's bit for bit, the gradient within max|a - b| /
    max|a| < 1e-5; the tap mode's image and counts equal the forward's; the
    shadow walks skipped are some of the shading lanes but not all (the
    plain samples' count), and the build that walks them all counts more
    work."""
    s = _port_scene("sphere")
    s.add_envmap(jenv.make_test_envmap())
    if route == "bvh":
        s.accel = "bvh"
    mat = _material(seed=6)
    mat[..., 3] = np.random.RandomState(7).uniform(0.5, 0.9, mat.shape[:2])
    mat = torch.as_tensor(mat)
    tb = pl.build_loop_tables(s._render_data("direct"), s.camera, s._config((16, 16), 4), 11)
    assert (tb.bvh is not None) == (route == "bvh") and tb.env is not None
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    early = int(route == "early")
    prod = kernels.load_host_library().zdr_direct_env_host
    acc, _g, counts = _host(prod, tb, lanes, mat, early=early)
    ref, _g, ref_counts = _host(walk_all, tb, lanes, mat, early=early)
    assert torch.equal(acc, ref)
    g_acc, grad, g_counts = _host(prod, tb, lanes, mat, le, early)
    _r, ref_grad, _c = _host(walk_all, tb, lanes, mat, le, early)
    assert torch.equal(g_acc, acc) and g_counts == counts
    assert float(ref_grad.abs().max()) > 0
    assert float((grad - ref_grad).abs().max() / ref_grad.abs().max()) < 1e-5
    shading, skipped = _shading(tb, lanes, mat)
    assert 0 < skipped < shading
    assert counts[0] < ref_counts[0]
    if route == "bvh":
        assert counts[1] < ref_counts[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["forward", "gradient"])
def test_cuda_env_bvh_kernels_match_plain(kind):
    """On the card, direct_env_bvh (bit for bit) and direct_grad_env_bvh
    (max|a - b| / max|a| < 1e-5, float atomics) against their plain
    versions on the sphere under the env through the BVH, 32x32, 4 spp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], accel="bvh", device=dev)
    s.camera = zt.Camera(**SPHERE_CAM)
    s.add_envmap(jenv.make_test_envmap())
    mat = torch.as_tensor(_material(seed=6), device=dev)
    data = s._render_data("direct")
    tb = pl.build_loop_tables(data, s.camera, s._config((32, 32), 4), 11)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    if kind == "forward":
        got = kernels.direct_env_bvh(tb, lanes, mat)
        assert torch.equal(got, dr.render_direct_plain(tb, lanes, mat))
        return
    le = torch.full((3, lanes.shape[1]), 0.25, device=dev)
    grad, _acc = kernels.direct_grad_env_bvh(tb, lanes, mat, le)
    want, _acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    assert float((grad - want).abs().max() / want.abs().max()) < 1e-5
