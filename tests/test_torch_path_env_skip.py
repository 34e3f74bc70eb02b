"""The path integrator's env kernels as redesigned (kernels/csrc/
path_loop_step.cuh loop_step<.., kEnv = true>): the NEE shadow ray walked
only where the light sample lies above the shading hemisphere. The g++
build of the kernels' code (zdr_path_loop_env_host) against a build of the
same sources edited to walk every shading lane, on the cornell box with its
light and on the env-only sphere under make_test_envmap(), by the dense
sweep and through the BVH; and on the card, the two gradient kernels
against their plain versions. Imports nothing of JAX, so that its card
tests run where JAX is not installed."""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.envmap import make_test_envmap
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import path_loop as pl
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

RES, SPP, SEED = (16, 16), 4, 11
CAM = dict(fov=0.87, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))
SPHERE_CAM = dict(fov=50 / 180 * np.pi, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))
_ENV = {}

# the reference build's edit of path_loop_step.cuh: every shading lane
# walks its shadow ray
_WALK_ALL = (
    ("    occ = shade && wi_light_local.z >= 1e-4f && tr.any(tb, q, s.p, s.wl, s.l_dist, c);\n",
     "    occ = shade && tr.any(tb, q, s.p, s.wl, s.l_dist, c);\n"),
)


def _envmap(device):
    """make_test_envmap() (64 x 128), its tables built once a module."""
    if "img" not in _ENV:
        _ENV["img"] = make_test_envmap()
    return _ENV["img"]


def _scene(name, accel, device="cpu"):
    """The cornell box with its light (env + mesh light samples) or the
    sphere of 8 x 16 (224 triangles, the env its only light) under the env,
    paths stopped at depth 4."""
    if name == "cbox":
        s = zt.Scene([(tproc.make_cornell_box(), None, None),
                      (tproc.make_cornell_light(), None, 15.0)], "path", accel, device=device)
        s.camera = zt.Camera(**CAM)
    else:
        s = zt.Scene([(tproc.make_uv_sphere(0.5, 8, 16), None, None)], "path", accel,
                     device=device)
        s.camera = zt.Camera(**SPHERE_CAM)
    s.add_envmap(_envmap(device))
    s.max_depth = 4
    return s


def _material(seed, res=16):
    """Diffuse in [0.1, 0.9], roughness in [0.5, 0.9]."""
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, size=(res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.5, 0.9, size=(res, res))
    return torch.as_tensor(mat)


@pytest.fixture(scope="module")
def walk_all(tmp_path_factory):
    """zdr_path_loop_env_host of the kernels' sources under _WALK_ALL, built
    with g++ as load_host_library builds the production one."""
    src = tmp_path_factory.mktemp("walk_all")
    for name in os.listdir(kernels.CSRC):
        if name.endswith((".cuh", ".cpp", ".cu")):
            shutil.copy(os.path.join(kernels.CSRC, name), src)
    path = src / "path_loop_step.cuh"
    text = path.read_text()
    for old, new in _WALK_ALL:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    out = str(src / "libwalk_all.so")
    subprocess.run(["g++", *kernels.HOST_FLAGS, "-o", out, str(src / "path_loop_host.cpp")],
                   check=True)
    prod = kernels.load_host_library().zdr_path_loop_env_host
    return kernels._bind(ctypes.CDLL(out), "zdr_path_loop_env_host", prod.argtypes)


def _host(entry, tb, lanes, mat, n_steps, le=None, carry=None):
    """One call of a build's zdr_path_loop_env_host from `carry` (the first
    carry by default) -> (the carry after n_steps, the gradient or None,
    counts: tests and node visits)."""
    n = lanes.shape[1]
    carry = pl.init_carry(lanes) if carry is None else carry
    cpu = torch.device("cpu")
    tables, params = kernels.pack_tables(tb), kernels.loop_params(tb, mat)
    f_out, i_out = torch.empty_like(carry.f), torch.empty_like(carry.i)
    k_near = min(kernels.GRAD_NEAR_ROWS["bvh" if tb.bvh is not None else "dense"], tb.max_depth)
    far = torch.empty((tb.max_depth - k_near, kernels.GRAD_ROW_PLANES, n))
    grad = torch.zeros_like(mat)
    counts = torch.zeros((2,), dtype=torch.int64)
    bvh = (None, None, 0, 0) if tb.bvh is None else kernels.bvh_args(tb.bvh, cpu)
    rc = entry(params, tables.data_ptr(), tables.numel(), 1, tb.bn.data_ptr(), mat.data_ptr(),
               lanes.data_ptr(), None if le is None else le.data_ptr(), carry.f.data_ptr(),
               carry.i.data_ptr(), f_out.data_ptr(), i_out.data_ptr(), far.data_ptr(),
               grad.data_ptr(), n, n_steps, k_near, *bvh, counts.data_ptr(),
               *kernels.env_args(tb.env, cpu))
    assert rc == 0
    return pl.Carry(f_out, i_out), (None if le is None else grad), counts.tolist()


def _inputs(name, accel):
    s = _scene(name, accel)
    tb = pl.build_loop_tables(s._render_data("path"), s.camera, s._config(RES, SPP), SEED)
    assert (tb.bvh is not None) == (accel == "bvh") and tb.env is not None
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    return tb, lanes, _material(6), le


def _path_work(tb, lanes, mat):
    """chip_smoke._path_work on every lane, the plain walk's count of the
    shadow rays the kernels walk and skip and of the dense sweep's tests."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    return cs._path_work(dataclasses.replace(tb, bvh=None), lanes, mat, stride=1)


@pytest.mark.parametrize("accel", ["bruteforce", "bvh"])
@pytest.mark.parametrize("name", ["cbox", "sphere"])
def test_host_skip_keeps_the_image(name, accel, walk_all):
    """16x16, 4 spp, roughness in [0.5, 0.9], a random adjoint, by the dense
    sweep and through the BVH: the forward's carry equals the walk-all
    build's bit for bit, the gradient within max|a - b| / max|a| < 1e-5
    (on the card the float atomics add in a varying order); the tap
    mode's carry and counts equal the forward's; the shadow walks skipped
    are some of the shading steps but not all (the plain walk's count,
    chip_smoke._path_work, whose tests equal the dense build's), and the
    walk-all build counts more tests on the dense route, and more node
    visits and no fewer tests through the BVH."""
    tb, lanes, mat, le = _inputs(name, accel)
    prod = kernels.load_host_library().zdr_path_loop_env_host
    fwd, _g, counts = _host(prod, tb, lanes, mat, tb.n_steps)
    ref, _g, ref_counts = _host(walk_all, tb, lanes, mat, tb.n_steps)
    assert torch.equal(fwd.f, ref.f) and torch.equal(fwd.i, ref.i)
    assert float(fwd.f[0:3].max()) > 0
    g_carry, grad, g_counts = _host(prod, tb, lanes, mat, tb.n_steps, le)
    _c, ref_grad, _rc = _host(walk_all, tb, lanes, mat, tb.n_steps, le)
    assert torch.equal(g_carry.f, fwd.f) and torch.equal(g_carry.i, fwd.i)
    assert g_counts == counts
    assert float(ref_grad.abs().max()) > 0
    assert float((grad - ref_grad).abs().max() / ref_grad.abs().max()) < 1e-5
    work = _path_work(tb, lanes, mat)
    assert 0 < work["shadow_skipped"] < work["shadow_walked"] + work["shadow_skipped"]
    assert work["below_env"] > 0
    if accel == "bruteforce":
        assert work["tests"] == counts[0] < ref_counts[0]
    else:
        # a ray into the cornell box's wall may leave the tree before a leaf
        assert counts[0] <= ref_counts[0] and counts[1] < ref_counts[1]


@pytest.mark.parametrize("accel", ["bruteforce", "bvh"])
def test_host_tap_mode_writes_out_the_forward_carry(accel):
    """The carry a tap-mode launch writes out after 1, 2 and 3 steps on the
    cornell box equals the forward's bit for bit, and its env light
    samples' pdf and radiance (l_pdf, lev) the plain step's chain within
    the host builds' bars (glibc's sinf and torch's differ by ulps:
    tests/test_torch_path_env.py)."""
    tb, lanes, mat, le = _inputs("cbox", accel)
    prod = kernels.load_host_library().zdr_path_loop_env_host
    want = pl.init_carry(lanes)
    env_rows = [pl.F_IDX[k] for k in ("l_pdf", "lev_r", "lev_g", "lev_b")]
    for n_steps in (1, 2, 3):
        fwd, _g, _c = _host(prod, tb, lanes, mat, n_steps)
        got, _g, _c = _host(prod, tb, lanes, mat, n_steps, le)
        assert torch.equal(got.f, fwd.f) and torch.equal(got.i, fwd.i)
        want = pl.loop_step(want, tb, lanes, mat)
        env = want.f[pl.F_IDX["l_dist"]] == 1e30
        assert bool(env.any())
        np.testing.assert_array_equal(got.i.numpy(), want.i.numpy())
        np.testing.assert_allclose(got.f[env_rows][:, env].numpy(),
                                   want.f[env_rows][:, env].numpy(), rtol=1e-5, atol=1e-6)


def _cuda_inputs(name, accel):
    dev = torch.device("cuda", 0)
    s = _scene(name, accel, dev)
    tb = pl.build_loop_tables(s._render_data("path"), s.camera, s._config((32, 32), 4), SEED)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    return tb, lanes, _material(6).to(dev), le


@pytest.mark.cuda
@pytest.mark.parametrize("name,accel", [("cbox", "bruteforce"), ("sphere", "bvh")])
def test_cuda_path_env_grad_kernels_match_plain(name, accel):
    """On the card, path_loop_grad_env (the cornell box, dense) and
    path_loop_grad_env_bvh (the sphere, BVH) against the plain backward at
    32x32, 4 spp: max|a - b| / max|a| < 1e-5 (float atomics), the radiance
    of the written-out carry equal to the plain walk's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tb, lanes, mat, le = _cuda_inputs(name, accel)
    grad, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    want, want_carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    kname = "path_loop_grad_env" + ("_bvh" if accel == "bvh" else "")
    assert getattr(kernels, kname).launches >= 1
    assert float(want.abs().max()) > 0
    assert float((grad - want).abs().max() / want.abs().max()) < 1e-5
    assert torch.equal(carry.f[0:3], want_carry.f[0:3])
