"""The gradient kernel's own per-lane code (kernels/csrc/path_loop_step.cuh
in tap mode), built with g++ (kernels.load_host_library()), against the
plain backward; and the finite-difference gate of the PRB gradient, run on
that build because it renders hundreds of samples per pixel.
"""

import numpy as np
import pytest
import torch
from test_torch_loop import _material

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.texture import round_bf16
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)


def _scene(sampler):
    s = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                 integrator="path", sampler=sampler, device="cpu")
    s.camera = zt.Camera(fov=50 / 180 * 3.14159, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
    return s


def _host_grad(tb, lanes, mat, le_grad, k_near=kernels.GRAD_NEAR_ROWS["dense"]):
    """zdr_path_loop_grad_host, the first k_near tap rows of a sample where
    the kernel keeps them in shared memory (the flagship's launch takes
    GRAD_NEAR_ROWS["dense"]), the rest in global scratch -> (d_material
    (H, W, 4), the final carry)."""
    lib = kernels.load_host_library()
    n = lanes.shape[1]
    carry = pl.init_carry(lanes)
    f, i = torch.empty_like(carry.f), torch.empty_like(carry.i)
    rows = max(tb.max_depth, 1)
    k_near = min(k_near, rows)
    # the kMerge instantiations keep the merge draw u_m in a row too
    planes = kernels.GRAD_ROW_PLANES + (1 if tb.splat_merge > 1 else 0)
    far = torch.empty((rows - k_near, planes, n))
    grad = torch.zeros_like(mat)
    tables = kernels.pack_tables(tb)
    rc = lib.zdr_path_loop_grad_host(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), le_grad.data_ptr(), carry.f.data_ptr(),
        carry.i.data_ptr(), f.data_ptr(), i.data_ptr(), far.data_ptr(), grad.data_ptr(),
        n, tb.n_steps, k_near)
    assert rc == 0
    if tb.packed_splat:  # the launch's epilogue, splat_round
        grad = round_bf16(grad)
    return grad, pl.Carry(f, i)


def _host_render(tb, lanes, mat):
    """zdr_path_loop_host over the whole walk -> (W*H, 3) mean radiance."""
    lib = kernels.load_host_library()
    carry = pl.init_carry(lanes)
    f, i = torch.empty_like(carry.f), torch.empty_like(carry.i)
    tables = kernels.pack_tables(tb)
    rc = lib.zdr_path_loop_host(
        kernels.loop_params(tb, mat), tables.data_ptr(), tables.numel(), tb.bn.data_ptr(),
        mat.data_ptr(), lanes.data_ptr(), carry.f.data_ptr(), carry.i.data_ptr(),
        f.data_ptr(), i.data_ptr(), lanes.shape[1], tb.n_steps)
    assert rc == 0
    return f[0:3].T / tb.spp


def _assert_host_grad_matches_plain(sampler, rough_lo, bar, k_near=kernels.GRAD_NEAR_ROWS["dense"],
                                    max_depth=6, merge=1, packed=False):
    """24x24, 8 spp, max_depth 6, roughness in [rough_lo, 0.9], a random
    adjoint: the gradient within max|a - b| / max|a| < bar, and the walk's
    own radiance (acc) as the forward render's (glibc's sinf and torch's
    differ by ulps, as in
    test_torch_loop.test_host_build_of_kernel_step_matches_plain)."""
    s = _scene(sampler)
    s.max_depth = max_depth
    s.splat_merge, s.packed_splat = merge, packed
    mat = _material(seed=6)
    mat[..., 3] = np.random.RandomState(7).uniform(rough_lo, 0.9, mat.shape[:2])
    mat = torch.as_tensor(mat)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((24, 24), 8), 11)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.as_tensor(np.random.RandomState(8).rand(3, lanes.shape[1]).astype(np.float32))
    got, carry = _host_grad(tb, lanes, mat, le, k_near)
    want, want_carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max() / want.abs().max()) < bar
    np.testing.assert_array_equal(carry.i[0].numpy(), want_carry.i[0].numpy())
    diff = (carry.f[0:3] - want_carry.f[0:3]).abs().max(dim=0).values
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.99


@pytest.mark.parametrize("sampler", ["pmj02bn", "lcg"])
def test_host_build_of_grad_kernel_matches_plain(sampler):
    """Roughness in [0.5, 0.9], at the bar 1e-5 (see
    tests/test_torch_grad_bridge.py)."""
    _assert_host_grad_matches_plain(sampler, 0.5, 1e-5)


@pytest.mark.parametrize("sampler", ["pmj02bn", "lcg"])
def test_host_build_of_grad_kernel_matches_plain_at_low_roughness(sampler):
    """Roughness in [0.2, 0.9], where the kernel's hand-written roughness
    derivative (ggx_spec_droughness) is largest, at the bridge tests'
    LOW_ROUGHNESS_BAR of 5e-5. Measured over 3 seeds: up to 8.9e-6; with
    the derivative taken through alpha instead, 9.5e-2 to 3.5e-1."""
    _assert_host_grad_matches_plain(sampler, 0.2, 5e-5)


@pytest.mark.parametrize("k_near, max_depth",
                         [(0, 6), (3, 6), (kernels.GRAD_NEAR_ROWS["dense"], 12)])
def test_host_build_of_grad_kernel_keeps_its_rows_anywhere(k_near, max_depth):
    """The tap rows split at any depth between the kernel's shared-memory
    rows and its global scratch: every row in global scratch (k_near 0, the
    first kernel's layout), a split inside the samples (3 of max_depth 6),
    and the dense launch's GRAD_NEAR_ROWS["dense"] under a max_depth past
    it (12, rows 8 .. 11 in scratch), each at the bar 1e-5 against the
    plain backward."""
    _assert_host_grad_matches_plain("pmj02bn", 0.5, 1e-5, k_near, max_depth)


@pytest.mark.parametrize("merge,packed", [(4, False), (4, True)])
@pytest.mark.parametrize("k_near", [0, kernels.GRAD_NEAR_ROWS["dense"]])
def test_host_build_of_merged_grad_kernel_matches_plain(merge, packed, k_near):
    """The kMerge instantiation (splat_merge 4: a sample's rows merged in
    step order into the lane's pending tap, path_loop_step.cuh
    replay_merge), with every row in global scratch and with the dense
    launch's shared-memory rows, and packed_splat's rounding after it,
    against the plain backward (JAX's static fold over the steps) at the
    bar 1e-5. Measured: 7.4e-7 to 1.2e-6 unpacked, 0 packed (no total
    rounded to the other side)."""
    _assert_host_grad_matches_plain("pmj02bn", 0.5, 1e-5, k_near, 6, merge, packed)


FD_EPS = 0.01
SEED = 3


def _fd_errors(sampler, spps):
    """|AD - FD| / |FD| on the diffuse texel of largest |gradient|, at each
    spp: the trend gate of tests/test_fd_validate.py:175-231, on the port.
    Roulette off (rr_depth 99) and max_depth 5, a 12^2 texture and image;
    AD is the backward at seed + 1 with the adjoint of sum(image[..., :3]),
    FD the two-sided difference of renders at seed, eps 0.01."""
    s = _scene(sampler)
    s.rr_depth, s.max_depth = 99, 5
    mat = torch.as_tensor(np.random.RandomState(0).uniform(0.25, 0.75, (12, 12, 4))
                          .astype(np.float32))
    lanes = None

    def tables(spp, seed):
        return pl.build_loop_tables(s._data, s.camera, s._config((12, 12), spp), seed)

    def loss(m, spp):
        return float(_host_render(tables(spp, SEED), lanes, m).double().sum())

    def ad(spp):
        ones = torch.full((3, 144), 1.0 / spp)
        return _host_grad(tables(spp, SEED + 1), lanes, mat, ones)[0]

    errs = []
    for k, spp in enumerate(spps):
        lanes = pl.pixel_lanes((12, 12), spp, "cpu")
        g = ad(spp)
        if k == 0:
            ti = np.unravel_index(int(g[..., :3].abs().argmax()), (12, 12, 3))
        up, down = mat.clone(), mat.clone()
        up[ti] += FD_EPS
        down[ti] -= FD_EPS
        fd = (loss(up, spp) - loss(down, spp)) / (2 * FD_EPS)
        errs.append(abs(float(g[ti]) - fd) / max(abs(fd), 1e-9))
    return errs


def test_fd_error_shrinks_with_spp_lcg():
    """The JAX gate's lcg bars (test_fd_validate.py:238-241). Measured on
    the port: 0.0863 at 64 spp, 0.0118 at 512 (0.0051 at 4096); the JAX
    package measured 0.099 -> 0.0088."""
    errs = _fd_errors("lcg", [64, 512])
    assert errs[1] < 0.5 * errs[0], errs
    assert errs[1] <= 0.1, errs


def test_fd_error_shrinks_with_spp_pmj02bn():
    """pmj02bn, the default sampler, which the JAX CI does not gate (it pins
    lcg). Measured on the port: 0.0526 at 64 spp, 0.0031 at 512 (0.0054 at
    4096: the FD estimate's own noise floor); the bound 0.02 is 6.5 times
    the value at 512."""
    errs = _fd_errors("pmj02bn", [64, 512])
    assert errs[1] < 0.5 * errs[0], errs
    assert errs[1] <= 0.02, errs


def test_grad_wrapper_runs_the_plain_version_on_cpu_tensors():
    """Given CPU tensors, kernels.path_loop_grad runs the plain backward and
    counts no launch; a device that is neither cuda nor cpu raises."""
    s = _scene("pmj02bn")
    s.max_depth = 3
    mat = torch.as_tensor(_material(seed=2))
    tb = pl.build_loop_tables(s._data, s.camera, s._config((8, 8), 2), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, "cpu")
    le = torch.full((3, 64), 0.25)
    launches, calls = kernels.path_loop_grad.launches, pl.render_path_backward_loop_plain.calls
    got, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    want, want_carry = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    assert torch.equal(got, want) and torch.equal(carry.f, want_carry.f)
    assert kernels.path_loop_grad.launches == launches
    assert pl.render_path_backward_loop_plain.calls == calls + 2
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        kernels.path_loop_grad(tb, lanes.to("meta"), mat, le, 1)
