"""The port's CUDA kernels against their plain PyTorch versions on the card:
the path loop's (path_loop, path_loop_grad, sampler_probe), the direct
integrator's (trace_interact, direct, direct_grad, and their envmap
instantiations), the collocated integrator's (collocated, collocated_grad,
dense and BVH), the trace kernels
(trace_closest, trace_any, dense and BVH), the megakernels' BVH
instantiations on scenes past shared memory (in triangle rows, or in
light rows alone), the gradient kernels' tap rows at every split between
shared and global memory, and the sweep variants (sweep_variant,
woop_sweep, aabb_sweep, floor_probe). Marked `cuda`: each test skips
without a CUDA device. chip_smoke.py runs the same checks, and the main
paths, on an H100."""

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel import bvh as tbvh
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu_torch.integrators import bounce
from zdr_tpu_torch.integrators import direct as dr
from zdr_tpu_torch.integrators import path_loop as pl
from zdr_tpu_torch.integrators.scene_tables import scene_table
from zdr_tpu_torch.samplers import sampler_probe_plain
from zdr_tpu_torch.samplers.pmj02bn import bluenoise

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(dev, sampler="pmj02bn"):
    s = zt.Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                 integrator="path", sampler=sampler, device=dev)
    s.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                         target=(-0.2, 2.6, -5.0))
    return s


def _material(dev, res=64, seed=0):
    rs = np.random.RandomState(seed)
    mat = rs.uniform(0.1, 0.9, (res, res, 4)).astype(np.float32)
    mat[..., 3] = rs.uniform(0.2, 0.9, (res, res))
    return torch.as_tensor(mat, device=dev)


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_sampler_probe_bit_exact(dev, kind):
    rs = np.random.RandomState(1)
    n = 4096
    lanes = torch.as_tensor(np.stack([
        rs.randint(0, 1024, n), rs.randint(0, 1024, n),
        rs.randint(-2**31, 2**31, n), rs.randint(0, 64, n)]).astype(np.int32), device=dev)
    bn = bluenoise(dev)
    got = kernels.sampler_probe(kind, 64, lanes, 6, bn)
    assert torch.equal(got, sampler_probe_plain(kind, 64, lanes, 6, bn))


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_one_step_matches_loop_step(dev, kind):
    s = _scene(dev, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 1)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    carry = pl.init_carry(lanes)
    for _ in range(3):
        got = kernels.path_loop(tb, lanes, mat, carry, 1)
        want = pl.loop_step(carry, tb, lanes, mat)
        torch.cuda.synchronize()
        assert torch.equal(got.i, want.i)
        torch.testing.assert_close(got.f, want.f, rtol=1e-6, atol=1e-6, equal_nan=True)
        carry = want


def test_render_matches_plain(dev):
    """64x64, 8 spp: mean abs diff <= 1e-6, 99.9% of pixels within 1e-5."""
    s = _scene(dev)
    mat = _material(dev)
    before = kernels.path_loop.launches
    img = s.render(mat, res=(64, 64), spp=8, seed=2)
    assert kernels.path_loop.launches == before + 1
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 2)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    plain = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want = (plain.f[0:3] / torch.tensor(8.0, device=dev)).T.reshape(64, 64, 3)
    diff = (img[..., :3] - want).abs()
    assert float(diff.mean()) <= 1e-6
    assert float((diff.amax(-1) <= 1e-5).float().mean()) >= 0.999


# the BVH walk's stack in local memory: trace.cuh kStackDepth entries of 4
# bytes, in every BVH kernel's stack frame
WALK_STACK_BYTES = 4 * tbvh.MAX_DEPTH
# ptxas's local memory a thread of the forward kernels, capped at 64
# registers: a 32-byte stack frame and the spills (204 bytes stored dense,
# 304 BVH, to L1), and on the BVH route the walk's stack; a heavier spill,
# which an edit of the shared step could cause, fails here
LOOP_LOCAL_BYTES = {"dense": 128, "bvh": 192 + WALK_STACK_BYTES}


@pytest.mark.parametrize("route", ["dense", "bvh"])
@pytest.mark.parametrize("res", [(45, 37), (64, 64)], ids=["45x37", "64x64"])
def test_path_loop_every_launch_shape_matches_plain(dev, route, res):
    """The route's forward kernel at every block it launches at (powers of
    two from 32 to plan["max_block"], through kernels.loop_launch), at a
    size whose last block is part-empty (45x37) and at one that blocks of
    32 to 512 divide (64x64): each block's carry equals the launch's pick
    bit for bit, and the pick's radiance and sample counts equal the plain
    version's."""
    s = _scene(dev) if route == "dense" else _bvh_scene(dev, "bigsphere", "path")
    mat = _material(dev)
    tb = pl.build_loop_tables(s._render_data("path"), s.camera, s._config(res, 8), 3)
    assert (tb.bvh is not None) == (route == "bvh")
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    carry0 = pl.init_carry(lanes)
    lib = kernels.load_library()
    picked, _c, plan = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps)
    assert plan["max_block"] == (512 if route == "dense" else 256)
    assert plan["blocks"] == -(-lanes.shape[1] // plan["block"]) and plan["rounds"] >= 1
    assert plan["registers"] <= 64 and plan["local_bytes"] <= LOOP_LOCAL_BYTES[route]
    block = 32
    while block <= plan["max_block"]:
        got, _c, p = kernels.loop_launch(lib, tb, lanes, mat, carry0, tb.n_steps, block)
        torch.cuda.synchronize()
        assert p["block"] == block
        assert torch.equal(got.f.view(torch.int32), picked.f.view(torch.int32)), block
        assert torch.equal(got.i, picked.i), block
        block *= 2
    plain = pl.render_path_loop_plain(tb, lanes, mat, carry0, tb.n_steps)
    assert torch.equal(picked.i[pl.I_IDX["sample_idx"]], plain.i[pl.I_IDX["sample_idx"]])
    assert torch.equal(picked.f[0:3], plain.f[0:3])


@pytest.mark.parametrize("kind", ["lcg", "pmj02bn"])
def test_grad_kernel_matches_plain_backward(dev, kind):
    """64x64, 8 spp, a random adjoint: per-channel sums within rtol 1e-5,
    texels past 1e-3 of the largest gradient within rtol 1e-4 (float
    atomics sum in a run-dependent order); the kernel's radiance equals the
    forward kernel's bit for bit."""
    s = _scene(dev, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 3)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    before = kernels.path_loop_grad.launches
    got, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    assert kernels.path_loop_grad.launches == before + 1
    fwd = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    assert torch.equal(carry.f[0:3], fwd.f[0:3])
    torch.testing.assert_close(got.double().sum((0, 1)), want.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((got - want).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


@pytest.mark.parametrize("route", ["dense", "bvh"])
@pytest.mark.parametrize("k_cap", [None, 3, 0])
@pytest.mark.parametrize("res", [(64, 64), (45, 37)], ids=["64x64", "45x37"])
def test_grad_kernels_keep_their_rows_anywhere(dev, route, k_cap, res):
    """path_loop_grad and path_loop_grad_bvh at 64x64, and at 45x37 (1665
    lanes: the last block part empty), 8 spp, max_depth 12, a random
    adjoint, with the wrapper's launch (None: the route's tap rows in
    shared memory), or through kernels.grad_launch with 3 of them, or every
    row in global scratch (0): per-channel sums within rtol 1e-5 and texels
    within rtol 1e-4 of the plain backward (float atomics), the radiance
    bit for bit the forward kernel's; the launch record holds the rows it
    kept."""
    s = _scene(dev) if route == "dense" else _bvh_scene(dev, "bigsphere", "path")
    s.max_depth = 12
    mat = _material(dev)
    tb = pl.build_loop_tables(s._render_data("path"), s.camera, s._config(res, 8), 4)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(5).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    if k_cap is None:
        got, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
        plan = (kernels.path_loop_grad if route == "dense" else kernels.path_loop_grad_bvh).plan
    else:
        got, carry, _c, plan = kernels.grad_launch(kernels.load_library(), tb, lanes, mat, le,
                                                   tb.n_steps, k_cap)
    fwd = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    if k_cap is None:
        assert plan["k_near"] <= kernels.GRAD_NEAR_ROWS[route]
        assert plan["k_near"] >= 1 or kernels.GRAD_NEAR_ROWS[route] == 0
    else:
        assert plan["k_near"] == k_cap
    # the kernels' stack frame, which the forward path_loop kernel and the
    # first gradient kernel have too (ptxas: 40 bytes, 0 bytes spilled), and
    # the BVH walk's stack: a register cap that spills would raise it
    assert plan["local_bytes"] <= 40 + (WALK_STACK_BYTES if route == "bvh" else 0)
    assert torch.equal(carry.f[0:3], fwd.f[0:3])
    torch.testing.assert_close(got.double().sum((0, 1)), want.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((got - want).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


def test_scene_backward_launches_the_grad_kernel(dev):
    s = _scene(dev)
    mat = _material(dev).requires_grad_()
    before = kernels.path_loop_grad.launches
    s.render(mat, res=(32, 32), spp=4, seed=1)[..., :3].sum().backward()
    assert kernels.path_loop_grad.launches == before + 1
    assert bool(torch.isfinite(mat.grad).all()) and float(mat.grad.abs().max()) > 0


def _direct_scene(dev, name, sampler="pmj02bn"):
    if name == "cbox":
        s = _scene(dev, sampler)
        s.integrator = "direct"
        return s
    # "bigsphere": 3102 triangles, a 149 KB shared-memory table (past the
    # 48 KB a launch gets without opting in)
    # (the dense route: "auto" walks the BVH past DENSE_MAX_TRIS)
    stacks, slices = (32, 50) if name == "bigsphere" else (16, 32)
    s = zt.Scene([(tproc.make_uv_sphere(0.5, stacks, slices), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)], sampler=sampler,
                 accel="bruteforce", device=dev)
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    return s


@pytest.mark.parametrize("name", ["cbox", "sphere", "bigsphere"])
def test_trace_interact_matches_plain(dev, name):
    """16384 random rays, full and lite: ints equal, floats within 1e-6."""
    s = _direct_scene(dev, name)
    table = scene_table(s._data)
    g = torch.Generator().manual_seed(3)
    n = 16384
    o = torch.randn((n, 3), generator=g) * 0.5 + torch.tensor([-0.2, 2.6, -3.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    if name != "cbox":
        o = 1.6 * torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
        d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g) - 0.5 - o, dim=1)
    pdf = 0.1 + 10.0 * torch.rand(n, generator=g)
    act = (torch.rand(n, generator=g) > 0.1).to(torch.int32)
    rays = [x.contiguous().to(dev) for x in (*o.T, *d.T, pdf)] + [act.to(dev)]
    for lite in (False, True):
        before = kernels.trace_interact.launches
        got = kernels.trace_interact(table, rays, lite)
        assert kernels.trace_interact.launches == before + 1
        want = bounce.trace_interact_plain(table, rays, lite)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.dtype == torch.int32:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kind", [("cbox", "lcg"), ("sphere", "pmj02bn"),
                                       ("bigsphere", "pmj02bn")])
def test_direct_matches_plain(dev, name, kind):
    """64x64, 8 spp: mean abs diff <= 1e-6, 99.9% of pixels within 1e-5."""
    s = _direct_scene(dev, name, kind)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 2)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    before = kernels.direct.launches
    got = kernels.direct(tb, lanes, mat)
    assert kernels.direct.launches == before + 1
    want = dr.render_direct_plain(tb, lanes, mat)
    torch.cuda.synchronize()
    diff = (got - want).abs().amax(0) / 8
    assert float(diff.mean()) <= 1e-6
    assert float((diff <= 1e-5).float().mean()) >= 0.999
    assert int(kernels.direct.tests) >= lanes.shape[1] * 8 * tb.scene.shape[0]


@pytest.mark.parametrize("name", ["cbox", "sphere", "bigsphere"])
def test_direct_grad_matches_plain_backward(dev, name):
    """64x64, 8 spp, a random adjoint: per-channel sums within rtol 1e-5,
    texels past 1e-3 of the largest gradient within rtol 1e-4 (float
    atomics); the kernel's radiance equals direct's bit for bit."""
    s = _direct_scene(dev, name)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((64, 64), 8), 3)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    before = kernels.direct_grad.launches
    got, acc = kernels.direct_grad(tb, lanes, mat, le)
    assert kernels.direct_grad.launches == before + 1
    fwd = kernels.direct(tb, lanes, mat)
    want, want_acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    torch.cuda.synchronize()
    assert torch.equal(acc, fwd)
    torch.testing.assert_close(got.double().sum((0, 1)), want.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((got - want).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


@pytest.mark.parametrize("name", ["cbox", "sphere"])
@pytest.mark.parametrize("early", [False, True], ids=["sweep", "early"])
def test_direct_sweeps_match_plain_at_every_block(dev, name, early):
    """Each instantiation of the dense direct kernels (the sweeps without
    and with the early out; kernels.direct_early picks the first for
    the cornell box, the second for the 962-triangle sphere) at every block
    the launch takes, 48x48, 8 spp: the forward at test_direct_matches_plain's
    bars, bit for bit the other instantiation's, with the same tests; the
    tap mode at test_direct_grad_matches_plain_backward's bars, its radiance
    the forward's."""
    s = _direct_scene(dev, name)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._data, s.camera, s._config((48, 48), 8), 4)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(5).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    lib = kernels.load_library()
    want = dr.render_direct_plain(tb, lanes, mat)
    want_g, _acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    other = kernels.direct_launch(lib, tb, lanes, mat, early=not early)
    block, largest = 32, 32
    while block <= largest:
        _g, got, counts, plan = kernels.direct_launch(lib, tb, lanes, mat, block=block,
                                                      early=early)
        grad, acc, _c, _p = kernels.direct_launch(lib, tb, lanes, mat, le, block, early)
        torch.cuda.synchronize()
        assert plan["block"] == block and plan["early"] == early
        diff = (got - want).abs().amax(0) / 8
        assert float(diff.mean()) <= 1e-6
        assert float((diff <= 1e-5).float().mean()) >= 0.999
        assert torch.equal(got, other[1]) and torch.equal(counts, other[2])
        assert torch.equal(acc, got)
        torch.testing.assert_close(grad.double().sum((0, 1)), want_g.double().sum((0, 1)),
                                   rtol=1e-5, atol=0.0)
        mag = want_g.abs().amax(-1)
        big = mag > 1e-3 * float(mag.max())
        assert float(((grad - want_g).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4
        largest = plan["max_block"]
        block *= 2


def test_scene_direct_backward_launches_the_direct_kernels(dev):
    """The default integrator: render + backward launch direct and
    direct_grad once each and no plain version."""
    s = _direct_scene(dev, "sphere")
    mat = _material(dev).requires_grad_()
    before = (kernels.direct.launches, kernels.direct_grad.launches)
    calls = (dr.direct_sample_plain.calls, bounce.trace_interact_plain.calls,
             bounce.shade_plain.calls)
    s.render(mat, res=(32, 32), spp=4, seed=1)[..., :3].sum().backward()
    assert (kernels.direct.launches, kernels.direct_grad.launches) == (
        before[0] + 1, before[1] + 1)
    assert (dr.direct_sample_plain.calls, bounce.trace_interact_plain.calls,
            bounce.shade_plain.calls) == calls
    assert bool(torch.isfinite(mat.grad).all()) and float(mat.grad.abs().max()) > 0


# ------------------------------------------------ the big-mesh route (BVH)


def _bvh_scene(dev, name, integrator="direct"):
    """"bigsphere" (3102 triangles) forced through the BVH, or the big mesh:
    tools/bench_bigmesh.py's 160 x 160 sphere (50,880 triangles) over the
    quad light, which "auto" sends through it."""
    stacks, accel = ((32, 50), "bvh") if name == "bigsphere" else ((160, 160), "auto")
    s = zt.Scene([(tproc.make_uv_sphere(0.5, *stacks), None, None),
                  (tproc.make_quad(size=1.0, y=-2.0), None, 40.0)],
                 integrator=integrator, accel=accel, device=dev)
    s.camera = zt.Camera(fov=0.8, origin=(1.5, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    return s


@pytest.mark.parametrize("name", ["sphere", "bigsphere", "bigmesh"])
@pytest.mark.parametrize("method", ["bruteforce", "bvh"])
def test_trace_kernels_match_plain(dev, name, method):
    """65536 random rays: trace_closest and trace_any (per-ray t_max) equal
    to their plain versions bit for bit, with the same counted tests and
    node visits."""
    from zdr_tpu_torch.accel import build_accel
    from zdr_tpu_torch.accel import trace as tt

    s = _bvh_scene(dev, name) if name != "sphere" else _direct_scene(dev, "sphere")
    acc = build_accel(s._data.geom, method)
    g = torch.Generator().manual_seed(4)
    n = 65536
    o = (0.8 * torch.randn((n, 3), generator=g)).to(dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(dev)
    t_max = (0.5 + 2.5 * torch.rand(n, generator=g)).to(dev)
    before = (kernels.trace_closest.launches, kernels.trace_any.launches)
    got = kernels.trace_closest(acc, o, d, 0.0, 1e30)
    occ = kernels.trace_any(acc, o, d, 1e-4, t_max)
    assert (kernels.trace_closest.launches, kernels.trace_any.launches) == (
        before[0] + 1, before[1] + 1)
    want, work = tt.trace_closest_plain(acc, o, d, 0.0, 1e30)
    want_occ, any_work = tt.trace_any_plain(acc, o, d, 1e-4, t_max)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(occ, want_occ) and occ.any() and not occ.all()
    assert kernels.trace_closest.counts.tolist() == [int(x) for x in work]
    assert kernels.trace_any.counts.tolist() == [int(x) for x in any_work]


@pytest.mark.parametrize("name", ["bigsphere", "bigmesh"])
@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_bvh_kernels_match_plain(dev, name, integrator):
    """The BVH instantiations at 128x128, 16 spp: the forward bit for bit
    against the plain walk, the gradient (a random adjoint, a random 64^2
    material) at per-channel sums rtol 1e-5 and texel rtol 1e-4 (float
    atomics), the tap mode's radiance equal to the forward's; one launch of
    each BVH kernel and none of the dense ones."""
    s = _bvh_scene(dev, name, integrator)
    mat = _material(dev)
    cfg = s._config((128, 128), 16)
    data = s._render_data(integrator)
    tb = pl.build_loop_tables(data, s.camera, cfg, 2)
    assert tb.bvh is not None
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    names = ("direct", "direct_grad", "direct_bvh", "direct_grad_bvh") if integrator == "direct" \
        else ("path_loop", "path_loop_grad", "path_loop_bvh", "path_loop_grad_bvh")
    before = [getattr(kernels, k).launches for k in names]
    if integrator == "direct":
        got = kernels.direct(tb, lanes, mat)
        grad, acc = kernels.direct_grad(tb, lanes, mat, le)
        want = dr.render_direct_plain(tb, lanes, mat)
        want_g, _acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    else:
        got = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        grad, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
        acc = carry.f[0:3]
        want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        want_g, _c = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    assert [getattr(kernels, k).launches - b for k, b in zip(names, before)] == [0, 0, 1, 1]
    assert torch.equal(got, want) and torch.equal(acc, got)
    torch.testing.assert_close(grad.double().sum((0, 1)), want_g.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want_g.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((grad - want_g).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4


# ------------------------------------------- the sweep variants (B9's)


def _variant_sets(dev):
    """The protocol scene's geometry rows, table and Woop rows, and its
    three ray sets of 16384 rays (accel/variants.py)."""
    from zdr_tpu_torch.accel import build_accel
    from zdr_tpu_torch.accel import variants as tv
    from zdr_tpu_torch.accel.woop import woop_rows

    s = _direct_scene(dev, "sphere")
    table = scene_table(s._data)
    geom = build_accel(s._data.geom, "bruteforce").geom
    prim = tv.primary_rays(s, res=(128, 128))
    sets = {"primary": prim, "bounce": tv.bounce_rays(16384, dev),
            "shadow": tv.shadow_rays(geom, table, prim)}
    return geom, table, woop_rows(geom), sets


def _assert_variant(got, want, mode):
    """Closest and any hit bit for bit; the epilogue modes' ints equal and
    floats within atol 1e-6, rtol 1e-6 (chip_smoke.py phase 14's bar)."""
    if mode == "any":
        assert torch.equal(got, want)
        return
    for a, b in zip(got, want, strict=True):
        if mode == "closest" or a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["sweep_variant", "woop_sweep", "aabb_sweep"])
def test_sweep_variants_match_plain(dev, name):
    """Every grid point the kernel is built for, on the ray sets its phase-14
    modes take (closest and the epilogues on the primaries and bounce rays,
    any hit on the bounce and shadow rays): against its plain version, with
    the same counted tests and box tests."""
    from zdr_tpu_torch.accel import variants as tv
    from zdr_tpu_torch.accel.woop import tile_boxes

    geom, table, woop, sets = _variant_sets(dev)
    # (mode, kTile, R, woop, cull) of the library's grid, by kernel
    points = [p for p in kernels.variant_points()
              if {"sweep_variant": not (p[3] or p[4]), "woop_sweep": p[3] and not p[4],
                  "aabb_sweep": p[4]}[name]]
    wrapper = getattr(kernels, name)
    for set_name, (rays, act) in sets.items():
        for point in points:
            mode = point[0]
            if (mode == "any") != (set_name == "shadow") and set_name != "bounce":
                continue
            before = wrapper.launches
            if name == "sweep_variant":
                got = wrapper(geom, table, rays, act, mode, point[1], point[2])
                want, work = tv.sweep_variant_plain(geom, table, rays, act, mode)
            elif name == "woop_sweep":
                got = wrapper(woop, geom, table, rays, act, mode, point[1])
                want, work = tv.woop_sweep_plain(woop, geom, table, rays, act, mode)
            else:
                rows, boxes = (woop if point[3] else geom), tile_boxes(geom, point[1])
                got = wrapper(rows, geom, boxes, point[1], rays, act, mode, point[3])
                want, work = tv.aabb_sweep_plain(rows, geom, boxes, point[1], rays, act, mode,
                                                 point[3])
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            _assert_variant(got, want, mode)
            assert wrapper.counts.tolist() == [int(x) for x in work], (set_name, point)


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_emissive_sphere_past_shared_memory(dev, integrator):
    """A uv sphere of 4512 emissive triangles over a floor (288,768 bytes of
    light rows, past a block's shared memory) at 64x64, 8 spp by
    accel="auto": the BVH kernels, their small tables in global memory, the
    forward bit for bit against the plain walk, the gradient (a random
    adjoint) at per-channel sums rtol 1e-5 and texel rtol 1e-4; the dense
    route refuses the scene."""
    s = zt.Scene([(tproc.make_uv_sphere(0.5, 48, 48), None, 4.0),
                  (tproc.make_quad(size=2.0, y=-0.7), None, None)],
                 integrator=integrator, device=dev)
    s.camera = zt.Camera(fov=0.9, origin=(1.6, 0.6, 0.4), target=(0.0, -0.3, 0.0))
    mat = _material(dev)
    tb = pl.build_loop_tables(s._render_data(integrator), s.camera, s._config((64, 64), 8), 2)
    assert tb.bvh is not None
    small = kernels.pack_tables(tb).numel() - tb.scene.shape[0] * 31
    assert not kernels.small_tables_shared(small)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(3).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    if integrator == "direct":
        got = kernels.direct(tb, lanes, mat)
        grad, _acc = kernels.direct_grad(tb, lanes, mat, le)
        want = dr.render_direct_plain(tb, lanes, mat)
        want_g, _acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    else:
        got = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        grad, _c = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
        want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        want_g, _c = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and float(want.max()) > 0
    torch.testing.assert_close(grad.double().sum((0, 1)), want_g.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want_g.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((grad - want_g).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4
    s.accel = "bruteforce"
    with pytest.raises(NotImplementedError, match="accel='auto' or 'bvh'"):
        s.render(mat, res=(2, 2), spp=1)


@pytest.mark.parametrize("n", [1, 3, 4, 262147])
def test_floor_probe_tail(dev, n):
    """floor_probe's float4 body and scalar tail: a + b at lengths under,
    at and past a float4, and a long one that is not a multiple of 4."""
    g = torch.Generator().manual_seed(n)
    a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
    assert torch.equal(kernels.floor_probe(a, b), a + b)


def test_floor_probe_is_a_plus_b(dev):
    """The floor of the timing harness: out = a + b, one launch."""
    g = torch.Generator().manual_seed(5)
    a, b = (torch.rand(100003, generator=g).to(dev) for _ in range(2))
    before = kernels.floor_probe.launches
    assert torch.equal(kernels.floor_probe(a, b), a + b)
    assert kernels.floor_probe.launches == before + 1


def _slice_scene(dev, integrator, name, accel):
    """The collocated or envmap scenes of the new kernels: the cornell box,
    or tools/gen_golden.py's 960-triangle sphere and its camera; the direct
    integrator's under make_test_envmap(64, 128)."""
    from zdr_tpu_torch.envmap import make_test_envmap

    if name == "cbox":
        s = _scene(dev)
        s.integrator, s.accel = integrator, accel
    else:
        s = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator=integrator,
                     accel=accel, device=dev)
        s.camera = zt.Camera(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    if integrator == "direct":
        s.add_envmap(make_test_envmap(64, 128))
    return s


# the kernels of each (integrator, scene, accel): forward, gradient
SLICE_CASES = {
    ("collocated", "cbox", "auto"): ("collocated", "collocated_grad"),
    ("collocated", "sphere", "bruteforce"): ("collocated", "collocated_grad"),
    ("collocated", "sphere", "auto"): ("collocated_bvh", "collocated_grad_bvh"),
    ("direct", "cbox", "auto"): ("direct_env", "direct_grad_env"),
    ("direct", "sphere", "bruteforce"): ("direct_env", "direct_grad_env"),
    ("direct", "sphere", "auto"): ("direct_env_bvh", "direct_grad_env_bvh"),
}


@pytest.mark.parametrize("case", list(SLICE_CASES), ids=lambda c: "-".join(c))
def test_collocated_and_env_kernels_match_plain(dev, case):
    """The collocated kernels and the direct kernels' envmap instantiations
    (dense without and with the early out, BVH) at 64x64, 8 spp, a random
    adjoint: the forward bit for bit its plain version; the gradient's
    per-channel sums within rtol 1e-5 and texels past 1e-3 of the largest
    within rtol 1e-4 of it (float atomics); the tap mode's radiance equal to
    the forward's; one launch of each of the case's kernels."""
    from zdr_tpu_torch.integrators import collocated as co

    integrator, name, accel = case
    fwd, bwd = SLICE_CASES[case]
    s = _slice_scene(dev, integrator, name, accel)
    mat = _material(dev)
    tb = pl.build_loop_tables(s._render_data(integrator), s.camera, s._config((64, 64), 8), 3)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(2).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    fk, gk = (kernels.collocated, kernels.collocated_grad) if integrator == "collocated" \
        else (kernels.direct, kernels.direct_grad)
    fp, gp = (co.render_collocated_plain, co.render_collocated_backward_plain) \
        if integrator == "collocated" else (dr.render_direct_plain, dr.render_direct_backward_plain)
    before = (getattr(kernels, fwd).launches, getattr(kernels, bwd).launches)
    got = fk(tb, lanes, mat)
    grad, acc = gk(tb, lanes, mat, le)
    assert (getattr(kernels, fwd).launches, getattr(kernels, bwd).launches) == (
        before[0] + 1, before[1] + 1)
    want = fp(tb, lanes, mat)
    want_g, _acc = gp(tb, lanes, mat, le)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(acc, got)
    torch.testing.assert_close(grad.double().sum((0, 1)), want_g.double().sum((0, 1)),
                               rtol=1e-5, atol=0.0)
    mag = want_g.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    assert float(((grad - want_g).abs().amax(-1)[big] / mag[big]).max()) <= 1e-4
