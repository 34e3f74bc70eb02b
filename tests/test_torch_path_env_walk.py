"""The walks of the path integrator's env forwards (path_loop_env,
path_loop_env_bvh), counted. chip_smoke._path_walk_counts walks through the
plain BVH walk only what the kernels walk (each running lane's next ray, a
shading lane's shadow ray above the hemisphere) and counts its tests and
node visits, which chip_smoke.py phase 27 holds the card's counts to; here
the g++ build of the kernels' code (zdr_path_loop_env_host) is held to it
on the cornell box with its light and on the env-only sphere under
make_test_envmap(), through trees of leaf 2, 4 and 8; and on the card the
two forwards against their plain versions, the BVH one's counts against
the plain walk's. Imports nothing of JAX, so that its card tests run where
JAX is not installed."""

import dataclasses
import os
import sys

import pytest
import torch

from zdr_tpu_torch import kernels
from zdr_tpu_torch.accel import variants as tv
from zdr_tpu_torch.integrators import path_loop as pl
from test_torch_path_env_skip import _cuda_inputs, _host, _inputs, _scene
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)


def _plain_counts(tb, lanes, mat):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    return cs._path_walk_counts(tb, lanes, mat)


@pytest.mark.parametrize("name,leaf", [("cbox", 4), ("cbox", 2), ("sphere", 2), ("sphere", 8)])
def test_host_bvh_counts_are_the_plain_walks(name, leaf):
    """16x16, 4 spp, paths stopped at depth 4, through a tree of `leaf`
    rows a leaf: the BVH forward's tests and node visits equal the plain
    walk's of the same rays, and some but not all of its steps walk a
    shadow ray."""
    tb, lanes, mat, _le = _inputs(name, "bvh")
    scene = _scene(name, "bvh")
    scene._render_data("path")
    tb = dataclasses.replace(tb, bvh=tv.leaf_accel(scene._data.geom, leaf))
    prod = kernels.load_host_library().zdr_path_loop_env_host
    fwd, _g, counts = _host(prod, tb, lanes, mat, tb.n_steps)
    assert float(fwd.f[0:3].max()) > 0
    plain = _plain_counts(tb, lanes, mat)
    assert counts == [plain["tests"], plain["visits"]] and counts[1] > 0
    assert 0 < plain["shadow_walks"] < plain["steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,accel", [("cbox", "bruteforce"), ("sphere", "bvh")])
def test_cuda_path_env_forwards_match_plain(name, accel):
    """On the card, path_loop_env (the cornell box, dense) and
    path_loop_env_bvh (the sphere, BVH) against the plain forward at 32x32,
    4 spp: the carry's radiance bit for bit, and through the BVH the
    kernel's tests and node visits the plain walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tb, lanes, mat, _le = _cuda_inputs(name, accel)
    kname = "path_loop_env" + ("_bvh" if accel == "bvh" else "")
    carry = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    assert getattr(kernels, kname).launches >= 1
    counts = getattr(kernels, kname).counts.tolist() if accel == "bvh" else None
    want = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    assert float(want.f[0:3].max()) > 0
    assert torch.equal(carry.f[0:3], want.f[0:3])
    if accel == "bvh":
        plain = _plain_counts(tb, lanes, mat)
        assert [int(c) for c in counts] == [plain["tests"], plain["visits"]]
