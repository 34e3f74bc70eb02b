"""Finite-difference vs autograd gates of the port (the port of
tests/test_fd_validate.py): Scene.render + loss.backward(), whose backward
re-estimates the texture gradient at seed + 1, against a two-sided FD of
the same render at one seed (correlated noise), on the CPU, where the
renders run the kernels' plain versions.

Protocol as the JAX package's: loss = sum(image[..., :3]), the texel of
the largest |grad| within a channel (diffuse 0 or roughness 3), the lcg
sampler (the bars are calibrated on white noise). The material is uniform
in [0.25, 0.75] from np.random.RandomState(0) (JAX's jax.random stream
cannot be reproduced without jax). The bars are JAX's; the sizes are JAX's
(texture 24^2, 40x40, 160 spp) where the CPU's time allows, else cut, with
the errors measured at the cut sizes at each test: the plain versions walk
a lane's samples one after another, ~0.5 s a sample at 64x64 through the
BVH of the 960-triangle sphere."""

import numpy as np
import pytest
import torch

import zdr_tpu_torch as zt
from zdr_tpu_torch.envmap import make_test_envmap
from zdr_tpu_torch.geometry import procedural as tproc
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

FD_EPS = 0.01
SEED = 3
SAMPLER = "lcg"
SPHERE_CAM = dict(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))
CBOX_CAM = dict(fov=50 / 180 * 3.14159, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0))


def _material(tex):
    return torch.as_tensor(
        np.random.RandomState(0).uniform(0.25, 0.75, (tex, tex, 4)).astype(np.float32))


def fd_ad_pairs(scene, texres, res, spp, channels):
    """-> {channel: (ad, fd)} for the argmax-|grad| texel of each channel,
    one gradient for all of them."""
    material = _material(texres)

    def loss(m):
        return scene.render(m, res=res, spp=spp, seed=SEED)[..., :3].sum()

    m = material.clone().requires_grad_()
    loss(m).backward()
    g = m.grad.numpy()
    pairs = {}
    for c in channels:
        gc = np.abs(g[..., c])
        ti = np.unravel_index(np.argmax(gc), gc.shape) + (c,)
        m0, m1 = material.clone(), material.clone()
        m0[ti] -= FD_EPS
        m1[ti] += FD_EPS
        with torch.no_grad():
            fd = (float(loss(m1)) - float(loss(m0))) / (2 * FD_EPS)
        pairs[c] = (float(g[ti]), fd)
    return pairs


def assert_close(ad, fd, rtol):
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad) > 1e-6, "picked a zero-gradient texel"
    assert abs(ad - fd) <= rtol * max(abs(ad), abs(fd)), (ad, fd)


def _sphere(integrator, env=False):
    s = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator=integrator,
                 sampler=SAMPLER, device="cpu")
    if env:
        s.add_envmap(make_test_envmap())
    s.camera = zt.Camera(**SPHERE_CAM)
    return s


def _cbox(integrator):
    s = zt.Scene([(tproc.make_cornell_box(), None, None),
                  (tproc.make_cornell_light(), None, 15.0)],
                 integrator=integrator, sampler=SAMPLER, device="cpu")
    s.camera = zt.Camera(**CBOX_CAM)
    return s


@pytest.fixture(scope="module")
def direct_scene():
    return _cbox("direct")


@pytest.fixture(scope="module")
def path_scene():
    return _cbox("path")


@pytest.fixture(scope="module")
def env_scene():
    return _sphere("direct", env=True)


@pytest.fixture(scope="module")
def collocated_pairs():
    # cut from 24^2 / 40x40 / 160 spp to an 8^2 texture at 32 spp (the
    # sphere's BVH walk; at JAX's size 76 s): measured rel err diffuse
    # 0.0011, roughness 0.0134 (JAX's size: 0.0043, 0.0574)
    return fd_ad_pairs(_sphere("collocated"), 8, (40, 40), 32, (0, 3))


@pytest.fixture(scope="module")
def direct_pairs(direct_scene):
    # JAX's size: measured rel err diffuse 0.0078, roughness 0.063
    return fd_ad_pairs(direct_scene, 24, (40, 40), 160, (0, 3))


@pytest.fixture(scope="module")
def path_pairs(path_scene):
    # cut to a 16^2 texture at 128 spp (JAX's size: 41 s here, rel err
    # 0.0171 / 0.0068): measured rel err diffuse 0.0017, roughness 0.0863
    return fd_ad_pairs(path_scene, 16, (40, 40), 128, (0, 3))


class TestCollocated:
    def test_diffuse_grad(self, collocated_pairs):
        assert_close(*collocated_pairs[0], rtol=0.10)

    def test_roughness_grad(self, collocated_pairs):
        assert_close(*collocated_pairs[3], rtol=0.10)


class TestDirect:
    def test_image_lit(self, direct_scene):
        mat = torch.full((16, 16, 4), 0.5)
        img = direct_scene.render(mat, res=(32, 32), spp=32, seed=0).numpy()
        assert img[..., :3].mean() > 0.01
        assert np.isfinite(img).all()

    def test_diffuse_grad(self, direct_pairs):
        assert_close(*direct_pairs[0], rtol=0.05)

    def test_roughness_grad(self, direct_pairs):
        assert_close(*direct_pairs[3], rtol=0.10)


class TestPathPRB:
    def test_gi_brighter_than_direct(self, path_scene, direct_scene):
        mat = torch.full((16, 16, 4), 0.5)
        p = path_scene.render(mat, res=(32, 32), spp=32, seed=0).numpy()
        d = direct_scene.render(mat, res=(32, 32), spp=32, seed=0).numpy()
        assert np.isfinite(p).all()
        # indirect bounces add energy
        assert p[..., :3].mean() > d[..., :3].mean() * 1.2

    def test_diffuse_grad(self, path_pairs):
        assert_close(*path_pairs[0], rtol=0.15)

    def test_roughness_grad(self, path_pairs):
        assert_close(*path_pairs[3], rtol=0.15)

    @pytest.mark.parametrize("merge,packed", [(4, True)])
    def test_diffuse_grad_at_jax_splat_knobs(self, merge, packed):
        """The JAX package's defaults splat_merge 4 and packed_splat
        (ROADMAP A17), path_pairs' sizes, the bar of
        tests/test_fd_validate.py:153: measured rel err 0.0114 (0.0017 at
        1 and False)."""
        s = _cbox("path")
        s.splat_merge, s.packed_splat = merge, packed
        assert_close(*fd_ad_pairs(s, 16, (40, 40), 128, (0,))[0], rtol=0.15)


class TestDirectEnvmap:
    def test_image_lit(self, env_scene):
        # cut from 32x32, 32 spp (the BVH walk): the background is the
        # envmap's radiance, the sphere lit by it
        mat = torch.full((16, 16, 4), 0.5)
        img = env_scene.render(mat, res=(16, 16), spp=8, seed=0).numpy()
        assert img[..., :3].mean() > 0.05
        assert np.isfinite(img).all()

    def test_diffuse_grad(self, env_scene):
        # cut to an 8^2 texture, 24x24, 16 spp (JAX's size: 148 s here, rel
        # err 0.0101): measured rel err 0.0315
        pairs = fd_ad_pairs(env_scene, 8, (24, 24), 16, (0,))
        assert_close(*pairs[0], rtol=0.15)


class TestConvergenceTrend:
    """|AD - FD| / |FD| shrinks as spp grows by 8x (the JAX package's 64 ->
    512 at 12x12). Decision-free: rr_depth 99, max_depth 5, lcg, a diffuse
    texel (diffuse never steers sampling). Cut: the plain loop walks a
    lane's samples one after another, so the port keeps JAX's sample counts
    on more pixels at 1/8 the spp (a 12^2 texture): measured direct at 20x20,
    16 -> 128 spp 0.0121 -> 0.0038 (JAX's 12x12, 64 -> 512: 0.0479 ->
    0.0120, 26 s here); path at 34x34, 8 -> 64 spp 0.0445 -> 0.0150."""

    def _errs(self, scene, res, spps):
        scene.rr_depth = 99
        scene.max_depth = 5
        material = _material(12)

        def loss(m, spp):
            return scene.render(m, res=res, spp=spp, seed=SEED)[..., :3].sum()

        m = material.clone().requires_grad_()
        loss(m, spps[0]).backward()
        gd = np.abs(m.grad.numpy()[..., :3])
        ti = np.unravel_index(np.argmax(gd), gd.shape)
        errs = []
        for spp in spps:
            m = material.clone().requires_grad_()
            loss(m, spp).backward()
            ad = float(m.grad[ti])
            m0, m1 = material.clone(), material.clone()
            m0[ti] -= FD_EPS
            m1[ti] += FD_EPS
            with torch.no_grad():
                fd = (float(loss(m1, spp)) - float(loss(m0, spp))) / (2 * FD_EPS)
            errs.append(abs(ad - fd) / max(abs(fd), 1e-9))
        return errs

    def test_direct_error_shrinks_with_spp(self):
        errs = self._errs(_cbox("direct"), (20, 20), [16, 128])
        assert errs[1] < 0.6 * errs[0], errs
        assert errs[1] <= 0.2, errs

    def test_path_error_shrinks_with_spp(self):
        errs = self._errs(_cbox("path"), (34, 34), [8, 64])
        assert errs[1] < 0.5 * errs[0], errs
        assert errs[1] <= 0.1, errs
