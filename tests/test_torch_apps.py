"""The port's texture-recovery entry points and their support modules
(zdr_tpu_torch/apps/, integrators/uvgrad.py through Scene.render_duvdxy,
imageio_exr.py, checkpoint.py, profiling.py) against the JAX package's, on
inputs made from a seed with numpy, and the apps' own gates on the CPU.
Tolerances are stated at each test."""

import importlib.util
import json
import os
import re
import sys

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zdr_tpu import Camera, Scene, float3
from zdr_tpu import imageio_exr as jexr
from zdr_tpu.accel import trace_closest as jax_trace_closest
from zdr_tpu.camera import generate_ray, tent_warp
from zdr_tpu.checkpoint import load_checkpoint as jax_load, save_checkpoint as jax_save
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light, make_uv_sphere
from zdr_tpu.integrators.wrapper import _pixel_grid
from zdr_tpu.profiling import RunLogger as JaxRunLogger
from zdr_tpu.samplers import make_sampler

import zdr_tpu_torch as zt
from zdr_tpu_torch import checkpoint as tck
from zdr_tpu_torch import imageio_exr as texr
from zdr_tpu_torch import profiling as tprof
from zdr_tpu_torch.accel.trace import trace_closest
from zdr_tpu_torch.apps import _common, example, fd_validate, lightstage
from zdr_tpu_torch.camera import camera_const
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import uvgrad
from zdr_tpu_torch.integrators.wrapper import pixel_grid, with_accel
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the golden bar (tests/test_golden.py)
GOLDEN_ATOL, GOLDEN_RTOL = 2e-4, 1e-4
EXAMPLE_CAM = dict(fov=50 / 180 * 3.1415926, origin=(1.0, 0.0, 0.0), target=(0.0, 0.0, 0.0),
                   up=(0.0, 1.0, 0.0))
CBOX_CAM = dict(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5), target=(-0.2, 2.6, -5.0),
                up=(0.0, 1.0, 0.0))


def _jax_app(name):
    """The JAX package's apps/<name>.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"_jax_app_{name}",
                                                  os.path.join(ROOT, "apps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_camera(cam):
    return Camera(fov=cam["fov"], origin=float3(*cam["origin"]), target=float3(*cam["target"]),
                  up=float3(*cam["up"]))


def _scenes(name):
    """The example's sphere (960 triangles: the BVH route) or the cornell
    box (12: the dense route), in both packages."""
    if name == "sphere":
        js = Scene([(make_uv_sphere(0.5), None, None)], integrator="direct")
        ts = zt.Scene([(tproc.make_uv_sphere(0.5), None, None)], integrator="direct",
                      device="cpu")
        cam = EXAMPLE_CAM
    else:
        js = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
                   integrator="path")
        ts = zt.Scene([(tproc.make_cornell_box(), None, None),
                       (tproc.make_cornell_light(), None, 15.0)], integrator="path",
                      device="cpu")
        cam = CBOX_CAM
    js.camera = _jax_camera(cam)
    ts.camera = zt.Camera(**cam)
    return js, ts


def _jax_prims(js, res, spp, seed):
    """JAX's closest hit of each sample's central ray (its render_uvgrad's
    rays) -> (spp, H * W)."""
    w, h = res
    coords = _pixel_grid(res)
    resf = jnp.array([w, h], jnp.float32)
    aspect = jnp.array([1.0, h / w], jnp.float32)
    prims = []
    for it in range(spp):
        u2, _s = make_sampler("lcg", coords, jnp.asarray(seed, jnp.int32), spp, it).next2()
        base = coords.astype(jnp.float32) + tent_warp(u2, 1.0) + 0.5
        o, d = generate_ray(js.camera, (2.0 / resf * base - 1.0) * aspect)
        prims.append(np.asarray(jax_trace_closest(js._data.accel, o, d).prim))
    return np.stack(prims)


@pytest.mark.parametrize("name", ["sphere", "cbox"])
def test_render_duvdxy_matches_jax(name):
    """Scene.render_duvdxy against JAX's at 16x16, 4 spp: every sample's
    central ray hits the same triangle in both (count of pixels that differ:
    0), and on those pixels max |d| <= 1e-5 * max |AOV| (measured: 1.2e-6
    sphere, 1.7e-6 cornell box)."""
    res, spp, seed = (16, 16), 4, 3
    js, ts = _scenes(name)
    want = np.asarray(js.render_duvdxy(jnp.zeros((4, 4, 4)), res=res, spp=spp, seed=seed))
    mat = torch.zeros((4, 4, 4), requires_grad=True)
    got_t = ts.render_duvdxy(mat, res=res, spp=spp, seed=seed)
    assert got_t.shape == (16, 16, 4) and got_t.device.type == "cpu"
    assert not got_t.requires_grad
    got = got_t.numpy()

    data = with_accel(ts._render_data(ts.integrator))
    assert data.accel.is_bvh == (name == "sphere")
    cfg = ts._config(res, spp)
    cam = camera_const(ts.camera)
    coords = pixel_grid(res, "cpu")
    consts = uvgrad.ray_consts(res, "cpu")
    port_prims = np.stack([
        trace_closest(data.accel, *uvgrad.sample_rays(cam, consts, coords, seed, cfg, it)[0])
        .prim.numpy() for it in range(spp)])
    same = (port_prims == _jax_prims(js, res, spp, seed)).all(0).reshape(16, 16)
    assert int((~same).sum()) == 0
    assert (port_prims >= 0).any()
    assert (port_prims < 0).any() == (name == "sphere")  # the box has no miss
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want)[same].max() <= 1e-5 * scale


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_save_exr_bytes_equal_jax(tmp_path, half, channels):
    """save_exr writes JAX's bytes (half and float channels), and load_exr
    reads them back as JAX's does."""
    img = np.random.RandomState(channels).randn(37, 21, channels).astype(np.float32) * 4
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    texr.save_exr(a, img, half=half)
    jexr.save_exr(b, img, half=half)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(texr.load_exr(a), jexr.load_exr(b))


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 3), (19, 23, 4)])
def test_png_matches_jax_save_image(tmp_path, shape):
    """The port's own PNG writer: imageio reads back the uint8 array that
    JAX's save_image (imageio) writes, its quantisation
    (clip(img, 0, 1) * 255 + 0.5) included."""
    img = np.random.RandomState(7).uniform(-0.2, 1.2, shape).astype(np.float32)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    texr.save_image(a, img)
    jexr.save_image(b, img)
    got, want = iio.imread(a), iio.imread(b)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(texr.load_image(a), jexr.load_image(b))


@pytest.mark.parametrize("channels", [1, 2])
def test_png_gray_channels(tmp_path, channels):
    """Gray and gray + alpha, which JAX's writer (imageio) refuses for one
    channel: imageio reads back the quantised array."""
    img = np.random.RandomState(8).uniform(-0.2, 1.2, (9, 13, channels)).astype(np.float32)
    path = str(tmp_path / "g.png")
    texr.save_image(path, img)
    want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(iio.imread(path), want[..., 0] if channels == 1 else want)


def _grads(n, shape):
    rng = np.random.RandomState(11)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _torch_adam(material):
    m = torch.as_tensor(np.array(material, np.float32)).requires_grad_()
    return m, torch.optim.Adam([m], lr=1e-2)


def _torch_step(m, opt, g):
    m.grad = torch.as_tensor(g)
    opt.step()


def test_checkpoint_from_jax(tmp_path):
    """A JAX checkpoint (optax.adam after 2 steps) loads into a fresh torch
    Adam bit for bit (material, mu, nu, count), and one more step on the
    same gradient matches optax's within 1e-6."""
    shape = (8, 6, 4)
    g1, g2, g3 = _grads(3, shape)
    opt = optax.adam(1e-2)
    mat = jnp.full(shape, 0.5, jnp.float32)
    state = opt.init(mat)
    for g in (g1, g2):
        up, state = opt.update(jnp.asarray(g), state)
        mat = optax.apply_updates(mat, up)
    path = str(tmp_path / "jax.npz")
    jax_save(path, mat, state, step=2, extra={"loss": 1.5})

    m, topt = _torch_adam(np.zeros(shape))
    m_loaded, step, extras = tck.load_checkpoint(path, topt)
    assert m_loaded is m and step == 2 and float(extras["loss"]) == 1.5
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(mat))
    st = topt.state[m]
    count, mu, nu = jax.tree.leaves(state)
    assert float(st["step"]) == int(count) == 2
    np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu))
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(nu))

    up, state = opt.update(jnp.asarray(g3), state)
    mat = optax.apply_updates(mat, up)
    _torch_step(m, topt, g3)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(mat), rtol=0, atol=1e-6)


def test_checkpoint_to_jax(tmp_path):
    """The reverse: the port's checkpoint after 2 torch Adam steps loads into
    JAX's load_checkpoint with optax.adam's template, and one more step on
    the same gradient matches the port's within 1e-6."""
    shape = (5, 7, 4)
    g1, g2, g3 = _grads(3, shape)
    m, topt = _torch_adam(np.full(shape, 0.5))
    for g in (g1, g2):
        _torch_step(m, topt, g)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, m, topt, step=2)

    opt = optax.adam(1e-2)
    mat, state, step, _x = jax_load(path, opt.init(jnp.zeros(shape, jnp.float32)))
    assert step == 2
    np.testing.assert_array_equal(np.asarray(mat), m.detach().numpy())
    count, mu, nu = jax.tree.leaves(state)
    assert int(count) == 2 and np.asarray(count).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(mu), topt.state[m]["exp_avg"].numpy())
    up, state = opt.update(jnp.asarray(g3), state)
    mat = optax.apply_updates(mat, up)
    _torch_step(m, topt, g3)
    np.testing.assert_allclose(np.asarray(mat), m.detach().numpy(), rtol=0, atol=1e-6)


def test_checkpoint_round_trip_bit_exact(tmp_path):
    """The port's own round trip: a fresh optimizer's (optax.adam's init,
    0 and zeros) and one after 3 steps come back bit for bit, and the next
    step from the loaded one equals the uninterrupted run's bit for bit."""
    shape = (4, 4, 4)
    grads = _grads(4, shape)
    m, topt = _torch_adam(np.full(shape, 0.5))
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, m, topt, step=0)
    with np.load(path) as raw:
        assert sorted(raw.files) == ["material", "n_opt_leaves", "opt_0", "opt_1", "opt_2",
                                     "step"]
        assert int(raw["opt_0"]) == 0 and not raw["opt_1"].any() and not raw["opt_2"].any()
    for g in grads[:3]:
        _torch_step(m, topt, g)
    tck.save_checkpoint(path, m, topt, step=3, extra={"tag": 7})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    m2, topt2 = _torch_adam(np.zeros(shape))
    _m, step, extras = tck.load_checkpoint(path, topt2)
    assert step == 3 and int(extras["tag"]) == 7
    assert torch.equal(m2, m)
    for k in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(topt2.state[m2][k], topt.state[m][k]), k
    _torch_step(m, topt, grads[3])
    _torch_step(m2, topt2, grads[3])
    assert torch.equal(m2, m)


def test_run_logger_records_match_jax(tmp_path):
    """RunLogger writes JAX's jsonl records: the same keys, the same values
    but the clock, the same steps skipped by `every`."""
    recs = {}
    for name, cls in (("port", tprof.RunLogger), ("jax", JaxRunLogger)):
        path = str(tmp_path / f"{name}.jsonl")
        log = cls(path, every=2)
        for step in range(5):
            log.log(step, loss=np.float32(0.25 * step), grad=torch.tensor(1.5)
                    if name == "port" else jnp.asarray(1.5), note="x")
        log.close()
        with open(path) as f:
            recs[name] = [json.loads(line) for line in f]
    assert [r["step"] for r in recs["port"]] == [0, 2, 4]
    for a, b in zip(recs["port"], recs["jax"], strict=True):
        assert list(a) == list(b) == ["step", "t", "loss", "grad", "note"]
        assert {k: v for k, v in a.items() if k != "t"} == {k: v for k, v in b.items()
                                                           if k != "t"}


def test_device_time_on_the_cpu():
    """device_time on a CPU result times by the host clock; it needs a
    warm-up to find the device."""
    x = torch.ones(64)
    assert tprof.device_time(torch.add, x, x, iters=3) > 0
    with pytest.raises(ValueError):
        tprof.device_time(torch.add, x, x, warmup=0)


def test_procedural_wood_and_material_files_match_jax(tmp_path):
    """procedural_wood and load_material_files (PNG diffuse, sRGB -> linear,
    and a roughness map, nearest-resized) equal JAX's bit for bit."""
    jex = _jax_app("example")
    np.testing.assert_array_equal(example.procedural_wood(48).numpy(),
                                  np.asarray(jex.procedural_wood(48)))
    rng = np.random.RandomState(3)
    d, r = str(tmp_path / "d.png"), str(tmp_path / "r.png")
    iio.imwrite(d, rng.randint(0, 256, (20, 20, 3)).astype(np.uint8))
    iio.imwrite(r, rng.randint(0, 256, (20, 20)).astype(np.uint8))
    for spec in (d, f"{d},{r}"):
        np.testing.assert_array_equal(example.load_material_files(spec, 12).numpy(),
                                      np.asarray(jex.load_material_files(spec, 12)))


def test_lightstage_patterns_match_jax():
    """build_lightstage(6) in both packages: each of 2 patterns (one light on,
    the rest None: removed by update_lights; JAX compiles each) renders
    within the golden bar (atol 2e-4, rtol 1e-4) of JAX's at 16x16, 2 spp."""
    jls = _jax_app("lightstage")
    js, ts = jls.build_lightstage(6), lightstage.build_lightstage(6, device="cpu")
    cam = dict(fov=50 / 180 * 3.1415926, origin=(0, 0.5, 2), target=(0, 0, 0),
               up=(0.0, 1.0, 0.0))
    js.camera = _jax_camera(cam)
    ts.camera = lightstage.make_camera()
    mat = np.random.RandomState(5).uniform(0.2, 0.8, (16, 16, 4)).astype(np.float32)
    patterns = lightstage.make_patterns(6, 2)
    assert all(sum(e is not None for e in p) == 1 for p in patterns)
    assert len({tuple(p) for p in patterns}) > 1
    for p, em in enumerate(patterns):
        js.update_lights(em)
        ts.update_lights(em)
        want = np.asarray(js.render(jnp.asarray(mat), res=(16, 16), spp=2, seed=p))
        got = ts.render(torch.as_tensor(mat), res=(16, 16), spp=2, seed=p).numpy()
        assert want[..., :3].mean() > 1e-3
        np.testing.assert_allclose(got, want, atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL,
                                   err_msg=f"pattern {p}")


def test_example_app_on_the_cpu(tmp_path, monkeypatch):
    """apps/example.py's gate (tests/test_apps.py): --small --iters 10 ends
    with the image MSE < 0.2 and writes the five EXR + PNG outputs; here at
    --device cpu with --small cut to a 32x32 image, a 16^2 texture, 8 spp
    GT and 2 a step (the plain BVH walk on the CPU takes ~0.5 s a sample at
    64x64; measured: MSE 0.0096, loss 131.9 -> 85.1)."""
    monkeypatch.setattr(example, "SMALL", ((32, 32), 16, 8, 2, 40))
    log = str(tmp_path / "steps.jsonl")
    mse = example.main(["--small", "--iters", "10", "--device", "cpu", "--out",
                        str(tmp_path), "--log", log])
    assert mse < 0.2, mse
    for name in example.OUTPUTS:
        assert (tmp_path / f"{name}.exr").exists()
        assert (tmp_path / f"{name}.png").exists()
    d = texr.load_exr(str(tmp_path / "diffuse.exr"))
    assert d.ndim == 3 and d.shape == (16, 16, 3)
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(10))
    assert all(set(r) == {"step", "t", "loss", "step_ms"} for r in recs)
    assert recs[-1]["loss"] < recs[0]["loss"]


def test_lightstage_app_on_the_cpu(monkeypatch):
    """apps/lightstage.py's gate (tests/test_apps.py): the loss's excess over
    the MC noise floor shrinks, excess_last < 0.8 excess_first; here at
    --device cpu with --small cut to 6 lights, 24x24, 8 spp, 4 steps, an
    8^2 texture, 2 patterns (the plain BVH walk on the CPU; measured: loss
    1055.0 -> 879.3, floor 703.3: excess 351.8 -> 176.0)."""
    monkeypatch.setattr(lightstage, "SMALL", (6, (24, 24), 8, 4, 8, 2))
    r = lightstage.main(["--small", "--device", "cpu"])
    excess_first = r["loss_first"] - r["noise_floor"]
    excess_last = r["loss_last"] - r["noise_floor"]
    assert excess_first > 0, r
    assert excess_last < 0.8 * excess_first, r


def test_apps_need_a_card_for_cuda():
    """--device cuda without a card raises; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        assert _common.app_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _common.app_device("cuda")
    for app in (example, lightstage, fd_validate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(["--device", "cuda"])


def _index_of(line):
    """The index tuple a fd_validate line prints ("Image index: (2, 7, 0)
    ...", numpy's scalars as np.int64(2))."""
    head = line.split(":", 1)[1].split(")  ")[0].replace("int64", "")
    return tuple(int(x) for x in re.findall(r"\d+", head))


def test_fd_validate_app_matches_jax(monkeypatch, capsys):
    """apps/fd_validate.py against the JAX package's on the same starting
    array (JAX's jax.random.uniform handed the port's numpy one), the
    direct integrator at 16x16, an 8^2 texture, --max-exp 0: the same
    pixel and texel, the FD row within 1e-3 (measured 2.8e-4: FD divides
    the images' float-level gaps by 0.02) and the AD row within 1e-4
    (measured 2.1e-5)."""
    jfd = _jax_app("fd_validate")
    args = ["--integrator", "direct", "--res", "16", "--tex", "8", "--max-exp", "0"]
    arr = fd_validate.start_material(8).numpy()
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(arr))
    monkeypatch.setattr(sys, "argv", ["fd_validate.py", *args])
    jfd.main()
    lines = capsys.readouterr().out.splitlines()
    got = fd_validate.main([*args, "--device", "cpu"])
    assert got["imgidx"] == _index_of(next(x for x in lines if x.startswith("Image index")))
    assert got["texidx"] == _index_of(next(x for x in lines if x.startswith("Texture index")))
    fd_row = [float(v) for v in lines[lines.index("FD:") + 1].split()]
    ad_row = [float(v) for v in lines[lines.index("AD:") + 1].split()]
    np.testing.assert_allclose(got["fd"][0], fd_row, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ad"][0], ad_row, rtol=0, atol=1e-4)
    assert any(v != 0.0 for v in got["ad"][0])
