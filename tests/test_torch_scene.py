"""The port's scene tables, light metadata and conversion against the JAX
package's, and the port's independence from JAX."""

import os
import inspect
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdr_tpu import Scene
from zdr_tpu.geometry.procedural import make_cornell_box, make_cornell_light
from zdr_tpu.integrators import pallas_bounce as pb
from zdr_tpu.integrators import pallas_loop as plp
from zdr_tpu.integrators.wrapper import _pixel_grid

import zdr_tpu_torch as zt
from zdr_tpu_torch import convert
from zdr_tpu_torch.geometry import procedural as tproc
from zdr_tpu_torch.integrators import scene_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_scene(point_light):
    s = Scene([(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
              integrator="path")
    if point_light:
        s.add_point_light((0.0, 4.5, -4.0), (6.0, 5.0, 4.0))
    return s


def _arrays(s):
    d = s._data
    arrays = {k: np.asarray(getattr(d.geom, k)) for k in convert.GEOMETRY_KEYS}
    arrays.update(
        emission=np.asarray(d.emission), point_pos=np.asarray(d.point_pos),
        point_intensity=np.asarray(d.point_intensity),
        point_count=np.asarray(d.point_count),
    )
    return arrays


@pytest.mark.parametrize("point_light", [False, True])
def test_tables_match_build_fused_const(point_light):
    s = _jax_scene(point_light)
    meta = s._data.fused_meta
    data = convert.scene_from_numpy(_arrays(s), meta, "cpu")
    scene_pack, light_pack = pb.build_fused_const(s._data, meta)
    t = meta.num_tris
    np.testing.assert_allclose(scene_tables.scene_table(data).numpy(),
                               np.asarray(scene_pack)[:t, :31], rtol=1e-6, atol=1e-7)
    n_l = len(meta.light_tri_ids)
    np.testing.assert_allclose(scene_tables.light_table(data).numpy(),
                               np.asarray(light_pack)[:n_l, :16], rtol=1e-6, atol=1e-7)
    cfg = s._config((16, 16), 4)
    (_m, _sp, _lp, li, pp, *_rest) = plp._loop_setup(
        s._data, jnp.zeros((4, 4, 4), jnp.float32), cfg, _pixel_grid(cfg.res), 0)
    np.testing.assert_array_equal(scene_tables.light_inst_table(data).numpy(),
                                  np.asarray(li)[:meta.n_lights, :2])
    n_p = meta.n_point
    assert scene_tables.point_table(data).shape == (n_p, 6)
    np.testing.assert_array_equal(scene_tables.point_table(data).numpy(),
                                  np.asarray(pp)[:n_p, :6])


def test_light_meta_matches_fused_meta():
    s = _jax_scene(False)
    ts = zt.Scene([(tproc.make_cornell_box(), None, None),
                   (tproc.make_cornell_light(), None, 15.0)], device="cpu")
    jm, tm = s._data.fused_meta, ts._data.meta
    for field in ("n_lights", "light_tri_ids", "light_offsets", "light_tcs",
                  "num_tris", "n_env", "n_point", "n_total"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert tm.light_tri_ids == (10, 11)


def test_geometry_matches_build_geometry():
    s = _jax_scene(False)
    ts = zt.Scene([(tproc.make_cornell_box(), None, None),
                   (tproc.make_cornell_light(), None, 15.0)], device="cpu")
    for k in convert.GEOMETRY_KEYS:
        np.testing.assert_array_equal(getattr(ts._data.geom, k).numpy(),
                                      np.asarray(getattr(s._data.geom, k)))


def test_convert_round_trips():
    s = _jax_scene(True)
    data = convert.scene_from_numpy(_arrays(s), s._data.fused_meta, "cpu")
    arrays, meta = convert.scene_to_numpy(data)
    again = convert.scene_from_numpy(arrays, meta, "cpu")
    for k in convert.GEOMETRY_KEYS:
        assert torch.equal(getattr(again.geom, k), getattr(data.geom, k))
    assert torch.equal(again.emission, data.emission)
    assert torch.equal(again.point_pos, data.point_pos)
    assert torch.equal(again.point_intensity, data.point_intensity)
    assert again.meta == data.meta
    assert data.meta.n_point == 1
    mat = np.random.RandomState(0).rand(5, 7, 4).astype(np.float32)
    t = convert.material_from_numpy(mat, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(convert.material_to_numpy(t), mat)


def test_port_imports_no_jax():
    code = ("import sys, zdr_tpu_torch, zdr_tpu_torch.kernels, zdr_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'zdr_tpu.'))"
            " or m == 'zdr_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scene_requires_explicit_device():
    """The CPU has to be asked for explicitly: a Scene built without a
    device lives on the card (the default is "cuda"), so without a card it
    fails in torch, as device="cuda" does."""
    assert inspect.signature(zt.Scene).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert zt.Scene([(tproc.make_cornell_box(), None, None)]).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        zt.Scene([(tproc.make_cornell_box(), None, None)])


def test_cuda_scene_without_a_card_raises():
    """No silent fallback to the CPU: a CUDA scene fails in torch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        zt.Scene([(tproc.make_cornell_box(), None, None)], device="cuda")
