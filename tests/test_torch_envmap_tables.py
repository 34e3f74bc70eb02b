"""The port's envmap tables (zdr_tpu_torch/envmap.py build_envmap) against
the JAX package's (zdr_tpu/envmap.py build_envmap), bit for bit: the same
numpy code, float64 sums included. Kept apart from tests/test_torch_envmap.py
(which holds the scenes' envmap, 64x128 compensated, to the same check)
because each JAX build takes seconds on the CPU (its 289 filter taps), and
each file stays under a minute in one process."""

import numpy as np
import pytest

from zdr_tpu import envmap as jenv

from zdr_tpu_torch import envmap as tenv
from test_torch_unfused import one_torch_thread  # noqa: F401 (autouse)


def assert_tables_equal(got, want, compensate):
    """The port's EnvMap equals the JAX package's: texture, alias
    probabilities, alias indices (int32) and pdf; with the MIS compensation
    whole rows of the sample map are zero (their alias tables uniform,
    create_alias_table's all-zero case, and their pdf 0), without it
    none."""
    for field in ("texture", "alias_prob", "alias_idx", "pdf"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    rows = got.pdf.numpy().reshape(tenv.SAMPLE_MAP_H, tenv.SAMPLE_MAP_W)
    assert (rows.max(axis=1) == 0).any() == compensate


# (64, 128) compensated, the scenes' envmap, is held in tests/test_torch_envmap.py
@pytest.mark.parametrize("hw,compensate", [((16, 32), True), ((16, 32), False),
                                           ((64, 128), False)],
                         ids=["16x32-compensated", "16x32-plain", "64x128-plain"])
def test_build_envmap_equals_jax_bit_for_bit(hw, compensate):
    """make_test_envmap at two sizes, with and without the MIS compensation:
    the tables equal bit for bit (assert_tables_equal)."""
    img = jenv.make_test_envmap(*hw)
    assert np.array_equal(tenv.make_test_envmap(*hw), img)
    assert_tables_equal(tenv.build_envmap(img, compensate_mis=compensate),
                        jenv.build_envmap(img, compensate_mis=compensate), compensate)


def test_filter_taps_equal_bilinear_wrap():
    """build_envmap's filter taps (_filter_taps: rows and columns gathered
    apart) are _bilinear_wrap's on the sample map's grid, bit for bit, at
    the filter's corner and centre offsets and across the clamp-y edge."""
    img = tenv.make_test_envmap(16, 32)[..., :3]
    pu = (np.arange(tenv.SAMPLE_MAP_W) + 0.5) / tenv.SAMPLE_MAP_W
    pv = (np.arange(tenv.SAMPLE_MAP_H) + 0.5) / tenv.SAMPLE_MAP_H
    uu, vv = np.meshgrid(pu, pv)
    for dx, dy in ((-1.0, -1.0), (0.0, 0.0), (0.375, -0.625), (1.0, 1.0)):
        dx, dy = dx / tenv.SAMPLE_MAP_W, dy / tenv.SAMPLE_MAP_H
        want = tenv._bilinear_wrap(img, uu + dx, np.clip(vv + dy, 0.0, 1.0 - 1e-7))
        np.testing.assert_array_equal(tenv._filter_taps(img, pu, pv, dx, dy), want)
