"""Progressive multi-jittered (0,2) blue-noise sampler.

Port of zdr_tpu/samplers/pmj02bn.py (`PMJ02BNSampler`, `PMJ02BNSamplerP2`).
Per draw:
  * 1D: Kensler permutation of the sample index within spp (keyed by
    xxhash32(pixel, dimension, seed)), stratified value + the pixel's
    blue-noise Cranley-Patterson offset (pixel xor seed picks the texel).
  * 2D: an Owen-scrambled Sobol' (0,2) point, computed procedurally, plus a
    2D blue-noise offset, fract-wrapped.

The blue-noise textures are the port's own copy (bluenoise.npz beside this
module) of the "bluenoise" array of zdr_tpu/samplers/tables.npz, the one
array of that file the port reads. A draw indexes
`bn_rows[(y * res + x) * n_tex + dim % n_tex]` directly; the value is the
one the JAX package's per-lane cache holds. At a power-of-two spp the
permutation is the loop-free form (PMJ02BNSamplerP2), at any other the
generic rejection loop (PMJ02BNSampler): the same bits where both apply.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Tuple

import numpy as np
import torch

from .hashes import (
    M32,
    ONE_MINUS_EPSILON,
    is_pow2,
    mul32,
    next_pow2_mask,
    permutation_element,
    permutation_element_pow2,
    to_f32,
    u32,
    xxhash32_4,
)
from .lcg import SALT

BLUENOISE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bluenoise.npz")

_PMJ_SET_SEEDS = (
    (822569775, 2137449171),
    (524453158, 1365105717),
    (1880026316, 481516916),
    (1225605784, 1165481977),
    (1202486927, 1549064881),
)
_SOBOL2_DIRS = (
    2147483648, 3221225472, 2684354560, 4026531840, 2281701376, 3422552064,
    2852126720, 4278190080, 2155872256, 3233808384, 2694840320, 4042260480,
    2290614272, 3435921408, 2863267840, 4294901760,
)
N_SETS = len(_PMJ_SET_SEEDS)
N_SAMPLES = 65536


@functools.lru_cache(maxsize=None)
def bluenoise_rows() -> Tuple[np.ndarray, int, int]:
    """(bn_rows (res*res*n_tex,) float32, res, n_tex): every texture's value at
    one pixel in consecutive entries, the layout of pmj02bn._tables(). Read
    once per process; the array is read-only."""
    with np.load(BLUENOISE_PATH) as raw:
        bn = np.asarray(raw["bluenoise"], np.float32)  # (n_tex, res, res)
    n_tex, res = bn.shape[0], bn.shape[1]
    rows = np.ascontiguousarray(bn.transpose(1, 2, 0).reshape(-1))
    rows.setflags(write=False)
    return rows, res, n_tex


@functools.lru_cache(maxsize=None)
def bluenoise(device) -> Tuple[torch.Tensor, int, int]:
    """bluenoise_rows() as a tensor on `device`, uploaded once per device.
    Callers must not write to it."""
    rows, res, n_tex = bluenoise_rows()
    return torch.tensor(rows, device=device), res, n_tex


def _vdc_u32(v: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse (bit reversal) of a uint32."""
    v = ((v >> 16) | (v << 16)) & M32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    v = ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)
    return v


def _sobol2_u32(idx: torch.Tensor) -> torch.Tensor:
    """Second Sobol' dimension for an index below 2**16."""
    out = torch.zeros_like(idx)
    for k, d in enumerate(_SOBOL2_DIRS):
        out = out ^ (d * ((idx >> k) & 1))
    return out


def _owen_rev_u32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras scramble of an already bit-reversed input."""
    v = (v + seed) & M32
    v = v ^ mul32(v, 0x6C50B47C)
    v = v ^ mul32(v, 0xB82F1E52)
    v = v ^ mul32(v, 0xC7AFE638)
    v = v ^ mul32(v, 0x8D22F6E6)
    return _vdc_u32(v)


def pmj_point(set_idx: torch.Tensor, index: torch.Tensor):
    """(x, y) float32 of sample `index` (< 2**16) in set `set_idx`."""
    seeds = torch.tensor(_PMJ_SET_SEEDS, dtype=torch.int64, device=index.device)
    sx = seeds[set_idx, 0]
    sy = seeds[set_idx, 1]
    xu = _owen_rev_u32(index, sx)
    yu = _owen_rev_u32(_vdc_u32(_sobol2_u32(index)), sy)
    return to_f32(xu) * (2.0 ** -32), to_f32(yu) * (2.0 ** -32)


def bn_base(px: torch.Tensor, py: torch.Tensor, seed, res: int, n_tex: int) -> torch.Tensor:
    """Per-lane first index into bn_rows: the texel at (pixel ^ seed), with
    the int32 abs-then-mod of pmj02bn._build_bn_cache."""
    s = u32(seed)

    def wrap(c):
        b = u32(c) ^ s
        return torch.abs(b - ((b >> 31) << 32)) % res

    return (wrap(py) * res + wrap(px)) * n_tex


@dataclasses.dataclass(frozen=True)
class PMJ02BNSampler:
    _RESTART_VARYING = ("sample_index", "dimension")
    px: torch.Tensor  # int64 pixel x
    py: torch.Tensor  # int64 pixel y
    sample_index: torch.Tensor  # uint32 as int64
    dimension: torch.Tensor  # uint32 as int64
    seed: object  # uint32: an int, or an int64 tensor like px
    spp: int
    bn_rows: torch.Tensor  # (res*res*n_tex,) float32
    bn_base: torch.Tensor  # int64 per-lane index of the pixel's first texture
    n_tex: int

    @staticmethod
    def _perm(i, l: int, w: int, p):
        """The Kensler permutation within spp: the generic rejection loop."""
        return permutation_element(i, l, w, p)

    def _bn(self, dim: torch.Tensor) -> torch.Tensor:
        return self.bn_rows[self.bn_base + dim % self.n_tex]

    def salt(self) -> torch.Tensor:
        """Per-lane, per-bounce uint32 side channel (see LCGSampler.salt)."""
        return xxhash32_4(self.px ^ SALT, self.py, self.dimension,
                          u32(self.seed) ^ self.sample_index)

    def next1(self):
        w = next_pow2_mask(self.spp)
        h = xxhash32_4(self.px, self.py, self.dimension, self.seed)
        index = self._perm(self.sample_index, self.spp, w, h)
        spp = torch.tensor(float(self.spp), dtype=torch.float32, device=index.device)
        u = (to_f32(index) + self._bn(self.dimension)) / spp
        u = torch.clamp(u, 0.0, ONE_MINUS_EPSILON)
        return u, dataclasses.replace(self, dimension=(self.dimension + 1) & M32)

    def next2_xy(self):
        w = next_pow2_mask(self.spp)
        instance = self.dimension // 2
        h = xxhash32_4(self.px, self.py, self.dimension, self.seed)
        permuted = self._perm(self.sample_index, self.spp, w, h)
        index = torch.where(instance >= N_SETS, permuted, self.sample_index) % N_SAMPLES
        ptx, pty = pmj_point(instance % N_SETS, index)
        ux = ptx + self._bn(self.dimension)
        uy = pty + self._bn(self.dimension + 1)
        ux = ux - torch.floor(ux)
        uy = uy - torch.floor(uy)
        return (ux, uy), dataclasses.replace(self, dimension=(self.dimension + 2) & M32)


class PMJ02BNSamplerP2(PMJ02BNSampler):
    """Power-of-two spp: the permutation's first candidate is always below
    spp, so the rejection loop never runs (permutation_element_pow2)."""

    @staticmethod
    def _perm(i, l: int, w: int, p):
        return permutation_element_pow2(i, w, p)


def pmj02bn_class(spp: int):
    """The class the JAX package's factory picks at this spp."""
    return PMJ02BNSamplerP2 if is_pow2(spp) else PMJ02BNSampler


def make_pmj02bn_sampler_xy(px, py, seed, spp: int, sample_index, bn=None):
    """Fresh sampler at (pixel, seed, sample_index); seed an int or a tensor
    like px; bn = bluenoise(px.device) by default. The class by spp, as
    pmj02bn.py:268-295 picks it; spp <= 0 raises ValueError."""
    if spp <= 0:
        raise ValueError(f"spp must be >= 1, got {spp}")
    rows, res, n_tex = bluenoise(px.device) if bn is None else bn
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    return pmj02bn_class(spp)(
        px=px,
        py=py,
        sample_index=u32(torch.as_tensor(sample_index, device=px.device)).expand(px.shape),
        dimension=torch.zeros_like(px),
        seed=u32(seed),
        spp=int(spp),
        bn_rows=rows,
        bn_base=bn_base(px, py, seed, res, n_tex),
        n_tex=n_tex,
    )
