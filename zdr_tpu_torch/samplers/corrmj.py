"""Correlated multi-jitter sampler (Kensler CMJ).

Port of zdr_tpu/samplers/corrmj.py. A 1D draw is the sample index's
permuted stratum plus an LCG jitter; a 2D draw a multi-jittered point on an
r x r grid (r = floor(sqrt(spp + 0.4)), in float32) with shuffled row and
column strata. The state is a uint32 (held as int64) per lane: the sample
index, the dimension and the LCG jitter stream; the permutation seed is a
constant of the lane.

On the card the draws run inside the kernels (kernels/csrc/path_loop_step.cuh,
the sampler of kind 2); this is their plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashes import (
    M32,
    ONE_MINUS_EPSILON,
    is_pow2,
    lcg_step,
    lcg_to_unit_float,
    mul32,
    next_pow2_mask,
    permutation_element,
    permutation_element_pow2,
    to_f32,
    u32,
    xxhash32_4,
)
from .lcg import SALT

MASK = 0x70FFFFFF  # the permutation keys' mask


def grid_side(spp: int) -> int:
    """floor(sqrt(float32(spp) + 0.4)) in float32 arithmetic, at least 1:
    the grid side of make_corrmj_sampler_xy (corrmj.py:126)."""
    return max(1, int(np.sqrt(np.float32(spp) + np.float32(0.4))))


def is_p2(spp: int) -> bool:
    """spp and its grid side both powers of two: no permutation rejects."""
    return is_pow2(spp) and is_pow2(grid_side(spp))


@dataclasses.dataclass(frozen=True)
class CorrMJSampler:
    _RESTART_VARYING = ("sample_index", "dimension", "state")
    sample_index: torch.Tensor  # uint32 as int64
    dimension: torch.Tensor  # uint32 as int64
    permutation_seed: torch.Tensor  # uint32 as int64, constant per lane
    state: torch.Tensor  # uint32 as int64, the LCG jitter stream
    spp: int
    w: int  # next_pow2(spp) - 1
    res: int  # the grid side
    resw: int  # next_pow2(res) - 1

    @staticmethod
    def _perm(i, l: int, w: int, p):
        """The Kensler permutation: the generic rejection loop."""
        return permutation_element(i, l, w, p)

    def _f32(self, v: int) -> torch.Tensor:
        # a device tensor, not a Python number: a CUDA division by a host
        # scalar is a product by its reciprocal, which rounds otherwise
        return torch.tensor(float(v), dtype=torch.float32, device=self.state.device)

    def salt(self) -> torch.Tensor:
        """Per-lane, per-bounce uint32 side channel (see LCGSampler.salt)."""
        return self.state ^ mul32(self.dimension, 0x9E3779B9) ^ SALT

    def _key(self, k: int) -> torch.Tensor:
        ps = (self.permutation_seed + self.dimension) & M32
        return mul32(ps, k) & MASK

    def next1(self):
        index = self._perm(self.sample_index, self.spp, self.w, self._key(0x45FBE943))
        state = lcg_step(self.state)
        u = (to_f32(index) + lcg_to_unit_float(state)) / self._f32(self.spp)
        u = torch.clamp(u, 0.0, ONE_MINUS_EPSILON)
        return u, dataclasses.replace(self, dimension=(self.dimension + 1) & M32,
                                      state=state)

    def next2_xy(self):
        index = self._perm(self.sample_index, self.spp, self.w, self._key(0x51633E2D))
        y = index // self.res
        x = index % self.res
        sx = self._perm(x, self.res, self.resw, self._key(0x68BC21EB))
        sy = self._perm(y, self.res, self.resw, self._key(0x02E5BE93))
        s1 = lcg_step(self.state)
        s2 = lcg_step(s1)
        resf = self._f32(self.res)
        ux = (to_f32(x) + (to_f32(sy) + lcg_to_unit_float(s1)) / resf) / resf
        uy = (to_f32(y) + (to_f32(sx) + lcg_to_unit_float(s2)) / resf) / resf
        ux = torch.clamp(ux, 0.0, ONE_MINUS_EPSILON)
        uy = torch.clamp(uy, 0.0, ONE_MINUS_EPSILON)
        return (ux, uy), dataclasses.replace(self, dimension=(self.dimension + 2) & M32,
                                             state=s2)


class CorrMJSamplerP2(CorrMJSampler):
    """spp and the grid side both powers of two: every permutation is the
    loop-free form (permutation_element_pow2), the same bits."""

    @staticmethod
    def _perm(i, l: int, w: int, p):
        return permutation_element_pow2(i, w, p)


def corrmj_fresh_state(px, py, seed, sample_index) -> torch.Tensor:
    """The jitter stream of a fresh sampler at (pixel, seed, sample_index)."""
    return xxhash32_4(px, py, seed, sample_index)


def corrmj_sampler(px, py, seed, spp: int, sample_index, dimension, state) -> CorrMJSampler:
    """The sampler of the given state at the lane's pixel and seed, of the
    class the JAX package's factory picks at this spp."""
    res = grid_side(spp)
    cls = CorrMJSamplerP2 if is_p2(spp) else CorrMJSampler
    return cls(
        sample_index=sample_index,
        dimension=dimension,
        permutation_seed=xxhash32_4(px, py, seed, 0).expand(state.shape),
        state=state,
        spp=int(spp),
        w=next_pow2_mask(spp),
        res=res,
        resw=next_pow2_mask(res),
    )


def make_corrmj_sampler_xy(px, py, seed, spp: int, sample_index) -> CorrMJSampler:
    """Fresh sampler at (pixel, seed, sample_index); seed and sample_index
    ints or tensors like px. spp <= 0 raises ValueError."""
    if spp <= 0:
        raise ValueError(f"spp must be >= 1, got {spp}")
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    si = u32(torch.as_tensor(sample_index, device=px.device)).expand(px.shape)
    state = corrmj_fresh_state(px, py, seed, si).expand(px.shape)
    return corrmj_sampler(px, py, seed, spp, si, torch.zeros_like(px), state)
